"""Plain PyTorch version of paged decode attention (the kernel's oracle).

Mirrors the JAX package's kernels/paged_decode/ref.py: gather each row's
blocks in table order, then masked softmax attention in f32.
"""
from __future__ import annotations

import math

import torch


def paged_decode_ref(q, k_pool, v_pool, tables, lengths):
    """q: [B,Hq,hd]; k_pool/v_pool: [NB,Hkv,bs,hd]; tables: [B,MB] int32;
    lengths: [B] int32 (last valid logical position, -1 = fully masked).

    Returns [B,Hq,hd] f32.
    """
    B, Hq, hd = q.shape
    _, Hkv, bs, _ = k_pool.shape
    MB = tables.shape[1]
    g = Hq // Hkv
    idx = tables.long()
    kg = k_pool[idx].transpose(1, 2).reshape(B, Hkv, MB * bs, hd)
    vg = v_pool[idx].transpose(1, 2).reshape(B, Hkv, MB * bs, hd)
    qg = q.reshape(B, Hkv, g, hd).float()
    s = torch.matmul(qg, kg.float().transpose(-1, -2)) / math.sqrt(hd)
    kpos = torch.arange(MB * bs, device=q.device)
    ok = kpos[None, None, None, :] <= lengths.long()[:, None, None, None]
    s = s.masked_fill(~ok, float("-inf"))
    a = torch.softmax(s, dim=-1)
    a = torch.nan_to_num(a, nan=0.0)  # fully-masked rows -> zeros
    o = torch.matmul(a, vg.float())
    return o.reshape(B, Hq, hd)


def paged_decode_quant_ref(q, k_pool, v_pool, k_scale, v_scale, tables,
                           lengths):
    """Quantized oracle: dequantize the whole int8 pool up front (values
    times per-row scales, in f32), then run the fp version. k_pool/v_pool
    [NB,Hkv,bs,hd] int8; k_scale/v_scale [NB,Hkv,bs] f32. Returns
    [B,Hq,hd] f32."""
    kf = k_pool.float() * k_scale[..., None]
    vf = v_pool.float() * v_scale[..., None]
    return paged_decode_ref(q, kf, vf, tables, lengths)
