"""Plain PyTorch version of flash attention (the kernel's oracle).

Mirrors the JAX package's kernels/flash_attention/ref.py: exact softmax
attention in f32, causal and sliding-window masks at -inf, GQA with query
head h reading KV head h // g, the result cast to q's dtype.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B,Hq,Sq,hd]; k, v: [B,Hkv,Sk,hd]. Returns [B,Hq,Sq,hd] in
    q.dtype."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, Sq, hd)
    s = torch.matmul(qf, k.float()[:, :, None].transpose(-1, -2)) \
        / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = s.masked_fill(~ok, float("-inf"))
    a = torch.softmax(s, dim=-1)
    o = torch.matmul(a, v.float()[:, :, None])
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)
