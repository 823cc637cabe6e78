"""Plain versions of flash-decoding: one-token attention over a contiguous
KV cache (the JAX package's kernels/flash_decode/ref.py decode_ref), and
the partial (o, m, l) with the kernel's conventions, which the
sequence-sharded op merges across ranks."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, cur_len):
    """f32 scores [B,Hkv,g,S] over a [B,Hkv,S,hd] cache and the mask of
    positions <= cur_len ([S] bool; cur_len an int or a 1-element tensor,
    read on the device so no host sync)."""
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, hd)
    s = qf @ k.float().transpose(-1, -2) / math.sqrt(hd)
    cur = torch.as_tensor(cur_len, device=q.device).reshape(())
    ok = torch.arange(S, device=q.device) <= cur
    return s, ok


def decode_ref(q, k, v, cur_len):
    """q [B,Hq,hd]; k, v [B,Hkv,S,hd]; attends to positions <= cur_len.
    Returns [B,Hq,hd] f32 (a row with no valid position: NaN, as the
    reference's softmax over -inf)."""
    B, Hq, hd = q.shape
    s, ok = _scores(q, k, cur_len)
    a = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return (a @ v.float()).reshape(B, Hq, hd)


def flash_decode_partials_ref(q, k, v, cur_len):
    """The partials of flash_decode_kernel: (o [B,Hq,hd] f32, normalised
    with l floored at 1e-30; m [B,Hq,1] f32, the largest valid score;
    l [B,Hq,1] f32, the sum of exp(score - m) over valid positions). An
    all-masked slice (cur_len == -1) gives m = -1e30, l = 0, o = 0."""
    B, Hq, hd = q.shape
    s, ok = _scores(q, k, cur_len)
    m = torch.where(ok, s, torch.full_like(s, NEG_INF)).amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = (p @ v.float()) / torch.clamp_min(l, 1e-30)
    return (o.reshape(B, Hq, hd), m.reshape(B, Hq, 1), l.reshape(B, Hq, 1))
