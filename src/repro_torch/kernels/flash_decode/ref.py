"""Plain versions of flash-decoding: one-token attention over a contiguous
KV cache (the JAX package's kernels/flash_decode/ref.py decode_ref), and
the partial (o, m, l) with the kernel's conventions, which the
sequence-sharded op merges across ranks.

cur_len is one scalar for the batch (an int or a 1-element tensor), or a
[B] int tensor, row b's own last valid position. slots (optional, [B]
int) names the cache row each query row reads: k, v then hold num_slots
rows, several query rows may read one, and a row's result is what the
scalar form gives on that slot's row at that row's cur_len."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _scores(q, k, cur_len, slots=None):
    """f32 scores [B,Hkv,g,S] over a [B,Hkv,S,hd] cache (row b's slot of
    a [num_slots,Hkv,S,hd] one given slots) and the mask of positions <=
    cur_len ([S] bool for a scalar cur_len, [B,1,1,S] for a [B] one; read
    on the device so no host sync)."""
    B, Hq, hd = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if slots is not None:
        k = k[torch.as_tensor(slots, device=q.device).long()]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, hd)
    s = qf @ k.float().transpose(-1, -2) / math.sqrt(hd)
    cur = torch.as_tensor(cur_len, device=q.device)
    pos = torch.arange(S, device=q.device)
    if cur.numel() == 1:
        return s, pos <= cur.reshape(())
    return s, pos <= cur.reshape(B, 1, 1, 1)


def _values(q, v, slots=None):
    """The f32 value rows each query row reads (row b's slot's)."""
    if slots is not None:
        v = v[torch.as_tensor(slots, device=q.device).long()]
    return v.float()


def decode_ref(q, k, v, cur_len, slots=None):
    """q [B,Hq,hd]; k, v [B,Hkv,S,hd] (or [num_slots,...] with slots);
    attends to positions <= cur_len. Returns [B,Hq,hd] f32 (a row with no
    valid position: NaN, as the reference's softmax over -inf)."""
    B, Hq, hd = q.shape
    s, ok = _scores(q, k, cur_len, slots)
    a = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return (a @ _values(q, v, slots)).reshape(B, Hq, hd)


def flash_decode_partials_ref(q, k, v, cur_len, slots=None):
    """The partials of flash_decode_kernel: (o [B,Hq,hd] f32, normalised
    with l floored at 1e-30; m [B,Hq,1] f32, the largest valid score;
    l [B,Hq,1] f32, the sum of exp(score - m) over valid positions). An
    all-masked slice or row (cur_len == -1) gives m = -1e30, l = 0,
    o = 0."""
    B, Hq, hd = q.shape
    s, ok = _scores(q, k, cur_len, slots)
    m = torch.where(ok, s, torch.full_like(s, NEG_INF)).amax(-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    o = (p @ _values(q, v, slots)) / torch.clamp_min(l, 1e-30)
    return (o.reshape(B, Hq, hd), m.reshape(B, Hq, 1), l.reshape(B, Hq, 1))
