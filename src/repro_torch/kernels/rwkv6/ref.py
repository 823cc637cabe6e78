"""Plain PyTorch version of the RWKV-6 WKV recurrence (the kernel's
oracle).

Mirrors the JAX package's kernels/rwkv6/ref.py wkv6_ref: per (row, head)
an [hd, hd] state S, and for each step

    o_t = r_t^T (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T

with w_t = exp(logw_t), in f32 throughout, from a zero state (or s0).
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, logw, u, s0=None):
    """r, k, v, logw: [B,H,S,hd]; u: [H,hd]; s0: [B,H,hd,hd] or None.
    Returns (o [B,H,S,hd] f32, s_final [B,H,hd,hd] f32)."""
    B, H, S, hd = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = torch.exp(logw.float())
    uf = u.float()
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    o = torch.empty((B, H, S, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kt, vt = kf[:, :, t], vf[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]  # [B,H,hd,hd]
        att = s + (uf[None] * kt)[..., :, None] * vt[..., None, :]
        o[:, :, t] = torch.einsum("bhc,bhcd->bhd", rf[:, :, t], att)
        s = w[:, :, t][..., :, None] * s + kv
    return o, s
