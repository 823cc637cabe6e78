"""Plain PyTorch version of the RG-LRU scan (the kernel's oracle).

Mirrors the JAX package's kernels/rglru/ref.py rglru_ref_loop: the
sequential recurrence h_t = a_t * h_{t-1} + b_t per channel, in f32,
from h0 (zeros when absent). Each step is a product and a sum, rounded
separately, as the kernel computes them.
"""
from __future__ import annotations

import torch


def rglru_ref_loop(a, b, h0=None):
    """a, b: [B,S,W] f32; h0: [B,W] f32 or None. Returns h [B,S,W] f32."""
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), b.float()
    out = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out
