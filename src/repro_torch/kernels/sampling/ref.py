"""Sort-based plain version of the fused top-k/top-p mask (the kernel's
oracle), mirroring the JAX package's kernels/sampling/ref.py.

Semantics (per row, over the valid vocab):
  top_k > 0:  keep logits >= the k-th largest logit (value ties all kept)
  top_p < 1:  keep probs >= the prob of the last token in the minimal
              descending-prob prefix whose mass reaches top_p (ties kept)
Dropped entries become NEG_INF so a downstream argmax / Gumbel-max can
never pick them. The row's argmax always survives both filters.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def topk_topp_mask_ref(logits, top_k, top_p):
    """logits [T,V] f32; top_k [T] int32 (<=0 off); top_p [T] f32 (>=1 off).

    Returns [T,V] f32: kept logits unchanged, dropped entries NEG_INF.
    """
    logits = logits.float()
    T, V = logits.shape
    desc = torch.sort(logits, dim=-1, descending=True).values
    k = top_k.long().clamp(1, V)
    kth = torch.gather(desc, 1, (k - 1)[:, None])  # [T,1]
    keep_k = torch.where(top_k[:, None] > 0, logits >= kth, True)

    lmax = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - lmax)
    # The JAX oracle sums in f32. Here both sums run in f64 (the probs
    # stay f32): over a 32000-entry tail, f32 rounding of the running mass
    # is as large as the probabilities near a top_p close to 1, so an f32
    # cutoff depends on the summation order; in f64 it does not, and the
    # CUDA kernel (another order) lands on the same keep-set.
    denom = e.double().sum(dim=-1, keepdim=True).float()
    probs = e / denom
    # softmax is monotone, so the descending probs are the softmax of the
    # already-sorted logits — no second sort of the [T,V] matrix
    p_desc = torch.exp(desc - lmax) / denom
    csum = torch.cumsum(p_desc.double(), dim=-1)
    # first index where the running mass reaches top_p = the minimal prefix
    # (argmax of an all-False row is 0, as in the JAX oracle)
    idx = torch.argmax((csum >= top_p.double()[:, None]).to(torch.int8),
                       dim=-1)
    cutoff = torch.gather(p_desc, 1, idx[:, None])  # [T,1]
    keep_p = torch.where(top_p[:, None] < 1.0, probs >= cutoff, True)

    return torch.where(keep_k & keep_p, logits,
                       torch.full_like(logits, NEG_INF))
