"""Seeded sampling as the serving contract states it, plainly: a row's
key is fold_in(PRNGKey(seed), position) of the Threefry-2x32 generator
(jax.random's bits, the published algorithm: Salmon et al., SC'11), its
noise Gumbel(0, 1) over the vocabulary; the token is the argmax of
logits / temperature + noise over the nucleus (top-p) and top-k keep-set.
"""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & _M


def threefry(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 values held in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M
    x2 = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M
    return x1, x2


def gumbel(seed: int, position: int, n: int, device) -> torch.Tensor:
    """Gumbel noise [n] of the key fold_in(PRNGKey(seed), position), as
    jax.random.gumbel draws it (uniform in [tiny, 1) from the top 23 bits)."""
    z = torch.zeros((), dtype=torch.int64, device=device)
    k1, k2 = z, torch.tensor(int(seed) & _M, dtype=torch.int64, device=device)
    k1, k2 = threefry(k1, k2, z, torch.tensor(int(position) & _M,
                                              dtype=torch.int64,
                                              device=device))
    c = torch.arange(n, dtype=torch.int64, device=device)
    y1, y2 = threefry(k1, k2, torch.zeros_like(c), c)
    bits = ((y1 ^ y2) >> 9) | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(u * (1.0 - tiny) + tiny, tiny)
    return -torch.log(-torch.log(u))


def keep_set(logits: torch.Tensor, temperature: float, top_p: float,
             top_k: int, slack: float = 0.0) -> torch.Tensor:
    """Boolean [V]: the tokens of the nucleus and top-k set at this
    temperature. A token is kept while the probability mass of the tokens
    more probable than it is below top_p + slack (slack may be negative:
    the tokens every rounding keeps). The most probable token is always
    kept."""
    z = logits.double() / temperature
    keep = torch.ones_like(z, dtype=torch.bool)
    if top_k > 0:
        kth = torch.topk(z, min(top_k, z.numel())).values[-1]
        keep &= z >= kth
    if top_p < 1.0:
        p = torch.softmax(z, -1)
        ps, order = torch.sort(p, descending=True)
        # the mass of the tokens sorted before each one
        above = torch.cumsum(ps, 0) - ps
        kept = torch.empty_like(keep)
        kept[order] = above < max(top_p + slack, 1e-12)
        keep &= kept
    return keep
