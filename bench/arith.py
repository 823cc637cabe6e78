"""The benchmark's own arithmetic, frozen here so that a change to the
program cannot move the yardstick: the card's published peaks, the
percentiles of the end-to-end tails, and the model flops a token needs.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

# NVIDIA's data sheet for the H100 SXM part, dense rates: 989 TFLOP/s in
# bf16, HBM3 at 3.35 TB/s (80 GB). Looked up by a substring of
# torch.cuda.get_device_name(); a card not listed has no peak, and the
# readers that need one report nothing.
PEAKS = {
    "H100": {"bf16_flops_s": 989e12, "hbm_bytes_s": 3.35e12},
}


def peaks(kind: str) -> Dict[str, float]:
    for key, p in PEAKS.items():
        if key in kind:
            return p
    return {}


def nearest_rank(values: Sequence[float], pct: float) -> Tuple[float, int]:
    """The pct-th percentile by nearest rank over every value, and how
    many values lie beyond it."""
    if not values:
        raise ValueError("a percentile of no values")
    s = sorted(values)
    k = max(math.ceil(pct / 100.0 * len(s)) - 1, 0)
    return s[k], len(s) - k - 1


def matmul_params(cfg: dict) -> int:
    """Weights that every token multiplies: each layer's q, k, v, o and
    SwiGLU products, and the LM head (the embedding is a lookup)."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = head_dim(cfg)
    layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff
    return cfg["num_hidden_layers"] * layer + d * cfg["vocab_size"]


def head_dim(cfg: dict) -> int:
    return int(cfg.get("head_dim") or cfg.get("derived", {}).get("head_dim")
               or cfg["hidden_size"] // cfg["num_attention_heads"])


def span_flops(cfg: dict, lo: int, hi: int) -> float:
    """Model flops of computing the tokens at positions lo .. hi - 1
    (0-based): 2 x the product weights each, and attention's scores and
    P.V, 4 x layers x heads x head_dim for each of the position + 1 keys
    it reads."""
    if hi <= lo:
        return 0.0
    n = hi - lo
    att = 4 * cfg["num_hidden_layers"] * cfg["num_attention_heads"] \
        * head_dim(cfg)
    return 2.0 * matmul_params(cfg) * n + att * (n * (lo + hi + 1) / 2.0)
