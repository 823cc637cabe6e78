"""Seeded weights, made on the device in the type they are served in.

The benchmark draws every tensor itself from --seed with a
torch.Generator on the card, one call a leaf (the layers' leaves stacked
on a leading layer axis, as the program takes them), and hands the same
tensors to the program and to the plain reference. Scales: every product
N(0, 1/fan_in), the embedding N(0, 1), the RMSNorm and qk-norm scales
0.1 x N(0, 1). The program stores an RMSNorm scale as its offset from 1
(it multiplies by 1 + scale), so the published weight of each norm is
1 + the stored value; the reference reads it so.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def padded_vocab(vocab: int) -> int:
    """The one-device vocabulary of the program's parameter tree: rows
    rounded up to a multiple of 8."""
    return -(-vocab // 8) * 8


def make(cfg: dict, seed: int, device) -> dict:
    """The parameter tree the program's engine takes, for a dense decoder
    of "attn" layers: {"embed" [Vp, d], "blocks": ({"ln1", "attn": {"wq",
    "wk", "wv", "wo"[, "q_norm", "k_norm"]}, "ln2", "mlp": {"w_gate",
    "w_up", "w_down"}},) stacked over the layers, "tail": (), "final_norm",
    "unembed" [d, Vp]}, products [fan_in, fan_out] bf16, norm scales f32."""
    gen = torch.Generator(device=device)
    gen.manual_seed(abs(int(seed)) % (2**63 - 1))
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = int(cfg.get("head_dim") or cfg["derived"]["head_dim"])
    L, vp = cfg["num_hidden_layers"], padded_vocab(cfg["vocab_size"])
    qk_norm = bool(cfg.get("qk_norm", cfg.get("derived", {}).get("qk_norm")))

    def product(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                        device=device)
        return w.mul_(1.0 / math.sqrt(shape[-2]))

    def scale(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device).mul_(0.1)

    attn = {"wq": product(L, d, hq * hd), "wk": product(L, d, hkv * hd),
            "wv": product(L, d, hkv * hd), "wo": product(L, hq * hd, d)}
    if qk_norm:
        attn.update(q_norm=scale(L, hd), k_norm=scale(L, hd))
    block = {"ln1": scale(L, d), "attn": attn, "ln2": scale(L, d),
             "mlp": {"w_gate": product(L, d, ff), "w_up": product(L, d, ff),
                     "w_down": product(L, ff, d)}}
    embed = torch.randn((vp, d), generator=gen, dtype=torch.bfloat16,
                        device=device)
    return {"embed": embed, "blocks": (block,), "tail": (),
            "final_norm": scale(d), "unembed": product(d, vp)}


def layer_view(tree: dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's tensors by flat name (views into the stacked leaves)."""
    b = tree["blocks"][0]
    out = {"ln1": b["ln1"][i], "ln2": b["ln2"][i]}
    out.update({k: v[i] for k, v in b["attn"].items()})
    out.update({k: v[i] for k, v in b["mlp"].items()})
    return out
