"""The plain reference: a dense decoder as its published description has
it (Llama: Yi-9B; Qwen3: qk-norm), in float32 with TF32 off, one sequence
at a time, no cache, no kernels. It imports neither JAX nor the program.

Per layer, for hidden states h [S, d] at positions 0 .. S-1:
  x = RMSNorm(h) * w_ln1
  q, k, v = x Wq, x Wk, x Wv            (heads of head_dim; GQA)
  q, k = RMSNorm_head(q) * w_qn, RMSNorm_head(k) * w_kn   (qk-norm only)
  q, k = RoPE(q), RoPE(k)              (halves rotated, theta from the config)
  h = h + softmax(q k^T / sqrt(head_dim), causal) v Wo
  x = RMSNorm(h) * w_ln2
  h = h + (silu(x Wgate) * (x Wup)) Wdown
logits = (RMSNorm(h) * w_final) Wunembed, over the vocabulary.

Weights are handed over in the serving layout (bench/weights.py): the
products [fan_in, fan_out] bf16, an RMSNorm weight stored as its offset
from 1 (the published weight is 1 + the stored value). The reference
takes them as they are, in float32; `quant` (the control) rounds every
product and the embedding to float8 e4m3 first, one scale per output
column (per row of the embedding), and otherwise computes the same.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def full_f32():
    """float32 matrix products in float32: TF32 off for the duration."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """w [fan_in, fan_out] rounded to float8 e4m3 with one scale per
    column (absmax / 448), returned in float32."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=0, keepdim=True) / 448.0, 1e-12)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, hd] turned by its positions, the two halves of hd paired."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd // 2, dtype=torch.float64,
                                  device=x.device) * 2.0 / hd)
    ang = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


class Reference:
    """The model over one configuration (its published keys, a dict) and
    the weights tree; `layer(i)` gives layer i's tensors by flat name."""

    def __init__(self, cfg: dict, tree: dict,
                 layer: Callable[[int], Dict[str, torch.Tensor]],
                 quant: bool = False):
        self.cfg = cfg
        self.tree = tree
        self.layer = layer
        self.prep = fp8_columns if quant else (lambda w: w.float())
        self.L = cfg["num_hidden_layers"]
        self.hq = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.hd = int(cfg.get("head_dim") or cfg["derived"]["head_dim"])
        self.V = cfg["vocab_size"]
        self.eps = float(cfg.get("rms_norm_eps")
                         or cfg["assumed"]["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.qk_norm = bool(cfg.get("qk_norm",
                                    cfg.get("derived", {}).get("qk_norm")))

    def _attention(self, x, p, pos):
        S = x.shape[0]
        q = (x @ self.prep(p["wq"])).view(S, self.hq, self.hd)
        k = (x @ self.prep(p["wk"])).view(S, self.hkv, self.hd)
        v = (x @ self.prep(p["wv"])).view(S, self.hkv, self.hd)
        if self.qk_norm:
            q = rms(q, 1.0 + p["q_norm"].float(), self.eps)
            k = rms(k, 1.0 + p["k_norm"].float(), self.eps)
        q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
        g = self.hq // self.hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        out = torch.empty_like(q)
        # query rows in blocks, so the scores of a long sequence fit
        for a in range(0, S, 1024):
            b = min(S, a + 1024)
            s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) / math.sqrt(
                self.hd)
            causal = pos[a:b, None] >= pos[None, :b]
            s = s.masked_fill(~causal[None], float("-inf"))
            out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                    v[:b])
        return out.reshape(S, self.hq * self.hd) @ self.prep(p["wo"])

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, rows: Optional[slice] = None
               ) -> torch.Tensor:
        """float32 logits [len(rows), V] of the sequence `tokens` [S]
        (int64, on the weights' device) at the positions `rows`."""
        with full_f32():
            emb = self.tree["embed"]
            table = self.prep(emb.t()).t() if self.prep is fp8_columns \
                else None
            h = (table[tokens] if table is not None
                 else emb[tokens].float())
            del table
            pos = torch.arange(tokens.shape[0], device=tokens.device)
            for i in range(self.L):
                p = self.layer(i)
                x = rms(h, 1.0 + p["ln1"].float(), self.eps)
                h = h + self._attention(x, p, pos)
                x = rms(h, 1.0 + p["ln2"].float(), self.eps)
                gate = x @ self.prep(p["w_gate"])
                up = x @ self.prep(p["w_up"])
                h = h + (torch.nn.functional.silu(gate) * up) @ self.prep(
                    p["w_down"])
            h = h[rows] if rows is not None else h
            x = rms(h, 1.0 + self.tree["final_norm"].float(), self.eps)
            return (x @ self.prep(self.tree["unembed"]))[:, :self.V]
