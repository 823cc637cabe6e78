"""Core layers: RMSNorm, RoPE, GQA attention (prefill and decode), SwiGLU.

Port of the JAX package's models/layers.py, for serving. dtype
policy as there: parameters and activations bf16, norm and softmax
statistics f32. Elementwise bf16 expressions are written op by op as the
JAX code reads, so each op rounds to bf16 where the reference's does.

Batch invariance: a served row's tokens must not depend on which other
rows share its step (slot count, prefill lanes, the one-shot baseline's
batch). Dense row-wise work therefore runs on fixed ROW_TILE-row tiles
(models/model.py pads every step to a multiple of ROW_TILE rows and
`linear` multiplies one tile at a time), so the GEMM and reduction kernels
chosen for a row never change with the batch around it.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_decode import ops as pd_ops

ROW_TILE = 128


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.bfloat16) -> torch.Tensor:
    """The JAX package's dense_init: N(0, 1) * 1/sqrt(d_in) in f32, then
    `dtype` — drawn from a torch.Generator, so the values are not the JAX
    package's, but the shapes and scales are the same."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    # f64 pow rounded once to f32 reproduces the JAX package's f32 table
    i = torch.arange(head_dim // 2, dtype=torch.float64, device=device)
    return (theta ** (-2.0 * i / head_dim)).float()  # [hd/2]


def rope_cos_sin(positions, head_dim: int, theta: float):
    """cos/sin of the rotary angles, [..., S, 1, hd/2] for positions
    [..., S]: computed once per step, shared by every layer's q and k."""
    ang = positions[..., None].float() * rope_freqs(head_dim, theta,
                                                    positions.device)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rotate(x, cos, sin):
    """Apply rotary angles (rope_cos_sin) to x [..., S, H, hd]."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S] (int)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def linear(x, w):
    """x [..., K] @ w [K, N] in ROW_TILE-row tiles (batch invariance, see
    the module docstring). On the CPU the product is taken in f32 and
    rounded once to bf16, as XLA's CPU dot does for bf16 operands; on the
    GPU it is a bf16 GEMM with f32 accumulation."""
    lead = x.shape[:-1]
    if x.device.type == "cpu":
        mm = lambda t: (t.float() @ w.float()).to(x.dtype)
    else:
        mm = lambda t: t @ w
    tiles = [mm(t) for t in x.reshape(-1, x.shape[-1]).split(ROW_TILE)]
    y = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
    return y.reshape(*lead, w.shape[-1])


def linear_f32(x, w):
    """f32 x [..., K] @ f32 w [K, N] in ROW_TILE-row tiles (batch
    invariance, as `linear`). On the GPU in full f32: TF32 stays off
    (torch.backends.cuda.matmul.allow_tf32 is False by default)."""
    lead = x.shape[:-1]
    tiles = [t @ w for t in x.reshape(-1, x.shape[-1]).split(ROW_TILE)]
    y = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
    return y.reshape(*lead, w.shape[-1])


def sigmoid(x):
    """jax.nn.sigmoid as XLA expands it, 1 / (1 + exp(-x)), op by op in
    x's dtype (torch.sigmoid rounds once and differs in bf16)."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """jax.nn.silu: x * sigmoid(x), op by op in x's dtype."""
    return x * sigmoid(x)


def _project_qkv(p, x, cfg: ModelConfig):
    """Returns q [B,S,Hq,hd], k/v [B,S,Hkv,hd] (no rope yet). With
    cfg.qkv_bias the bf16 biases bq/bk/bv are added to the bf16 products,
    as the JAX package adds them (one more bf16 rounding). With
    cfg.qk_norm each head of q and of k goes through rms_norm with its
    f32 q_norm / k_norm [hd] scale, after the bias and before rope, where
    the JAX package puts it: the norm reads the bf16 projection and
    returns bf16."""
    hd = cfg.head_dim
    B, S = x.shape[0], x.shape[1]
    q, k, v = (linear(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k, v = (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
               v.reshape(B, S, -1, hd))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _group(q, hkv: int):
    """[B,S,Hq,hd] -> [B,Hkv,G,S,hd]."""
    B, S, Hq, hd = q.shape
    return q.reshape(B, S, hkv, Hq // hkv, hd).permute(0, 2, 3, 1, 4)


def _ungroup(o):
    """[B,Hkv,G,S,hd] -> [B,S,Hq*hd]."""
    B, Hkv, G, S, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G * hd)


def _mask_bias(Sq: int, Sk: int, causal: bool, window: int, device):
    """Additive f32 bias [Sq, Sk]: 0 where a query sees a key, -inf else."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, float("-inf"))


def _bf16_matmul(a, b):
    """bf16 a @ b rounded where the JAX package's einsum rounds: on the
    CPU the product is taken in f32 and rounded once to bf16 (XLA's CPU
    dot); on the GPU a bf16 GEMM with f32 accumulation."""
    if a.device.type == "cpu":
        return (a.float() @ b.float()).to(a.dtype)
    return a @ b


def attention_naive(q, k, v, cfg: ModelConfig, *, causal: bool,
                    window: int = 0):
    """Full-matrix attention, the JAX package's attention_naive with its
    own rounding: bf16 scores before the f32 scale, softmax in f32 rounded
    to bf16, bf16 P·V. q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq*hd].
    Classic prefill takes it for prompts of at most 128 tokens (the
    reference's dispatch); longer ones go through the flash kernel."""
    hkv = k.shape[2]
    qg = _group(q, hkv)  # [B,Hkv,G,Sq,hd]
    kk = k.transpose(1, 2)[:, :, None]  # [B,Hkv,1,Sk,hd]
    vv = v.transpose(1, 2)[:, :, None]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = _bf16_matmul(qg, kk.transpose(-1, -2)).float() * scale
    s = s + _mask_bias(q.shape[1], k.shape[1], causal, window, q.device)
    a = torch.softmax(s, dim=-1).to(v.dtype)
    return _ungroup(_bf16_matmul(a, vv))


def attention_paged_decode(q, k_pool, v_pool, tables, lengths,
                           cfg: ModelConfig):
    """Single-token attention over a block-paged KV pool.

    q: [B,1,Hq,hd]; k_pool/v_pool: [NB,Hkv,bs,hd]; tables: [B,MB] int32
    physical block ids (0 = null block); lengths: [B] int32 index of the
    last valid position. Softmax probabilities stay f32 up to the P·V
    product (the TPU kernel's semantics); the result is cast to the
    activation dtype. Returns [B,1,Hq*hd]."""
    B = q.shape[0]
    o = pd_ops.paged_flash_decode(q[:, 0].contiguous(), k_pool, v_pool,
                                  tables, lengths)
    return o.reshape(B, 1, -1).to(q.dtype)


def attention_paged_decode_quant(q, k_pool, v_pool, k_scale, v_scale, tables,
                                 lengths, cfg: ModelConfig):
    """attention_paged_decode over an int8 quant pool: k_pool/v_pool
    [NB,Hkv,bs,hd] int8, k_scale/v_scale [NB,Hkv,bs] f32. The op
    dequantizes in f32 (in registers on the card; the whole pool up front
    in the plain version the CPU runs) and keeps f32 probabilities; the
    result is cast back to the activation dtype, as the fp pool's read
    hands attention bf16. Returns [B,1,Hq*hd]."""
    B = q.shape[0]
    o = pd_ops.paged_flash_decode_quant(q[:, 0].contiguous(), k_pool, v_pool,
                                        k_scale, v_scale, tables, lengths)
    return o.reshape(B, 1, -1).to(q.dtype)


def attention_decode(q, k_cache, v_cache, cur_len, cfg: ModelConfig, *,
                     slots=None):
    """Single-token attention over a contiguous cache [N,Hkv,Smax,hd].

    cur_len: [B] int32 write position == last attended position per row.
    A contiguous cache is a block pool of N blocks of Smax tokens, so this
    is attention_paged_decode through a one-entry table per row: row b
    reads slot b (the identity table, N == B), or slots[b] when given
    (row -> slot indirection: verify rows share their slot, and rows may
    be fewer or more than the slots). Unlike the JAX package's
    attention_decode it keeps the probabilities in f32 (that one rounds
    them to bf16 before P·V), so the one-shot baseline and the paged
    engine compute the same function."""
    if slots is None:
        tables = torch.arange(q.shape[0], dtype=torch.int32,
                              device=q.device)[:, None]
    else:
        tables = slots.to(torch.int32)[:, None]
    return attention_paged_decode(q, k_cache, v_cache, tables,
                                  cur_len.to(torch.int32), cfg)


def mlp(p, x):
    # jax.nn.silu(g) * u, op by op in bf16: silu(g) = g * (1 / (1 + exp(-g)))
    h = silu(linear(x, p["w_gate"])) * linear(x, p["w_up"])
    return linear(h, p["w_down"])
