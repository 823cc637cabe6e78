"""Core layers: RMSNorm, RoPE, GQA attention (prefill, decode and the
training plan's chunked forms), SwiGLU.

Port of the JAX package's models/layers.py. dtype
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


def mrope_cos_sin(positions, head_dim: int, theta: float, sections):
    """cos/sin of Qwen2-VL's multimodal rotary angles, [..., S, 1, hd/2]
    for positions [..., S, 3] (temporal, h, w): the hd/2 rotary pairs are
    split into `sections` (sum hd/2), each turned by its own component of
    the position, the angles taken in f32 as the JAX package's
    apply_mrope takes them."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {head_dim // 2}")
    freqs = rope_freqs(head_dim, theta, positions.device)
    parts, off = [], 0
    for c, sec in enumerate(sections):
        parts.append(positions[..., c:c + 1].float() * freqs[off:off + sec])
        off += sec
    ang = torch.cat(parts, dim=-1)
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_mrope(x, positions, theta: float, sections):
    """Qwen2-VL multimodal RoPE (the JAX package's apply_mrope): x
    [..., S, H, hd], positions [..., S, 3]; rotated in f32, rounded back
    to x's dtype."""
    return rotate(x, *mrope_cos_sin(positions, x.shape[-1], theta, sections))


def _tiled_linear(x, w):
    lead = x.shape[:-1]
    tiles = [_bf16_matmul(t, w)
             for t in x.reshape(-1, x.shape[-1]).split(ROW_TILE)]
    y = tiles[0] if len(tiles) == 1 else torch.cat(tiles)
    return y.reshape(*lead, w.shape[-1])


class _Linear(torch.autograd.Function):
    """`linear` under autograd: the forward in row tiles, the backward as
    the JAX package's transposed dots, each one product over every row
    rounded once (dx = g w^T, dw = x^T g). Autograd through the tiles
    would round each tile's share of dw to bf16 and sum the shares in
    bf16."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _tiled_linear(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = _bf16_matmul(g2, w.t()).reshape(x.shape)
        dw = _bf16_matmul(x.reshape(-1, x.shape[-1]).t(), g2)
        return dx, dw


def linear(x, w):
    """x [..., K] @ w [K, N] in ROW_TILE-row tiles (batch invariance, see
    the module docstring). On the CPU the product is taken in f32 and
    rounded once to bf16, as XLA's CPU dot does for bf16 operands; on the
    GPU it is a bf16 GEMM with f32 accumulation. Differentiable
    (_Linear) when autograd records either operand."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Linear.apply(x, w)
    return _tiled_linear(x, w)


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


def _project(p, x, cfg: ModelConfig, w: str):
    """One of the q / k / v projections ("q", "k" or "v") of x [B,S,d]:
    [B,S,H,hd], with its bias and (q, k) its qk-norm, as _project_qkv."""
    y = linear(x, p["w" + w])
    if cfg.qkv_bias:
        y = y + p["b" + w]
    y = y.reshape(x.shape[0], x.shape[1], -1, cfg.head_dim)
    if cfg.qk_norm and w != "v":
        y = rms_norm(y, p[w + "_norm"], cfg.norm_eps)
    return y


def _project_qkv(p, x, cfg: ModelConfig, x_kv=None):
    """Returns q [B,S,Hq,hd] from x, k/v [B,Skv,Hkv,hd] from x_kv (x when
    None: self-attention; an encoder's output for cross-attention), no
    rope yet. With cfg.qkv_bias the bf16 biases bq/bk/bv are added to the
    bf16 products, as the JAX package adds them (one more bf16
    rounding). With cfg.qk_norm each head of q and of k goes through
    rms_norm with its f32 q_norm / k_norm [hd] scale, after the bias and
    before rope, where the JAX package puts it: the norm reads the bf16
    projection and returns bf16."""
    src = x if x_kv is None else x_kv
    return (_project(p, x, cfg, "q"), _project(p, src, cfg, "k"),
            _project(p, src, cfg, "v"))


def _group(q, hkv: int):
    """[B,S,Hq,hd] -> [B,Hkv,G,S,hd]."""
    B, S, Hq, hd = q.shape
    return q.reshape(B, S, hkv, Hq // hkv, hd).permute(0, 2, 3, 1, 4)


def _ungroup(o):
    """[B,Hkv,G,S,hd] -> [B,S,Hq*hd]."""
    B, Hkv, G, S, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, Hkv * G * hd)


def _bias(qpos, kpos, causal: bool, window: int):
    """Additive f32 bias [Sq, Sk] for query positions qpos [Sq] and key
    positions kpos [Sk]: 0 where a query sees a key, -inf else."""
    qpos, kpos = qpos[:, None], kpos[None, :]
    ok = torch.ones((qpos.shape[0], kpos.shape[1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    zero = torch.zeros((), dtype=torch.float32, device=qpos.device)
    return torch.where(ok, zero, float("-inf"))


def _mask_bias(Sq: int, Sk: int, causal: bool, window: int, device):
    """Additive f32 bias [Sq, Sk] over positions 0..Sq-1 and 0..Sk-1."""
    return _bias(torch.arange(Sq, device=device),
                 torch.arange(Sk, device=device), causal, window)


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


def attention_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                      window: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024):
    """Online-softmax attention over q chunks (outer) and kv chunks
    (inner), carrying (m, l, acc): the JAX package's attention_chunked,
    its training plan's ("xla_chunked") attention, written as plain
    tensor code under autograd with the reference's rounding (bf16
    scores before the f32 scale, f32 probabilities rounded to bf16 for a
    bf16 P.V, f32 accumulators). Masked blocks are computed, as there.
    q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] -> [B,Sq,Hq*hd]."""
    B, Sq, Hq, hd = q.shape
    Sk, hkv = k.shape[1], k.shape[2]
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Sk)
    if Sq % q_chunk or Sk % kv_chunk:  # the reference asserts the same
        raise ValueError(f"attention_chunked: Sq {Sq} / Sk {Sk} not whole "
                         f"chunks of {q_chunk} / {kv_chunk}")
    scale = 1.0 / math.sqrt(hd)
    qg = _group(q, hkv)  # [B,Hkv,G,Sq,hd]
    kk = k.transpose(1, 2)[:, :, None]  # [B,Hkv,1,Sk,hd]
    vv = v.transpose(1, 2)[:, :, None]
    G, dev = qg.shape[2], q.device
    inf = torch.full((), float("-inf"), device=dev)
    outs = []
    for i in range(Sq // q_chunk):
        qpos = torch.arange(i * q_chunk, (i + 1) * q_chunk, device=dev)
        qc = qg[:, :, :, i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, hkv, G, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, hkv, G, q_chunk), device=dev)
        acc = torch.zeros((B, hkv, G, q_chunk, hd), device=dev)
        for j in range(Sk // kv_chunk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            kpos = torch.arange(ks.start, ks.stop, device=dev)
            s = _bf16_matmul(qc, kk[:, :, :, ks].transpose(-1, -2)).float()
            s = s * scale + _bias(qpos, kpos, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully masked rows so far: m_new is -inf
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe, inf))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _bf16_matmul(
                p.to(v.dtype), vv[:, :, :, ks]).float()
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    return _ungroup(torch.cat(outs, dim=3))


def attention_window_prefill(q, k, v, cfg: ModelConfig, *, window: int,
                             q_chunk: int = 1024):
    """Sliding-window causal attention, each q chunk over the
    (q_chunk + window)-key span that can reach it: the JAX package's
    attention_window_prefill (its training plan's window attention),
    with attention_naive's rounding over each span. Keys left of
    position 0 are padding and masked. q [B,S,Hq,hd], k/v [B,S,Hkv,hd]
    -> [B,S,Hq*hd]."""
    B, Sq, Hq, hd = q.shape
    hkv = k.shape[2]
    q_chunk = min(q_chunk, Sq)
    if Sq % q_chunk or k.shape[1] != Sq:  # the reference asserts the same
        raise ValueError(f"attention_window_prefill: Sq {Sq} not whole "
                         f"chunks of {q_chunk}, or Sk {k.shape[1]} != Sq")
    span = q_chunk + window
    scale = 1.0 / math.sqrt(hd)
    qg = _group(q, hkv)
    # keys padded on the left by `window`: every span is in bounds
    kk = torch.nn.functional.pad(k.transpose(1, 2), (0, 0, window, 0))
    vv = torch.nn.functional.pad(v.transpose(1, 2), (0, 0, window, 0))
    dev = q.device
    outs = []
    for i in range(Sq // q_chunk):
        t0 = i * q_chunk
        qc = qg[:, :, :, t0:t0 + q_chunk]
        kc = kk[:, :, None, t0:t0 + span]
        vc = vv[:, :, None, t0:t0 + span]
        qpos = t0 + torch.arange(q_chunk, device=dev)
        kpos = t0 - window + torch.arange(span, device=dev)
        bias = _bias(qpos, kpos, True, window)
        bias = torch.where((kpos < 0)[None, :], float("-inf"), bias)
        s = _bf16_matmul(qc, kc.transpose(-1, -2)).float() * scale + bias
        a = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(_bf16_matmul(a, vc))
    return _ungroup(torch.cat(outs, dim=3))


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
