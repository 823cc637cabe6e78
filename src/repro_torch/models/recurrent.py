"""Recurrent layers: the Griffin RG-LRU block and RWKV-6 (Finch) time and
channel mix.

Port of the JAX package's models/recurrent.py for serving. Prefill closes
each recurrence over the whole prompt through a kernel: the RG-LRU's
h_t = a_t h_{t-1} + b_t through kernels/rglru (where the JAX model takes
an associative scan), the WKV6 state recurrence through kernels/rwkv6
(where it takes a chunked scan in jnp; the JAX package's Pallas kernels
compute the same functions). Decode takes one step of each recurrence in
plain tensor code, with the state carried in rows of the cache. Train
mode closes them as the JAX model does in training, in plain tensor code
under autograd: the associative scan (rglru_scan_assoc) and the chunked
WKV (rwkv_time_mix_chunked). The kernels have no backward, and the
reference's training computation calls no Pallas kernel either.

Prefill takes the row-padded activations of models/model.py (each prompt
padded to whole ROW_TILE-row tiles, see models/layers.py) and the real
prompt length S: the dense products run on every padded row, the
sequence ops (conv, scans, token shift) on the first S positions only,
and the post-prompt state is that of position S - 1. The f32 products of
the gates and of the decay LoRA run in ROW_TILE-row tiles too
(layers.linear_f32), so a row's state does not depend on its batch.

Rounding follows the JAX package on the CPU, where XLA rounds every bf16
elementwise op to bf16 (the conv's products and partial sums, the token
shift's lerp, gelu, gelu(gate) * h, relu(.)^2, sigmoid(.) * (.)): they
are written here op by op in bf16, with the reference's constants
rounded to bf16 first as JAX's weak types round them. One exception: a
bf16 op whose only consumer is an explicit cast to f32 keeps its f32
result unrounded (XLA drops the convert pair), which happens to the
conv's last sum (cast to f32 for the gates) and to the decay's lerp (cast
to f32 for the LoRA). tests/test_torch_recurrent.py holds each block to
the JAX one.

Per rank over a DeviceMesh (`ranks`, models/model.py _Ranks; the JAX
package's GSPMD layout, parallel/rules.py) each block takes its input
whole (gathered over tp under sequence parallelism: the conv and the
token shift read the whole sequence) and its weights as the rank's
shards. The RG-LRU's w_in, w_gate_in, conv_w and lam hold the rank's
channels and its block-diagonal gates whole blocks of them, so the scan
runs on w / tp channels; RWKV's w_r, w_k, w_v, w_g, decay_B, decay_base
and bonus_u hold the rank's heads, so the WKV runs on H / tp heads and
the group norm stays local; the channel mix's cm_k holds ff columns and
cm_v their rows, and cm_r's columns are gathered (its output multiplies
the summed cm_v product element by element). The row weights (w_out,
w_o, cm_v) give this rank's share of the output, summed over tp
(ranks.row). A sublayer whose channels or heads do not split evenly
over tp gets its weights whole (gathered by ranks.unshard) and computes
whole on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models import layers as L

# ---------------------------------------------------------------------------
# Griffin RG-LRU recurrent block
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_GATE_BLOCKS = 16  # block-diagonal recurrence gates (Griffin)


def gate_blocks(cfg: ModelConfig) -> int:
    """The blocks of the block-diagonal gates: _GATE_BLOCKS where they
    divide the width, else one."""
    return _GATE_BLOCKS if cfg.rglru_width % _GATE_BLOCKS == 0 else 1


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The JAX package's init_rglru_block shapes, dtypes and scales (drawn
    from a torch.Generator)."""
    d, w, cw = cfg.d_model, cfg.rglru_width, cfg.conv_width
    g = gate_blocks(cfg)
    bw = w // g
    dev = gen.device
    normal = lambda *s: torch.randn(s, generator=gen, dtype=torch.float32,
                                    device=dev)
    # Lambda init so a = exp(-c * softplus(L) * r) starts near 0.9..0.999
    uni = 0.9 + 0.099 * torch.rand((w,), generator=gen, dtype=torch.float32,
                                   device=dev)
    lam = torch.log(torch.expm1(-torch.log(uni) / _RGLRU_C))
    bg = lambda: (normal(g, bw, bw) / math.sqrt(bw)).to(torch.bfloat16)
    return {"w_in": L.dense_init(gen, d, w),
            "w_gate_in": L.dense_init(gen, d, w),
            "conv_w": (normal(cw, w) / math.sqrt(cw)).to(torch.bfloat16),
            "w_rgate": bg(),  # block-diagonal [G, w/G, w/G]
            "w_igate": bg(),
            "lam": lam,
            "w_out": L.dense_init(gen, w, d)}


def _block_diag_matmul(u, wb):
    """u [B,S,w] f32 x block-diagonal wb [G, w/G, w/G] f32 -> [B,S,w] f32
    (no cross-block terms), in ROW_TILE-row tiles."""
    B, S, w = u.shape
    g, bw, _ = wb.shape
    rows = u.reshape(-1, g, bw).transpose(0, 1)  # [G, N, bw]
    tiles = [torch.bmm(t, wb) for t in rows.split(L.ROW_TILE, dim=1)]
    y = tiles[0] if len(tiles) == 1 else torch.cat(tiles, dim=1)
    return y.transpose(0, 1).reshape(B, S, w)


def _causal_conv1d(x, conv_w, state=None):
    """Depthwise causal conv. x [B,S,w] bf16, conv_w [cw,w] bf16, state
    [B,cw-1,w] (decode) or None (zeros). The cw bf16 products are summed
    in the reference's order, in bf16, except the last sum, which the
    block only reads cast to f32 (see the module docstring). Returns
    (out [B,S,w] f32, the last cw-1 inputs)."""
    cw, S = conv_w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:S] * conv_w[0]
    for i in range(1, cw - 1):
        out = out + xp[:, i:i + S] * conv_w[i]
    last = (xp[:, cw - 1:cw - 1 + S] * conv_w[cw - 1]).float()
    out = last if cw == 1 else out.float() + last
    new_state = xp[:, -(cw - 1):] if cw > 1 else None
    return out, new_state


def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _const(v: float, like):
    """A Python constant as JAX's weak typing applies it: rounded to the
    operand's dtype first."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def gelu_tanh(x):
    """jax.nn.gelu's default, the tanh approximation
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))), op by op in x's
    dtype as JAX writes it."""
    c = _const(math.sqrt(2 / math.pi), x)
    inner = c * (x + _const(0.044715, x) * (x * x * x))
    cdf = _const(0.5, x) * (_const(1.0, x) + torch.tanh(inner))
    return x * cdf


def _rglru_gates(p, u):
    """u [B,S,w] f32 -> (a, b) with h_t = a_t h_{t-1} + b_t."""
    r = L.sigmoid(_block_diag_matmul(u, p["w_rgate"].float()))
    i = L.sigmoid(_block_diag_matmul(u, p["w_igate"].float()))
    log_a = -_RGLRU_C * softplus(p["lam"]) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, mult * (i * u)


def _interleave(x, y):
    """x at the even and y at the odd positions of axis 1 (len(x) is
    len(y) or len(y) + 1)."""
    n = y.shape[1]
    out = torch.stack([x[:, :n], y], dim=2).flatten(1, 2)
    return torch.cat([out, x[:, n:]], dim=1) if x.shape[1] > n else out


def rglru_scan_assoc(a, b):
    """h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1 of a, b [B,S,w]
    f32, as the JAX package's model closes it in training and prefill:
    jax.lax.associative_scan's odd/even recursion (pairs combined, the
    odd positions scanned recursively, the even ones filled in from
    them), with the same combine (a1 a2, a2 b1 + b2) in the same order,
    so each h_t is summed as the reference sums it. Plain tensor code
    under autograd (the kernel, kernels/rglru, has no backward). Returns
    h [B,S,w]."""
    def combine(x, y):  # x holds the earlier positions
        return x[0] * y[0], y[0] * x[1] + y[1]

    def scan(e):
        n = e[0].shape[1]
        if n < 2:
            return e
        odd = scan(combine([t[:, 0:-1:2] for t in e],
                           [t[:, 1::2] for t in e]))
        rest = [t[:, 2::2] for t in e]
        even = combine(odd if n % 2 else [t[:, :-1] for t in odd], rest)
        even = [torch.cat([t[:, :1], r], dim=1) for t, r in zip(e, even)]
        return [_interleave(x, y) for x, y in zip(even, odd)]

    return scan([a, b])[1]


def rglru_block(p, x, cfg: ModelConfig, state=None, *, S=None,
                return_state: bool = False, train: bool = False,
                ranks=None):
    """Griffin recurrent block. x [B,Sp,d] bf16 -> (y [B,Sp,d] bf16,
    new_state).

    Prefill (state None): S real positions of the row-padded x (default
    all); with return_state, the post-prompt state {"h": [B,w] f32,
    "conv": [B,cw-1,w] bf16}. Decode (state given, Sp == 1): one step from
    state; returns the next state (every row of x: the caller keeps the
    rows it owns). train: prefill's computation with the recurrence
    closed by rglru_scan_assoc, the reference's training form, in place
    of the kernel. ranks: this rank's channels (see the module
    docstring); the state holds them too."""
    if ranks is not None:
        x = ranks.enter(x)
    Sp = x.shape[1]
    S = Sp if S is None else S
    gate = gelu_tanh(L.linear(x, p["w_gate_in"]))
    u_pre = L.linear(x, p["w_in"])
    cw = p["conv_w"].shape[0]
    if state is None:
        u, _ = _causal_conv1d(u_pre[:, :S], p["conv_w"])
        # the gates' f32 products run on whole row tiles of this sequence
        a, b = _rglru_gates(p, F.pad(u, (0, 0, 0, Sp - S)))
        scan = rglru_scan_assoc if train else rglru_scan
        h = scan(a[:, :S].contiguous(), b[:, :S].contiguous())
        new_state = None
        if return_state:
            tail = u_pre[:, max(S - (cw - 1), 0):S]
            if tail.shape[1] < cw - 1:  # prompt shorter than the conv window
                tail = F.pad(tail, (0, 0, cw - 1 - tail.shape[1], 0))
            new_state = {"h": h[:, -1], "conv": tail}
        h = F.pad(h, (0, 0, 0, Sp - S))
    else:
        u, new_conv = _causal_conv1d(u_pre, p["conv_w"], state["conv"])
        a, b = _rglru_gates(p, u)
        h = a * state["h"][:, None, :] + b  # S == 1
        new_state = {"h": h[:, -1], "conv": new_conv}
    y = gate * h.to(gate.dtype)
    if ranks is not None:
        w = p["w_out"]
        return ranks.row(y, w, w.shape[0] != cfg.rglru_width), new_state
    return L.linear(y, p["w_out"]), new_state


def rglru_init_state(cfg: ModelConfig, batch: int, device,
                     width: int = None) -> dict:
    """Zero state rows: width channels (default all; a rank's share over
    a mesh)."""
    w, cw = width or cfg.rglru_width, cfg.conv_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cw - 1, w), dtype=torch.bfloat16,
                                device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch)
# ---------------------------------------------------------------------------

_DECAY_LORA = 64


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The JAX package's init_rwkv_block shapes, dtypes and scales (drawn
    from a torch.Generator)."""
    d, H, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    assert H * hd == d
    dev = gen.device
    normal = lambda *s: torch.randn(s, generator=gen, dtype=torch.float32,
                                    device=dev)
    f32 = torch.float32
    return {
        # time mix
        "mu": torch.full((5, d), 0.5, dtype=f32, device=dev),  # r,k,v,g,w
        "w_r": L.dense_init(gen, d, d),
        "w_k": L.dense_init(gen, d, d),
        "w_v": L.dense_init(gen, d, d),
        "w_g": L.dense_init(gen, d, d),
        "w_o": L.dense_init(gen, d, d),
        "decay_base": -6.0 + normal(d) * 0.3,
        "decay_A": L.dense_init(gen, d, _DECAY_LORA, dtype=f32),
        "decay_B": L.dense_init(gen, _DECAY_LORA, d, dtype=f32),
        "bonus_u": normal(H, hd) * 0.3,
        "ln_x": torch.ones((d,), dtype=f32, device=dev),  # group-norm scale
        # channel mix
        "cmu": torch.full((2, d), 0.5, dtype=f32, device=dev),
        "cm_k": L.dense_init(gen, d, ff),
        "cm_v": L.dense_init(gen, ff, d),
        "cm_r": L.dense_init(gen, d, d),
    }


def _token_shift(x, prev=None):
    """x_{t-1}, with x_{-1} = prev (decode) or 0 (prefill)."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _lerp(x, xs, mu, *, f32_out: bool = False):
    """x + (xs - x) * mu, op by op in x's dtype (mu cast to it); with
    f32_out the last sum is taken in f32 and not rounded (its only
    consumer casts it to f32, see the module docstring)."""
    t = (xs - x) * mu.to(x.dtype)
    return x.float() + t.float() if f32_out else x + t


def rwkv_decay(p, xw):
    """Data-dependent decay (the Finch contribution) from the f32 lerp xw:
    log w_t [B,S,d] f32, <= 0."""
    lora = L.linear_f32(torch.tanh(L.linear_f32(xw, p["decay_A"])),
                        p["decay_B"])
    return -torch.exp(torch.clamp(p["decay_base"] + lora, -20.0, 8.0))


def _group_norm_heads(x, scale, H: int, eps: float = 1e-5):
    """x [B,S,H,hd] normalised per head (population variance, as
    jnp.var) in f32, scaled, in x's dtype: [B,S,H*hd]."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    B, S = x.shape[0], x.shape[1]
    return (y.reshape(B, S, -1) * scale).to(x.dtype)


def _clip(x, lo: float, hi: float):
    """jnp.clip as the JAX package differentiates it: minimum(maximum(x,
    lo), hi), whose gradient is halved where x ties a bound (torch.clamp
    passes all of it). In the chunked WKV a tie is the rule: the
    pairwise decay of each step's predecessor is exp(0)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def rwkv_time_mix_chunked(r, k, v, logw, u, chunk: int = 64):
    """The WKV6 recurrence over whole chunks, from a zero state: the JAX
    package's rwkv_time_mix_chunked, its model's training form, as plain
    tensor code under autograd (the kernel, kernels/rwkv6, has no
    backward). r, k, v [B,S,H,hd] bf16; logw [B,S,H,hd] f32 (<= 0); u
    [H,hd] f32. Returns (o [B,S,H,hd] bf16, s_final [B,H,hd,hd] f32).

    Within a chunk the pairwise decay D[t,s,c] = exp(clip(L_{t-1,c} -
    L_{s,c})) is formed explicitly, [B,chunk,chunk,H,hd] f32 per chunk;
    the carried state enters through exp(L_{t-1}). This drifts from the
    step-exact recurrence at strong decays, as the reference does (its
    f32 cumulative sums), and like the reference it takes only whole
    chunks of min(chunk, S) steps."""
    B, S, H, hd = r.shape
    chunk = min(chunk, S)
    if S % chunk:  # the reference asserts the same
        raise ValueError(f"chunked WKV6: S {S} not whole chunks of {chunk}")
    n = S // chunk
    rf, kf, vf = (t.float().reshape(B, n, chunk, H, hd) for t in (r, k, v))
    lw = logw.reshape(B, n, chunk, H, hd)
    t_idx = torch.arange(chunk, device=r.device)
    strict = (t_idx[:, None] > t_idx[None, :]).float()  # [t,s]
    st = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(n):
        rc, kc, vc, lc = rf[:, c], kf[:, c], vf[:, c], lw[:, c]
        Lc = torch.cumsum(lc, dim=1)  # L_t = sum_{u<=t} log w_u
        Lprev = Lc - lc  # L_{t-1}
        D = torch.exp(_clip(Lprev[:, :, None] - Lc[:, None], -60.0, 0.0))
        A = torch.einsum("bthc,bshc,btshc->bhts", rc, kc, D)
        A = A * strict[None, None]
        Au = torch.einsum("bthc,bthc->bth", rc, u[None, None] * kc)
        o = torch.einsum("bhts,bshc->bthc", A, vc)
        o = o + Au[..., None] * vc  # the diagonal (bonus u) term
        rP = rc * torch.exp(_clip(Lprev, -60.0, 0.0))
        o = o + torch.einsum("bthc,bhcd->bthd", rP, st)
        LT = Lc[:, -1]  # [B,H,hd]
        kT = kc * torch.exp(_clip(LT[:, None] - Lc, -60.0, 0.0))
        st = (torch.exp(_clip(LT, -60.0, 0.0))[..., None] * st
              + torch.einsum("bshc,bshd->bhcd", kT, vc))
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return o.to(r.dtype), st


def rwkv_time_mix_step(r, k, v, logw, u, s):
    """One decode step. r, k, v: [B,1,H,hd] bf16; logw [B,1,H,hd] f32; u
    [H,hd] f32; s [B,H,hd,hd] f32. Returns (o [B,1,H,hd] bf16, s_new).

    Row by row: elementwise ops and the readout r^T att as a product and
    a sum over its own row (no batched GEMM, whose kernel could change with
    B), so the step runs on the real rows alone and a row's bits do not
    depend on its batch."""
    rf, kf, vf = (t.float()[:, 0] for t in (r, k, v))
    w = torch.exp(logw.float()[:, 0])  # [B,H,hd]
    att = s + (u[None] * kf)[..., :, None] * vf[..., None, :]
    o = (rf[..., :, None] * att).sum(dim=-2)
    s_new = w[..., :, None] * s + kf[..., :, None] * vf[..., None, :]
    return o[:, None].to(r.dtype), s_new


def rwkv_time_mix(p, x, cfg: ModelConfig, state=None, *, S=None,
                  return_state: bool = False, chunk: int = 0, ranks=None):
    """x [B,Sp,d] bf16 -> (y [B,Sp,d] bf16, {"s", "tm_prev"} or None).

    Prefill (state None): the WKV recurrence over the first S positions
    through the kernel, from a zero state; with return_state, the final
    state and position S - 1's input. Decode (state given): one step.
    chunk > 0 (train mode): prefill's computation with the recurrence in
    rwkv_time_mix_chunked's chunks of `chunk` steps, the reference's
    training form, in place of the kernel. ranks: this rank's heads (see
    the module docstring); the state "s" holds them too, "tm_prev" the
    whole input."""
    if ranks is not None:
        x = ranks.enter(x)
    B, Sp, d = x.shape
    S = Sp if S is None else S
    hd = cfg.head_dim
    prev = None if state is None else state["tm_prev"]
    xs = _token_shift(x, prev)
    xr, xk, xv, xg = (_lerp(x, xs, p["mu"][i]) for i in range(4))
    xw = _lerp(x, xs, p["mu"][4], f32_out=True)
    r = L.linear(xr, p["w_r"]).reshape(B, Sp, -1, hd)
    H = r.shape[2]  # the rank's heads over a mesh
    k = L.linear(xk, p["w_k"]).reshape(B, Sp, H, hd)
    v = L.linear(xv, p["w_v"]).reshape(B, Sp, H, hd)
    g = L.silu(L.linear(xg, p["w_g"]))
    logw = rwkv_decay(p, xw).reshape(B, Sp, H, hd)
    if state is None:
        wkv = (lambda *a: rwkv_time_mix_chunked(*a, chunk=chunk)) \
            if chunk else wkv6
        o, s_fin = wkv(*(t[:, :S].contiguous() for t in (r, k, v, logw)),
                       p["bonus_u"])
        o = F.pad(o.to(torch.bfloat16), (0, 0, 0, 0, 0, Sp - S))
        new_state = ({"s": s_fin, "tm_prev": x[:, S - 1]}
                     if return_state else None)
    else:
        n = state["s"].shape[0]  # the real rows: the rest pad the GEMMs
        o, s_fin = rwkv_time_mix_step(r[:n], k[:n], v[:n], logw[:n],
                                      p["bonus_u"], state["s"])
        o = F.pad(o, (0, 0, 0, 0, 0, 0, 0, B - n))
        new_state = {"s": s_fin, "tm_prev": x[:, -1]}
    split = H * hd != d
    scale = ranks.local(p["ln_x"], 0) if split else p["ln_x"]
    o = _group_norm_heads(o, scale, H)
    y = o * g.to(o.dtype)
    if ranks is not None:
        return ranks.row(y, p["w_o"], split), new_state
    return L.linear(y, p["w_o"]), new_state


def rwkv_channel_mix(p, x, cfg: ModelConfig, state=None, *, S=None,
                     return_state: bool = False, ranks=None):
    """x [B,Sp,d] bf16 -> (y [B,Sp,d] bf16, the next cm_prev [B,d] or
    None): position S - 1's input in prefill, the step's in decode.
    ranks: this rank's ff columns (see the module docstring)."""
    if ranks is not None:
        x = ranks.enter(x)
    S = x.shape[1] if S is None else S
    prev = None if state is None else state["cm_prev"]
    xs = _token_shift(x, prev)
    xk = _lerp(x, xs, p["cmu"][0])
    xr = _lerp(x, xs, p["cmu"][1])
    kk = torch.square(torch.relu(L.linear(xk, p["cm_k"])))
    rr = L.sigmoid(L.linear(xr, p["cm_r"]))
    if ranks is None:
        hv = L.linear(kk, p["cm_v"])
    else:
        hv = ranks.row(kk, p["cm_v"], p["cm_v"].shape[0] != cfg.d_ff)
        if rr.shape[-1] != x.shape[-1]:  # cm_r's columns: the whole rr
            rr = ranks.gather(rr, -1)
        rr = ranks.positions(rr)  # the rank's positions, as hv's
    y = rr * hv
    new = x[:, S - 1] if (state is not None or return_state) else None
    return y, new


def rwkv_init_state(cfg: ModelConfig, batch: int, device,
                    heads: int = None) -> dict:
    """Zero state rows: the WKV state of `heads` heads (default all; a
    rank's share over a mesh), the token shifts' whole inputs."""
    H, hd, d = heads or cfg.n_heads, cfg.head_dim, cfg.d_model
    return {"s": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "tm_prev": torch.zeros((batch, d), dtype=torch.bfloat16,
                                   device=device),
            "cm_prev": torch.zeros((batch, d), dtype=torch.bfloat16,
                                   device=device)}
