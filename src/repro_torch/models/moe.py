"""Mixture-of-Experts layer: sort-based, capacity-clipped dispatch.

Port of the JAX package's models/moe.py: the router picks top_k experts
per token, tokens are sorted by expert (stably, so a token's rank within
its expert is its order in the dispatch), every expert takes at most
`capacity` of them and the overflow is dropped (it passes through the
residual), the kept tokens run their expert's SwiGLU and come back
gate-weighted.

Over a DeviceMesh each rank dispatches its own tokens (the JAX package's
shard_map body, per rank) in one of two modes (plan.resolve_moe):
  "ep": experts sharded over the tp axis; the rank's tokens are its
        batch rows and, where S divides, its S / tp positions; an
        all_to_all carries each expert's slots to the rank that holds it
        and back ([E, cap, d] -> [E/tp, tp*cap, d] -> [E, cap, d]);
  "tp": every expert's ff columns sharded over the tp axis; the tp ranks
        dispatch the same tokens and sum the down projection's shares.
The capacity is the local dispatch's, as in the reference. An engine's
step (whole_rows: every rank holds every row, models/model.py _Ranks)
takes the rows the reference's shard_map gives a rank: its dp chunk
where the rows divide over dp, every row otherwise; the chunks' outputs
are gathered back over dp. The aux loss
is the mean of the ranks' own (the reference returns device 0's:
ROADMAP.md section 3).

Which tokens one dispatch holds decides the capacity and every drop, so
the caller hands moe_layer exactly the tokens the JAX package dispatches,
in its order: a decode step's real rows (masked rows included, padding
rows not), a prefill's real positions flattened as b * S + s
(models/model.py). The layer is not batch-invariant, in the JAX package
either: a token's output depends on the tokens it shares a dispatch with.

Determinism on the card: the sorts are stable, the top-k is a stable
descending sort (tied gates keep the lower expert first, as lax.top_k
does), the combine gathers each token's rows and sums them in sorted
order (no atomic scatter-add), and the router's f32 product runs in full
f32 (TF32 stays off, torch's default).

The expert products are plain batched matrix products, outside any TPU
kernel in the reference: torch.matmul, rounded where the JAX package's
CPU einsum rounds (layers._bf16_matmul).
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import functools
import types

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.env import Env
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules

# per-call dispatch records while a `dispatch_stats()` block is open
_STATS: Optional[List[dict]] = None


@contextlib.contextmanager
def dispatch_stats():
    """Collect one {"tokens", "capacity", "dropped"} record per moe_layer
    call (so per MoE layer, in layer order) while the block is open:
    the tokens dispatched, the slots an expert takes, and the (token,
    expert) assignments past them. The drop counts are read from the
    device when the block closes. Off by default: nothing is recorded or
    synchronised outside such a block."""
    global _STATS
    prev, _STATS = _STATS, []
    records = _STATS
    try:
        yield records
    finally:
        _STATS = prev
        for r in records:
            r["dropped"] = int(r["dropped"])


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """f32 router [d,E]; bf16 w_gate / w_up [E,d,ff] and w_down [E,ff,d],
    each expert drawn with dense_init (the JAX package's shapes and
    scales, torch's generator)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    router = L.dense_init(gen, d, E, dtype=torch.float32)

    def experts(d_in, d_out):
        w = torch.empty((E, d_in, d_out), dtype=torch.bfloat16,
                        device=gen.device)
        for e in range(E):
            w[e] = L.dense_init(gen, d_in, d_out)
        return w

    return {"router": router, "w_gate": experts(d, ff),
            "w_up": experts(d, ff), "w_down": experts(ff, d)}


def _capacity(n_tokens: int, E: int, k: int, cf: float) -> int:
    if n_tokens * k <= E:  # decode-scale dispatch: dropless worst case
        return n_tokens * k
    c = int(n_tokens * k * cf / E) + 1
    return max(8, -(-c // 8) * 8)  # multiple of 8, >= 8


def _top_k(gates, k: int):
    """lax.top_k over the last axis: values descending, a tie keeps the
    lower index first (a stable descending sort; E is small)."""
    val, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return val[:, :k], idx[:, :k]


def _route(x_flat, router_w, E: int, k: int):
    """Returns (e_sorted, tok_sorted, gate_sorted, rank, order, aux_loss):
    the n*k (token, expert) assignments sorted stably by expert, each one's
    rank within its expert, the sort permutation, and the Switch
    load-balance loss E * sum(frac_tokens * frac_prob) (for training)."""
    n = x_flat.shape[0]
    logits = L.linear_f32(x_flat.float(), router_w)  # [N,E] f32
    gates = torch.softmax(logits, dim=-1)
    gval, gidx = _top_k(gates, k)  # [N,k]
    gval = gval / torch.clamp_min(gval.sum(-1, keepdim=True), 1e-9)
    e_flat = gidx.reshape(-1)
    g_flat = gval.reshape(-1)
    tok_flat = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    order = torch.sort(e_flat, stable=True).indices
    e_s, tok_s, g_s = e_flat[order], tok_flat[order], g_flat[order]
    # per-expert counts without bincount, whose CUDA form syncs the host
    experts = torch.arange(E, device=e_flat.device)
    counts = (e_flat[:, None] == experts).sum(0)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n * k, device=x_flat.device) - starts[e_s]
    frac_tok = counts.float() / (n * k)
    frac_prob = gates.mean(dim=0)
    aux = E * torch.sum(frac_tok * frac_prob)
    return e_s, tok_s, g_s, rank, order, aux


def _dispatch(x_flat, router_w, E: int, k: int, capacity: int):
    """Capacity-clipped scatter of the sorted assignments into [E*C, d]
    (expert e's slots at e*C ... e*C + C-1; a dropped assignment lands in
    a trash row past them). Returns (buf, meta, aux)."""
    e_s, tok_s, g_s, rank, order, aux = _route(x_flat, router_w, E, k)
    keep = rank < capacity
    dest = torch.where(keep, e_s * capacity + rank, E * capacity)
    vals = x_flat[tok_s] * keep[:, None].to(x_flat.dtype)
    buf = x_flat.new_zeros((E * capacity + 1, x_flat.shape[1]))
    buf[dest] = vals  # kept destinations are distinct
    return buf[:E * capacity], (tok_s, g_s, dest, keep, order), aux


def _combine(expert_out, meta, n_tokens: int, k: int):
    """expert_out [E*C, d] -> y [N, d]: each token's k gate-weighted rows
    (zero where dropped), summed from zero in sorted (expert) order, as the
    JAX package's scatter-add applies them, as a gather: no atomics."""
    tok_s, g_s, dest, keep, order = meta
    padded = torch.cat([expert_out, expert_out.new_zeros(
        (1, expert_out.shape[1]))])
    rows = padded[dest] * (g_s * keep).to(expert_out.dtype)[:, None]
    # sorted position of assignment (t, j), then each token's in order
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    pos = torch.sort(pos.view(n_tokens, k), dim=1).values
    y = expert_out.new_zeros((n_tokens, expert_out.shape[1]))
    for j in range(k):
        y = y + rows[pos[:, j]]
    return y


def _expert_ffn(buf, wg, wu, wd):
    """buf [E,C,d]; weights [E,d,ff] / [E,ff,d]: SiLU(x Wg) * (x Wu) Wd
    per expert, op by op in bf16."""
    h = L.silu(L._bf16_matmul(buf, wg)) * L._bf16_matmul(buf, wu)
    return L._bf16_matmul(h, wd)


@functools.lru_cache(maxsize=8)
def _expert_specs(cfg: ModelConfig, env: Env) -> dict:
    """The specs of the stored expert weights over env.mesh (the JAX
    package's moe_param_specs, from parallel/rules.py)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    # the rules read a leaf's shape alone: no tensor is made (a step
    # that first calls this allocates nothing for it)
    leaf = lambda *shape: types.SimpleNamespace(shape=shape)
    struct = {"moe": {"w_gate": leaf(E, d, ff), "w_up": leaf(E, d, ff),
                      "w_down": leaf(E, ff, d)}}
    return rules.param_specs(struct, cfg, env)["moe"]


def _gather_fsdp(p, cfg: ModelConfig, env: Env) -> dict:
    """The expert weights with their FSDP-sharded dims all-gathered over
    the dp axes (their ep / tp split kept)."""
    out = dict(p)
    for name, spec in _expert_specs(cfg, env).items():
        for dim, e in enumerate(spec):
            axes = tuple(a for a in rules.axes_of(e) if a in env.dp_axes)
            if axes:
                out[name] = C.gather(out[name], env, axes, dim)
    return out


def moe_layer(p, x, cfg: ModelConfig, env: Env = None, *,
              seq_sharded: bool = False, whole_rows: bool = False):
    """x: [B, S, d], every token of it dispatched. Returns (y, aux_loss).

    Over a DeviceMesh (env.mesh): p is this rank's shards of the layer's
    weights (parallel/rules.py) and x its batch rows, [B/dp, S, d] with
    every position, or [B/dp, S/tp, d], its positions, with seq_sharded
    (the sharded forward's sequence-parallel residual); y comes back in
    x's layout, and aux is the mean over the mesh's ranks of each one's
    own dispatch's. whole_rows: x is every row on every rank (an
    engine's step), dispatched by dp chunks where B divides over dp."""
    if env is not None and env.mesh is not None:
        dpx = env.dpx if whole_rows and env.dp > 1 and \
            x.shape[0] % env.dp == 0 else ()
        for axis in dpx:  # major first, as gather undoes it
            x = C.split(x, env, axis, 0)
        y, aux = _moe_ranks(p, x, cfg, env, seq_sharded)
        return (C.gather(y, env, dpx, 0) if dpx else y), aux
    m = cfg.moe
    E, k, cf = m.num_experts, m.top_k, m.capacity_factor
    B, S, d = x.shape
    n = B * S
    flat = x.reshape(n, d)
    cap = _capacity(n, E, k, cf)
    buf, meta, aux = _dispatch(flat, p["router"], E, k, cap)
    _record(n, cap, meta)
    out = _expert_ffn(buf.reshape(E, cap, d), p["w_gate"], p["w_up"],
                      p["w_down"])
    y = _combine(out.reshape(E * cap, d), meta, n, k)
    return y.reshape(B, S, d), aux


def _record(n: int, cap: int, meta) -> None:
    if _STATS is not None:
        _STATS.append({"tokens": n, "capacity": cap,
                       "dropped": (~meta[3]).sum()})


def _moe_ranks(p, x, cfg: ModelConfig, env: Env, seq_sharded: bool):
    """moe_layer on one rank of env.mesh (the JAX package's shard_map
    body): see the module docstring."""
    m = cfg.moe
    E, k, cf = m.num_experts, m.top_k, m.capacity_factor
    mode = env.plan.resolve_moe(cfg, env.tp)
    tp_axis, tp = env.tp_axis, env.tp
    if mode == "ep" and E % tp:
        raise ValueError(f"ep mode puts {E} experts on {tp} tp ranks")
    S = x.shape[1] * (tp if seq_sharded else 1)
    seq_split = mode == "ep" and tp_axis is not None and S % tp == 0
    if seq_sharded and not seq_split:  # tp mode: every position
        x = C.gather(x, env, tp_axis, 1)
    elif seq_split and not seq_sharded:
        x = C.split(x, env, tp_axis, 1)
    B, Sl, d = x.shape
    n = B * Sl
    cap = _capacity(n, E, k, cf)
    w = _gather_fsdp(p, cfg, env)
    buf, meta, aux = _dispatch(x.reshape(n, d), p["router"], E, k, cap)
    _record(n, cap, meta)
    if mode == "ep" and tp_axis is not None:
        # expert e's slots to the rank holding it: [E/tp, tp*cap, d]
        el = E // tp
        buf = C.all_to_all(buf.reshape(tp, el * cap * d), env, tp_axis)
        buf = buf.reshape(tp, el, cap, d).transpose(0, 1).reshape(
            el, tp * cap, d)
        out = _expert_ffn(buf, w["w_gate"], w["w_up"], w["w_down"])
        out = out.reshape(el, tp, cap, d).transpose(0, 1).reshape(tp, -1)
        out = C.all_to_all(out, env, tp_axis).reshape(E, cap, d)
    elif tp > 1 and w["w_gate"].shape[-1] != cfg.d_ff:
        # ff columns sharded: each rank's share of the down projection,
        # summed over tp in f32 and rounded once
        buf = buf.reshape(E, cap, d)
        h = L.silu(L._bf16_matmul(buf, w["w_gate"])) * L._bf16_matmul(
            buf, w["w_up"])
        out = C.all_reduce(h.float() @ w["w_down"].float(), env,
                           (tp_axis,)).to(x.dtype)
    else:
        out = _expert_ffn(buf.reshape(E, cap, d), w["w_gate"], w["w_up"],
                          w["w_down"])
    y = _combine(out.reshape(E * cap, d), meta, n, k).reshape(B, Sl, d)
    if seq_sharded and not seq_split:
        y = C.split(y, env, tp_axis, 1)
    elif seq_split and not seq_sharded:
        y = C.gather(y, env, tp_axis, 1)
    return y, C.mesh_mean(aux, env)
