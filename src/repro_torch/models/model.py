"""Model assembly for serving: embed -> layers -> norm -> unembed.

Port of the JAX package's models/model.py for the decoder archs:
parameter init, the contiguous and paged caches, the slot-pool and
paged-pool helpers behind the KV backends, forward in three modes:
"prefill" (a whole prompt at once, emitting its caches), "decode" (one
token per row over a contiguous cache or block tables) and "train" (a
whole batch of sequences under autograd, no caches), and lm_loss.

Train mode runs prefill's stack (the same rounding, the same row tiles)
with each block's training form, as the reference's training computation
takes it: attention by env.plan.attn_impl (attention_naive, or
layers.attention_chunked / attention_window_prefill under "xla_chunked"
past attn_q_chunk), the RG-LRU closed by the associative scan and the
WKV6 by its chunked form, the MoE layers' aux losses summed. It launches
none of the CUDA kernels: they have no backward, and neither have the
reference's Pallas kernels, which its training computation never calls
(jax.grad cannot pass through its flash kernel, so the "pallas" plan
past 128 tokens raises here).

A model is `embed -> num_blocks x (the block_pattern unit) -> the
pattern_tail blocks -> norm -> unembed`. Block kinds: "attn" (global
attention + SwiGLU), "local" (sliding-window attention + SwiGLU, a
window-sized ring cache), "moe" (global attention + a mixture of SwiGLU
experts, models/moe.py), "rglru" (the Griffin recurrent block + SwiGLU,
models/recurrent.py) and "rwkv" (RWKV-6 time and channel mix). Attention
takes an optional qkv bias and qk-norm (models/layers.py). The JAX
layer scan becomes a Python loop; parameters and caches keep the JAX
layout: {"blocks": one dict per pattern position with leaves stacked on a
leading layer axis, "tail": one unstacked dict per tail block}, so the
weight bridge (repro_torch/bridge.py) carries the JAX tree over as it is.

Caches per kind: attention k/v [B,Hkv,S,hd] (a local ring holds the
trailing min(window, S) positions, position p at p % ring length);
recurrent state rows, rglru {"h" [B,w] f32, "conv" [B,cw-1,w] bf16} and
rwkv {"s" [B,H,hd,hd] f32, "tm_prev", "cm_prev" [B,d] bf16}, row b being
the state of batch row b (in a pool: of slot b).

Unlike the JAX package's pure functions, the cache ops here update the
cache tensors in place (one pool, no copy per step); they still return the
cache so call sites read as in the reference.
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.env import (Env, check_mesh, head_pad, kv_head_pad,
                                    out_dims, over_ranks, sharded,
                                    vocab_pad)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules

Pytree = Any

PAGEABLE_KINDS = ("attn", "moe", "local")
RECURRENT_KINDS = ("rglru", "rwkv")
# prompts longer than this take the flash kernel in prefill, shorter ones
# attention_naive: the JAX package's pallas-plan dispatch (Sq > 128)
FLASH_MIN_LEN = 128


def check_supported(cfg: ModelConfig) -> None:
    """The port runs decoders built of attn, moe, local, rglru and rwkv
    blocks (with or without a qkv bias and qk-norm), with M-RoPE behind a
    vision-embedding stub (qwen2-vl), and encoder-decoders: an "enc"
    stack behind a frame stub and "dec" blocks (whisper)."""
    kinds = set(cfg.block_pattern) | set(cfg.pattern_tail)
    if not kinds <= set(PAGEABLE_KINDS + RECURRENT_KINDS + ("dec",)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs attn, moe, local, rglru, rwkv and "
            f"dec blocks (block kinds {sorted(kinds)})")


def _units(cfg: ModelConfig, tree):
    """(kind, unit, stacked) for every unit of a params or cache tree: the
    pattern positions under "blocks" (leaves stacked on a layer axis),
    then the tail's."""
    for kind, unit in zip(cfg.block_pattern, tree["blocks"]):
        yield kind, unit, True
    for kind, unit in zip(cfg.pattern_tail, tree["tail"]):
        yield kind, unit, False


def _layer_views(unit: dict, stacked: bool) -> dict:
    """A cache unit's leaves with a leading layer axis (tail leaves get one
    of length 1). Views: in-place writes land in the unit."""
    return unit if stacked else {n: x[None] for n, x in unit.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_block(kind: str, gen: torch.Generator, cfg: ModelConfig,
                env: Env) -> dict:
    d = cfg.d_model
    z = lambda: torch.zeros((d,), dtype=torch.float32, device=gen.device)
    mlp = lambda: {"w_gate": L.dense_init(gen, d, cfg.d_ff),
                   "w_up": L.dense_init(gen, d, cfg.d_ff),
                   "w_down": L.dense_init(gen, cfg.d_ff, d)}
    hq, hkv, hd = head_pad(cfg, env), kv_head_pad(cfg, env), cfg.head_dim

    def attention():
        attn = {"wq": L.dense_init(gen, d, hq * hd),
                "wk": L.dense_init(gen, d, hkv * hd),
                "wv": L.dense_init(gen, d, hkv * hd),
                "wo": L.dense_init(gen, hq * hd, d)}
        if cfg.qkv_bias:  # zeros, as the JAX package's init_attention
            b = lambda n: torch.zeros((n,), dtype=torch.bfloat16,
                                      device=gen.device)
            attn.update(bq=b(hq * hd), bk=b(hkv * hd), bv=b(hkv * hd))
        if cfg.qk_norm:  # f32 zeros, read as 1 + scale by rms_norm
            hz = lambda: torch.zeros((hd,), dtype=torch.float32,
                                     device=gen.device)
            attn.update(q_norm=hz(), k_norm=hz())
        return attn

    if kind in PAGEABLE_KINDS + ("enc",):
        attn = attention()
        if kind == "moe":
            return {"ln1": z(), "attn": attn, "ln2": z(),
                    "moe": M.init_moe(gen, cfg)}
        return {"ln1": z(), "attn": attn, "ln2": z(), "mlp": mlp()}
    if kind == "dec":  # self-attention, cross-attention (lnx, xattn), MLP
        attn = attention()
        return {"ln1": z(), "attn": attn, "lnx": z(), "xattn": attention(),
                "ln2": z(), "mlp": mlp()}
    if kind == "rglru":
        return {"ln1": z(), "rec": R.init_rglru_block(gen, cfg), "ln2": z(),
                "mlp": mlp()}
    if kind == "rwkv":
        return {"ln1": z(), "ln2": z(), "mix": R.init_rwkv_block(gen, cfg)}
    raise ValueError(kind)


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _stacked(make, n: int):
    """n calls of make() (a dict nest of tensors) stacked on a leading
    axis, as _stack([make() for _ in range(n)]) builds it and with the
    same calls in the same order, but filled into tensors allocated once:
    the peak is the stack plus one layer, not twice the stack (a 65.6 GB
    bf16 model is built on an 80 GB card)."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def fill(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                fill(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    first = make()
    out = alloc(first)
    fill(out, first, 0)
    del first
    for i in range(1, n):
        fill(out, make(), i)
    return out


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on the meta device (shapes only): the
    initialisers place their tensors on `gen.device`."""
    device = torch.device("meta")


def init_params(cfg: ModelConfig, env: Env, *, seed: int = 0,
                device="cuda") -> Pytree:
    """Seeded random parameters with the JAX package's shapes, dtypes and
    scales (Mo.init_params): one entry of `blocks` per pattern position,
    its leaves stacked on a leading layer axis, the tail unstacked,
    vocabulary padded to vocab_pad. An encoder-decoder adds the encoder
    as the reference lays it out: "enc_blocks", one "enc" unit stacked
    encoder_layers deep, and "enc_norm". Drawn from a torch.Generator on
    `device`, so the values are not jax's; tests that compare the two
    packages bridge jax's parameters instead (repro_torch/bridge.py).
    device="meta" gives the tree's shapes and dtypes with no storage (the
    port's jax.eval_shape: launch/steps.py state_struct).

    Under a mesh the heads and the vocabulary are padded for its tp
    degree (head_pad, vocab_pad) and the tree is the whole (global) one,
    drawn alike on every rank: parallel/rules.py apply_shardings places
    it."""
    check_supported(cfg)
    check_mesh(cfg, env)
    if torch.device(device).type == "meta":
        gen = _MetaGenerator()
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    d, vp = cfg.d_model, vocab_pad(cfg, env)
    params = {
        "embed": L.dense_init(gen, vp, d),
        "blocks": tuple(_stacked(lambda: _init_block(kind, gen, cfg, env),
                                 cfg.num_blocks)
                        for kind in cfg.block_pattern),
        "tail": tuple(_init_block(kind, gen, cfg, env)
                      for kind in cfg.pattern_tail),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "unembed": L.dense_init(gen, d, vp),
    }
    if cfg.is_encdec:
        params["enc_blocks"] = (_stacked(
            lambda: _init_block("enc", gen, cfg, env), cfg.encoder_layers),)
        params["enc_norm"] = torch.zeros((d,), dtype=torch.float32,
                                         device=device)
    return params


def meta_params(cfg: ModelConfig, env: Env) -> Pytree:
    """init_params(cfg, env, device="meta"), cached: the tree's shapes
    depend on the mesh only through its tp degree (the dry run reads it
    for every cell)."""
    check_mesh(cfg, env)
    return _meta_params(cfg, env.tp)


@functools.lru_cache(maxsize=32)
def _meta_params(cfg: ModelConfig, tp: int) -> Pytree:
    from repro_torch.launch.mesh import ShapeMesh
    mesh = ShapeMesh((tp,), ("model",)) if tp > 1 else None
    return init_params(cfg, Env(mesh=mesh), device="meta")


def count_params(cfg: ModelConfig, env: Env, padded: bool = True) -> int:
    """Exact parameter count from init_params' shapes on the meta device
    (no storage; the JAX package's count_params over jax.eval_shape).
    padded=False subtracts what the tp padding adds, as the JAX package
    does: the padded query heads' rows of wq and wo (head_pad) and the
    padded vocabulary rows of embed and unembed (vocab_pad)."""
    from repro_torch.optim.adamw import tree_leaves
    total = sum(x.numel() for x in tree_leaves(meta_params(cfg, env)))
    if not padded:
        d, hd = cfg.d_model, cfg.head_dim
        dh = head_pad(cfg, env) - cfg.n_heads
        dv = vocab_pad(cfg, env) - cfg.vocab_size
        n_attn = sum(k in ("attn", "moe", "local", "enc") for k in
                     cfg.block_pattern) * cfg.num_blocks
        n_attn += sum(k in ("attn", "moe", "local") for k in cfg.pattern_tail)
        n_attn += cfg.encoder_layers + 2 * (cfg.block_pattern.count("dec")
                                            * cfg.num_blocks)
        total -= n_attn * 2 * dh * hd * d  # padded wq + wo rows
        total -= 2 * dv * d  # padded embed/unembed rows
    return total


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _state_cache(kind: str, cfg: ModelConfig, rows: int, device,
                 rk=None) -> dict:
    """Zero state rows of a recurrent unit: every channel or head, or
    this rank's (rk, a _Ranks: its share unless the kind computes whole
    there)."""
    n = 1 if rk is None or kind in rk.whole else rk.tp
    if kind == "rglru":
        return R.rglru_init_state(cfg, rows, device, cfg.rglru_width // n)
    return R.rwkv_init_state(cfg, rows, device, cfg.n_heads // n)


def _tree_of(cfg: ModelConfig, unit_of) -> Pytree:
    """A cache tree from unit_of(kind) (one unit's zero leaves): stacked
    num_blocks deep under "blocks", once per tail block."""
    def stacked(kind):
        return {n: x.new_zeros((cfg.num_blocks,) + tuple(x.shape))
                for n, x in unit_of(kind).items()}

    return {"blocks": tuple(stacked(k) for k in cfg.block_pattern),
            "tail": tuple(unit_of(k) for k in cfg.pattern_tail)}


def _local_rows(batch: int, env: Env) -> int:
    """The rows of a batch of `batch` one rank of env.mesh holds."""
    if batch % env.dp:
        raise ValueError(f"a batch of {batch} rows over {env.dp} dp ranks")
    return batch // env.dp


def _seq_len_local(n: int, rk) -> int:
    """The positions of a global unit's cache of length n one rank holds
    under the seq_sharded layout."""
    if n % rk.tp:
        raise ValueError(f"a cache of {n} positions split over {rk.tp} tp "
                         "ranks (seq_sharded)")
    return n // rk.tp


def init_cache(cfg: ModelConfig, env: Env, batch: int, max_len: int, *,
               device="cuda") -> Pytree:
    """Contiguous decode cache: attention k/v [L, B, Hkv, max_len, hd]
    bf16 (local rings min(window, max_len) long), recurrent state rows
    [L, B, ...]; a "dec" unit adds the cross-attention caches xk/xv
    [L, B, Hkv, max_len // enc_downsample, hd] (the encoder's length).

    Over a DeviceMesh (models/env.py sharded), this rank's: B / dp rows,
    and the heads, positions and channels _Ranks lays out (the cross
    caches' encoder positions too). Over a shape-only mesh
    (launch/mesh.py ShapeMesh) the whole cache, heads padded for its tp
    degree, as the JAX package's init_cache under an abstract mesh: the
    dry run's cache_struct (launch/steps.py)."""
    rk = (_Ranks(cfg, env, 1) if over_ranks(env) and sharded(cfg, env)
          else None)
    hkv, hd = kv_head_pad(cfg, env), cfg.head_dim
    enc_len = max_len // cfg.enc_downsample if cfg.is_encdec else 0
    hx, xlen = hkv, enc_len  # the cross caches' heads and positions
    if rk is not None:
        batch = _local_rows(batch, env)
        if rk.kv_seq:
            xlen = rk.cross_len(enc_len)
        else:
            hx = rk.n_kv_local()
    z = lambda h, n: torch.zeros((batch, h, n, hd), dtype=torch.bfloat16,
                                 device=device)

    def unit(kind):
        if kind in RECURRENT_KINDS:
            return _state_cache(kind, cfg, batch, device, rk)
        n = min(cfg.local_window, max_len) if kind == "local" else max_len
        h = hkv
        if rk is not None and rk.kv_seq and kind != "local":
            n = _seq_len_local(n, rk)
        elif rk is not None:
            h = rk.n_kv_local()
        if kind == "dec":
            return {"k": z(h, n), "v": z(h, n), "xk": z(hx, xlen),
                    "xv": z(hx, xlen)}
        return {"k": z(h, n), "v": z(h, n)}

    return _tree_of(cfg, unit)


def init_paged_cache(cfg: ModelConfig, env: Env, num_blocks: int,
                     block_size: int, *, num_rows: int = 0,
                     quant: bool = False, device="cuda") -> Pytree:
    """Block-pooled decode cache: attention k/v [L, NB, Hkv, bs, hd] bf16,
    shared by every request through per-request block tables (global and
    local units alike; a local unit's table names its ring's blocks);
    physical block 0 is the null block that absorbs masked rows' writes.
    Recurrent state leaves have no sequence axis and stay row-addressed,
    [L, num_rows, ...], as in the slot pool.

    With quant=True, k/v store int8 values plus per-row f32 dequant scales
    k_scale/v_scale [L, NB, Hkv, bs] (one scale per (block, head, token)
    over the head dim): (hd + 4) / (2 hd) of the bf16 pool's bytes. The
    decode path dispatches on the presence of "k_scale"."""
    hkv, hd = kv_head_pad(cfg, env), cfg.head_dim
    shape = (num_blocks, hkv, block_size, hd)
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)

    def unit(kind):
        if kind in RECURRENT_KINDS:
            return _state_cache(kind, cfg, num_rows, device)
        if kind not in PAGEABLE_KINDS:
            raise ValueError(f"block kind {kind!r} has no paged-cache layout "
                             "(enc/dec caches carry cross-attention state)")
        if not quant:
            return {"k": z(shape, torch.bfloat16), "v": z(shape, torch.bfloat16)}
        return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                "k_scale": z(shape[:-1], torch.float32),
                "v_scale": z(shape[:-1], torch.float32)}

    return _tree_of(cfg, unit)


def grow_caches(caches: Pytree, extra: int, cfg: ModelConfig,
                env: Env = None) -> Pytree:
    """Extend prefill-emitted KV caches ([L,B,Hkv,S,hd], length == prompt)
    by `extra` zero positions so decode can append. Cross-attention caches
    (xk/xv) keep the encoder's length (per rank, the layout their prefill
    gave them); recurrent states have no sequence axis and pass through.
    Sliding-window ('local') rings grow only to min(window, prompt +
    extra): a full ring is never padded, or the slot = pos % window
    alignment breaks.

    Per rank over a DeviceMesh under the seq_sharded layout (env), a
    global unit's grown k/v [.., S + extra, hd] keep this rank's
    (S + extra) / tp positions (_Ranks)."""
    rk = (_Ranks(cfg, env, 1) if env is not None and sharded(cfg, env)
          and env.plan.kv_cache == "seq_sharded" else None)

    def grow(kind, d):
        out = {}
        for n, x in d.items():
            pad_n = extra if (n in ("k", "v")
                              and x.dtype == torch.bfloat16) else 0
            if pad_n and kind == "local":
                cur = x.shape[-2]
                pad_n = max(min(cfg.local_window, cur + extra) - cur, 0)
            out[n] = F.pad(x, (0, 0, 0, pad_n)) if pad_n else x
            if rk is not None and n in ("k", "v") and kind != "local":
                sl = _seq_len_local(out[n].shape[-2], rk)
                r = C.axis_rank(env, rk.tp_axis)
                out[n] = out[n].narrow(-2, r * sl, sl).contiguous()
        return out

    return {"blocks": tuple(grow(k, d) for k, d in
                            zip(cfg.block_pattern, caches["blocks"])),
            "tail": tuple(grow(k, d) for k, d in
                          zip(cfg.pattern_tail, caches["tail"]))}


# Slot-pool cache ops (serve/slots.py). A pooled cache is an init_cache()
# cache whose batch axis is the slot axis: leaves [L, num_slots, ...]
# under "blocks", [num_slots, ...] in the tail. Attention k/v and
# recurrent state rows alike. They work in place and return the pool.


def _all_views(tree):
    """Every leaf of a cache tree with a leading layer axis (views)."""
    out = []
    for unit in tree["blocks"]:
        out.extend(unit.values())
    for unit in tree["tail"]:
        out.extend(x[None] for x in unit.values())
    return out


def cache_insert_slot(pool: Pytree, request: Pytree, slot: int) -> Pytree:
    """Write a batch-1 cache (grown to the pool's length with grow_caches)
    into `slot`; every leaf of the slot is overwritten (state rows
    included), so freed slots need no zeroing before reuse."""
    for dst, src in zip(_all_views(pool), _all_views(request)):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return pool


def cache_evict_slot(pool: Pytree, slot: int) -> Pytree:
    """Zero `slot` (hygiene and tests: insert overwrites the whole slot)."""
    for leaf in _all_views(pool):
        leaf[:, slot] = 0
    return pool


def cache_read_slot(pool: Pytree, slot: int) -> Pytree:
    """`slot` as a batch-1 cache (a copy; inverse of insert)."""
    return {"blocks": tuple({n: x[:, slot:slot + 1].clone()
                             for n, x in unit.items()}
                            for unit in pool["blocks"]),
            "tail": tuple({n: x[slot:slot + 1].clone()
                           for n, x in unit.items()}
                          for unit in pool["tail"])}


# Paged-pool helpers (serve/blocks.py). The JAX package builds them as
# closures to jit; here they work in place on the pool's leaves: k/v
# [L,NB,H,bs,hd] and, in a quant pool, the scales [L,NB,H,bs] (no head-dim
# axis), addressed through the global table or, for local units, the
# ring table; recurrent state rows [L,rows,...] addressed by slot.


def make_paged_insert(cfg: ModelConfig, block_size: int):
    """Scatter a batch-1 cache ([L,1,Hkv,S,hd] k/v; a quant request from
    quantize_paged_request adds [L,1,Hkv,S] scales) into the blocks its
    tables name, block_size positions per block (unallocated entries are
    0: padding lands in the null block); local rings go through
    `tables_local` in their ring order, state leaves land at row `slot`."""
    bs = block_size

    def insert(pool, request, tables, slot: int = 0, tables_local=None):
        for (kind, dst_u, st), (_, src_u, _) in zip(_units(cfg, pool),
                                                   _units(cfg, request)):
            dst_u, src_u = _layer_views(dst_u, st), _layer_views(src_u, st)
            tbl = tables_local if kind == "local" else tables
            for name, dst in dst_u.items():
                src = src_u[name]
                if kind in RECURRENT_KINDS:
                    dst[:, slot] = src[:, 0].to(dst.dtype)
                elif name.endswith("_scale"):  # [L,1,H,S] -> [L,nb,H,bs]
                    Lyr, _, H, S = src.shape
                    nb = -(-S // bs)
                    src = F.pad(src, (0, nb * bs - S)).to(dst.dtype)
                    chunks = src.reshape(Lyr, H, nb, bs).transpose(1, 2)
                    dst[:, tbl[:nb].long()] = chunks
                else:  # [L,1,H,S,hd] -> chunks [L,nb,H,bs,hd]
                    Lyr, _, H, S, hd = src.shape
                    nb = -(-S // bs)
                    src = F.pad(src, (0, 0, 0, nb * bs - S)).to(dst.dtype)
                    chunks = src.reshape(Lyr, H, nb, bs, hd).transpose(1, 2)
                    dst[:, tbl[:nb].long()] = chunks
        return pool

    return insert


def make_paged_copy(cfg: ModelConfig):
    """Copy one physical block's K/V (and scales; every layer, global and
    local units alike) from `src` to `dst` — the copy-on-write step behind
    prefix sharing (serve/blocks.py). State rows have no blocks and are
    untouched."""
    def copy(pool, src: int, dst: int):
        for kind, unit, st in _units(cfg, pool):
            if kind in RECURRENT_KINDS:
                continue
            for leaf in _layer_views(unit, st).values():
                leaf[:, dst] = leaf[:, src]
        return pool

    return copy


def make_paged_evict(cfg: ModelConfig):
    """Zero the blocks the tables name (and, given `slot`, its state row)
    — hygiene only; allocation hygiene lives in the BlockManager free
    list."""
    def evict(pool, tables, slot=None, tables_local=None):
        for kind, unit, st in _units(cfg, pool):
            for leaf in _layer_views(unit, st).values():
                if kind in RECURRENT_KINDS:
                    if slot is not None:
                        leaf[:, slot] = 0
                    continue
                tbl = tables_local if kind == "local" else tables
                if tbl is not None:
                    leaf[:, tbl.long()] = 0
        return pool

    return evict


def make_paged_read(cfg: ModelConfig):
    """Gather one slot back out of a pool as a batch-1 cache (inverse of
    insert). `valid` / `valid_local` mask unallocated table entries, so a
    freed slot reads as zeros whatever masked rows left in the null
    block; state leaves read row `slot`."""
    def read(pool, tables, valid, slot: int = 0, tables_local=None,
             valid_local=None):
        blocks, tail = [], []
        for kind, unit, st in _units(cfg, pool):
            out = {}
            for name, leaf in _layer_views(unit, st).items():
                if kind in RECURRENT_KINDS:
                    g = leaf[:, slot:slot + 1].clone()
                else:
                    tbl, ok = ((tables_local, valid_local) if kind == "local"
                               else (tables, valid))
                    g = leaf[:, tbl.long()]  # [L,MB,H,bs(,hd)]
                    ok = ok.to(leaf.dtype).reshape(
                        (1, -1) + (1,) * (g.dim() - 2))
                    g = (g * ok).transpose(1, 2)
                    Lyr, H, MB, bs = g.shape[:4]
                    g = g.reshape(Lyr, 1, H, MB * bs, *g.shape[4:])
                out[name] = g if st else g[0]
            (blocks if st else tail).append(out)
        return {"blocks": tuple(blocks), "tail": tuple(tail)}

    return read


def _map_pageable(cfg: ModelConfig, request: Pytree, fn) -> Pytree:
    """fn applied to every attention unit of a cache; state units as
    they are."""
    out = {"blocks": [], "tail": []}
    for kind, unit, st in _units(cfg, request):
        out["blocks" if st else "tail"].append(
            unit if kind in RECURRENT_KINDS else fn(unit))
    return {k: tuple(v) for k, v in out.items()}


def quantize_paged_request(cfg: ModelConfig, request: Pytree) -> Pytree:
    """Expand a batch-1 fp cache ({"k","v"} per attention unit) into the
    quant pool's structure ({"k","v","k_scale","v_scale"}): symmetric int8
    over the head dim, one f32 scale per (head, position) — insertable
    into a quant pool with make_paged_insert."""
    def unit(d):
        kq, ks = pd_ops.quantize_kv(d["k"])
        vq, vs = pd_ops.quantize_kv(d["v"])
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}

    return _map_pageable(cfg, request, unit)


def dequantize_paged_request(cfg: ModelConfig, request: Pytree) -> Pytree:
    """Inverse of quantize_paged_request (up to quantization error): fold
    the scales back into bf16 {"k","v"} units — what make_paged_read
    returns from a quant pool becomes comparable to an fp read."""
    def unit(d):
        return {n: (d[n].float() * d[f"{n}_scale"][..., None]).to(
            torch.bfloat16) for n in ("k", "v")}

    return _map_pageable(cfg, request, unit)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _train_attention(q, k, v, cfg: ModelConfig, plan, window: int,
                     causal: bool = True):
    """Train mode's self-attention over q/k/v [B,S,H,hd] (causal, or not:
    an encoder's), dispatched on the plan as the reference's
    _attn_sublayer dispatches it."""
    Sq = q.shape[1]
    if plan.attn_impl == "xla_chunked" and Sq > plan.attn_q_chunk:
        if window > 0:
            return L.attention_window_prefill(q, k, v, cfg, window=window,
                                              q_chunk=plan.attn_q_chunk)
        return L.attention_chunked(q, k, v, cfg, causal=causal,
                                   q_chunk=plan.attn_q_chunk,
                                   kv_chunk=plan.attn_kv_chunk)
    if plan.attn_impl == "pallas" and Sq > FLASH_MIN_LEN:
        raise NotImplementedError(
            f"train mode under the pallas plan at {Sq} > {FLASH_MIN_LEN} "
            "positions: the flash kernel has no backward (in the reference "
            "either: jax.grad through its Pallas flash kernel fails); train "
            "under the naive or xla_chunked plan")
    return L.attention_naive(q, k, v, cfg, causal=causal, window=window)


def _attn_prefill(p, h, cfg: ModelConfig, S: int, rope, window: int = 0,
                  plan=None, causal: bool = True, ranks=None):
    """Prefill attention over the first S (real) positions of the
    row-padded h [B,Sp,d]: causal, global (window 0) or sliding-window,
    or (causal=False) an encoder's full attention. Sequences longer than
    FLASH_MIN_LEN go through the flash kernel, shorter ones through
    attention_naive, as the JAX package's pallas plan dispatches; padding
    positions never enter attention (their output rows are zeros). rope:
    (cos, sin) of the S positions (rope_cos_sin, or mrope_cos_sin for an
    M-RoPE arch). Returns (out [B,Sp,d], {"k","v"} [B,Hkv,S,hd] after
    rope; a window unit keeps the trailing min(window, S) positions,
    ring-aligned: position p at p % that length). With a training plan
    (train mode): attention as _train_attention dispatches it, and no
    cache (None). ranks (the per-rank forward): this rank's heads over
    the whole sequence, its share of the output projection summed over
    the tp ranks; the cache holds the KV heads its heads read, or every
    KV head for a global unit under the seq_sharded layout (_Ranks)."""
    if ranks is not None:
        h = ranks.enter(h)
    q, k, v = L._project_qkv(p, h, cfg)  # [B,Sp,H,hd]
    q = L.rotate(q[:, :S], *rope)
    k = L.rotate(k[:, :S], *rope)
    v = v[:, :S]
    k_all, v_all = k, v
    if ranks is not None:
        k, v = ranks.local_kv(k, v)
    out = ((lambda o: L.linear(o, p["wo"])) if ranks is None else
           (lambda o: ranks.row(o, p["wo"], ranks.heads_split)))
    if plan is not None:
        o = F.pad(_train_attention(q, k, v, cfg, plan, window, causal),
                  (0, 0, 0, h.shape[1] - S))
        return out(o), None
    if S > FLASH_MIN_LEN:
        o = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window, n_kv_heads=k.shape[2])
    else:
        o = L.attention_naive(q, k, v, cfg, causal=causal, window=window)
    o = F.pad(o, (0, 0, 0, h.shape[1] - S))
    if ranks is not None and ranks.kv_seq and window == 0:
        k, v = k_all, v_all  # split over the positions by grow_caches
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    if window > 0:
        w = min(window, S)
        kc = torch.roll(kc[:, :, S - w:], (S - w) % w, dims=2)
        vc = torch.roll(vc[:, :, S - w:], (S - w) % w, dims=2)
    return out(o), {"k": kc, "v": vc}


def _xattn_prefill(p, h, cfg: ModelConfig, S: int, enc, train: bool,
                   ranks=None):
    """Cross-attention of the first S positions of the row-padded decoder
    stream h [B,Sp,d] over the encoder's output: enc = (its row-padded
    output [B,Sep,d], its Se real positions). No rope, no mask, always
    attention_naive (the reference's dispatch sends no cross-attention to
    its flash kernel). Returns (out [B,Sp,d], {"xk","xv"} [B,Hkv,Se,hd],
    the decode steps' cross caches; None in train mode). ranks (the
    per-rank forward; enc whole on every rank): this rank's query heads
    over the whole decoder sequence, its share of the output projection
    summed over tp; the cache holds the KV heads its heads read, or under
    the seq_sharded layout every KV head at the rank's encoder positions
    (_Ranks.cross_local)."""
    e, Se = enc
    if ranks is not None:
        h = ranks.enter(h)
    q, k, v = L._project_qkv(p, h, cfg, x_kv=e)
    k, v = k[:, :Se], v[:, :Se]
    kc, vc = k, v
    if ranks is not None:
        k, v = ranks.local_kv(k, v)
        if ranks.kv_seq:
            kc, vc = ranks.cross_local(kc, 1), ranks.cross_local(vc, 1)
        else:
            kc, vc = k, v
    o = F.pad(L.attention_naive(q[:, :S], k, v, cfg, causal=False),
              (0, 0, 0, h.shape[1] - S))
    out = (L.linear(o, p["wo"]) if ranks is None
           else ranks.row(o, p["wo"], ranks.heads_split))
    if train:
        return out, None
    return out, {"xk": kc.transpose(1, 2).contiguous(),
                 "xv": vc.transpose(1, 2).contiguous()}


def _xattn_decode(p, h, cfg: ModelConfig, n_rows: int, cache, ranks=None):
    """Decode cross-attention of the first n_rows rows of h [Bp,1,d] over
    the cached xk/xv [B,Hkv,Se,hd]: every row attends over all Se encoder
    positions (depth Se - 1, as the reference reads its cross cache)
    through the contiguous-cache read of models/layers.py. Nothing is
    written. ranks (the per-rank forward): this rank's query heads over
    its cross cache, its share of the output projection summed over tp;
    under the seq_sharded layout flash-decoding over the rank's encoder
    positions (_flash_decode_ranks)."""
    q = L._project(p, h, cfg, "q")[:n_rows]  # no rope
    xk, xv = cache["xk"], cache["xv"]
    if ranks is not None and ranks.kv_seq:
        # no write: every encoder position valid, each rank's whole slice
        # read (where the cache is whole on every rank, Se % tp != 0, the
        # ranks' partials are the same and merge to themselves)
        o = _flash_decode_ranks(q, xk, xv, ranks.tp * xk.shape[-2] - 1,
                                ranks)
    else:
        depth = torch.full((n_rows,), xk.shape[-2] - 1, dtype=torch.int32,
                           device=h.device)
        o = L.attention_decode(q, xk, xv, depth, cfg)
    o = F.pad(o, (0, 0, 0, 0, 0, h.shape[0] - n_rows))
    if ranks is not None:
        return ranks.row(o, p["wo"], ranks.heads_split)
    return L.linear(o, p["wo"])


def _attn_sublayer(p, h, cfg: ModelConfig, n_rows: int, cur_len, rope,
                   cache, tables, window: int = 0, row_slots=None,
                   ranks=None):
    """Decode attention for the first n_rows rows of the row-padded h: each
    row writes its token's K/V (through its block table, or at its own row
    of a contiguous cache) and attends at its own depth. A window unit
    writes at cur_len % (ring length) and attends over min(cur_len, ring
    length - 1) + 1 ring entries (the ring holds exactly the window, in
    ring order: softmax does not care). rope: the rows' (cos, sin) from
    layers.rope_cos_sin. cache: this layer's leaves ({"k","v"}, plus
    "k_scale"/"v_scale" in a quant pool). row_slots ([n_rows] slot of each
    row, -1 masked) addresses a contiguous cache through its slots instead
    of row == slot. Every row's K/V is written before any row attends, so
    a row sees the rows of its slot at lower depths in the same step.

    Masked rows all write one place (the null block's, or the contiguous
    cache's tail position) and read it back. In an MoE arch their hidden
    states differ (a dispatch keeps some and drops others) and they take
    capacity from real rows, so what they read must be what the JAX
    package's scatter leaves there, its last row's write: every row of a
    shared place writes that row's K/V (_last_writer), which also keeps
    the card's duplicate-index writes deterministic.

    ranks (the per-rank forward, a contiguous cache): this rank's query
    heads; its share of the output projection summed over tp. A global
    unit under the seq_sharded layout goes through _attn_seq_sharded;
    otherwise the rank's cache holds the KV heads its heads read."""
    q, k, v = L._project_qkv(p, h, cfg)  # [Bp,1,H,hd]
    q = L.rotate(q, *rope)[:n_rows]
    k = L.rotate(k, *rope)[:n_rows, 0]
    v = v[:n_rows, 0]
    ck, cv = cache["k"], cache["v"]
    if ranks is not None:
        if ranks.kv_seq and not window:
            o = _attn_seq_sharded(q, k, v, ck, cv, cur_len, ranks)
            o = F.pad(o, (0, 0, 0, 0, 0, h.shape[0] - n_rows))
            return ranks.row(o, p["wo"], ranks.heads_split)
        k, v = ranks.local_kv(k, v, dim=1)
    if tables is not None:
        bs = ck.shape[-2]
        idx = cur_len % window if window else cur_len
        phys = torch.gather(tables, 1, (idx // bs)[:, None])[:, 0].long()
        off = idx % bs
        if cfg.moe is not None:
            src = _last_writer(phys * bs + off)
            k, v = k[src], v[src]
        lengths = (torch.clamp_max(cur_len, window - 1) if window
                   else cur_len).to(torch.int32)
        if "k_scale" in cache:
            # quant pool: quantize-on-insert (this token's K/V row goes in
            # as int8 + per-row scale), dequant fused into the read
            ks_pool, vs_pool = cache["k_scale"], cache["v_scale"]
            kq, ks = pd_ops.quantize_kv(k)  # [B,Hkv,hd] int8, [B,Hkv]
            vq, vs = pd_ops.quantize_kv(v)
            ck[phys, :, off] = kq
            cv[phys, :, off] = vq
            ks_pool[phys, :, off] = ks
            vs_pool[phys, :, off] = vs
            o = L.attention_paged_decode_quant(q, ck, cv, ks_pool, vs_pool,
                                               tables, lengths, cfg)
        else:
            ck[phys, :, off] = k.to(ck.dtype)
            cv[phys, :, off] = v.to(cv.dtype)
            o = L.attention_paged_decode(q, ck, cv, tables, lengths, cfg)
    elif row_slots is not None:
        # row -> slot indirection over the contiguous cache: several rows
        # may share a slot at distinct depths (speculative verify rows),
        # and rows may be fewer or more than the slots. A masked row
        # (slot < 0) writes at (slot 0, Sc - 1): a live request's last
        # write is at Sc - 2 and no depth reaches Sc - 1, so the tail
        # position is the contiguous analogue of the paged null block
        if window:
            raise NotImplementedError(
                "row-slot indirection over a windowed ring cache")
        Sc = ck.shape[-2]
        live = row_slots >= 0
        slot = torch.where(live, row_slots, 0).long()
        idx = torch.where(live, cur_len, Sc - 1)
        if cfg.moe is not None:
            src = _last_writer(slot * Sc + idx)
            k, v = k[src], v[src]
        ck[slot, :, idx] = k.to(ck.dtype)
        cv[slot, :, idx] = v.to(cv.dtype)
        o = L.attention_decode(q, ck, cv, cur_len, cfg, slots=slot)
    else:
        Sc = ck.shape[-2]
        idx = cur_len % Sc if window else cur_len
        rows = torch.arange(n_rows, device=h.device)
        ck[rows, :, idx] = k.to(ck.dtype)
        cv[rows, :, idx] = v.to(cv.dtype)
        lengths = torch.clamp_max(cur_len, Sc - 1) if window else cur_len
        o = L.attention_decode(q, ck, cv, lengths, cfg)
    o = F.pad(o, (0, 0, 0, 0, 0, h.shape[0] - n_rows))
    if ranks is not None:
        return ranks.row(o, p["wo"], ranks.heads_split)
    return L.linear(o, p["wo"])


def _attn_seq_sharded(q, k, v, ck, cv, cur_len, ranks):
    """Decode attention of this rank's query heads q [n,1,Hq/tp,hd] over
    a global unit's cache split over tp along the sequence: ck, cv
    [n,Hkv,Smax/tp,hd], this rank's positions of every KV head. The new
    K/V (k, v [n,Hkv,hd], every KV head) is written on the rank that owns
    cur_len, then _flash_decode_ranks attends. The rows share one cur_len
    (the one-shot's uniform batch), read on the device. Returns
    [n,1,Hq/tp*hd]."""
    n = q.shape[0]
    s_local = ck.shape[-2]
    r = C.axis_rank(ranks.env, ranks.tp_axis)
    cur = cur_len[:1]
    idx = cur - r * s_local
    own = (idx >= 0) & (idx < s_local)
    pos = idx.clamp(0, s_local - 1)
    rows = torch.arange(n, device=q.device)
    ck[rows, :, pos] = torch.where(own, k.to(ck.dtype), ck[rows, :, pos])
    cv[rows, :, pos] = torch.where(own, v.to(cv.dtype), cv[rows, :, pos])
    return _flash_decode_ranks(q, ck, cv, cur, ranks)


def _flash_decode_ranks(q, ck, cv, cur, ranks):
    """This rank's query heads q [n,1,Hq/tp,hd] over a cache split over tp
    along its positions (ck, cv [n,Hkv,S/tp,hd], every KV head at this
    rank's positions; cur the global index of the last valid one): q is
    gathered over tp (every head), flash-decoding (kernel #5: the kernel
    on the card, its plain version on the CPU) attends to the rank's
    positions and merges the tp ranks' partials, and the rank keeps its
    own heads. Returns [n,1,Hq/tp*hd]."""
    from repro_torch.kernels.flash_decode.ops import flash_decode_seq_sharded
    n, _, hq, hd = q.shape
    r = C.axis_rank(ranks.env, ranks.tp_axis)
    qa = ranks.gather(q[:, 0], 1).contiguous()  # [n,Hq,hd]
    o = flash_decode_seq_sharded(qa, ck, cv, cur,
                                 group=C._group(ranks.env, ranks.tp_axis),
                                 index=r)
    return o[:, r * hq:(r + 1) * hq].reshape(n, 1, hq * hd)


def _last_writer(place):
    """[n] int: for each row, the last row writing the same place (a row
    is its own when no later row shares its place)."""
    rows = torch.arange(place.shape[0], device=place.device)
    same = place[:, None] == place[None, :]
    return torch.amax(torch.where(same, rows[None, :], -1), dim=1)


def _moe_sublayer(p, x, cfg: ModelConfig, *, S=None, n_rows=None,
                  ranks=None):
    """The MoE FFN over the rows the JAX package dispatches: a prefill's
    first S positions of each row-padded sequence (flattened b * S + s),
    a decode step's first n_rows rows (masked rows included); the padding
    rows are not dispatched and come out zero. ranks: this rank's rows of
    the per-rank forward (train mode, prefill or decode), dispatched by
    the layer's ep or tp mode. Returns (out, aux loss)."""
    if ranks is not None and ranks.sp:
        return M.moe_layer(p, x, cfg, ranks.env, seq_sharded=True)
    env = None if ranks is None else ranks.env
    if S is not None:
        y, aux = M.moe_layer(p, x[:, :S], cfg, env)
        return F.pad(y, (0, 0, 0, x.shape[1] - S)), aux
    y, aux = M.moe_layer(p, x[:n_rows], cfg, env)
    return F.pad(y, (0, 0) * (x.dim() - 1) + (0, x.shape[0] - n_rows)), aux


# state leaves read only by row-wise ops (the WKV step): they stay at the
# real rows, the others are padded with the step to whole row tiles
_UNPADDED_STATE = ("s",)


def _rows_state(state: dict, n_rows: int, Bp: int) -> dict:
    """The decode step's state: row b is the state of batch row b. Leaves
    that feed the padded rows' GEMMs (conv and token-shift inputs, the
    RG-LRU's h) are padded to the step's Bp rows with zeros; rows past
    n_rows are never written back."""
    for n, x in state.items():
        if x.shape[0] != n_rows:
            raise ValueError(f"decode with {n_rows} rows over {x.shape[0]} "
                             f"recurrent state rows ({n!r}): row b is the "
                             "state of batch row b")
    return {n: x if n in _UNPADDED_STATE
            else F.pad(x, (0, 0) * (x.dim() - 1) + (0, Bp - n_rows))
            for n, x in state.items()}


def _write_rows(cache: dict, new: dict, n_rows: int) -> None:
    for n, x in new.items():
        cache[n].copy_(x[:n_rows].to(cache[n].dtype))


def _apply_block(kind: str, p, h, hf, cfg: ModelConfig, *, S=None, rope=None,
                 n_rows=None, cur_len=None, cache=None, tables=None,
                 row_slots=None, plan=None, enc=None, ranks=None):
    """One block: h + first(norm(h)), then + second(norm(.)) (a "dec"
    block puts its cross-attention, + cross(lnx-norm(.)), between the
    two). Prefill when `cache` is None (S real positions of the
    row-padded h; returns the block's prompt cache), decode otherwise
    (updates `cache` in place; the first n_rows rows are real). With a
    training plan (train mode): prefill's computation with the blocks'
    training forms, no cache. An "enc" block (the encoder) attends
    without a mask and returns no cache; enc: the encoder's output and
    length for a "dec" block's prefill cross-attention.

    hf: the f32 value of h where the reference reads it unrounded into the
    first norm (the previous block's last residual sum inside the same
    pattern unit or the tail: XLA drops the bf16 round trip into the
    norm's f32 cast), else None. Returns (h bf16, its f32 sum, cache, the
    MoE aux loss or 0). ranks: the per-rank forward's rank (h its rows,
    p its shards, the cache its own; _Ranks)."""
    eps = cfg.norm_eps
    decode = cache is not None
    train = plan is not None
    prefill_kw = {} if decode else {"S": S, "return_state": not train}
    subs = []  # (norm, sublayer) in order; each returns (out, cache part)
    if kind in PAGEABLE_KINDS + ("enc", "dec"):
        window = cfg.local_window if kind == "local" else 0
        if decode:
            tbl = (None if tables is None
                   else tables["local" if window else "global"])
            subs.append(("ln1", lambda x: (_attn_sublayer(
                p["attn"], x, cfg, n_rows, cur_len, rope, cache, tbl,
                window, row_slots, ranks), None)))
        else:
            subs.append(("ln1", lambda x: _attn_prefill(
                p["attn"], x, cfg, S, rope, window, plan,
                causal=kind != "enc", ranks=ranks)))
        if kind == "dec":
            subs.append(("lnx", (lambda x: (_xattn_decode(
                p["xattn"], x, cfg, n_rows, cache, ranks), None)) if decode
                else (lambda x: _xattn_prefill(p["xattn"], x, cfg, S, enc,
                                               train, ranks))))
        if kind == "moe":
            subs.append(("ln2", lambda x: _moe_sublayer(
                p["moe"], x, cfg, S=None if decode else S, n_rows=n_rows,
                ranks=ranks)))
        elif ranks is not None:
            subs.append(("ln2", lambda x: (ranks.mlp(p["mlp"], x), None)))
        else:
            subs.append(("ln2", lambda x: (L.mlp(p["mlp"], x), None)))
    elif kind == "rglru":
        st = _rows_state(cache, n_rows, h.shape[0]) if decode else None
        mlp = L.mlp if ranks is None else ranks.mlp
        subs += [("ln1", lambda x: R.rglru_block(p["rec"], x, cfg, st,
                                                 train=train, ranks=ranks,
                                                 **prefill_kw)),
                 ("ln2", lambda x: (mlp(p["mlp"], x), None))]
    else:  # rwkv
        st = _rows_state(cache, n_rows, h.shape[0]) if decode else None
        chunk = plan.rwkv_chunk if train else 0
        subs += [("ln1", lambda x: R.rwkv_time_mix(
                     p["mix"], x, cfg, st, chunk=chunk, ranks=ranks,
                     **prefill_kw)),
                 ("ln2", lambda x: R.rwkv_channel_mix(
                     p["mix"], x, cfg, st, ranks=ranks, **prefill_kw))]
    parts = []
    for norm, sub in subs:
        # the reference (XLA) fuses each residual add into the next norm:
        # the norm reads the f32 sum, the residual stream its bf16 rounding
        a, c = sub(L.rms_norm(h if hf is None else hf, p[norm], eps)
                   .to(torch.bfloat16))
        hf = h.float() + a.float()
        h = hf.to(torch.bfloat16)
        parts.append(c)
    aux = parts[-1] if kind == "moe" else 0.0
    if train or kind == "enc":
        return h, hf, None, aux
    if kind == "rwkv":
        new = {**parts[0], "cm_prev": parts[1]}
    elif kind == "dec" and not decode:
        new = {**parts[0], **parts[1]}
    else:
        new = parts[0]
    if decode and kind in RECURRENT_KINDS:
        _write_rows(cache, new, n_rows)
    return h, hf, new, aux


def _run_blocks(params, h, cfg: ModelConfig, caches=None, plan=None,
                ranks=None, **kw):
    """Every block in order: num_blocks units of the pattern, then the
    tail. Returns (final-norm input, prompt caches or None, the summed
    MoE aux loss). A unit boundary rounds the residual to bf16 (the
    reference's layer scan carries it in bf16); inside a unit and through
    the tail the next norm reads the f32 sum (see _apply_block).

    plan (train mode): each pattern unit is recomputed in the backward
    pass (torch.utils.checkpoint) under plan.remat "nothing" or "dots",
    where the reference wraps its unit in jax.checkpoint (its "dots"
    policy keeps the products; recomputing them gives the same values);
    the tail is not, as there.

    ranks (the per-rank forward): each block's FSDP-sharded weights
    are gathered before use (inside the recomputed unit: gathered again
    in the backward pass, as FSDP does)."""
    pattern, tail = cfg.block_pattern, cfg.pattern_tail
    unshard = ((lambda p, path: p) if ranks is None else ranks.unshard)
    out_blocks = [[] for _ in pattern]
    aux = 0.0  # a tensor once an MoE layer adds one: no launch otherwise

    def unit(h, i):
        hf, a = None, 0.0
        for j, kind in enumerate(pattern):
            c = None if caches is None else _layer(caches["blocks"][j], i)
            h, hf, new, aj = _apply_block(
                kind, unshard(_layer(params["blocks"][j], i), ("blocks", j)),
                h, hf, cfg, cache=c, plan=plan, ranks=ranks, **kw)
            a = a + aj
            if plan is None:
                out_blocks[j].append(new)
        return h, a

    remat = plan is not None and plan.remat in ("nothing", "dots")
    for i in range(cfg.num_blocks):
        if remat:
            h, a = torch.utils.checkpoint.checkpoint(unit, h, i,
                                                     use_reentrant=False)
        else:
            h, a = unit(h, i)
        aux = aux + a
    hf = None
    out_tail = []
    for j, kind in enumerate(tail):
        c = None if caches is None else caches["tail"][j]
        h, hf, new, a = _apply_block(
            kind, unshard(params["tail"][j], ("tail", j)), h, hf, cfg,
            cache=c, plan=plan, ranks=ranks, **kw)
        aux = aux + a
        out_tail.append(new)
    x = h if hf is None else hf
    if caches is not None or plan is not None:
        return x, None, aux
    return x, {"blocks": tuple(_stack(u) for u in out_blocks),
               "tail": tuple(out_tail)}, aux


def build_mrope_positions(S: int, nv: int, cur_len=None, device="cpu"):
    """Qwen2-VL's 3-D positions (the JAX package's build_mrope_positions):
    the nv vision patches on a g x g grid (g = isqrt(nv)) at t = 0, the
    text continuing linearly from g on every component. Prefill: [1,S,3]
    int32 over positions 0..S-1; decode (cur_len, a scalar or [B] cache
    position): [B,1,3] (B = 1 for a scalar), the token at g + cur_len - nv
    on all three."""
    g = max(math.isqrt(max(nv, 0)), 1)
    if cur_len is not None:
        p = torch.as_tensor(cur_len, device=device).reshape(-1, 1, 1)
        return (g + p - nv).expand(-1, 1, 3).to(torch.int32)
    idx = torch.arange(S, device=device)
    is_vis = idx < nv
    text = g + idx - nv
    t = torch.where(is_vis, 0, text)
    hh = torch.where(is_vis, idx // g, text)
    ww = torch.where(is_vis, idx % g, text)
    return torch.stack([t, hh, ww], -1)[None].to(torch.int32)


def _rope_of(cfg: ModelConfig, positions):
    """(cos, sin) of positions for every attention layer: M-RoPE over
    [..., 3] positions for an M-RoPE arch, plain rope otherwise."""
    if cfg.mrope:
        return L.mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                               cfg.mrope_sections)
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _pad_rows(h, S: int):
    """h [B,S,d] padded with zero positions to a multiple of
    layers.ROW_TILE."""
    return F.pad(h, (0, 0, 0, -(-S // L.ROW_TILE) * L.ROW_TILE - S))


def _with_vision(h, cfg: ModelConfig, vision_embeds):
    """A sequence's embeddings and the rope angles of its positions. A
    VLM's sequence is its vision embeddings [B,Nv,d] (the stub of the
    patch embedder) followed by the prompt's token embeddings h [B,S,d],
    at M-RoPE's 3-D positions; other archs' h at positions 0..S-1.
    Returns (h, rope)."""
    if cfg.family != "vlm":
        pos = torch.arange(h.shape[1], device=h.device)
    elif vision_embeds is None:
        raise ValueError(f"{cfg.name}: a prefill or train forward needs "
                         "vision_embeds [B, num_vision_embeds, d_model]")
    else:
        h = torch.cat([vision_embeds.to(torch.bfloat16), h], 1)
        pos = build_mrope_positions(h.shape[1], cfg.num_vision_embeds,
                                    device=h.device)
    return h, _rope_of(cfg, pos)


def _embed(params, tokens, cfg: ModelConfig, vision_embeds=None):
    """Whole sequences' embeddings (a VLM's vision embeddings first,
    _with_vision), each padded to a multiple of layers.ROW_TILE positions
    (h [B,Sp,d] bf16), the rope angles of their S positions and S."""
    h, rope = _with_vision(params["embed"][tokens.long()].to(torch.bfloat16),
                           cfg, vision_embeds)
    S = h.shape[1]
    return _pad_rows(h, S), rope, S


def _encode(params, frames, cfg: ModelConfig, plan=None, env=None):
    """The encoder of an encoder-decoder over its frame stub frames
    [B,Se,d] (the conv front end's output): encoder_layers "enc" blocks
    (full attention at rope positions 0..Se-1, as the reference runs its
    encoder in train mode: past FLASH_MIN_LEN frames the flash kernel,
    non-causal, in a prefill; train mode's dispatch under a training
    plan), then enc_norm. Returns (the row-padded output [B,Sep,d] bf16,
    Se), what the "dec" blocks' cross-attention reads.

    Per rank over env.mesh (a DeviceMesh; frames this rank's rows): each
    block on the rank's heads and ff columns (_Ranks, sequence-parallel
    over the frames when tp divides Se), its FSDP-sharded weights
    gathered; enc_norm reads the whole output on every rank (row-padded
    at tp 1, as on one device)."""
    if frames is None:
        raise ValueError(f"{cfg.name}: a prefill or train forward needs "
                         "frames [B, S_enc, d_model]")
    Se = frames.shape[1]
    h = frames.to(torch.bfloat16)
    rk = _Ranks(cfg, env, Se) if env is not None else None
    if rk is None or rk.tp == 1:
        h = _pad_rows(h, Se)
    if rk is not None and rk.sp:
        h = C.split(h, env, rk.tp_axis, 1)
    rope = _rope_of(cfg, torch.arange(Se, device=frames.device))
    unit = params["enc_blocks"][0]
    unshard = ((lambda p: p) if rk is None
               else (lambda p: rk.unshard(p, ("enc_blocks", 0))))

    def layer(h, i):
        return _apply_block("enc", unshard(_layer(unit, i)), h, None, cfg,
                            S=Se, rope=rope, plan=plan, ranks=rk)[0]

    remat = plan is not None and plan.remat in ("nothing", "dots")
    for i in range(cfg.encoder_layers):
        h = (torch.utils.checkpoint.checkpoint(layer, h, i,
                                               use_reentrant=False)
             if remat else layer(h, i))
    if rk is not None:
        h = rk.enter(h)
    return L.rms_norm(h, params["enc_norm"], cfg.norm_eps), Se


def _prefill(params, tokens, cfg: ModelConfig, last_only: bool = False,
             vision_embeds=None, frames=None):
    """forward(mode="prefill"): tokens [B,S] -> (logits [B,S,Vpad] — or
    [B,Vpad] of the last position with last_only — and the prompt caches;
    a VLM's S counts its vision positions first).

    Each sequence is padded to a multiple of layers.ROW_TILE positions, so
    every `linear` tile holds rows of one sequence only and a prompt's rows
    do not depend on the batch around it (B=1 and B=16 prefills of the same
    prompt give bit-identical rows); attention and the recurrences read the
    real S positions only. last_only multiplies the unembedding on the
    row tile holding position S-1 alone: the same tile, so the same bits
    as the full product, without the [B,S,Vpad] logits."""
    h, rope, S = _embed(params, tokens, cfg, vision_embeds)
    enc = _encode(params, frames, cfg) if cfg.is_encdec else None
    x, caches, _ = _run_blocks(params, h, cfg, S=S, rope=rope, enc=enc)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps).to(torch.bfloat16)
    if last_only:
        t0 = (S - 1) // L.ROW_TILE * L.ROW_TILE
        tile = L.linear(h[:, t0:t0 + L.ROW_TILE], params["unembed"])
        return tile[:, S - 1 - t0], caches
    return L.linear(h, params["unembed"])[:, :S], caches


def whole_kinds(cfg: ModelConfig, tp: int) -> set:
    """The recurrent kinds each of tp ranks computes whole: those whose
    channels (and gate blocks) or heads do not split evenly."""
    kinds = set(cfg.block_pattern) | set(cfg.pattern_tail)
    whole = set()
    if tp > 1 and "rglru" in kinds and (
            cfg.rglru_width % tp or R.gate_blocks(cfg) % tp):
        whole.add("rglru")
    if tp > 1 and "rwkv" in kinds and cfg.n_heads % tp:
        whole.add("rwkv")
    return whole


class _Ranks:
    """One rank of the per-rank forward over a DeviceMesh (the port's
    counterpart of the JAX package's GSPMD layout): the rank computes on
    its local shards of what parallel/rules.py places (apply_shardings,
    or bridge.rank_shards for serving), with the collectives of
    parallel/collectives.py between them. Train mode (the sharded train
    step), prefill and decode (serving) share it.

    - The batch is split over the dp axes; the loss is a mean over ranks.
    - FSDP (plan.fsdp): a weight's dim sharded over the dp axes is
      all-gathered before its block runs (the gradient reduce-scattered).
    - TP: column weights (wq, w_gate, w_up) hold this rank's heads or ff
      columns; the row weights (wo, w_down) its rows, whose product is
      this rank's share of the output, summed over the tp ranks in f32
      and rounded to bf16 once. wk / wv are replicated: the rank keeps
      the KV heads its query heads read (local_kv). The embedding's
      columns and the unembedding's vocabulary are split over tp. The
      recurrent blocks hold their channels or heads over tp
      (models/recurrent.py); a block whose channels or heads do not
      split evenly computes whole on every rank (`whole`).
    - Sequence parallelism (out_dims: plan.seq_shard_acts, S % tp == 0):
      the residual stream holds this rank's S / tp positions; a
      sublayer gathers the sequence on entry and its share of the output
      is reduce-scattered back onto the positions.
    - The decode caches (init_cache, grow_caches): under plan.kv_cache
      "replicated" an attention unit's k / v hold the KV heads the
      rank's query heads read, at every position; under "seq_sharded"
      a global unit's hold every KV head at the rank's Smax / tp
      positions (flash-decoding, kernel #5, merges the ranks' partials),
      and window rings stay whole. A "dec" unit's cross caches xk / xv
      follow the layout over the encoder's Se positions (cross_local:
      whole where tp does not divide Se, as rules._validated drops the
      axis). Recurrent states hold the rank's channels or heads.
    - The modality stubs are the rank's rows: a VLM's vision embeddings
      go before its tokens (the M-RoPE positions and sequence
      parallelism cover Nv + S positions); an encoder-decoder's frames
      go through the encoder per rank (_encode), whose whole output each
      rank's cross-attention reads.

    At tp 1 every product is the one-device forward's (row tiles
    included), so a 1 x 1 mesh computes the one-device step's values."""

    def __init__(self, cfg: ModelConfig, env: Env, S: int):
        self.cfg, self.env = cfg, env
        self.tp_axis, self.tp = env.tp_axis, env.tp
        self.sp = out_dims(env, S)[1] is not None
        self.specs = param_specs(cfg, env)
        self.heads_split = self.tp > 1 and head_pad(cfg, env) % self.tp == 0
        self.ff_split = self.tp > 1 and cfg.d_ff % self.tp == 0
        self.kv_seq = env.plan.kv_cache == "seq_sharded"
        self.whole = whole_kinds(cfg, self.tp)

    def on_tp(self, spec, dim: int) -> bool:
        """Whether a leaf's dim is split over tp ranks."""
        return self.tp > 1 and self.tp_axis in rules.axes_of(
            spec[dim] if len(spec) > dim else None)

    def unshard(self, p, path):
        """p with every dim sharded over the dp axes all-gathered (FSDP),
        and, for a recurrent block computed whole, over tp too; the MoE
        experts are gathered by moe_layer."""
        spec = self.specs
        for k in path:
            spec = spec[k]
        kind = {"blocks": self.cfg.block_pattern,
                "tail": self.cfg.pattern_tail,
                "enc_blocks": ("enc",)}[path[0]][path[1]]
        if not self.env.plan.fsdp and kind not in self.whole:
            return p  # no spec names a dp axis without FSDP
        dp = set(self.env.dp_axes)
        whole = dp | ({self.tp_axis} if kind in self.whole else set())

        def one(names, x, sp):
            if "moe" in names and names[-1] != "router":
                return x
            on = whole if names[0] in ("rec", "mix") else dp
            # a stacked leaf's spec names its layer dim, which x lacks
            for d, e in enumerate(sp[len(sp) - x.dim():]):
                axes = tuple(a for a in rules.axes_of(e) if a in on)
                if axes:
                    x = C.gather(x, self.env, axes, d)
            return x

        return rules._tree_map_with_names(one, p, spec)

    def cross_local(self, x, dim: int):
        """A cross cache's encoder positions (dim) this rank holds under
        the seq_sharded layout: its tp chunk, or all of them where tp does
        not divide them (rules._validated drops the axis)."""
        n = x.shape[dim]
        if n % self.tp:
            return x
        r = C.axis_rank(self.env, self.tp_axis)
        return x.narrow(dim, r * (n // self.tp), n // self.tp)

    def cross_len(self, n: int) -> int:
        """The length of cross_local's chunk of n encoder positions."""
        return n if n % self.tp else n // self.tp

    def enter(self, x):
        """A sublayer's input: the whole sequence under sequence
        parallelism (gathered over tp), x as it is otherwise."""
        return C.gather(x, self.env, self.tp_axis, 1) if self.sp else x

    def gather(self, x, dim: int):
        """x's dim, split over tp, gathered."""
        return C.gather(x, self.env, self.tp_axis, dim)

    def local(self, x, dim: int):
        """This rank's tp chunk of dim of a value replicated over tp."""
        return C.split(x, self.env, self.tp_axis, dim)

    def row(self, x, w, split: bool):
        """x @ w for a row weight w: split, w holds this rank's rows and the
        shares are summed over tp (reduce-scattered onto the positions
        under sequence parallelism); a whole w gives the whole product on
        every rank."""
        if self.tp == 1 or not split:
            y = L.linear(x, w)
            return C.split(y, self.env, self.tp_axis, 1) if self.sp else y
        y = x.float() @ w.float()
        y = (C.reduce_scatter(y, self.env, self.tp_axis, 1) if self.sp
             else C.all_reduce(y, self.env, (self.tp_axis,)))
        return y.to(torch.bfloat16)

    def mlp(self, p, x):
        """layers.mlp over this rank's ff columns."""
        x = self.enter(x)
        h = L.silu(L.linear(x, p["w_gate"])) * L.linear(x, p["w_up"])
        return self.row(h, p["w_down"], self.ff_split)

    def kv_index(self, hkv: int):
        """Which of hkv KV heads this rank's query heads read: rank r holds
        query heads r*hq_local ... and query head h reads KV head h // G
        (G = padded heads / Hkv). A slice (a whole group, or a part of
        one, keeps the grouping), or, where the rank's heads straddle
        groups unevenly, a list: each query head its own KV head."""
        hq_local = head_pad(self.cfg, self.env) // self.tp
        if not self.heads_split:
            return slice(0, hkv)
        G = hq_local * self.tp // hkv
        r = C.axis_rank(self.env, self.tp_axis)
        idx = [(r * hq_local + i) // G for i in range(hq_local)]
        lo, n = idx[0], idx[-1] + 1 - idx[0]
        if hq_local % n == 0 and idx == [lo + i // (hq_local // n)
                                        for i in range(hq_local)]:
            return slice(lo, lo + n)
        return idx

    def local_kv(self, k, v, dim: int = 2):
        """The KV heads (dim) of k / v that this rank's query heads read
        (kv_index)."""
        sel = self.kv_index(k.shape[dim])
        if isinstance(sel, slice):
            return k.narrow(dim, sel.start, sel.stop - sel.start), \
                v.narrow(dim, sel.start, sel.stop - sel.start)
        sel = torch.tensor(sel, device=k.device)
        return k.index_select(dim, sel), v.index_select(dim, sel)

    def n_kv_local(self) -> int:
        sel = self.kv_index(kv_head_pad(self.cfg, self.env))
        return (sel.stop - sel.start) if isinstance(sel, slice) else len(sel)


@functools.lru_cache(maxsize=8)
def param_specs(cfg: ModelConfig, env: Env):
    """The parameter specs (parallel/rules.py) of init_params' tree over
    env.mesh."""
    return rules.param_specs(init_params(cfg, env, device="meta"), cfg, env)


def _embed_ranks(params, tokens, rk: _Ranks):
    """This rank's tokens' embeddings, whole: the embedding's columns
    gathered over tp."""
    h = params["embed"][tokens.long()].to(torch.bfloat16)
    if rk.on_tp(rk.specs["embed"], 1):
        h = C.gather(h, rk.env, rk.tp_axis, h.dim() - 1)
    return h


def _stack_ranks(params, tokens, cfg: ModelConfig, env: Env, vision_embeds,
                 frames, plan=None):
    """The per-rank stack of prefill and train mode over env.mesh
    (_Ranks): params are this rank's shards, tokens and the stubs its
    rows. A VLM's vision embeddings go first (the positions and the
    sequence parallelism cover Nv + S); an encoder-decoder runs its
    encoder per rank first. At tp 1 each sequence is padded to whole row
    tiles as on one device (the same bits); at tp > 1 the residual
    stream is split over the positions when tp divides them (sequence
    parallelism). Returns (the final norm's output [B/dp, S(p), d] bf16,
    whole over the sequence, the prompt caches (None under a training
    plan), the MoE aux loss, S)."""
    h, rope = _with_vision(_embed_ranks(params, tokens, _Ranks(cfg, env, 1)),
                           cfg, vision_embeds)
    S = h.shape[1]
    rk = _Ranks(cfg, env, S)
    if rk.tp == 1:
        h = _pad_rows(h, S)
    if rk.sp:
        h = C.split(h, env, rk.tp_axis, 1)
    enc = _encode(params, frames, cfg, plan, env) if cfg.is_encdec else None
    x, caches, aux = _run_blocks(params, h, cfg, S=S, rope=rope, plan=plan,
                                 ranks=rk, enc=enc)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps).to(torch.bfloat16)
    return rk.enter(h), caches, aux, S


def _train_sharded(params, tokens, cfg: ModelConfig, env: Env,
                   vision_embeds=None, frames=None):
    """forward(mode="train") per rank over env.mesh (_stack_ranks):
    params are this rank's shards, tokens and the stubs its rows [B/dp,
    ...]. Returns (this rank's logits [B/dp, S, Vpad / tp] — its
    vocabulary columns; a VLM's over its vision positions too —, the MoE
    aux loss, a mean over the mesh's ranks)."""
    h, _, aux, S = _stack_ranks(params, tokens, cfg, env, vision_embeds,
                                frames, env.plan)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    return L.linear(h, params["unembed"])[:, :S], aux


def _prefill_sharded(params, tokens, cfg: ModelConfig, env: Env,
                     last_only: bool, vision_embeds=None, frames=None):
    """forward(mode="prefill") per rank over env.mesh (_stack_ranks):
    params are this rank's shards, tokens and the stubs its rows [B/dp,
    ...]. Returns (this rank's logits, its vocabulary columns: [B/dp, S,
    Vpad/tp], or [B/dp, Vpad/tp] with last_only; its prompt caches, in the
    layout _Ranks describes)."""
    h, caches, _, S = _stack_ranks(params, tokens, cfg, env, vision_embeds,
                                   frames)
    if last_only:
        t0 = (S - 1) // L.ROW_TILE * L.ROW_TILE
        tile = L.linear(h[:, t0:t0 + L.ROW_TILE], params["unembed"])
        return tile[:, S - 1 - t0], caches
    return L.linear(h, params["unembed"])[:, :S], caches


def _train(params, tokens, cfg: ModelConfig, env: Env, vision_embeds=None,
           frames=None):
    """forward(mode="train"): tokens [B,S] -> (logits [B,S,Vpad] — a
    VLM's over its vision positions too —, the summed MoE aux loss),
    under autograd. Prefill's stack on the same row tiles (so the logits
    are prefill's wherever the blocks' training forms compute what the
    kernels compute); the padding positions reach no real position, so
    they carry no gradient into a loss over the first S. Over a
    DeviceMesh, the sharded train forward (_train_sharded)."""
    if sharded(cfg, env):
        return _train_sharded(params, tokens, cfg, env, vision_embeds,
                              frames)
    h, rope, S = _embed(params, tokens, cfg, vision_embeds)
    enc = (_encode(params, frames, cfg, env.plan) if cfg.is_encdec
           else None)
    x, _, aux = _run_blocks(params, h, cfg, S=S, rope=rope, plan=env.plan,
                            enc=enc)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps).to(torch.bfloat16)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    return L.linear(h, params["unembed"])[:, :S], aux


def forward(params, tokens, cfg: ModelConfig, env: Env, mode: str = "decode",
            caches=None, cur_len=None, block_tables=None, row_slots=None,
            last_only: bool = False, vision_embeds=None, frames=None):
    """mode="prefill": tokens [B,S] (whole prompts); returns (logits
    [B,S,Vpad] bf16 — [B,Vpad] of the last position with last_only —,
    caches in the init_cache layout at the prompt's length: attention k/v
    after rope, local rings ring-aligned, post-prompt recurrent states),
    ready for grow_caches or a pool insert. A VLM takes vision_embeds
    [B,Nv,d] (the patch embedder's stub) before the prompt: its logits
    and caches cover Nv + S positions. An encoder-decoder takes frames
    [B,Se,d] (the conv front end's stub) through its encoder; its "dec"
    caches add xk/xv [B,Hkv,Se,hd].

    mode="decode": tokens [B,1] int (one token per row). cur_len: [B] int
    (or a scalar) KV write position == attention depth of each row.
    block_tables (paged cache): {"global": [B,MB] int32, "local":
    [B,MBw] int32 (window units)} block tables into caches from
    init_paged_cache (bf16 or quant); without it, caches is a contiguous
    init_cache cache with one row per batch row, or, given row_slots ([B]
    int, -1 masked), with row b addressing slot row_slots[b] (attention
    archs only). Recurrent state rows: row b of the cache is batch row
    b's, so the cache holds exactly B rows. The caches are updated in
    place. Returns (logits [B,1,Vpad] bf16, caches).

    mode="train": tokens [B,S] (and the stubs, as prefill); returns
    (logits [B,S,Vpad] bf16, the summed MoE aux loss, f32 scalar),
    differentiable in params (see the module docstring; attention follows
    env.plan.attn_impl).

    A VLM decodes at M-RoPE position g + cur_len - Nv on every component
    (build_mrope_positions); an encoder-decoder's decode reads its cross
    caches and runs no encoder.

    Every row-wise op runs on rows padded to a multiple of layers.ROW_TILE
    (batch invariance, see models/layers.py); the padding rows never touch
    the cache.

    Over a DeviceMesh (models/env.py sharded) every mode runs per rank
    (_Ranks): params are the rank's shards (bridge.rank_shards, or
    parallel/rules.py apply_shardings), tokens and the stubs its rows,
    the logits its vocabulary columns and the caches its own
    (init_cache, grow_caches; a contiguous cache: block tables and row
    slots, the engines' pools, raise NotImplementedError there). Decode under the seq_sharded
    layout takes one cur_len for every row (the one-shot's uniform
    batch)."""
    check_supported(cfg)
    per_rank = sharded(cfg, env)
    if mode == "prefill":
        if per_rank:
            return _prefill_sharded(params, tokens, cfg, env, last_only,
                                    vision_embeds, frames)
        return _prefill(params, tokens, cfg, last_only, vision_embeds, frames)
    if mode == "train":
        return _train(params, tokens, cfg, env, vision_embeds, frames)
    if mode != "decode":
        raise ValueError(f"mode={mode!r}: one of train, prefill, decode")
    B = tokens.shape[0]
    Bp = -(-B // L.ROW_TILE) * L.ROW_TILE
    cl = torch.as_tensor(cur_len, device=tokens.device).long()
    rk = None
    if per_rank:
        if block_tables is not None or row_slots is not None:
            raise NotImplementedError(
                "decode over a mesh reads a contiguous cache: the engines' "
                "pools (block tables, row slots) over a mesh are ROADMAP "
                "item 12")
        rk = _Ranks(cfg, env, 1)
        if rk.kv_seq and cl.ndim:
            raise ValueError("decode under the seq_sharded layout takes one "
                             "cur_len for every row")
    cl = cl.expand(B) if cl.ndim == 0 else cl
    clp = F.pad(cl, (0, Bp - B))
    pos = (build_mrope_positions(1, cfg.num_vision_embeds, cur_len=clp,
                                 device=clp.device) if cfg.mrope
           else clp[:, None])
    rope = _rope_of(cfg, pos)  # [Bp,1,1,hd/2] each
    tok = F.pad(tokens[:, 0].long(), (0, Bp - B))
    if rk is None:
        h = params["embed"][tok][:, None, :].to(torch.bfloat16)  # [Bp,1,d]
    else:
        h = _embed_ranks(params, tok, rk)[:, None, :]
    x, _, _ = _run_blocks(params, h, cfg, caches, rope=rope, n_rows=B,
                          cur_len=cl, tables=block_tables,
                          row_slots=row_slots, ranks=rk)
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps).to(torch.bfloat16)
    logits = L.linear(h, params["unembed"])[:B]
    return logits, caches


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def token_logprobs(logits, labels, cfg: ModelConfig, env: Env = None):
    """(log-partition, label logit) per position, f32 [B,S] each, from
    logits [B,S,Vpad]: the padded vocabulary columns are masked to -1e30
    before the log-sum-exp, and the label's column is picked by an index
    comparison summed over the vocabulary (as the reference reads it).

    Logits narrower than vocab_pad(cfg, env) are this rank's vocabulary
    columns (the sharded train forward): the max, the sum of
    exponentials and the label's logit are taken over the tp ranks."""
    lf = logits.float()
    vl = lf.shape[-1]
    split = env is not None and vl != vocab_pad(cfg, env)
    off = C.axis_rank(env, env.tp_axis) * vl if split else 0
    viota = torch.arange(off, off + vl, device=lf.device)
    lf = torch.where(viota < cfg.vocab_size, lf, -1e30)
    ll = torch.sum(torch.where(viota == labels[..., None], lf, 0.0), dim=-1)
    if not split:
        return torch.logsumexp(lf, dim=-1), ll
    tp = (env.tp_axis,)
    m = C.all_reduce_max(lf.detach().amax(dim=-1), env, tp)
    se = C.all_reduce(torch.exp(lf - m[..., None]).sum(dim=-1), env, tp)
    return m + torch.log(se), C.all_reduce(ll, env, tp)


def lm_loss(params, batch, cfg: ModelConfig, env: Env,
            aux_weight: float = 0.01):
    """batch {"tokens": [B,S], "labels": [B,S]} (plus "vision_embeds" or
    "frames", the modality stubs) -> (loss, {"ce", "aux"}): the mean
    next-token cross-entropy of train mode's logits (a VLM's over its
    text positions only) plus aux_weight times the MoE aux loss (the
    reference's lm_loss).

    Over a DeviceMesh (the sharded train forward) batch holds this
    rank's rows, and the loss, its "ce" and its "aux" are means over the
    mesh's ranks, the same value on every rank."""
    logits, aux = forward(params, batch["tokens"], cfg, env, mode="train",
                          vision_embeds=batch.get("vision_embeds"),
                          frames=batch.get("frames"))
    if cfg.family == "vlm":
        logits = logits[:, cfg.num_vision_embeds:]
    logz, ll = token_logprobs(logits, batch["labels"], cfg, env)
    loss = torch.mean(logz - ll)
    if sharded(cfg, env):
        return (C.loss_mean(loss + aux_weight * aux, env),
                {"ce": C.mesh_mean(loss.detach(), env), "aux": aux})
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}
