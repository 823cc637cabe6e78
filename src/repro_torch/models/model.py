"""Model assembly for serving: embed -> layers -> norm -> unembed.

Port of the JAX package's models/model.py for what serving a dense
attention-only model needs: parameter init, the contiguous and paged
caches, the slot-pool and paged-pool helpers behind the KV backends, and
forward in two modes: "prefill" (a whole prompt at once, emitting its K/V)
and "decode" (one token per row over a contiguous cache or block tables).
The JAX layer scan becomes a Python loop over the stacked `blocks` leaves
(parameters and caches keep the JAX layout: a leading layer axis).

Unlike the JAX package's pure functions, the cache ops here update the
cache tensors in place (one pool, no copy per step); they still return the
cache so call sites read as in the reference.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.models import layers as L
from repro_torch.models.env import Env, head_pad, kv_head_pad, vocab_pad

Pytree = Any

PAGEABLE_KINDS = ("attn",)
# prompts longer than this take the flash kernel in prefill, shorter ones
# attention_naive: the JAX package's pallas-plan dispatch (Sq > 128)
FLASH_MIN_LEN = 128


def check_supported(cfg: ModelConfig) -> None:
    """The port serves dense attention-only decoders so far."""
    kinds = set(cfg.block_pattern) | set(cfg.pattern_tail)
    if (kinds != {"attn"} or cfg.qkv_bias or cfg.qk_norm or cfg.mrope
            or cfg.is_encdec or cfg.family == "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention-only decoders "
            f"(block kinds {sorted(kinds)})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn_block(gen: torch.Generator, cfg: ModelConfig, env: Env) -> dict:
    hq, hkv = head_pad(cfg, env), kv_head_pad(cfg, env)
    hd, d = cfg.head_dim, cfg.d_model
    z = torch.zeros((d,), dtype=torch.float32, device=gen.device)
    return {"ln1": z,
            "attn": {"wq": L.dense_init(gen, d, hq * hd),
                     "wk": L.dense_init(gen, d, hkv * hd),
                     "wv": L.dense_init(gen, d, hkv * hd),
                     "wo": L.dense_init(gen, hq * hd, d)},
            "ln2": z.clone(),
            "mlp": {"w_gate": L.dense_init(gen, d, cfg.d_ff),
                    "w_up": L.dense_init(gen, d, cfg.d_ff),
                    "w_down": L.dense_init(gen, cfg.d_ff, d)}}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, env: Env, *, seed: int = 0,
                device="cuda") -> Pytree:
    """Seeded random parameters with the JAX package's shapes, dtypes and
    scales (Mo.init_params): `blocks` leaves stacked on a leading layer
    axis, vocabulary padded to vocab_pad. Drawn from a torch.Generator on
    `device`, so the values are not jax's; tests that compare the two
    packages bridge jax's parameters instead (repro_torch/bridge.py)."""
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, vp = cfg.d_model, vocab_pad(cfg, env)
    return {
        "embed": L.dense_init(gen, vp, d),
        "blocks": (_stack([_init_attn_block(gen, cfg, env)
                           for _ in range(cfg.num_blocks)]),),
        "tail": (),
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=device),
        "unembed": L.dense_init(gen, d, vp),
    }


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, env: Env, batch: int, max_len: int, *,
               device="cuda") -> Pytree:
    """Contiguous decode cache: k/v [L, B, Hkv, max_len, hd] bf16."""
    shape = (cfg.num_blocks, batch, kv_head_pad(cfg, env), max_len,
             cfg.head_dim)
    return {"blocks": ({"k": torch.zeros(shape, dtype=torch.bfloat16,
                                         device=device),
                        "v": torch.zeros(shape, dtype=torch.bfloat16,
                                         device=device)},),
            "tail": ()}


def init_paged_cache(cfg: ModelConfig, env: Env, num_blocks: int,
                     block_size: int, *, quant: bool = False,
                     device="cuda") -> Pytree:
    """Block-pooled decode cache: k/v [L, NB, Hkv, bs, hd] bf16, shared by
    every request through per-request block tables; physical block 0 is
    the null block that absorbs masked rows' writes.

    With quant=True, k/v store int8 values plus per-row f32 dequant scales
    k_scale/v_scale [L, NB, Hkv, bs] (one scale per (block, head, token)
    over the head dim): (hd + 4) / (2 hd) of the bf16 pool's bytes. The
    decode path dispatches on the presence of "k_scale"."""
    if not quant:
        return init_cache(cfg, env, num_blocks, block_size, device=device)
    shape = (cfg.num_blocks, num_blocks, kv_head_pad(cfg, env), block_size,
             cfg.head_dim)
    z = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
    return {"blocks": ({"k": z(shape, torch.int8),
                        "v": z(shape, torch.int8),
                        "k_scale": z(shape[:-1], torch.float32),
                        "v_scale": z(shape[:-1], torch.float32)},),
            "tail": ()}


def grow_caches(caches: Pytree, extra: int) -> Pytree:
    """Extend prefill-emitted KV caches ([L,B,Hkv,S,hd], length == prompt)
    by `extra` zero positions so decode can append (attention units only:
    the port has no window rings or recurrent state)."""
    def grow(d):
        return {n: F.pad(x, (0, 0, 0, extra)) if n in ("k", "v")
                and x.dtype == torch.bfloat16 else x for n, x in d.items()}

    return {"blocks": tuple(grow(d) for d in caches["blocks"]),
            "tail": caches["tail"]}


# Slot-pool cache ops (serve/slots.py). A pooled cache is an init_cache()
# cache whose batch axis is the slot axis: leaves [L, num_slots, H, S, hd].
# They work in place and return the pool.


def cache_insert_slot(pool: Pytree, request: Pytree, slot: int) -> Pytree:
    """Write a batch-1 cache (grown to the pool's length with grow_caches)
    into `slot`; every leaf of the slot is overwritten, so freed slots need
    no zeroing before reuse."""
    for dst, src in zip(_kv_leaves(pool), _kv_leaves(request)):
        dst[:, slot] = src[:, 0].to(dst.dtype)
    return pool


def cache_evict_slot(pool: Pytree, slot: int) -> Pytree:
    """Zero `slot` (hygiene and tests: insert overwrites the whole slot)."""
    for leaf in _kv_leaves(pool):
        leaf[:, slot] = 0
    return pool


def cache_read_slot(pool: Pytree, slot: int) -> Pytree:
    """`slot` as a batch-1 cache (a copy; inverse of insert)."""
    return {"blocks": tuple({n: x[:, slot:slot + 1].clone()
                             for n, x in unit.items()}
                            for unit in pool["blocks"]),
            "tail": ()}


# Paged-pool helpers (serve/blocks.py). The JAX package builds them as
# closures to jit; here they work in place on the pool's leaves: k/v
# [L,NB,H,bs,hd] and, in a quant pool, the scales [L,NB,H,bs] (no head-dim
# axis). The port's pools hold global-attention blocks only, so there are
# no window tables and no row-addressed recurrent state.


def _kv_leaves(pool: Pytree):
    return [leaf for unit in pool["blocks"] for leaf in unit.values()]


def _seq_axis_last(leaf) -> bool:
    """Scale leaves [L,NB,H,bs] end on the token axis; k/v on head_dim."""
    return leaf.dim() == 4


def make_paged_insert(cfg: ModelConfig, block_size: int):
    """Scatter a batch-1 cache ([L,1,Hkv,S,hd] leaves; a quant request from
    quantize_paged_request adds [L,1,Hkv,S] scales) into the blocks its
    table names, block_size positions per block (unallocated entries are 0:
    padding lands in the null block)."""
    bs = block_size

    def insert(pool, request, tables):
        for dst, src in zip(_kv_leaves(pool), _kv_leaves(request)):
            if _seq_axis_last(dst):  # [L,1,H,S] -> chunks [L,nb,H,bs]
                Lyr, _, H, S = src.shape
                nb = -(-S // bs)
                src = F.pad(src, (0, nb * bs - S)).to(dst.dtype)
                chunks = src.reshape(Lyr, H, nb, bs).transpose(1, 2)
            else:  # [L,1,H,S,hd] -> chunks [L,nb,H,bs,hd]
                Lyr, _, H, S, hd = src.shape
                nb = -(-S // bs)
                src = F.pad(src, (0, 0, 0, nb * bs - S)).to(dst.dtype)
                chunks = src.reshape(Lyr, H, nb, bs, hd).transpose(1, 2)
            dst[:, tables[:nb].long()] = chunks
        return pool

    return insert


def make_paged_copy(cfg: ModelConfig):
    """Copy one physical block's K/V (and scales; every layer) from `src`
    to `dst` — the copy-on-write step behind prefix sharing
    (serve/blocks.py)."""
    def copy(pool, src: int, dst: int):
        for leaf in _kv_leaves(pool):
            leaf[:, dst] = leaf[:, src]
        return pool

    return copy


def make_paged_evict(cfg: ModelConfig):
    """Zero the blocks a table names — hygiene only; allocation hygiene
    lives in the BlockManager free list."""
    def evict(pool, tables):
        for leaf in _kv_leaves(pool):
            leaf[:, tables.long()] = 0
        return pool

    return evict


def make_paged_read(cfg: ModelConfig):
    """Gather one slot back out of a pool as a batch-1 cache (inverse of
    insert). `valid` masks unallocated table entries, so a freed slot
    reads as zeros whatever masked rows left in the null block."""
    def read(pool, tables, valid):
        units = []
        for unit in pool["blocks"]:
            out = {}
            for name, leaf in unit.items():
                g = leaf[:, tables.long()]  # [L,MB,H,bs(,hd)]
                ok = valid.to(leaf.dtype).reshape(
                    (1, -1) + (1,) * (g.dim() - 2))
                g = (g * ok).transpose(1, 2)
                Lyr, H, MB, bs = g.shape[:4]
                out[name] = g.reshape(Lyr, 1, H, MB * bs, *g.shape[4:])
            units.append(out)
        return {"blocks": tuple(units), "tail": ()}

    return read


def quantize_paged_request(cfg: ModelConfig, request: Pytree) -> Pytree:
    """Expand a batch-1 fp cache ({"k","v"} per unit) into the quant pool's
    structure ({"k","v","k_scale","v_scale"}): symmetric int8 over the
    head dim, one f32 scale per (head, position) — insertable into a quant
    pool with make_paged_insert."""
    def unit(d):
        kq, ks = pd_ops.quantize_kv(d["k"])
        vq, vs = pd_ops.quantize_kv(d["v"])
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}

    return {"blocks": tuple(unit(d) for d in request["blocks"]),
            "tail": ()}


def dequantize_paged_request(cfg: ModelConfig, request: Pytree) -> Pytree:
    """Inverse of quantize_paged_request (up to quantization error): fold
    the scales back into bf16 {"k","v"} units — what make_paged_read
    returns from a quant pool becomes comparable to an fp read."""
    def unit(d):
        return {n: (d[n].float() * d[f"{n}_scale"][..., None]).to(
            torch.bfloat16) for n in ("k", "v")}

    return {"blocks": tuple(unit(d) for d in request["blocks"]),
            "tail": ()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _attn_prefill(p, h, cfg: ModelConfig, S: int, rope):
    """Prefill attention over the first S (real) positions of the
    row-padded h [B,Sp,d]: causal, global (window 0, no cross-attention).
    Prompts longer than FLASH_MIN_LEN go through the flash kernel, shorter
    ones through attention_naive, as the JAX package's pallas plan
    dispatches; padding positions never enter attention (their output rows
    are zeros). rope: (cos, sin) of positions 0..S-1. Returns (out
    [B,Sp,d], {"k","v"} [B,Hkv,S,hd] after rope)."""
    q, k, v = L._project_qkv(p, h, cfg)  # [B,Sp,H,hd]
    q = L.rotate(q[:, :S], *rope)
    k = L.rotate(k[:, :S], *rope)
    v = v[:, :S]
    if S > FLASH_MIN_LEN:
        o = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True,
                                   n_kv_heads=k.shape[2])
    else:
        o = L.attention_naive(q, k, v, cfg, causal=True)
    o = F.pad(o, (0, 0, 0, h.shape[1] - S))
    return L.linear(o, p["wo"]), {"k": k.transpose(1, 2),
                                  "v": v.transpose(1, 2)}


def _attn_sublayer(p, h, cfg: ModelConfig, n_rows: int, cur_len, rope,
                   cache, tables):
    """Decode attention for the first n_rows rows of the row-padded h: each
    row writes its token's K/V at cur_len (through its block table, or at
    its own row of a contiguous cache) and attends at its own depth. rope:
    the rows' (cos, sin) from layers.rope_cos_sin. cache: this layer's
    leaves ({"k","v"}, plus "k_scale"/"v_scale" in a quant pool)."""
    q, k, v = L._project_qkv(p, h, cfg)  # [Bp,1,H,hd]
    q = L.rotate(q, *rope)[:n_rows]
    k = L.rotate(k, *rope)[:n_rows, 0]
    v = v[:n_rows, 0]
    ck, cv = cache["k"], cache["v"]
    if tables is not None:
        bs = ck.shape[-2]
        phys = torch.gather(tables, 1, (cur_len // bs)[:, None])[:, 0].long()
        off = cur_len % bs
        lengths = cur_len.to(torch.int32)
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
    else:
        rows = torch.arange(n_rows, device=h.device)
        ck[rows, :, cur_len] = k.to(ck.dtype)
        cv[rows, :, cur_len] = v.to(cv.dtype)
        o = L.attention_decode(q, ck, cv, cur_len, cfg)
    o = F.pad(o, (0, 0, 0, 0, 0, h.shape[0] - n_rows))
    return L.linear(o, p["wo"])


def _block(p, h, eps: float, attn):
    """One attention unit: h + attn(norm(h)), then h + mlp(norm(h)).
    attn(x) returns (out, cache entries or None)."""
    a, kv = attn(L.rms_norm(h, p["ln1"], eps))
    # the reference (XLA) fuses this residual add into the next norm: the
    # norm reads the f32 sum, the residual stream its bf16 rounding
    hf = h.float() + a.float()
    h = hf.to(torch.bfloat16)
    hn = L.rms_norm(hf, p["ln2"], eps).to(torch.bfloat16)
    return h + L.mlp(p["mlp"], hn), kv


def _prefill(params, tokens, cfg: ModelConfig):
    """forward(mode="prefill"): tokens [B,S] -> (logits [B,S,Vpad], caches
    {"k","v"} [L,B,Hkv,S,hd]).

    Each sequence is padded to a multiple of layers.ROW_TILE positions, so
    every `linear` tile holds rows of one sequence only and a prompt's rows
    do not depend on the batch around it (B=1 and B=16 prefills of the same
    prompt give bit-identical rows); attention reads the real S positions
    only."""
    B, S = tokens.shape
    Sp = -(-S // L.ROW_TILE) * L.ROW_TILE
    tok = F.pad(tokens.long(), (0, Sp - S))
    h = params["embed"][tok].to(torch.bfloat16)  # [B,Sp,d]
    rope = L.rope_cos_sin(torch.arange(S, device=tokens.device),
                          cfg.head_dim, cfg.rope_theta)  # [S,1,hd/2] each
    blocks, eps = params["blocks"][0], cfg.norm_eps
    ks, vs = [], []
    for i in range(cfg.num_blocks):
        p = _layer(blocks, i)
        h, kv = _block(p, h, eps, lambda x: _attn_prefill(
            p["attn"], x, cfg, S, rope))
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = L.rms_norm(h, params["final_norm"], eps)
    logits = L.linear(h, params["unembed"])[:, :S]
    return logits, {"blocks": ({"k": torch.stack(ks),
                                "v": torch.stack(vs)},), "tail": ()}


def forward(params, tokens, cfg: ModelConfig, env: Env, mode: str = "decode",
            caches=None, cur_len=None, block_tables=None):
    """mode="prefill": tokens [B,S] (whole prompts); returns (logits
    [B,S,Vpad] bf16, caches {"blocks": ({"k","v"} [L,B,Hkv,S,hd],),
    "tail": ()}), the K/V after rope, ready for grow_caches or a pool
    insert.

    mode="decode": tokens [B,1] int (one token per row). cur_len: [B] int
    (or a scalar) KV write position == attention depth of each row.
    block_tables (paged cache): {"global": [B,MB] int32} block tables into
    caches from init_paged_cache (bf16 or quant); without it, caches is a
    contiguous init_cache cache with one row per batch row. The caches are
    updated in place. Returns (logits [B,1,Vpad] bf16, caches).

    Every row-wise op runs on rows padded to a multiple of layers.ROW_TILE
    (batch invariance, see models/layers.py); the padding rows never touch
    the cache. mode="train" waits for the training slice."""
    check_supported(cfg)
    if mode == "prefill":
        return _prefill(params, tokens, cfg)
    if mode != "decode":
        raise NotImplementedError(
            f"mode={mode!r}: the port runs prefill and decode (training "
            "comes with the training slice)")
    B = tokens.shape[0]
    Bp = -(-B // L.ROW_TILE) * L.ROW_TILE
    cl = torch.as_tensor(cur_len, device=tokens.device).long()
    cl = cl.expand(B) if cl.ndim == 0 else cl
    rope = L.rope_cos_sin(F.pad(cl, (0, Bp - B))[:, None], cfg.head_dim,
                          cfg.rope_theta)  # [Bp,1,1,hd/2] each
    tok = F.pad(tokens[:, 0].long(), (0, Bp - B))
    h = params["embed"][tok][:, None, :].to(torch.bfloat16)  # [Bp,1,d]
    tables = None if block_tables is None else block_tables["global"]
    eps = cfg.norm_eps
    blocks, cache = params["blocks"][0], caches["blocks"][0]
    for i in range(cfg.num_blocks):
        p = _layer(blocks, i)
        h, _ = _block(p, h, eps, lambda x: (_attn_sublayer(
            p["attn"], x, cfg, B, cl, rope, _layer(cache, i), tables), None))
    h = L.rms_norm(h, params["final_norm"], eps)
    logits = L.linear(h, params["unembed"])[:B]
    return logits, caches
