"""Train, prefill and fused decode step builders (port of the JAX
package's launch/steps.py).

PyTorch runs eagerly, so a "step" is a plain function over tensors;
nothing is traced or compiled. The builders keep the JAX names and
closures so the serving code reads as in the reference. Over a
DeviceMesh the train step runs per rank on the local shards of a state of
DTensors (_sharded_train_step), and the prefill and decode steps per rank
on the rank's shards, rows and caches (models/model.py _Ranks): their
logits are the rank's vocabulary columns, which `greedy` reads. The
engines' fused steps over a mesh take every row on every rank and pick
the same tokens on each: greedy rows by the vocabulary-parallel argmax,
sampled rows from the columns gathered over tp (make_sample_fn).
"""
from __future__ import annotations

import torch

from repro_torch import random as R
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.sampling.ops import topk_topp_mask
from repro_torch.models import model as Mo
from repro_torch.models.env import Env, mesh_size, sharded
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_map, value_and_grad)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules

# Packed per-row step metadata: one [META_I_ROWS,T] int32 + one
# [META_F_ROWS,T] float32 upload per decode step (ReplicaEngine.step_decode
# fills them; the fused steps below index through these names). This is
# what keeps the serving loop's per-step host traffic down to two small
# uploads and one [T] token-vector download.
ROW_TOK_SRC = 0  # row in prev_tok holding this row's input token (-1: fresh)
ROW_FRESH = 1    # freshly uploaded input token (prompt chunk / first token)
ROW_CUR_LEN = 2  # KV write position == attention depth for the row
ROW_SEED = 3     # SamplingParams.seed (per-request PRNG root)
ROW_TOP_K = 4    # top-k cutoff (<=0 disables)
ROW_POS0 = 5     # len(prompt)-1 of the row's request (PRNG position base)
META_I_ROWS = 6
ROW_TEMPERATURE = 0  # <=0 lowers the row to greedy argmax
ROW_TOP_P = 1        # nucleus mass (>=1 disables)
META_F_ROWS = 2


def make_train_step(cfg: ModelConfig, env: Env, opt: AdamWConfig):
    """One training step: lm_loss in train mode, its gradient with
    respect to every parameter, one AdamW update. (state, batch) ->
    (new state, {"loss", "ce", "aux"}); state is make_train_state's
    {"params", "opt"}. The new parameters are new tensors; the optimizer
    state is updated in place (optim/adamw.py). Over a DeviceMesh, the
    sharded step (_sharded_train_step)."""
    if sharded(cfg, env):
        return _sharded_train_step(cfg, env, opt)

    def train_step(state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: Mo.lm_loss(p, batch, cfg, env), state["params"])
        new_params, new_opt = adamw_update(grads, state["opt"], opt)
        return ({"params": new_params, "opt": new_opt},
                {"loss": loss, **{k: v.detach() for k, v in metrics.items()}})

    return train_step


def _local(x):
    """A DTensor's local shard (detached), anything else as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local().detach() if isinstance(x, DTensor) else x


def _rewrap(local, like):
    """local (a tree of shards) as DTensors placed as `like`'s leaves."""
    from torch.distributed.tensor import DTensor
    return tree_map(lambda t, d: None if t is None else DTensor.from_local(
        t, d.device_mesh, d.placements, run_check=False, shape=d.shape,
        stride=d.stride()), local, like)


def sync_grads(grads, specs, env: Env):
    """Each leaf's gradient summed (in f32) over the mesh axes its spec
    does not name: the data-parallel sum of a leaf FSDP does not shard,
    and the tp ranks' partial gradients of a replicated one (a norm's
    scale, the router, wk / wv). A leaf sharded over an axis already has
    its own gradient there (FSDP's reduce-scatter, a tp shard's product)."""
    def one(g, spec):
        on = {a for e in spec for a in rules.axes_of(e)}
        axes = tuple(a for a in env.axis_names if a not in on)
        return C.sum_over(g.float(), env, axes).to(g.dtype) if axes else g

    return tree_map(one, grads, specs)


def _sharded_train_step(cfg: ModelConfig, env: Env, opt: AdamWConfig):
    """make_train_step over env.mesh, per rank: the state's leaves are
    DTensors placed by parallel/rules.py (apply_shardings of state_specs)
    and the batch's are this rank's rows (DTensors placed by batch_specs,
    or the rows themselves). The rank computes lm_loss on its shards
    (models/model.py _Ranks), synchronises the gradients (sync_grads) and
    updates its shards of the optimizer state; the new state comes back
    as DTensors placed as the old, and the metrics are the same on every
    rank."""
    specs = Mo.param_specs(cfg, env)

    def train_step(state, batch):
        local = tree_map(_local, state)
        rows = {k: _local(v) for k, v in batch.items()}
        (loss, metrics), grads = value_and_grad(
            lambda p: Mo.lm_loss(p, rows, cfg, env), local["params"])
        grads = sync_grads(grads, specs, env)
        new_params, new_opt = adamw_update(grads, local["opt"], opt,
                                           specs, env)
        return ({"params": _rewrap(new_params, state["params"]),
                 "opt": _rewrap(new_opt, state["opt"])},
                {"loss": loss, **{k: v.detach() for k, v in metrics.items()}})

    return train_step


# ---------------------------------------------------------------------------
# shape builders: meta-device tensors (shapes and dtypes, no storage), the
# JAX package's jax.eval_shape structs; the dry run (launch/roofline.py,
# launch/memory_model.py) reads them
# ---------------------------------------------------------------------------


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """A cell's batch: tokens [B, S] int32 (a VLM's S less its vision
    positions, which the vision embeddings [B, Nv, d] f32 fill), labels
    for train, an encoder-decoder's frames [B, S / enc_downsample, d]
    f32."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "vlm":
        S = S - cfg.num_vision_embeds
    out = {"tokens": _meta((B, S), torch.int32)}
    if shape.kind == "train":
        out["labels"] = _meta((B, S), torch.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _meta((B, cfg.num_vision_embeds, cfg.d_model),
                                     torch.float32)
    if cfg.is_encdec:
        out["frames"] = _meta((B, S // cfg.enc_downsample, cfg.d_model),
                              torch.float32)
    return out


def params_struct(cfg: ModelConfig, env: Env):
    """init_params' tree (padded for env's tp degree) on the meta
    device."""
    return Mo.meta_params(cfg, env)


def state_struct(cfg: ModelConfig, env: Env, opt: AdamWConfig):
    """make_train_state's tree as meta-device tensors: shapes and dtypes,
    no storage (the JAX package's jax.eval_shape of it)."""
    params = params_struct(cfg, env)
    return {"params": params, "opt": adamw_init(params, opt)}


def cache_struct(cfg: ModelConfig, env: Env, shape: ShapeConfig):
    """The contiguous decode cache of a cell (global_batch rows,
    seq_len positions) on the meta device: over a shape-only mesh the
    whole cache (models/model.py init_cache)."""
    return Mo.init_cache(cfg, env, shape.global_batch, shape.seq_len,
                         device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, env: Env,
                opt: AdamWConfig = None):
    """(the step's arguments as meta-device trees, the step) for a cell's
    kind: train (state, batch) -> make_train_step; prefill (params,
    batch) -> make_prefill_step; decode (params, cache, tokens [B, 1]
    int32, cur_len int32) -> make_decode_step. No shardings: the rules
    (parallel/rules.py) resolve the trees' specs over env.mesh, a
    shape-only mesh included. Over a mesh of more than one device the
    train step is the sharded one (it runs over a DeviceMesh's ranks)."""
    opt = opt or AdamWConfig()
    if shape.kind == "train":
        step = (_sharded_train_step(cfg, env, opt) if mesh_size(env) > 1
                else make_train_step(cfg, env, opt))
        return (state_struct(cfg, env, opt), batch_struct(cfg, shape)), step
    params = params_struct(cfg, env)
    if shape.kind == "prefill":
        return (params, batch_struct(cfg, shape)), make_prefill_step(cfg, env)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    cur = _meta((), torch.int32)
    return ((params, cache_struct(cfg, env, shape), tokens, cur),
            make_decode_step(cfg, env))


def make_prefill_step(cfg: ModelConfig, env: Env):
    """Full-sequence prefill: (last-position logits [B,Vpad], the prompt
    caches of Mo.forward) for batch {"tokens": [B,S]}, plus the modality
    stubs "vision_embeds" (a VLM) or "frames" (an encoder-decoder). Only
    the last position's row tile is unembedded (the same bits as the full
    logits, without the [B,S,Vpad] tensor). Over a DeviceMesh, per rank:
    its rows, its vocabulary columns, its caches; an engine's classic
    admission prefills its batch of one on every rank (the rows whole),
    its caches holding the heads and channels of the rank's pool."""
    def prefill_step(params, batch):
        return Mo.forward(params, batch["tokens"], cfg, env, mode="prefill",
                          last_only=True,
                          vision_embeds=batch.get("vision_embeds"),
                          frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg: ModelConfig, env: Env):
    """Contiguous-cache decode: (logits [B,Vpad], caches) for one token per
    row at write position cur_len (the one-shot baseline's step); over a
    DeviceMesh per rank, as make_prefill_step."""
    def decode_step(params, caches, tokens, cur_len):
        logits, new_caches = Mo.forward(params, tokens, cfg, env,
                                        mode="decode", caches=caches,
                                        cur_len=cur_len)
        return logits[:, 0, :], new_caches

    return decode_step


def greedy(logits, cfg: ModelConfig, env: Env):
    """The greedy tokens [B, 1] int32 of step logits [B, Vpad]: the
    argmax over the first vocab_size columns; per rank over a DeviceMesh
    (the logits its vocabulary columns) the vocabulary-parallel argmax,
    the same token on every tp rank (parallel/collectives.py
    vocab_argmax)."""
    if sharded(cfg, env):
        tok = C.vocab_argmax(logits, env, cfg.vocab_size)
    else:
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)
    return tok.to(torch.int32)[:, None]


def _select_tokens(prev_tok, meta_i):
    """Device-side input-token select from the packed step metadata. Row i
    decodes prev_tok[tok_src[i]] (last step's fused sample/argmax, still on
    device) unless tok_src[i] < 0, in which case it takes the freshly
    uploaded token (prompt-chunk token or a first token)."""
    tok_src, fresh_tok = meta_i[ROW_TOK_SRC], meta_i[ROW_FRESH]
    safe = tok_src.clamp(0, prev_tok.shape[0] - 1).long()
    return torch.where(tok_src >= 0, prev_tok[safe], fresh_tok)


def make_sample_fn(cfg: ModelConfig, prompt_len: int, env: Env = None):
    """Fused on-device sample step: [T,Vpad] logits -> [T] int32 tokens.

    Each row's key is fold_in(PRNGKey(seed), position) where position =
    cur_len - pos0 is the request-logical token index (0 for the first
    generated token), so a seeded request emits bit-identical tokens
    whether it decodes alone, inside a busy mixed-depth batch, or after a
    preemption restart. Rows with temperature <= 0 take the plain argmax.
    top-k/top-p masking runs through kernels/sampling; sampling itself is
    Gumbel-max over the masked, temperature-scaled logits.

    Over a DeviceMesh (env; the logits a rank's vocabulary columns) the
    columns are gathered over tp first (parallel/collectives.py
    vocab_gather), so every tp rank masks and draws the same whole rows
    and picks the same tokens."""
    V = cfg.vocab_size
    per_rank = env is not None and sharded(cfg, env)

    def sample(logits, meta_i, meta_f):
        if per_rank:
            logits = C.vocab_gather(logits, env)
        lf = logits[:, :V].float()
        greedy = torch.argmax(lf, dim=-1)
        temp = meta_f[ROW_TEMPERATURE]
        pos = torch.clamp_min(meta_i[ROW_CUR_LEN] - meta_i[ROW_POS0], 0)
        # temperature first, nucleus second (the vLLM/HF ordering): top_p
        # must see the distribution actually being sampled
        scaled = lf / torch.clamp_min(temp, 1e-6)[:, None]
        masked = topk_topp_mask(scaled, meta_i[ROW_TOP_K].contiguous(),
                                meta_f[ROW_TOP_P].contiguous())
        key = R.fold_in(R.PRNGKey(meta_i[ROW_SEED]), pos)
        sampled = torch.argmax(masked + R.gumbel(key, V), dim=-1)
        return torch.where(temp > 0.0, sampled, greedy).to(torch.int32)

    return sample


def make_fused_decode_step(cfg: ModelConfig, env: Env, *, prompt_len: int = 0,
                           sample: bool = False):
    """Contiguous-cache (slot pool) decode with the sample step fused:
    (next tokens [T] int32, caches). sample=False is the pure-argmax
    variant an all-greedy batch runs.

    Without row_slots, row t is slot t. Given row_slots ([T] int32), row i
    writes its K/V into slot row_slots[i] at cur_len[i] and attends over
    that slot at its own depth; rows with row_slots[i] < 0 are masked
    (their write lands at the cache's never-attended tail position). This
    is the slot pool's analogue of the paged step's block tables: it lets
    speculative verify rows (several rows sharing one slot at consecutive
    depths) ride the fused step, and a drafter step one row over a pool
    of many slots. Over a DeviceMesh every rank runs every row
    (whole_rows) on its pool and picks the same tokens (_pick)."""
    sampler = make_sample_fn(cfg, prompt_len, env) if sample else None

    def step(params, caches, prev_tok, meta_i, meta_f, row_slots=None):
        tok = _select_tokens(prev_tok, meta_i)
        logits, new_caches = Mo.forward(
            params, tok[:, None], cfg, env, mode="decode", caches=caches,
            cur_len=meta_i[ROW_CUR_LEN], row_slots=row_slots,
            whole_rows=True)
        return _pick(logits[:, 0, :], meta_i, meta_f, sampler, cfg,
                     env), new_caches

    return step


# the JAX package's name for the row-indirected form of the same step
make_spec_decode_step = make_fused_decode_step


def make_paged_decode_step(cfg: ModelConfig, env: Env, *, prompt_len: int = 0,
                           sample: bool = False):
    """Fused decode step over a paged (block-table) KV cache.

    Rows are decode slots plus optional piggybacked prefill lanes: every
    row writes its token's K/V into the physical block its table names at
    cur_len and attends at its own depth, so a prompt chunk (consecutive
    cur_len values sharing one table) prefills inside the running decode
    batch. tables: {"global": [T,MB]} plus {"local": [T,MBw]} for window
    units (their rings). Recurrent units read and write state row t for
    row t (a state pool has no lanes: T == slots); the rows padded past T
    to whole row tiles touch no state (Mo.forward). The sample/argmax
    step is fused; the [T] token vector is the only per-step download.
    Over a DeviceMesh every rank runs every row on its pool (the KV heads
    its query heads read, its state channels) and picks the same tokens
    (_pick)."""
    sampler = make_sample_fn(cfg, prompt_len, env) if sample else None

    def step(params, caches, prev_tok, meta_i, meta_f, tables):
        tok = _select_tokens(prev_tok, meta_i)
        logits, new_caches = Mo.forward(
            params, tok[:, None], cfg, env, mode="decode", caches=caches,
            cur_len=meta_i[ROW_CUR_LEN], block_tables=tables)
        return _pick(logits[:, 0, :], meta_i, meta_f, sampler, cfg,
                     env), new_caches

    return step


def _pick(logits, meta_i, meta_f, sampler, cfg: ModelConfig, env: Env):
    """A fused step's [T] int32 tokens from its logits [T, Vpad] (a
    rank's vocabulary columns over a mesh): the argmax (greedy, the
    vocabulary-parallel one over a mesh) without a sampler."""
    if sampler is not None:
        return sampler(logits, meta_i, meta_f)
    return greedy(logits, cfg, env)[:, 0]
