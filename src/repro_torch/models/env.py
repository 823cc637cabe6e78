"""Execution environment threaded through model code.

The JAX package's Env carries a device mesh and a ParallelPlan and pads
heads and vocabulary for its tensor-parallel degree. The port's Env
carries an optional mesh too: a torch DeviceMesh over the ranks of a
process group, or a shape-only mesh from launch/mesh.py (axis names and
sizes, no ranks) for resolving the sharding rules (parallel/rules.py).
Over a DeviceMesh every arch (dense, MoE, recurrent, and the modality
archs behind their stubs) computes per rank on its local shards
(`sharded`; models/model.py): the train step, and prefill and decode for
serving, the engines' steps included (serve/scheduler.py builds its
`Env(mesh=, plan=)` as the JAX package's engine does). The padding
helpers take the mesh's tp degree, as the JAX package's do; kv_index
says which KV heads one rank's query heads read, the heads a rank's
cache or pool holds under the replicated layout.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ParallelPlan

# The reference's SERVE_PLAN (serve/scheduler.py) takes "pallas" on a TPU
# and "naive" elsewhere. The port serves as the pallas plan does on every
# device (its kernels on the card, their plain versions on the CPU:
# prefill past 128 tokens through flash attention, f32 decode
# probabilities), so it names that plan. Train mode reads this field for
# the DPO trainer and the logprob scorer: at sequences of up to 128
# positions both plans take attention_naive, so the port trains as the
# reference's CPU runs do; past 128 the pallas plan raises, as jax.grad
# through the reference's flash kernel does on a TPU.
SERVE_PLAN = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                          kv_cache="replicated")


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a DeviceMesh or a shape-only mesh (both carry
    `mesh_dim_names` and `shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class Env:
    plan: ParallelPlan = field(default_factory=lambda: SERVE_PLAN)
    mesh: Optional[Any] = None

    # ---- axis helpers (the JAX package's models/env.py) ---------------------
    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None \
            else ()

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.plan.dp_axes if a in self.axis_names)

    @property
    def dpx(self) -> Tuple[str, ...]:
        return self.dp_axes

    @property
    def tp_axis(self) -> Optional[str]:
        return self.plan.tp_axis if self.plan.tp_axis in self.axis_names \
            else None

    @property
    def tp(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return mesh_axes(self.mesh)[self.tp_axis]

    @property
    def dp(self) -> int:
        if self.mesh is None:
            return 1
        axes = mesh_axes(self.mesh)
        n = 1
        for a in self.dp_axes:
            n *= axes[a]
        return n


def mesh_size(env: Env) -> int:
    n = 1
    for size in mesh_axes(env.mesh).values() if env.mesh is not None else ():
        n *= size
    return n


def modality(cfg: ModelConfig) -> bool:
    """A VLM or an encoder-decoder: the archs with a front-end stub."""
    return cfg.family == "vlm" or cfg.is_encdec


def check_mesh(cfg: ModelConfig, env: Env) -> None:
    """The model's refusal of a mesh: axes other than the plan's dp axes
    and tp axis (ValueError). Every arch is accepted over the others."""
    if env.mesh is None:
        return
    extra = set(env.axis_names) - set(env.plan.dp_axes) - {env.plan.tp_axis}
    if extra:
        raise ValueError(f"mesh axes {sorted(extra)} are neither the plan's "
                         f"dp axes {env.plan.dp_axes} nor its tp axis "
                         f"{env.plan.tp_axis!r}")


def over_ranks(env: Env) -> bool:
    """Whether env.mesh is a DeviceMesh of a process group's ranks (not
    None, not a shape-only mesh)."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(env.mesh, DeviceMesh)


def sharded(cfg: ModelConfig, env: Env) -> bool:
    """Whether the model computes per rank over env.mesh (models/model.py
    _Ranks: train mode, prefill and decode): over a DeviceMesh, every
    arch check_mesh lets through. A shape-only mesh of more than one
    device has no ranks to compute on (ValueError); of one device it
    computes on that device (False)."""
    check_mesh(cfg, env)
    if env.mesh is None:
        return False
    if not over_ranks(env):
        if mesh_size(env) > 1:
            raise ValueError(
                f"a shape-only mesh of {mesh_size(env)} devices resolves "
                "sharding specs; the model computes over a DeviceMesh of a "
                "process group's ranks")
        return False
    return True


def out_dims(env: Env, seq_len: int):
    """Layer-output layout: sequence-parallel over tp when enabled (turns
    the preceding row product's all-reduce into a reduce-scatter)."""
    if (env.plan.seq_shard_acts and env.tp > 1 and seq_len % env.tp == 0
            and seq_len >= env.tp):
        return (env.dpx, env.plan.tp_axis, None)
    return (env.dpx, None, None)


def head_pad(cfg: ModelConfig, env: Env) -> int:
    """Padded query-head count for the current TP degree."""
    tp = env.tp
    if tp <= 1:
        return cfg.n_heads
    return ((cfg.n_heads + tp - 1) // tp) * tp


def kv_head_pad(cfg: ModelConfig, env: Env) -> int:
    """MHA (kv == q heads) pads KV heads alongside Q so GQA grouping stays
    integral; GQA keeps its true KV head count."""
    hkv = max(cfg.n_kv_heads, 1)
    if cfg.n_kv_heads == cfg.n_heads:
        return head_pad(cfg, env)
    return hkv


def vocab_pad(cfg: ModelConfig, env: Env) -> int:
    tp = max(env.tp, 1)
    m = max(128, tp) if tp > 1 else 8
    return ((cfg.vocab_size + m - 1) // m) * m


def kv_index(cfg: ModelConfig, env: Env, rank: int, hkv: int):
    """Which of hkv KV heads tp rank `rank`'s query heads read: the rank
    holds query heads rank * hq_local ... (head_pad over tp) and query
    head h reads KV head h // G (G = padded heads / hkv). A slice (a
    whole group, or a part of one, keeps the grouping), or, where the
    rank's heads straddle groups unevenly, a list: each query head its
    own KV head. Every head where the heads do not split over tp."""
    tp = env.tp
    hq = head_pad(cfg, env)
    if tp <= 1 or hq % tp:
        return slice(0, hkv)
    hq_local = hq // tp
    G = hq // hkv
    idx = [(rank * hq_local + i) // G for i in range(hq_local)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hq_local % n == 0 and idx == [lo + i // (hq_local // n)
                                    for i in range(hq_local)]:
        return slice(lo, lo + n)
    return idx


def kv_heads_local(cfg: ModelConfig, env: Env, rank: int) -> int:
    """The KV heads one tp rank's cache or pool holds under the
    replicated layout (kv_index's count); kv_head_pad on one device."""
    sel = kv_index(cfg, env, rank, kv_head_pad(cfg, env))
    return (sel.stop - sel.start) if isinstance(sel, slice) else len(sel)
