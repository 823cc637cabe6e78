"""Sharding rules: DP/FSDP/TP/EP/SP partition specs for every tree in the
system (params, optimizer state, KV/state caches, batches); port of the
JAX package's parallel/rules.py.

One resolver maps a tree path + rank to a spec; every dim whose size the
mesh axis does not divide falls back to replication (validated against
the mesh), so the same rules serve the production 16x16 mesh, small test
meshes and one device. A spec is a tuple with one entry per dim: None
(replicated), an axis name, or a tuple of axis names (one dim over
several mesh axes, major first) - the entries of the JAX package's
PartitionSpec, which writes a one-name tuple as the bare name. Without a
mesh every spec is () (the JAX package's P()).

Layout summary:
  column weights  [d_in, d_out]    (fsdp, tp)     (QKV, MLP-in, ...)
  row weights     [d_in, d_out]    (tp, fsdp)     (O, MLP-out, ...)
  embed/unembed                    (None, tp)
  MoE experts                      ep: experts over tp; tp: ff over tp
  KV caches (decode)               seq-sharded over tp (flash-decoding)
  recurrent states                 width/heads over tp

The mesh is a torch DeviceMesh or a shape-only mesh (launch/mesh.py):
resolving reads only axis names and sizes. Placing a tree
(apply_shardings) needs a DeviceMesh: each leaf becomes a DTensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.env import Env, mesh_axes

Pytree = Any


class Spec(tuple):
    """A partition spec: one entry per dim. A tuple (equal to the tuple of
    its entries, as the JAX package's PartitionSpec is), and a leaf to the
    tree walks, where a plain tuple is a node."""

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


_COL = {"wq", "w_gate", "w_up", "w_in", "w_gate_in", "w_r", "w_k", "w_v",
        "w_g", "cm_k", "cm_r", "decay_B"}
_ROW = {"wo", "w_down", "w_out", "cm_v", "w_o"}
_MOE_LEAVES = {"w_gate", "w_up", "w_down"}


def _param_dims(names, cfg: ModelConfig, env: Env) -> Optional[Tuple]:
    """Spec dims for an (unstacked) parameter leaf."""
    leaf = names[-1]
    tp = env.plan.tp_axis
    fs = ("pod", "data") if env.plan.fsdp else None
    if "moe" in names and leaf in (_MOE_LEAVES | {"router"}):
        mode = env.plan.resolve_moe(cfg, max(env.tp, 1))
        if leaf == "router":
            return (None, None)
        if mode == "ep":
            return {"w_gate": (tp, fs, None), "w_up": (tp, fs, None),
                    "w_down": (tp, None, fs)}[leaf]
        return {"w_gate": (None, fs, tp), "w_up": (None, fs, tp),
                "w_down": (None, tp, fs)}[leaf]
    if leaf in ("embed", "unembed"):
        return (None, tp)
    if leaf in _COL:
        return (fs, tp)
    if leaf in _ROW:
        return (tp, fs)
    if leaf in ("wk", "wv"):
        return (fs, None)  # small KV projections: replicate columns (GQA)
    if leaf == "bq":
        return (tp,)
    if leaf == "conv_w":
        return (None, tp)
    if leaf in ("w_rgate", "w_igate"):
        return (tp, None, None)  # block-diagonal gates: blocks over tp
    if leaf in ("lam", "decay_base"):
        return (tp,)
    if leaf == "bonus_u":
        return (tp, None)
    return None  # -> replicate


def _cache_dims(names, rank: int, cfg: ModelConfig, env: Env
                ) -> Optional[Tuple]:
    leaf = names[-1]
    tp = env.plan.tp_axis
    dp = env.dpx or None
    seq_sh = env.plan.kv_cache == "seq_sharded"
    if leaf in ("k", "v", "xk", "xv"):  # [B, Hkv, S, hd]
        return (dp, None, tp if seq_sh else None, None)
    if leaf == "h":  # rglru state [B, w]
        return (dp, tp)
    if leaf == "conv":  # [B, cw-1, w]
        return (dp, None, tp)
    if leaf == "s":  # rwkv state [B, H, hd, hd]
        return (dp, tp, None, None)
    if leaf in ("tm_prev", "cm_prev"):  # [B, d]
        return (dp, None)
    return None


def _resolve(names, rank: int, cfg: ModelConfig, env: Env,
             kind: str) -> Tuple:
    leaf = names[-1]
    if leaf == "step":
        return ()
    # optimizer state wrapping: .../<param>/q or /s  (int8 moments)
    if kind == "state" and leaf in ("q", "s") and len(names) >= 2:
        base = _resolve(names[:-1], rank if leaf == "q" else rank + 1, cfg,
                        env, "state")
        return base if leaf == "q" else base[:-1]
    if kind == "cache":
        dims = _cache_dims(names, rank, cfg, env)
    else:
        dims = _param_dims(names, cfg, env)
    if dims is None:
        dims = (None,) * rank
    # stacked leading scan dim for repeated blocks
    stacked = any(n in ("blocks", "enc_blocks") for n in names[:-1])
    if kind == "cache":
        stacked = "blocks" in names[:1]
    if stacked and len(dims) == rank - 1:
        dims = (None,) + dims
    if len(dims) != rank:  # rank mismatch (e.g. replicated default)
        dims = tuple(dims[:rank]) + (None,) * max(0, rank - len(dims))
    return dims


def _validated(dims, shape, env: Env) -> Spec:
    """Drop axis assignments that do not divide the dim size."""
    if env.mesh is None:
        return Spec()
    sizes = mesh_axes(env.mesh)
    out = []
    for size, d in zip(shape, dims):
        if d is None:
            out.append(None)
            continue
        axes = d if isinstance(d, tuple) else (d,)
        axes = tuple(a for a in axes if a in sizes)
        if not axes:
            out.append(None)
            continue
        n = 1
        for a in axes:
            n *= sizes[a]
        if n > 0 and size % n == 0:
            out.append(axes[0] if len(axes) == 1 else axes)
        else:
            out.append(None)
    return Spec(out)


def _tree_map_with_names(fn, tree, *rest, names=()):
    """fn(names, leaf, *matching leaves of rest) over a nest of dicts,
    tuples and lists (a Spec is a leaf); names are the path's dict keys
    and sequence indices as strings; None stays None (an empty
    subtree)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map_with_names(fn, v, *(r[k] for r in rest),
                                        names=names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(_tree_map_with_names(fn, v, *(r[i] for r in rest),
                                               names=names + (str(i),))
                          for i, v in enumerate(tree))
    return fn(names, tree, *rest)


def _tree_specs(struct: Pytree, cfg: ModelConfig, env: Env, kind: str
                ) -> Pytree:
    def one(names, leaf):
        dims = _resolve(names, len(leaf.shape), cfg, env, kind)
        return _validated(dims, leaf.shape, env)

    return _tree_map_with_names(one, struct)


# ---- public API --------------------------------------------------------------


def param_specs(params_struct: Pytree, cfg: ModelConfig, env: Env) -> Pytree:
    return _tree_specs(params_struct, cfg, env, "param")


def state_specs(state_struct: Pytree, cfg: ModelConfig, env: Env) -> Pytree:
    """Train state {"params":…, "opt": {step, master, m, v}}."""
    return _tree_specs(state_struct, cfg, env, "state")


def cache_specs(cache_struct: Pytree, cfg: ModelConfig, env: Env) -> Pytree:
    return _tree_specs(cache_struct, cfg, env, "cache")


def batch_specs(batch_struct: Pytree, cfg: ModelConfig, shape: ShapeConfig,
                env: Env) -> Pytree:
    dp = env.dpx if (env.dp and shape.global_batch % max(env.dp, 1) == 0) \
        else None

    def one(names, leaf):
        dims = (dp,) + (None,) * (len(leaf.shape) - 1)
        return _validated(dims, leaf.shape, env)

    return _tree_map_with_names(one, batch_struct)


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes one entry of a spec names (None, a name or a tuple)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Spec, mesh) -> Tuple:
    """A spec as DTensor placements over `mesh`, one per mesh dim: Shard(d)
    where tensor dim d names the mesh dim, Replicate() elsewhere. A dim
    over several mesh axes is sharded over them in mesh order (the order
    the rules write them: "pod" before "data")."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class Placed:
    """Where a leaf goes: DTensor placements over a DeviceMesh (the JAX
    package's NamedSharding)."""
    mesh: Any
    placements: Tuple


def to_shardings(specs: Pytree, env: Env) -> Optional[Pytree]:
    """A Placed per leaf of `specs`, or None without a mesh."""
    if env.mesh is None:
        return None
    return _tree_map_with_names(
        lambda _, s: Placed(env.mesh, placements(s, env.mesh)), specs)


def local_shard(x, spec: Spec, env: Env):
    """This rank's chunk of a whole leaf x, cut as apply_shardings places
    it (DTensor's Shard: a dim over several axes is cut major first),
    with no message: every rank holds x whole. A leaf of a rank outside
    the mesh is None."""
    coord = env.mesh.get_coordinate()
    if coord is None:
        return None
    where = dict(zip(env.mesh.mesh_dim_names, coord))
    sizes = mesh_axes(env.mesh)
    for d, e in enumerate(spec):
        n, i = 1, 0
        for a in axes_of(e):
            n, i = n * sizes[a], i * sizes[a] + where[a]
        if n > 1:
            x = x.narrow(d, i * (x.shape[d] // n), x.shape[d] // n)
    return x.contiguous()


def local_shards(tree: Pytree, specs: Pytree, env: Env) -> Pytree:
    """local_shard over a tree and its specs."""
    return _tree_map_with_names(lambda _, x, s: local_shard(x, s, env),
                                tree, specs)


def apply_shardings(tree: Pytree, specs: Pytree, env: Env) -> Pytree:
    """Distribute a concrete tree over env.mesh with the resolved specs
    (each leaf a DTensor); without a mesh the tree as it is."""
    if env.mesh is None:
        return tree
    from torch.distributed.tensor import distribute_tensor
    return _tree_map_with_names(
        lambda _, x, s: distribute_tensor(x, env.mesh,
                                          placements(s, env.mesh)),
        tree, specs)
