"""AdamW with fp32 or int8-blockwise moment states and global-norm
clipping (port of the JAX package's optim/adamw.py).

The int8 states quantize each moment per row (over its last axis) to int8
with one f32 scale a row: about 2.1 bytes a parameter for both moments
instead of 8. A 1-D leaf keeps f32 moments ({"q": f32, "s": None}).

Parameter trees are nests of dicts and tuples of tensors, walked in the
JAX package's leaf order (dict keys sorted), so a state bridged from the
JAX package's numpy tree (repro_torch/bridge.py) lines up leaf for leaf.

Every step's arithmetic is the reference's, op by op in f32, with its
Python constants rounded to f32 as JAX's weak types round them; divisions
stay divisions (a scalar over a tensor is written torch.div, never the
reciprocal product torch's `float / tensor` computes), and the square
root is correctly rounded (_sqrt). On the CPU the
elementwise updates equal the JAX package's eager (op by op) update bit
for bit; the global norm sums in another order, and XLA's and PyTorch's
f32 pow and cos can round apart by an ulp, which moves the clip factor,
the learning rate and the bias corrections by an ulp or so
(tests/test_torch_train.py states the bound). Under jit XLA rewrites the
int8 quantizer's `amax / 127` as `amax * (1/127)`, which rounds apart in
about one row in 20 (ROADMAP.md §3); the port divides, as the eager
reference does.

adamw_update returns the new parameters as new tensors in the old dtypes,
detached from any graph, and updates the state's tensors in place (as
torch.optim does): the caller's parameters are never written, so an
engine serving them keeps its weights until set_params, and a step holds
one copy of the f32 master weights, not two. Leaves are updated in row
chunks of at most CHUNK elements, which bounds the step's f32
temporaries on a card (a 202,048 x 5,120 embedding is 4.1 GB a
temporary at full size); the rows are independent, so the values are
the same.

Over a DeviceMesh (the sharded train step, launch/steps.py) the trees
hold each rank's local shards and `specs` their parameters' specs: the
global norm sums each leaf's squares over the axes that shard it (a
replicated leaf counts once), and an int8 moment's row scale is the max
over the axes that shard its last dim, so a shard quantizes with the
whole row's scale, as one device does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

Pytree = Any
CHUNK = 1 << 26  # elements of one leaf updated at a time


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "fp32"  # fp32 | int8
    # schedule
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---- trees -------------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of dicts, tuples and lists, in the JAX
    package's order (dict keys sorted); None is an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` (and the matching subtrees of `rest`,
    which may hold more below a leaf of `tree`, as the moment states do),
    in the same nest."""
    if isinstance(tree, dict):  # visited in leaf order, keys kept in place
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def value_and_grad(loss_fn, params: Pytree):
    """((loss, aux), grads) of loss_fn(params) -> (loss, aux): the
    gradient of the scalar loss with respect to every leaf of `params`,
    in its tree (zeros for a leaf the loss does not reach). The leaves
    are taken as fresh autograd leaves (detached views: no copy), so the
    caller's tensors never join a graph."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(live)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))
    grads = tree_map(lambda p: next(grads), live)
    grads = tree_map(lambda p, g: torch.zeros_like(p) if g is None else g,
                     live, grads)
    return (loss.detach(), aux), grads


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to cfg.lr over warmup_steps, then a cosine down to
    min_lr_frac * lr at total_steps: an f32 scalar for `step` (an int or
    a tensor)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / float(max(cfg.warmup_steps, 1)), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(torch.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# ---- int8 blockwise (per-row) quantization ---------------------------------


def _sqrt(x):
    """f32 sqrt, correctly rounded as XLA's is: on the CPU taken in f64 and
    rounded once (PyTorch's vectorised f32 sqrt there is not correctly
    rounded: about one value in 150 lands an ulp off); CUDA's f32 sqrt
    is."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _quantize(x, env=None, axes: Tuple[str, ...] = ()):
    """f32 -> (int8, f32 scale per row of the last axis); a 1-D tensor
    passes through with no scale. axes: the mesh axes sharding the last
    axis (x a local shard): the row max is taken over them."""
    if x.dim() < 2:
        return x, None
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if axes:
        from repro_torch.parallel.collectives import all_reduce_max
        amax = all_reduce_max(amax, env, axes)
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequantize(q, scale):
    if scale is None:
        return q
    return q.float() * scale[..., None]


# ---- state ------------------------------------------------------------------


def adamw_init(params: Pytree, cfg: AdamWConfig) -> Dict[str, Pytree]:
    """{"step": int32 0, "master": f32 copies of the parameters, "m",
    "v": zero moments (f32 tensors, or {"q", "s"} under int8)}."""
    def init_m(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.state_dtype == "int8":
            q, s = _quantize(z)
            return {"q": q, "s": s}
        return z

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "master": tree_map(lambda p: p.detach().float().clone(), params),
            "m": tree_map(init_m, params),
            "v": tree_map(init_m, params)}


def global_norm(tree: Pytree, specs: Pytree = None,
                env=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares.
    With specs and a mesh env: the leaves are local shards, each leaf's
    sum taken over the mesh axes its spec names."""
    sq = torch.stack([torch.sum(torch.square(x.float()))
                      for x in tree_leaves(tree)])
    if env is not None:
        from repro_torch.parallel.collectives import sum_over
        from repro_torch.parallel.rules import axes_of
        on = [set(a for e in s for a in axes_of(e))
              for s in _spec_leaves(tree, specs)]
        for axis in env.axis_names:
            mask = torch.tensor([axis in o for o in on], device=sq.device)
            sq = torch.where(mask, sum_over(sq, env, (axis,)), sq)
    return torch.sqrt(torch.sum(sq))


def _spec_leaves(tree: Pytree, specs: Pytree) -> list:
    """The spec of every leaf of `tree`, in tree_leaves order."""
    out = []
    tree_map(lambda x, s: out.append(s), tree, specs)
    return out


def _rows(x: torch.Tensor) -> List[slice]:
    """Row slices of the leading axis, each at most CHUNK elements (one
    slice for 0-D and 1-D leaves)."""
    if x.dim() < 2 or x.numel() <= CHUNK:
        return [slice(None)]
    per = max(1, CHUNK // (x.numel() // x.shape[0]))
    return [slice(i, i + per) for i in range(0, x.shape[0], per)]


def adamw_update(grads: Pytree, state: Dict[str, Pytree], cfg: AdamWConfig,
                 specs: Pytree = None, env=None
                 ) -> Tuple[Pytree, Dict[str, Pytree]]:
    """One AdamW step: (new parameters in the grads' dtypes, the state).
    grads matches the parameters' tree; see the module docstring for what
    is new and what is updated in place. specs and env: the parameters'
    specs over env.mesh, the trees holding this rank's shards."""
    if specs is None:
        specs = tree_map(lambda g: (), grads)
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gn = global_norm(grads, specs, env)
    clip = torch.clamp_max(
        torch.div(_f32(cfg.grad_clip, gn), torch.clamp_min(gn, 1e-12)), 1.0)
    b1c = 1 - torch.pow(_f32(cfg.b1, gn), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2, gn), step.float())
    is_q = cfg.state_dtype == "int8"

    def moment(x, rows):
        if is_q:
            return _dequantize(x["q"][rows],
                               None if x["s"] is None else x["s"][rows])
        return x[rows]

    def store(x, rows, val, axes):
        if not is_q:
            x[rows] = val
            return
        q, s = _quantize(val, env, axes)
        if s is None:
            x["q"] = q
        else:
            x["q"][rows] = q
            x["s"][rows] = s

    from repro_torch.parallel.rules import axes_of

    def upd(g, master, m, v, spec):
        axes = tuple(a for a in axes_of(spec[-1] if spec else None)
                     if env is not None and a in env.axis_names)
        new = torch.empty(g.shape, dtype=g.dtype, device=g.device)
        for rows in _rows(g):
            gf = g[rows].float() * clip
            mm = cfg.b1 * moment(m, rows) + (1 - cfg.b1) * gf
            vv = cfg.b2 * moment(v, rows) + (1 - cfg.b2) * torch.square(gf)
            mhat = mm / b1c
            vhat = vv / b2c
            ma = master[rows]
            ma.sub_(lr * (mhat / (_sqrt(vhat) + cfg.eps)
                          + cfg.weight_decay * ma))
            store(m, rows, mm, axes)
            store(v, rows, vv, axes)
            new[rows] = ma
        return new

    with torch.no_grad():
        new_params = tree_map(upd, grads, state["master"], state["m"],
                              state["v"], specs)
        state["step"] = step
    return new_params, state


def make_train_state(params: Pytree, cfg: AdamWConfig) -> Dict[str, Pytree]:
    return {"params": params, "opt": adamw_init(params, cfg)}
