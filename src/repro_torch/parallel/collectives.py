"""Collectives over a DeviceMesh's axes, each with its mirror under
autograd: the port's counterpart of the collectives inside the JAX
package's shard_map and of what GSPMD inserts for its sharding
constraints.

The sharded train step runs per rank on local shards (models/model.py).
A value is either sharded over a mesh axis (each rank holds its own
slice) or replicated over it (every rank holds the same value). The
gradient convention is DTensor's Partial one: a replicated value's
gradient on each rank is a partial sum, and its true gradient is the sum
over the axis' ranks. That fixes every mirror:

  gather          all-gather a sharded dim   | reduce-scatter (f32 sum)
  reduce_scatter  sum partials, shard a dim  | all-gather
  all_reduce      sum partials               | all-reduce (sum)
  split           take this rank's chunk     | zero-pad (no message)
  all_to_all      exchange dim-0 chunks      | the same exchange
  mesh_mean       mean over every rank       | all-reduce / ranks
  loss_mean       the loss's mesh_mean       | 1 / ranks (each rank seeds 1)

Serving (prefill and decode per rank) runs the same calls outside
autograd, and adds the vocabulary-parallel greedy pick (vocab_argmax),
the gather of a step's vocabulary columns for the sampler
(vocab_gather) and the engines' check that every rank picked the same
tokens (same_on_every_rank).

so a replicated value feeding a column-sharded product needs no identity
with an all-reduce behind it (Megatron's f): its partial gradients are
summed where the value was gathered or where the parameter's gradient is
synchronised (launch/steps.py). Every function calls its collective even
over an axis of one rank (a one-rank group copies), so a 1 x 1 mesh runs
the same calls as a larger one.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.models.env import Env, mesh_axes


# Result bytes on this rank of every collective issued, by type (what the
# dry run's analytic count, launch/roofline.py, predicts): host-side
# counters read from the tensors' shapes, no launch and no sync.
_BYTES = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0,
          "all-to-all": 0}


# The same bytes by (type, process group name), for the collectives
# issued over a named group: the step analysis (launch/step_analysis.py)
# names each group's mesh axis.
_GROUP_BYTES = {}


def count(kind: str, x, group=None) -> None:
    """Add a collective's result tensor x to the `kind` count (and to
    its group's, given the group it ran over)."""
    n = x.numel() * x.element_size()
    _BYTES[kind] += n
    if group is not None:
        key = (kind, group.group_name)
        _GROUP_BYTES[key] = _GROUP_BYTES.get(key, 0) + n


def collective_bytes(reset: bool = False) -> dict:
    """The counts since the last reset, {type: bytes}; reset=True zeroes
    them (and group_bytes') after reading."""
    out = dict(_BYTES)
    if reset:
        for k in _BYTES:
            _BYTES[k] = 0
        _GROUP_BYTES.clear()
    return out


def group_bytes() -> dict:
    """The counts by group since the last reset, {(type, group name):
    bytes}."""
    return dict(_GROUP_BYTES)


def axis_size(env: Env, axis: str) -> int:
    return mesh_axes(env.mesh)[axis]


def axis_rank(env: Env, axis: str) -> int:
    return env.mesh.get_local_rank(axis)


def _group(env: Env, axis: str):
    return env.mesh.get_group(axis)


def _all_gather(x, group, n: int, dim: int):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    count("all-gather", out, group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, n: int, dim: int):
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + tuple(xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    count("reduce-scatter", out, group)
    return out.movedim(0, dim)


def _sum(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    count("all-reduce", x, group)
    return x


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):  # the partials summed in f32, rounded once
        return (_reduce_scatter(g.float(), *ctx.args).to(g.dtype), None,
                None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, *ctx.args), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, r, dim):
        ctx.args = (x.shape[dim], n, r, dim)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, g):
        size, n, r, dim = ctx.args
        out = g.new_zeros(g.shape[:dim] + (size,) + g.shape[dim + 1:])
        out.narrow(dim, r * (size // n), size // n).copy_(g)
        return out, None, None, None


def _exchange(x, group):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    count("all-to-all", out, group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _MeshMean(torch.autograd.Function):
    """Mean over every rank. The gradient that reaches it is partial
    (summed over the ranks) or, for the loss, whole on every rank (each
    rank seeds its backward pass with 1): `seeded` says which."""

    @staticmethod
    def forward(ctx, x, env, seeded):
        ctx.env, ctx.seeded = env, seeded
        return sum_over(x, env, env.axis_names) / env.mesh.size()

    @staticmethod
    def backward(ctx, g):
        env = ctx.env
        if not ctx.seeded:
            g = sum_over(g, env, env.axis_names)
        return g / env.mesh.size(), None, None


def gather(x, env: Env, axes, dim: int):
    """All-gather dim, sharded over `axes` (one name, or a tuple of names
    major first as a spec writes them: the minor axis is gathered first)."""
    for axis in reversed(axes if isinstance(axes, tuple) else (axes,)):
        x = _Gather.apply(x, _group(env, axis), axis_size(env, axis), dim)
    return x


def reduce_scatter(x, env: Env, axis: str, dim: int):
    """Sum the axis' partials and keep this rank's chunk of dim."""
    return _ReduceScatter.apply(x, _group(env, axis), axis_size(env, axis),
                                dim)


def all_reduce(x, env: Env, axes: Sequence[str]):
    """Sum over each of `axes` (partials in, a replicated value out)."""
    for axis in axes:
        x = _AllReduce.apply(x, _group(env, axis))
    return x


def split(x, env: Env, axis: str, dim: int):
    """This rank's chunk of dim of a value replicated over the axis."""
    return _Split.apply(x, axis_size(env, axis), axis_rank(env, axis), dim)


def all_to_all(x, env: Env, axis: str):
    """Send chunk j of dim 0 to the axis' rank j; chunk r of the result
    came from rank r."""
    return _AllToAll.apply(x, _group(env, axis))


def mesh_mean(x, env: Env):
    """The mean of x over every rank of the mesh, replicated."""
    return _MeshMean.apply(x, env, False)


def loss_mean(x, env: Env):
    """mesh_mean for the loss, the value every rank's backward pass starts
    from with a gradient of 1: each rank's x gets its share, 1 / ranks."""
    return _MeshMean.apply(x, env, True)


@torch.no_grad()
def all_reduce_max(x, env: Env, axes: Sequence[str]):
    """Elementwise max over each of `axes` (no gradient)."""
    x = x.contiguous().clone()
    for axis in axes:
        group = _group(env, axis)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
        count("all-reduce", x, group)
    return x


@torch.no_grad()
def sum_over(x, env: Env, axes: Sequence[str]):
    """Sum over each of `axes`, outside autograd (gradient sync, norms)."""
    for axis in axes:
        x = _sum(x, _group(env, axis))
    return x


@torch.no_grad()
def vocab_argmax(logits, env: Env, vocab_size: int):
    """The greedy token of vocabulary-parallel logits [..., V / tp], this
    rank's columns of the padded vocabulary: torch.argmax over the
    first vocab_size columns of the whole row, on every rank. Each rank
    takes its local max and its first index; the tp ranks' pairs are
    gathered and the max taken again, a tie going to the lowest global
    index (the lower rank), as torch.argmax breaks it. Returns int64
    [...]."""
    vl = logits.shape[-1]
    tp = env.tp_axis
    off = axis_rank(env, tp) * vl if tp is not None else 0
    col = torch.arange(off, off + vl, device=logits.device)
    lf = torch.where(col < vocab_size, logits.float(), -torch.inf)
    idx = torch.argmax(lf, dim=-1)
    val = torch.gather(lf, -1, idx[..., None])[..., 0]
    idx = idx + off
    if tp is None:
        return idx
    n = axis_size(env, tp)
    vals = _all_gather(val[None], _group(env, tp), n, 0)
    idxs = _all_gather(idx[None], _group(env, tp), n, 0)
    best = torch.argmax(vals, dim=0)  # the first rank among equal maxima
    return torch.gather(idxs, 0, best[None])[0]


@torch.no_grad()
def vocab_gather(logits, env: Env):
    """Vocabulary-parallel logits [..., V / tp] (this rank's columns of
    the padded vocabulary) gathered whole, [..., V], on every rank
    (contiguous, as the kernels' wrappers take their rows)."""
    if env.tp_axis is None:
        return logits
    return _all_gather(logits, _group(env, env.tp_axis),
                       axis_size(env, env.tp_axis),
                       logits.dim() - 1).contiguous()


@torch.no_grad()
def same_on_every_rank(x, env: Env) -> bool:
    """Whether the integer tensor x is the same on every rank of the
    mesh: one max-reduction of (x, -x) over its axes (the max and the
    negated min), so every rank gets the same answer."""
    both = torch.stack([x.long(), -x.long()])
    top = all_reduce_max(both, env, env.axis_names)
    return bool(torch.equal(top[0], -top[1]))
