"""Error-feedback int8 gradient compression for the cross-pod sync axis
(port of the JAX package's optim/compress.py).

Per-row int8 quantization of (gradient + carried error), the quantized
views averaged across the ranks of a process group, the local residual
fed back next step. Like the reference, this reproduces the numerics:
the all-reduce carries the dequantized f32 view (the collectives have no
int8-sum wire format), so the convergence behaviour is faithful and the
wire saving is modelled, not taken.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

Pytree = Any


def _q(x):
    if x.dim() < 2:
        return x, None
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq(q, scale):
    return q if scale is None else q.float() * scale


def compress_decompress(x, err):
    """One EF-compression round on a local tensor.

    Returns (decompressed, new_err): decompressed is what the wire would
    carry (int8-quantized view of x+err); new_err is the residual."""
    xf = x.float() + err
    q, s = _q(xf)
    dq = _dq(q, s)
    return dq, xf - dq


def ef_psum_grads(grads: Pytree, err: Pytree, group=None
                  ) -> Tuple[Pytree, Pytree]:
    """Error-feedback compressed mean over the ranks of `group` (None: the
    default group): each rank quantizes (grad + carried error) to int8,
    the dequantized views are all-reduced and divided by the world size
    (the reference's pmean), and the local residual is returned as the
    next error."""
    world = dist.get_world_size(group)
    new_err = []

    def one(g, e):  # leaves in the tree's order, the same on every rank
        dq, ne = compress_decompress(g, e)
        dist.all_reduce(dq, op=dist.ReduceOp.SUM, group=group)
        new_err.append(ne)
        return dq / world

    synced = tree_map(one, grads, err)
    errs = iter(new_err)
    return synced, tree_map(lambda _: next(errs), grads)


def init_error(params: Pytree) -> Pytree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
