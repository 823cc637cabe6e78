"""Weight bridge: the JAX package's parameter pytree, as numpy, to torch.

`Mo.init_params(PRNGKey(0), cfg, env)` converted leaf by leaf with
np.asarray is a nest of dicts and tuples of numpy arrays; bf16 leaves
arrive with numpy's extension dtype named "bfloat16". The port uses the
same layout (models/model.py), so the bridge keeps the structure as it is:
bf16 stays bf16, `blocks` leaves stay stacked on the layer axis and the
vocabulary stays padded. The port never imports JAX to load weights: the
tests make the numpy tree and hand it over.

Over a DeviceMesh the same tree is padded for its tp degree
(pad_for_mesh) and cut to each rank's shards (rank_shards): the parameter
leaves of every block kind, the recurrent ones, an encoder's and the
cross-attention's included.

The same conversion carries an AdamW state over (optim/adamw.py): the
int32 step, the f32 master weights and the moments, f32 or int8 {"q",
"s"} with s None (an empty subtree) for 1-D leaves, so a test can step
both packages from one state.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def to_torch(tree: Any, device="cuda") -> Any:
    """Convert a nest of dicts/tuples/lists of numpy arrays to torch (None
    stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(v, device) for v in tree)
    a = np.array(tree)  # a writable copy torch may own
    if a.dtype.name == "bfloat16":  # same 16 bits: reinterpret, never round
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def pad_for_mesh(params: Any, cfg, env) -> Any:
    """A one-device parameter tree (heads and vocabulary padded for tp 1)
    padded with zeros into env's tp layout, the shapes the JAX package's
    init_params gives under that mesh (head_pad, vocab_pad): the
    vocabulary's embed rows and unembed columns appended, and every
    attention's query heads (the encoder's and the cross-attention's
    too; the qkv biases with their weights) padded inside each KV group (G heads a group become
    head_pad / Hkv, so every real head keeps its KV head); an MHA arch
    pads its KV heads alongside, appended. A padded head's wq columns and
    wo rows are zero, so it adds nothing to the output."""
    import torch.nn.functional as F

    from repro_torch.models.env import Env, head_pad, kv_head_pad, vocab_pad
    one = Env(plan=env.plan)
    hq0, hq1 = head_pad(cfg, one), head_pad(cfg, env)
    hkv0, hkv1 = kv_head_pad(cfg, one), kv_head_pad(cfg, env)
    hd = cfg.head_dim
    dv = vocab_pad(cfg, env) - vocab_pad(cfg, one)

    def heads(x, dim, n0, n1, groups):
        """Pad dim (n0 * hd wide) to n1 * hd: within `groups` groups."""
        if n1 == n0:
            return x
        shape = x.shape
        dim = dim % x.dim()
        x = x.reshape(shape[:dim] + (groups, n0 // groups, hd)
                      + shape[dim + 1:])
        pad = [0, 0] * (x.dim() - dim - 2) + [0, (n1 - n0) // groups]
        return F.pad(x, pad).reshape(shape[:dim] + (n1 * hd,)
                                     + shape[dim + 1:])

    def attn(p):
        g = 1 if hkv1 != hkv0 else hkv0  # MHA appends, GQA pads in groups
        out = dict(p)
        out["wq"] = heads(p["wq"], -1, hq0, hq1, g)
        out["wo"] = heads(p["wo"], -2, hq0, hq1, g)
        if "bq" in p:
            out["bq"] = heads(p["bq"], -1, hq0, hq1, g)
        for n in ("wk", "wv", "bk", "bv"):
            if n in p:
                out[n] = heads(p[n], -1, hkv0, hkv1, 1)
        return out

    def unit(u):
        return {k: attn(v) if k in ("attn", "xattn") else v
                for k, v in u.items()}

    out = dict(params)
    for group in ("blocks", "tail", "enc_blocks"):
        if group in params:
            out[group] = tuple(unit(u) for u in params[group])
    out["embed"] = F.pad(params["embed"], (0, 0, 0, dv))
    out["unembed"] = F.pad(params["unembed"], (0, dv))
    return out


def rank_shards(params: Any, cfg, env) -> Any:
    """A one-device parameter tree (torch, whole on every rank) as this
    rank's shards over env.mesh: padded for its tp degree (pad_for_mesh),
    then each leaf cut to the rank's chunk of its spec
    (parallel/rules.py param_specs, local_shard), the local tensors
    apply_shardings would place, with no message."""
    from repro_torch.models.model import param_specs
    from repro_torch.parallel.rules import local_shards
    return local_shards(pad_for_mesh(params, cfg, env),
                        param_specs(cfg, env), env)
