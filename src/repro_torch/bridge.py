"""Weight bridge: the JAX package's parameter pytree, as numpy, to torch.

`Mo.init_params(PRNGKey(0), cfg, env)` converted leaf by leaf with
np.asarray is a nest of dicts and tuples of numpy arrays; bf16 leaves
arrive with numpy's extension dtype named "bfloat16". The port uses the
same layout (models/model.py), so the bridge keeps the structure as it is:
bf16 stays bf16, `blocks` leaves stay stacked on the layer axis and the
vocabulary stays padded. The port never imports JAX to load weights: the
tests make the numpy tree and hand it over.

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
