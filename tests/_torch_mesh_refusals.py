"""What the port's model still refuses over a mesh, now that every arch
computes per rank over one (the modality archs included): axes the plan
does not name, compute over a shape-only mesh of more than one device,
and the engines' pools (block tables, row slots) over a DeviceMesh
(ROADMAP item 12). Shared by the three test files whose gloo children
hold a DeviceMesh (tests/test_torch_substrates.py, test_torch_sharded.py
and test_torch_mesh_serving.py).

RANK_CODE runs in a rank child (torch and repro_torch only) with `mesh`,
a DeviceMesh of ("data", "model") over its ranks, and leaves `refused`:
per arch "" when init_params over the mesh accepts it, else the
NotImplementedError's message; per refusal its message, or "" if nothing
was raised. check() holds the children's `refused` and the shape-only
mesh's cases in the test process.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.launch import mesh as LM
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A

MODALITY = ("qwen2-vl-7b", "whisper-small")

RANK_CODE = """
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
refused = {}
for arch in ARCH_IDS:
    try:
        Mo.init_params(get_smoke(arch), Env(plan=ParallelPlan(), mesh=mesh),
                       device="meta")
        refused[arch] = ""
    except NotImplementedError as e:
        refused[arch] = str(e)
tok = torch.zeros((2, 1), dtype=torch.int32)
for what, kw in (("block_tables", {"block_tables": {"global": tok}}),
                 ("row_slots", {"row_slots": tok[:, 0]})):
    try:
        Mo.forward(None, tok, get_smoke("whisper-small"),
                   Env(plan=ParallelPlan(), mesh=mesh), mode="decode",
                   cur_len=0, **kw)
        refused[what] = ""
    except NotImplementedError as e:
        refused[what] = str(e)
try:  # the plan's dp axes leave "data" unnamed
    Mo.init_params(get_smoke("qwen2-vl-7b"), Env(
        plan=ParallelPlan(dp_axes=("pod",)), mesh=mesh), device="meta")
    refused["extra_axes"] = ""
except ValueError as e:
    refused["extra_axes"] = str(e)
"""


def check(refused_by_rank):
    """Every rank accepted every arch over its DeviceMesh and refused
    block tables and row slots (ROADMAP item 12) and an unnamed axis;
    over a shape-only (1, 2) mesh init_params gives the JAX package's
    padded shapes for both modality archs, and their compute raises
    ValueError."""
    assert refused_by_rank
    for refused in refused_by_rank:
        assert all(refused[arch] == "" for arch in ARCH_IDS), refused
        for what in ("block_tables", "row_slots"):
            assert "ROADMAP item 12" in refused[what], refused
        assert "neither the plan's dp axes" in refused["extra_axes"]
    wide = Env(plan=ParallelPlan(), mesh=LM.ShapeMesh((1, 2),
                                                      ("data", "model")))
    jenv = JEnv(mesh=AbstractMesh((1, 2), ("data", "model")), plan=JPlan())
    tok = torch.zeros((1, 4), dtype=torch.int32)
    for arch in MODALITY:
        want = jax.eval_shape(lambda k: JMo.init_params(
            k, get_smoke(arch), jenv), jax.ShapeDtypeStruct((2,), jnp.uint32))
        got = Mo.init_params(torch_smoke(arch), wide, device="meta")
        assert [tuple(x.shape) for x in A.tree_leaves(got)] == \
            [tuple(x.shape) for x in jax.tree.leaves(want)]
        params = Mo.init_params(torch_smoke(arch), Env(), device="cpu")
        for mode in ("train", "prefill"):
            with pytest.raises(ValueError, match="shape-only mesh"):
                Mo.forward(params, tok, torch_smoke(arch), wide, mode=mode)
