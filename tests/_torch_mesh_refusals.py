"""What the port's model accepts and still refuses over a mesh, now that
every arch computes per rank over one (the modality archs included) and
the engines' pools decode over one in either KV layout (ROADMAP item
12): it refuses axes the plan does not name and compute over a
shape-only mesh of more than one device. Shared by the three test files
whose gloo children hold a DeviceMesh (tests/test_torch_substrates.py,
test_torch_sharded.py and test_torch_mesh_serving.py).

RANK_CODE runs in a rank child (torch and repro_torch only) with `mesh`,
a DeviceMesh of ("data", "model") over its ranks, and leaves `refused`:
per arch "" when init_params over the mesh accepts it, else the
NotImplementedError's message; per refusal its message, or "" if nothing
was raised; for block tables and row slots (the engines' pools: the
paged pool under either layout, the slot pool under either) "" when a
decode step over the mesh returns finite logits of its rows and, on the
rank of a 1 x 1 mesh, the one-device step's logits: bit for bit, but for
row slots under the seq_sharded layout within LAYOUT_TOL = 0.0625 (the
bound tests/test_torch_mesh_serving.py holds the seq_sharded one-shot's
decode to: kernel #5's plain version over the positions, its partials
merged, against the one-device step's paged-decode attention, two f32
attentions summed in another order). check() holds the children's
`refused` and the shape-only mesh's cases in the test process.
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
from repro_torch import bridge
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.env import SERVE_PLAN
cfg = get_smoke("paper-demo")
params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
one = make_test_mesh(1, model=1, device_type=mesh.device_type)
tok = torch.tensor([[5], [7]], dtype=torch.int32)


def pool_decode(env, what):
    # one decode step of two rows over a pool: block tables into a paged
    # pool, or row slots into a slot pool's contiguous cache
    p = (bridge.rank_shards(params, cfg, env) if env.mesh is not None
         else params)
    if what == "block_tables":
        caches = Mo.init_paged_cache(cfg, env, 3, 16, device="cpu")
        kw = {"block_tables": {"global": torch.tensor([[2], [1]],
                                                      dtype=torch.int32)}}
    else:
        caches = Mo.init_cache(cfg, env, 2, 16, device="cpu",
                               whole_rows=True)
        kw = {"row_slots": torch.tensor([1, 0], dtype=torch.int32)}
    return Mo.forward(p, tok, cfg, env, mode="decode", caches=caches,
                      cur_len=torch.tensor([3, 0]), **kw)[0]


for what, plan in (("block_tables", ParallelPlan()),
                   ("row_slots", SERVE_PLAN),
                   ("row_slots_seq_sharded", ParallelPlan())):
    kind = what.split("_seq")[0]
    try:
        lg = pool_decode(Env(plan=plan, mesh=mesh), kind)
        ok = lg.shape[0] == 2 and bool(torch.isfinite(lg.float()).all())
        if one.get_coordinate() is not None:
            a = pool_decode(Env(plan=plan, mesh=one), kind)
            b = pool_decode(Env(plan=plan), kind)
            ok = ok and (torch.equal(a, b) if what != "row_slots_seq_sharded"
                         else float((a.float() - b.float()).abs().max())
                         <= 0.0625)
        refused[what] = "" if ok else "differs from one device"
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
    """Every rank accepted every arch over its DeviceMesh, decoded through
    block tables and row slots over it in either layout (a 1 x 1 mesh the
    one-device step's logits), and refused an unnamed axis;
    over a shape-only (1, 2) mesh init_params gives the JAX package's
    padded shapes for both modality archs, and their compute raises
    ValueError."""
    assert refused_by_rank
    for refused in refused_by_rank:
        assert all(refused[arch] == "" for arch in ARCH_IDS), refused
        for what in ("block_tables", "row_slots", "row_slots_seq_sharded"):
            assert refused[what] == "", refused
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
