"""The port's training substrates against the JAX package: the data
pipeline, the checkpoint manager, int8 error-feedback gradient
compression, the sharding rules and the mesh constructors.

Inputs are made with numpy (or by the JAX package, for trees handed to
both) and go through both packages on the CPU. Tolerances, and why:
- Data batches, checkpoints (files, manifests, restored leaves),
  compress_decompress, the EF residual and the resolved sharding specs:
  equal, bit for bit or entry for entry. Each is the same arithmetic on
  the same numbers (numpy's Philox streams; f32 elementwise ops each
  rounded once), or no arithmetic at all.
- ef_psum_grads' synced mean: within EF_TOL relative to the largest
  value. The four ranks' views are summed by a gloo all-reduce in its
  order and by JAX's pmean in another; each f32 add rounds once, so the
  sums of four terms of size ~1 part by a few ulps (~1e-7).

The multi-rank cases (ef_psum_grads, apply_shardings over a 2x2
DeviceMesh) share one spawn of four gloo children per module: each child
imports torch and repro_torch only.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

try:  # optional test dep: falls back to fixed deterministic examples
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.configs.base import ShapeConfig as JShape
from repro.data import pipeline as JD
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.parallel import rules as JR
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.data import pipeline as D
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.optim import compress as C
from repro_torch.parallel import rules as R

import _torch_mesh_refusals as refusals

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EF_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    """A torch tensor's bits as numpy (bf16 as uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jnp(a):
    """A JAX array's bits as numpy (bf16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


# ---- data pipeline -----------------------------------------------------------


@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (3, 5, 1, 2), (7, 123, 3, 4),
                          (2**20, 9999, 0, 8)])
def test_synthetic_batches_equal_jax(seed, step, shard, n_shards):
    j = JD.SyntheticLM(1000, 32, seed).batch_np(step, 8, shard, n_shards)
    t = D.SyntheticLM(1000, 32, seed).batch_np(step, 8, shard, n_shards)
    for k in ("tokens", "labels"):
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])


@pytest.mark.parametrize("seed,step,shard,n_shards",
                         [(0, 0, 0, 1), (5, 17, 1, 4)])
def test_memmap_batches_equal_jax(tmp_path, seed, step, shard, n_shards):
    path = str(tmp_path / "corpus.bin")
    D.MemmapCorpus.write(path, np.arange(20_000) * 7919 % 50_257)
    j = JD.MemmapCorpus(path, 64, seed).batch_np(step, 8, shard, n_shards)
    t = D.MemmapCorpus(path, 64, seed).batch_np(step, 8, shard, n_shards)
    for k in ("tokens", "labels"):
        assert np.array_equal(t[k], j[k])
    assert t["tokens"].shape == (8 // n_shards, 64)


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small"])
def test_modality_stubs_equal_jax(arch):
    for step, seed in ((0, 0), (11, 4)):
        base = JD.SyntheticLM(512, 32, seed).batch_np(step, 4)
        j = JD.add_modality_stubs(dict(base), get_smoke(arch), step, seed)
        t = D.add_modality_stubs(dict(base), torch_smoke(arch), step, seed)
        assert set(t) == set(j) and len(t) == 3
        for k in j:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])


def test_synthetic_determinism():
    src = D.SyntheticLM(1000, 32, seed=3)
    a = src.batch_np(step=5, batch=8)
    b = src.batch_np(step=5, batch=8)
    assert np.array_equal(a["tokens"], b["tokens"])
    c = src.batch_np(step=6, batch=8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert np.array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])


@settings(max_examples=10, deadline=None)
@given(n_shards=st.sampled_from([1, 2, 4]), step=st.integers(0, 100))
def test_shards_are_disjoint_slices(n_shards, step):
    src = D.SyntheticLM(5000, 16, seed=1)
    batches = [src.batch_np(step, 8, shard=s, n_shards=n_shards)
               for s in range(n_shards)]
    for i in range(n_shards):
        again = src.batch_np(step, 8, shard=i, n_shards=n_shards)
        assert np.array_equal(batches[i]["tokens"], again["tokens"])
        for j in range(i + 1, n_shards):
            assert not np.array_equal(batches[i]["tokens"],
                                      batches[j]["tokens"])


def test_memmap_corpus_roundtrip(tmp_path):
    path = str(tmp_path / "corpus.bin")
    D.MemmapCorpus.write(path, np.arange(10_000) % 777)
    c = D.MemmapCorpus(path, seq_len=32, seed=0)
    b = c.batch_np(0, 4)
    assert b["tokens"].shape == (4, 32)
    assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


@pytest.mark.parametrize("arch", ["paper-demo", "qwen2-vl-7b"])
def test_loader_gives_jax_batches_as_torch_tensors(arch):
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    src = D.SyntheticLM(cfg.vocab_size, 16, 2)
    jl = JD.ShardedLoader(JD.SyntheticLM(cfg.vocab_size, 16, 2), jcfg,
                          JShape("t", 16, 4, "train"),
                          JEnv(mesh=None, plan=JPlan()), seed=2)
    tl = D.ShardedLoader(src, cfg, ShapeConfig("t", 16, 4, "train"),
                         Env(), seed=2, device="cpu")
    for step in (0, 3):
        j, t = jl.batch(step), tl.batch(step)
        assert set(t) == set(j)
        for k in j:
            assert isinstance(t[k], torch.Tensor) and t[k].device.type == "cpu"
            assert np.array_equal(_np(t[k]), np.asarray(j[k]))
    with pytest.raises(ValueError, match="shape-only mesh has no ranks"):
        D.ShardedLoader(src, cfg, ShapeConfig("t", 16, 4, "train"),
                        Env(mesh=LM.make_test_mesh(4, abstract=True)))


# ---- checkpoint ------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((8, 16), generator=g).to(torch.bfloat16),
                   "b": torch.randn((16,), generator=g)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": (torch.randn((8, 16), generator=g),
                      {"q": torch.randint(-127, 128, (4, 8), generator=g,
                                          dtype=torch.int8), "s": None})},
    }


def _equal_trees(a, b):
    la, lb = A.tree_leaves(a), A.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.cpu(), y.cpu())


def _meta(tree):
    return A.tree_map(lambda x: None if x is None else torch.empty(
        x.shape, dtype=x.dtype, device="meta"), tree)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _tree()
    mgr.save(7, state, {"note": "x"})
    out = mgr.restore(_meta(state), device="cpu")
    _equal_trees(out, state)
    assert out["opt"]["m"][1]["s"] is None
    assert isinstance(out["opt"]["m"], tuple)
    assert mgr.metadata()["note"] == "x"
    # a real target places each leaf on its own device
    _equal_trees(mgr.restore(state), state)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.available_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _tree()
    mgr.save_async(9, state)
    mgr.wait()
    assert mgr.latest_step() == 9
    _equal_trees(mgr.restore(_meta(state), device="cpu"), state)


def test_async_save_writes_the_state_as_it_was_when_called(tmp_path):
    """save_async, then an in-place update of every leaf (as AdamW updates
    the master weights and moments), then the write: the checkpoint holds
    the values from before the update. The pool is held busy until after
    the update, so a write that read live tensors would see new values."""
    import threading
    mgr = CheckpointManager(str(tmp_path))
    state = _tree()
    before = A.tree_map(lambda x: None if x is None else x.clone(), state)
    gate = threading.Event()
    blocker = mgr._pool.submit(gate.wait, 60)
    mgr.save_async(3, state)
    with torch.no_grad():
        for x in A.tree_leaves(state):
            x.add_(1)
    gate.set()
    mgr.wait()
    assert blocker.result() is True
    _equal_trees(mgr.restore(_meta(state), device="cpu"), before)


def test_checkpoint_rejects_tree_and_shape_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _tree()
    mgr.save(1, state)
    with pytest.raises(ValueError, match="tree mismatch"):
        mgr.restore({"params": _meta(state["params"])}, device="cpu")
    bad = _meta(state)
    bad["params"]["w"] = torch.empty((8, 17), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(bad, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        CheckpointManager(str(tmp_path / "empty")).restore(_meta(state))


def _jax_train_state(state_dtype):
    """A JAX yi-9b smoke train state (PRNGKey(0) weights) one AdamW step
    in, so the moments (and int8 scales) are not zeros."""
    cfg = get_smoke("yi-9b")
    opt = JA.AdamWConfig(state_dtype=state_dtype, warmup_steps=0)
    params = JMo.init_params(jax.random.PRNGKey(0), cfg,
                             JEnv(mesh=None, plan=JPlan()))
    state = JA.make_train_state(params, opt)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(size=p.shape).astype(np.float32)).astype(p.dtype), params)
    new_params, new_opt = jax.jit(JA.adamw_update, static_argnums=2)(
        grads, state["opt"], opt)
    return {"params": new_params, "opt": new_opt}, opt


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_checkpoints_cross_between_packages_bit_for_bit(tmp_path,
                                                        state_dtype):
    """JAX writes, the port restores every leaf bit for bit (onto its own
    meta struct of the same tree); the port writes the same state and
    its step directory equals JAX's file for file, byte for byte
    (manifest included); JAX restores the port's bit for bit."""
    jstate, jopt = _jax_train_state(state_dtype)
    JCheckpointManager(str(tmp_path / "jax")).save(3, jstate, {"epoch": 1})
    cfg = torch_smoke("yi-9b")
    struct = St.state_struct(cfg, Env(), A.AdamWConfig(
        state_dtype=state_dtype))
    mgr = CheckpointManager(str(tmp_path / "jax"))
    got = mgr.restore(struct, device="cpu")
    assert mgr.metadata() == {"epoch": 1}
    jleaves = jax.tree.leaves(jstate)
    tleaves = A.tree_leaves(got)
    assert len(tleaves) == len(jleaves)
    assert state_dtype == "int8" or len(tleaves) == 49
    for j, t in zip(jleaves, tleaves):
        assert np.array_equal(_np(t), _jnp(j)) and _np(t).dtype == \
            _jnp(j).dtype
    if state_dtype == "int8":
        assert got["opt"]["m"]["final_norm"]["s"] is None
    CheckpointManager(str(tmp_path / "torch")).save(
        3, bridge.to_torch(jax.tree.map(np.asarray, jstate), "cpu"),
        {"epoch": 1})
    step_dir = "step_00000003"
    jfiles = _files(str(tmp_path / "jax" / step_dir))
    tfiles = _files(str(tmp_path / "torch" / step_dir))
    assert list(tfiles) == list(jfiles)
    wk = "__opt_____m_____blocks____0____attn_____wk__"
    assert (wk + ".npy" if state_dtype == "fp32"
            else wk[:-2] + "_____q__.npy") in tfiles
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    back = JCheckpointManager(str(tmp_path / "torch")).restore(
        jax.eval_shape(lambda: jstate))
    for j, b in zip(jleaves, jax.tree.leaves(back)):
        assert b.dtype == j.dtype and np.array_equal(_jnp(b), _jnp(j))


# ---- gradient compression ------------------------------------------------------


def _ef_inputs(seed, world=1):
    """Per-rank gradients (f32 2-D, bf16 2-D, a 1-D leaf) and carried
    errors, [world, ...] each."""
    rng = np.random.default_rng(seed)
    g = {"w": rng.normal(size=(world, 8, 32)).astype(np.float32),
         "e": (rng.normal(size=(world, 4, 16)).astype(jnp.bfloat16),),
         "b": rng.normal(size=(world, 32)).astype(np.float32)}
    e = {"w": rng.normal(size=(world, 8, 32)).astype(np.float32) * 1e-2,
         "e": (rng.normal(size=(world, 4, 16)).astype(np.float32) * 1e-2,),
         "b": rng.normal(size=(world, 32)).astype(np.float32) * 1e-2}
    return g, e


def _to_torch(a):
    return bridge.to_torch(np.asarray(a), "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_decompress_equals_jax(seed):
    g, e = _ef_inputs(seed)
    for gx, ex in zip(jax.tree.leaves(g), jax.tree.leaves(e)):
        jdq, jerr = JC.compress_decompress(jnp.asarray(gx[0]),
                                           jnp.asarray(ex[0]))
        tdq, terr = C.compress_decompress(_to_torch(gx[0]), _to_torch(ex[0]))
        assert tdq.dtype == torch.float32
        assert np.array_equal(tdq.numpy(), np.asarray(jdq))
        assert np.array_equal(terr.numpy(), np.asarray(jerr))
    # a 1-D leaf passes through unquantized: no residual
    _, terr = C.compress_decompress(_to_torch(g["b"][0]), _to_torch(e["b"][0]))
    assert not terr.any()


def test_error_feedback_reduces_bias():
    """With EF, the accumulated compressed sum tracks the true sum."""
    g = torch.randn((8, 128), generator=torch.Generator().manual_seed(0)) \
        * 0.01
    err = torch.zeros_like(g)
    acc_c, acc_t = torch.zeros_like(g), torch.zeros_like(g)
    for _ in range(50):
        dq, err = C.compress_decompress(g, err)
        acc_c += dq
        acc_t += g
    rel = float(torch.linalg.norm(acc_c - acc_t) / torch.linalg.norm(acc_t))
    assert rel < 0.01


def test_init_error_is_f32_zeros_in_the_tree():
    params = _tree()["params"]
    err = C.init_error(params)
    assert set(err) == set(params)
    for p, e in zip(A.tree_leaves(params), A.tree_leaves(err)):
        assert e.dtype == torch.float32 and e.shape == p.shape
        assert not e.any()


# ---- sharding rules ----------------------------------------------------------------


MESHES = [((1, 1), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _spec_leaves(tree):
    """Spec entries of a spec tree in leaf order (P and Spec are leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not isinstance(tree, (P, R.Spec)):
        return [x for v in tree for x in _spec_leaves(v)]
    return [] if tree is None else [tuple(tree)]


def _as_meta(struct):
    return jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), struct)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolved_specs_equal_jax(arch):
    """param_specs, state_specs (fp32 and int8 moments), cache_specs and
    batch_specs over meshes (1,1), (4,2) and (2,16,16), fsdp on and off,
    and every MoE mode, resolved on JAX's structs (the shapes of each
    mesh's tp degree), entry for entry."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    modes = ("auto", "ep", "tp") if cfg.moe is not None else ("auto",)
    jshape = JShape("d", 32, 8, "decode")
    shape = ShapeConfig("d", 32, 8, "decode")
    checked = 0
    for dims, names in MESHES:
        jmesh = AbstractMesh(dims, names)
        mesh = LM.ShapeMesh(dims, names)
        structs = {}
        for fsdp in (False, True):
            for mode in modes:
                kw = dict(fsdp=fsdp, moe_mode=mode)
                jenv, env = (JEnv(mesh=jmesh, plan=JPlan(**kw)),
                             Env(plan=ParallelPlan(**kw), mesh=mesh))
                assert (env.tp, env.dp, env.dpx) == (jenv.tp, jenv.dp,
                                                     jenv.dpx)
                for sd in ("fp32", "int8"):
                    if sd not in structs:
                        structs[sd] = JSt.state_struct(
                            jcfg, jenv, JA.AdamWConfig(state_dtype=sd))
                    js = structs[sd]
                    ts = _as_meta(js)
                    pairs = [(JR.state_specs(js, jcfg, jenv),
                              R.state_specs(ts, cfg, env))]
                    if sd == "fp32":
                        pairs.append((JR.param_specs(js["params"], jcfg,
                                                     jenv),
                                      R.param_specs(ts["params"], cfg, env)))
                    for j, t in pairs:
                        jl, tl = _spec_leaves(j), _spec_leaves(t)
                        assert len(jl) == len(tl) > 0
                        assert tl == jl
                        checked += len(tl)
                if "cache" not in structs:
                    structs["cache"] = JSt.cache_struct(jcfg, jenv, jshape)
                jc = structs["cache"]
                assert _spec_leaves(R.cache_specs(_as_meta(jc), cfg, env)) \
                    == _spec_leaves(JR.cache_specs(jc, jcfg, jenv))
                for B in (8, 6):
                    b = {"tokens": jax.ShapeDtypeStruct((B, 32), jnp.int32),
                         "frames": jax.ShapeDtypeStruct((B, 4, 64),
                                                        jnp.float32)}
                    js_, ts_ = (JShape("b", 32, B, "train"),
                                ShapeConfig("b", 32, B, "train"))
                    assert _spec_leaves(
                        R.batch_specs(_as_meta(b), cfg, ts_, env)) == \
                        _spec_leaves(JR.batch_specs(b, jcfg, js_, jenv))
    assert checked > 0
    if arch == "yi-9b":  # the example in the reference's terms
        env = Env(plan=ParallelPlan(), mesh=LM.ShapeMesh(
            (2, 16, 16), ("pod", "data", "model")))
        struct = _as_meta(JSt.state_struct(
            jcfg, JEnv(mesh=AbstractMesh((2, 16, 16),
                                         ("pod", "data", "model")),
                       plan=JPlan()), JA.AdamWConfig()))
        wq = R.state_specs(struct, cfg, env)["params"]["blocks"][0][
            "attn"]["wq"]
        assert wq == (None, ("pod", "data"), "model")


def test_no_mesh_gives_empty_specs_and_leaves_trees_alone():
    cfg = torch_smoke("paper-demo")
    env = Env(plan=ParallelPlan())
    struct = St.state_struct(cfg, env, A.AdamWConfig())
    specs = R.state_specs(struct, cfg, env)
    assert all(s == () for s in _spec_leaves(specs))
    assert R.to_shardings(specs, env) is None
    tree = _tree()
    assert R.apply_shardings(tree, specs, env) is tree


def test_mesh_constructors_resolve_the_production_layout_without_ranks():
    m = LM.make_production_mesh(abstract=True)
    assert (m.shape, m.mesh_dim_names, m.size()) == ((16, 16),
                                                    ("data", "model"), 256)
    m = LM.make_production_mesh(multi_pod=True, abstract=True)
    assert (m.shape, m.mesh_dim_names) == ((2, 16, 16),
                                           ("pod", "data", "model"))
    assert LM.make_test_mesh(8, abstract=True).shape == (4, 2)
    assert LM.make_test_mesh(3, model=2, abstract=True).shape == (3, 1)
    env = Env(plan=ParallelPlan(), mesh=LM.make_test_mesh(8, abstract=True))
    assert (env.axis_names, env.dp_axes, env.tp_axis, env.tp, env.dp) == \
        (("data", "model"), ("data",), "model", 2, 4)


def test_the_model_refuses_a_mesh_of_more_than_one_device(gloo_ranks):
    """What the model still refuses over a mesh (models/env.py
    check_mesh, sharded; models/model.py forward), now that every arch
    computes per rank (ROADMAP item 8.4 closed): over the four gloo
    ranks' 2x2 DeviceMesh every arch is accepted, block tables and row
    slots (the engines' pools, ROADMAP item 12) decode over it in either
    KV layout (a 1 x 1 mesh as one device does; row slots under
    seq_sharded within the seq_sharded decode's tolerance), and an axis
    the plan does not name is refused
    (tests/_torch_mesh_refusals.py). Over a shape-only mesh every
    arch's init_params gives the whole tree padded for the mesh's tp
    degree, the JAX package's shapes under the same mesh, the modality
    archs' included; computing needs a DeviceMesh's ranks (a shape-only
    mesh of two raises ValueError); a mesh of one device computes on
    it."""
    out, _ = gloo_ranks
    reports = []
    for r in range(WORLD):
        with open(out + f".mesh.{r}.json") as f:
            reports.append(json.load(f)["refused"])
    refusals.check(reports)
    shape_mesh = lambda dims: LM.ShapeMesh(dims, ("data", "model"))
    wide = Env(plan=ParallelPlan(), mesh=shape_mesh((1, 2)))
    tok = torch.zeros((1, 4), dtype=torch.int32)
    for arch in ("rwkv6-1.6b", "recurrentgemma-9b"):
        params = Mo.init_params(torch_smoke(arch), Env(), device="cpu")
        with pytest.raises(ValueError, match="shape-only mesh"):
            Mo.forward(params, tok, torch_smoke(arch), wide, mode="train")
    for arch in ("qwen2-1.5b", "granite-3-8b", "grok-1-314b", "rwkv6-1.6b",
                 "recurrentgemma-9b", "qwen2-vl-7b", "whisper-small"):
        jenv = JEnv(mesh=AbstractMesh((1, 2), ("data", "model")),
                    plan=JPlan())
        want = jax.eval_shape(lambda k: JMo.init_params(
            k, get_smoke(arch), jenv), jax.ShapeDtypeStruct((2,), jnp.uint32))
        got = Mo.init_params(torch_smoke(arch), wide, device="meta")
        assert [tuple(x.shape) for x in A.tree_leaves(got)] == \
            [tuple(x.shape) for x in jax.tree.leaves(want)]
    cfg = torch_smoke("paper-demo")
    one = Env(plan=ParallelPlan(fsdp=False, attn_impl="naive"),
              mesh=shape_mesh((1, 1)))
    params = Mo.init_params(cfg, one, device="cpu")
    logits, _ = Mo.forward(params, tok, cfg, one, mode="train")
    assert logits.shape[:2] == (1, 4)
    with pytest.raises(ValueError, match="shape-only mesh"):
        Mo.forward(params, tok, cfg, Env(plan=ParallelPlan(),
                                         mesh=shape_mesh((2, 1))),
                   mode="train")


# ---- four gloo ranks: ef_psum_grads and apply_shardings ------------------------


_RANK = """
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.launch import steps as St
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.optim.compress import ef_psum_grads
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)

# 1. ef_psum_grads on this rank's gradients and errors
z = np.load(out + ".ef.npz")
take = lambda n: torch.from_numpy(z[n][rank])
bf16 = torch.from_numpy(z["g_e"][rank].view(np.int16)).view(torch.bfloat16)
grads = {"w": take("g_w"), "e": (bf16,), "b": take("g_b")}
err = {"w": take("e_w"), "e": (take("e_e"),), "b": take("e_b")}
synced, new_err = ef_psum_grads(grads, err)
np.savez(out + f".ef.{rank}.npz",
         **{f"s_{k}": v.numpy() for k, v in
            zip(("b", "e", "w"), A.tree_leaves(synced))},
         **{f"n_{k}": v.numpy() for k, v in
            zip(("b", "e", "w"), A.tree_leaves(new_err))})

# 2. a paper-demo smoke train state (fsdp, int8 moments) over a 2x2 mesh
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_smoke("paper-demo")
opt = A.AdamWConfig(state_dtype="int8")
plan = ParallelPlan(fsdp=True)
from repro_torch.models import model as Mo
params = Mo.init_params(cfg, Env(plan=plan), seed=0, device="cpu")
state = {"params": params, "opt": A.adamw_init(params, opt)}
env = Env(plan=plan, mesh=mesh)
specs = R.state_specs(state, cfg, env)
dist_state = R.apply_shardings(state, specs, env)
sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
report = {"leaves": 0, "sharded": 0, "bad": []}
flat_specs = []
def walk(t):
    if isinstance(t, dict):
        for k in sorted(t): walk(t[k])
    elif isinstance(t, (tuple, list)) and not isinstance(t, R.Spec):
        for v in t: walk(v)
    elif t is not None:
        flat_specs.append(t)
walk(specs)
for x, d, s in zip(A.tree_leaves(state), A.tree_leaves(dist_state),
                   flat_specs):
    report["leaves"] += 1
    want = list(x.shape)
    for i, e in enumerate(s):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            want[i] //= sizes[a]
    if want != list(x.shape):
        report["sharded"] += 1
    if not torch.equal(d.full_tensor(), x) or \\
            list(d.to_local().shape) != want:
        report["bad"].append([list(x.shape), list(s)])
exec(sys.argv[5])  # tests/_torch_mesh_refusals.py RANK_CODE: `refused`
report["refused"] = refused
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".mesh.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
"""

WORLD = 4


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """One spawn of four gloo children for the module's multi-rank cases;
    returns the output prefix they wrote under."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = str(tmp / "run")
    g, e = _ef_inputs(7, WORLD)
    np.savez(out + ".ef.npz", g_w=g["w"], g_e=g["e"][0].view(np.uint16),
             g_b=g["b"], e_w=e["w"], e_e=e["e"][0], e_b=e["b"])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out, refusals.RANK_CODE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=300)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return out, (g, e)


def test_ef_psum_grads_over_four_gloo_ranks_matches_jax(gloo_ranks):
    """Each rank's synced gradients against JAX's ef_psum_grads under
    jax.vmap(axis_name="r") over the same four ranks' inputs (within
    EF_TOL: the sums run in another order); each rank's new error is its
    own residual, bit for bit."""
    out, (g, e) = gloo_ranks
    jg = {"w": jnp.asarray(g["w"]), "e": (jnp.asarray(g["e"][0]),),
          "b": jnp.asarray(g["b"])}
    je = jax.tree.map(jnp.asarray, e)
    jsync, jerr = jax.vmap(lambda a, b: JC.ef_psum_grads(a, b, "r"),
                           axis_name="r")(jg, je)
    for r in range(WORLD):
        z = np.load(out + f".ef.{r}.npz")
        for k, js, jn in (("b", jsync["b"], jerr["b"]),
                          ("e", jsync["e"][0], jerr["e"][0]),
                          ("w", jsync["w"], jerr["w"])):
            want = np.asarray(js[r])
            scale = float(np.abs(want).max())
            assert np.abs(z[f"s_{k}"] - want).max() <= EF_TOL * scale, k
            assert np.array_equal(z[f"n_{k}"], np.asarray(jn[r])), k


def test_apply_shardings_over_a_2x2_device_mesh(gloo_ranks):
    """A paper-demo smoke train state (fsdp, int8 moments) distributed
    over a 2x2 (data, model) DeviceMesh of the four gloo ranks: every
    leaf's full_tensor() equals the original on every rank, and every
    local shard has the shape its spec implies."""
    out, _ = gloo_ranks
    for r in range(WORLD):
        with open(out + f".mesh.{r}.json") as f:
            rep = json.load(f)
        assert rep["bad"] == [], rep["bad"][:3]
        assert rep["leaves"] > 0 and rep["sharded"] > rep["leaves"] // 3
