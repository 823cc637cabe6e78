"""The port's analytic dry run (src/repro_torch/launch/{memory_model,
roofline,dryrun}.py) against the JAX package's and against what the
port's own step executes.

- cells(), count_params (padded and not), model_flops and analyze_memory
  equal the JAX package's on every cell of cells() over both production
  meshes (JAX over AbstractMesh under default_plan, the port over
  launch/mesh.py's shape-only meshes): integers, so equal, component by
  component.
- The analytic step flops (roofline.count_step) within 1% of
  torch.utils.flop_counter.FlopCounterMode counting the port's own step
  on the CPU (the kernels' plain versions), one device at smoke size, in
  train, prefill and decode, for a dense, an MoE, two recurrent and two
  modality archs. Both count matrix products only; elementwise work
  (norms, rope, softmax, the RG-LRU scan, the depthwise conv, the WKV
  state update, AdamW) is counted by neither. One product is computed
  without a matmul op: the WKV decode step's readout r^T S
  (models/recurrent.py rwkv_time_mix_step, a product and a sum over its
  own row), which FlopCounterMode does not see; the test adds its count
  (StepCount.unmatmul) to the counter's apart. The analytic count is
  exact on every case here (the 1% is the stated bound).
- Over eight gloo ranks, spawned once for the module: the collective
  bytes by type that parallel/collectives.py counts (each collective's
  result bytes on the rank) equal the analytic ones, and the rank's
  product flops equal FlopCounterMode's on the rank: a sharded train
  step of yi-9b smoke at (2, 4) with FSDP (and other archs and meshes),
  grok-1-314b smoke's MoE layer in ep and tp modes at (4, 2), the decode
  step and its greedy pick at (1, 8) under seq_sharded and replicated.
- The same ranks' counters against the measured dry run
  (launch/step_analysis.py measure_step): each step case measured for
  each rank on the meta device inside a fake process group of the
  mesh's size in this process, its collective bytes by type and its
  flops equal to that rank's counters over gloo.
- The dry-run CLI on one cell (the step measured) and on --all --mesh
  single --analytic (the analytic terms of every cell; the measured
  counts of every cell: tests/test_torch_step_cells_<n>.py): exit 0,
  one OK line a cell (32), the rates' sources printed.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs.base import default_plan as jdefault_plan
from repro.launch.memory_model import analyze_memory as janalyze_memory
from repro.launch.roofline import model_flops as jmodel_flops
from repro.models import model as JMo
from repro.models.env import Env as JEnv

from repro_torch.configs import cells, get_config, get_shape, get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig, default_plan
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RF
from repro_torch.launch import steps as St
from repro_torch.launch.memory_model import (analyze_memory,
                                             formula_excess, tree_bytes)
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.launch.step_analysis import measure_step
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import (AdamWConfig, make_train_state,
                                     tree_leaves, value_and_grad)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a, s, _ in jcells()]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FLOP_TOL = 0.01
WORLD = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- eight gloo ranks: collective bytes and per-rank flops ------------------

_RANK = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.launch import roofline as RF
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models import moe as M
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
cases = json.loads(sys.argv[5])
report = {}


def mesh_of(dims):
    if len(dims) == 3:
        return init_device_mesh("cpu", tuple(dims),
                                mesh_dim_names=("pod", "data", "model"))
    return make_test_mesh(world, model=dims[1], device_type="cpu")


def measure(name, fn, want):
    C.collective_bytes(reset=True)
    with FlopCounterMode(display=False) as fc:
        fn()
    got = C.collective_bytes(reset=True)
    report[name] = {"bytes": {k: v for k, v in got.items() if v},
                    "want": {k: v for k, v in want.coll.by_type.items() if v},
                    "flops": fc.get_total_flops(),
                    "want_flops": want.flops - want.unmatmul}


def batch_of(cfg, shape):
    g = np.random.default_rng(3)
    out = {}
    for k, v in St.batch_struct(cfg, shape).items():
        if v.dtype == torch.int32:
            out[k] = torch.from_numpy(g.integers(0, cfg.vocab_size, v.shape)
                                      .astype(np.int32))
        else:
            out[k] = torch.from_numpy(g.standard_normal(v.shape)
                                      .astype(np.float32))
    return out


for name, (kind, arch, dims, B, S, plan_kw, moments) in cases.items():
    cfg = get_smoke(arch)
    env = Env(plan=ParallelPlan(**plan_kw), mesh=mesh_of(dims))
    whole = Mo.init_params(cfg, Env(), seed=0, device="cpu")
    if kind == "train":
        opt = A.AdamWConfig(state_dtype=moments)
        params = bridge.pad_for_mesh(whole, cfg, env)
        state = {"params": params, "opt": A.adamw_init(params, opt)}
        st = R.apply_shardings(state, R.state_specs(state, cfg, env), env)
        shape = ShapeConfig("t", S, B, "train")
        batch = batch_of(cfg, shape)
        batch = R.apply_shardings(batch, R.batch_specs(batch, cfg, shape,
                                                       env), env)
        step = St.make_train_step(cfg, env, opt)
        measure(name, lambda: step(st, batch),
                RF.count_step(cfg, shape, env, opt))
    elif kind == "prefill":
        shape = ShapeConfig("p", S, B, "prefill")
        rows = {k: v.chunk(env.dp)[0] for k, v in batch_of(cfg, shape).items()}
        local = bridge.rank_shards(whole, cfg, env)
        step = St.make_prefill_step(cfg, env)
        measure(name, lambda: step(local, rows),
                RF.count_step(cfg, shape, env))
    elif kind == "moe":
        p = {"moe": {k: v[0] for k, v in whole["blocks"][0]["moe"].items()}}
        local = A.tree_map(lambda t: t.to_local(), R.apply_shardings(
            p, R.param_specs(p, cfg, env), env))["moe"]
        x = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)).bfloat16()
        rows = x.chunk(env.dp)[env.mesh.get_local_rank("data")]
        measure(name, lambda: M.moe_layer(local, rows, cfg, env),
                RF.count_moe_layer(cfg, env, B, S))
    else:  # decode: one step over a contiguous cache, then the greedy pick
        local = bridge.rank_shards(whole, cfg, env)
        cache = Mo.init_cache(cfg, env, B, S, device="cpu")
        tok = torch.ones((B // env.dp, 1), dtype=torch.int32)
        step = St.make_decode_step(cfg, env)

        def decode():
            logits, _ = step(local, cache, tok, torch.tensor(S // 3))
            St.greedy(logits, cfg, env)

        measure(name, decode,
                RF.count_step(cfg, ShapeConfig("d", S, B, "decode"), env))
with open(out + f".{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
"""

_FSDP = {"fsdp": True, "remat": "nothing", "attn_impl": "naive"}
RANK_CASES = {
    # the sharded train step, FSDP, sequence parallelism over S / tp
    "train yi-9b (2,4) fsdp": ("train", "yi-9b", (2, 4), 8, 16, _FSDP,
                               "fp32"),
    # S % tp != 0: no sequence parallelism, the row sums all-reduced
    "train yi-9b (2,4) S=18": ("train", "yi-9b", (2, 4), 8, 18, _FSDP,
                               "fp32"),
    "train grok-1-314b (4,2)": ("train", "grok-1-314b", (4, 2), 8, 16,
                                _FSDP, "fp32"),
    "train recurrentgemma-9b (2,4)": ("train", "recurrentgemma-9b", (2, 4),
                                      8, 16, _FSDP, "fp32"),
    "train whisper-small (2,2,2) int8": ("train", "whisper-small",
                                         (2, 2, 2), 8, 16, _FSDP, "int8"),
    "train rwkv6-1.6b (2,2,2) remat full": (
        "train", "rwkv6-1.6b", (2, 2, 2), 8, 16, dict(_FSDP, remat="full"),
        "fp32"),
    "prefill qwen2-vl-7b (2,4)": ("prefill", "qwen2-vl-7b", (2, 4), 8, 32,
                                  _FSDP, None),
    "moe grok-1-314b ep (4,2)": ("moe", "grok-1-314b", (4, 2), 8, 16,
                                 {"fsdp": True, "moe_mode": "ep"}, None),
    "moe grok-1-314b tp (4,2)": ("moe", "grok-1-314b", (4, 2), 8, 16,
                                 {"fsdp": True, "moe_mode": "tp"}, None),
    "decode paper-demo seq_sharded (1,8)": (
        "decode", "paper-demo", (1, 8), 4, 64,
        {"fsdp": False, "kv_cache": "seq_sharded"}, None),
    "decode whisper-small seq_sharded (1,8)": (
        "decode", "whisper-small", (1, 8), 4, 64,
        {"fsdp": False, "kv_cache": "seq_sharded"}, None),
    "decode grok-1-314b replicated (1,8)": (
        "decode", "grok-1-314b", (1, 8), 4, 64,
        {"fsdp": False, "kv_cache": "replicated"}, None),
}


@pytest.fixture(autouse=True, scope="module")
def gloo_ranks(tmp_path_factory):
    """The eight rank children, started when the module starts (they run
    beside its one-process tests); the test that reads them waits."""
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
    out = str(tmp / "run")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out, json.dumps(RANK_CASES)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    state = {"procs": procs, "out": out, "reports": None}
    yield state
    for p in procs:
        p.kill()


def _rank_reports(state):
    if state["reports"] is None:
        logs = []
        for p in state["procs"]:
            try:
                logs.append(p.communicate(timeout=600)[0])
            finally:
                p.kill()
        assert all(p.returncode == 0 for p in state["procs"]), \
            "\n".join(logs)[-20000:]
        state["reports"] = []
        for r in range(WORLD):
            with open(state["out"] + f".{r}.json") as f:
                state["reports"].append(json.load(f))
    return state["reports"]


# ---- the cells and the JAX package's counts ---------------------------------


def test_cells_are_the_jax_packages():
    assert list(cells()) == list(jcells())
    assert list(cells(include_long_skips=True)) == list(
        jcells(include_long_skips=True))
    assert len(CELLS) == 32 and len(list(cells(True))) == 40


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_and_memory_equal_jax(arch, shape, mesh):
    dims, names = MESHES[mesh]
    jcfg, jshape = jget_config(arch), jget_shape(shape)
    jenv = JEnv(mesh=AbstractMesh(dims, names),
                plan=jdefault_plan(jcfg, jshape))
    cfg, sh = get_config(arch), get_shape(shape)
    env = Env(plan=default_plan(cfg, sh),
              mesh=make_production_mesh(multi_pod=mesh == "multi",
                                        abstract=True))
    for padded in (True, False):
        assert Mo.count_params(cfg, env, padded=padded) == \
            JMo.count_params(jcfg, jenv, padded=padded)
    assert RF.model_flops(cfg, sh, env) == jmodel_flops(jcfg, jshape, jenv)
    want = janalyze_memory(jcfg, jshape, jenv)
    got = analyze_memory(cfg, sh, env)
    assert got.components == want.components
    assert got.traffic_bytes == want.traffic_bytes
    assert got.resident_bytes == want.resident_bytes
    assert got.fits_16GB == want.fits_16GB


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_are_shapes_only(shape):
    """input_specs gives the step's arguments on the meta device, the
    whole (global) trees over the production mesh, and the step of the
    cell's kind (over a mesh of more than one device the sharded train
    step)."""
    cfg, sh = get_config("yi-9b"), get_shape(shape)
    env = Env(plan=default_plan(cfg, sh),
              mesh=make_production_mesh(abstract=True))
    args, step = St.input_specs(cfg, sh, env)
    leaves = tree_leaves(list(args))
    assert leaves and all(x.device.type == "meta" for x in leaves)
    assert callable(step)
    if sh.kind == "train":
        state, batch = args
        assert batch["tokens"].shape == (sh.global_batch, sh.seq_len)
        assert step.__name__ == "train_step"
    elif sh.kind == "decode":
        _, cache, tok, cur = args
        k = cache["blocks"][0]["k"]
        assert k.shape[1:4] == (sh.global_batch, cfg.n_kv_heads, sh.seq_len)
        assert tok.shape == (sh.global_batch, 1) and cur.shape == ()


def test_memory_state_is_what_the_port_allocates():
    """A train cell's weight, gradient and optimizer bytes as the memory
    model counts them (MemoryReport.train_state: P_dev and half of
    opt_rw) on one device against the parameters, gradients and AdamW
    state the port allocates, fp32 and int8 moments. The weights and
    gradients are equal; the optimizer's differ by formula_excess: the
    formula reads each f32 leaf as two bf16 parameters, approximates the
    int8 state's row scales by 0.3 bytes a parameter, and has no step
    counter (the 1 byte allowed is int()'s rounding of 6.3 x P)."""
    cfg = get_smoke("paper-demo")
    env = Env(plan=ParallelPlan(fsdp=False, remat="nothing",
                                attn_impl="naive", kv_cache="replicated"))
    shape = ShapeConfig("t", 16, 2, "train")
    params = Mo.init_params(cfg, env, seed=0, device="cpu")
    tok = torch.zeros((2, 16), dtype=torch.int32)
    _, grads = value_and_grad(lambda p: Mo.lm_loss(
        p, {"tokens": tok, "labels": tok}, cfg, env), params)
    n_f32 = sum(x.numel() for x in tree_leaves(params)
                if x.dtype == torch.float32)
    assert n_f32 > 0
    for dtype, per_param in (("fp32", 12.0), ("int8", 6.3)):
        state = make_train_state(params, AdamWConfig(state_dtype=dtype))
        modeled = analyze_memory(cfg, shape, env, per_param).train_state()
        assert modeled["weights"] == tree_bytes(params)
        assert modeled["grads"] == tree_bytes(grads)
        excess = formula_excess(params, per_param)
        if dtype == "fp32":
            assert excess == 12 * n_f32 - 4
        assert abs(modeled["opt"] - excess
                   - tree_bytes(state["opt"])) <= 1


# ---- analytic step flops against FlopCounterMode, one device ----------------

FLOP_ARCHS = ("yi-9b", "grok-1-314b", "recurrentgemma-9b", "rwkv6-1.6b",
              "qwen2-vl-7b", "whisper-small")
# train under xla_chunked with chunks of 32 (attention_chunked and the
# window span past them), the WKV in chunks of 16; prefill past 128
# positions (the flash branch, the rows padded to two tiles); decode over
# a 64-position cache
TRAIN_PLAN = ParallelPlan(fsdp=False, remat="nothing",
                          attn_impl="xla_chunked", attn_q_chunk=32,
                          attn_kv_chunk=32, kv_cache="replicated",
                          rwkv_chunk=16)
FLOP_SHAPES = {"train": (2, 64), "prefill": (2, 136), "decode": (3, 64)}


def _batch(cfg, shape):
    g = torch.Generator().manual_seed(0)
    out = {}
    for k, v in St.batch_struct(cfg, shape).items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=g,
                                   dtype=torch.int32)
        else:
            out[k] = torch.randn(v.shape, generator=g)
    return out


@pytest.mark.parametrize("mode", sorted(FLOP_SHAPES))
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_step_flops_match_flop_counter(arch, mode):
    cfg = get_smoke(arch)
    env = Env(plan=TRAIN_PLAN) if mode == "train" else Env()
    B, S = FLOP_SHAPES[mode]
    shape = ShapeConfig("t", S, B, mode)
    params = Mo.init_params(cfg, env, seed=0, device="cpu")
    opt = AdamWConfig()
    if mode == "train":
        step, state = (St.make_train_step(cfg, env, opt),
                       make_train_state(params, opt))
        batch = _batch(cfg, shape)
        run = lambda: step(state, batch)
    elif mode == "prefill":
        step, batch = St.make_prefill_step(cfg, env), _batch(cfg, shape)
        run = lambda: step(params, batch)
    else:
        step = St.make_decode_step(cfg, env)
        cache = Mo.init_cache(cfg, env, B, S, device="cpu")
        tok = torch.ones((B, 1), dtype=torch.int32)
        run = lambda: step(params, cache, tok, torch.tensor(S // 2))
    with FlopCounterMode(display=False) as fc:
        run()
    count = RF.count_step(cfg, shape, env, opt)
    # the WKV decode readout: a product without a matmul op
    assert (count.unmatmul > 0) == (arch == "rwkv6-1.6b" and
                                    mode == "decode")
    counted = fc.get_total_flops() + count.unmatmul
    assert counted > 0
    assert abs(count.flops - counted) <= FLOP_TOL * counted, \
        (count.flops, counted)


# ---- the rates and the terms ------------------------------------------------


def test_rates_and_fabric():
    """The H100's rates name their source; the production meshes' axes
    all cross nodes (the 16-wide model axis spans two 8-GPU nodes), a
    (1, 8) mesh's model axis stays on NVLink; the ring model weighs an
    all-reduce twice."""
    assert "data sheet" in RF.H100["source"]
    assert RF.H100["bf16_flops"] == 989e12
    assert RF.H100["hbm_bytes_per_s"] == 3.35e12
    assert RF.axis_fabric({"data": 16, "model": 16}) == {
        "data": "network", "model": "network"}
    assert RF.axis_fabric({"data": 1, "model": 8}) == {
        "data": "nvlink", "model": "nvlink"}
    assert RF.axis_fabric({"data": 2, "model": 4}) == {
        "data": "nvlink", "model": "nvlink"}
    c = RF.CollectiveStats()
    c.add("all-reduce", 450e9, "model")
    c.add("all-gather", 450e9, "model")
    assert c.weighted_time({"model": "nvlink"}) == pytest.approx(3.0)
    assert c.weighted_time({"model": "network"}) == pytest.approx(27.0)
    rep = RF.analyze_cell("yi-9b", "decode_32k",
                          make_production_mesh(abstract=True))
    assert rep["step_s_lower"] == max(rep["compute_s"], rep["memory_s"],
                                      rep["collective_s"])
    assert 0 < rep["useful_flops_ratio"] <= 1
    assert rep["memory"]["fits_device"]


# ---- the collective bytes over eight gloo ranks -----------------------------


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_collective_bytes_equal_the_counted(gloo_ranks, case):
    reports = _rank_reports(gloo_ranks)
    for r, rep in enumerate(reports):
        got = rep[case]
        assert got["bytes"], (r, case)
        assert got["bytes"] == got["want"], (r, got)
        assert got["flops"] == got["want_flops"], (r, got)


@pytest.mark.parametrize("case", sorted(c for c, v in RANK_CASES.items()
                                         if v[0] != "moe"))
def test_measured_step_equals_the_ranks_counters(gloo_ranks, case):
    """The fake group's meta measurement of each rank against that rank's
    counters over gloo (the step cases; the MoE layer alone is no
    step)."""
    kind, arch, dims, B, S, plan_kw, moments = RANK_CASES[case]
    names = ("pod", "data", "model") if len(dims) == 3 else ("data",
                                                            "model")
    env = Env(plan=ParallelPlan(**plan_kw), mesh=ShapeMesh(dims, names))
    shape = ShapeConfig(kind[0], S, B, kind)
    opt = AdamWConfig(state_dtype=moments) if moments else None
    reports = _rank_reports(gloo_ranks)
    for r, rep in enumerate(reports):
        got = measure_step(get_smoke(arch), shape, env, opt, units=False,
                           rank=r)
        want = rep[case]
        assert {k: v for k, v in got.coll.by_type.items() if v} == \
            want["bytes"], (r, case)
        assert got.flops == want["flops"], (r, case)


# ---- the CLI ----------------------------------------------------------------


def test_dryrun_cli_one_cell(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-9b", "--shape", "train_4k", "--out", str(tmp_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    ok = [l for l in out.stdout.splitlines() if l.startswith("OK")]
    assert len(ok) == 1 and "yi-9b" in ok[0] and "dom=" in ok[0]
    assert "data sheet" in out.stdout
    with open(tmp_path / "single_pod_16x16" / "yi-9b__train_4k.json") as f:
        rep = json.load(f)
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "model_flops_global", "analytic_flops_global",
                "useful_flops_ratio", "step_s_lower", "step_s_upper",
                "roofline_fraction", "memory", "collective_by_type",
                "step_flops_global", "analytic_flops_per_device",
                "analytic_collective_by_type", "units"):
        assert key in rep
    assert "counts=agree" in ok[0] and rep["analytic_agrees"] is True
    assert rep["units"] == [{"segment": "main", "trip": 48,
                             "unit_flops": rep["units"][0]["unit_flops"]}]
    for key in ("step_args_bytes", "step_temp_bytes", "step_bytes_accessed"):
        assert rep["memory"][key] > 0


def test_dryrun_cli_all_cells_single_mesh(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(["--all", "--mesh", "single", "--analytic",
                          "--out", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert rc == 0, buf.getvalue()[-5000:]
    assert sum(l.startswith("OK   single_pod_16x16") for l in lines) == 32
    assert all("counts=analytic" in l for l in lines if l.startswith("OK"))
    assert not any(l.startswith("FAIL") for l in lines)
    assert len(os.listdir(tmp_path / "single_pod_16x16")) == 32
