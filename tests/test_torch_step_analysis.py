"""The measured dry run (src/repro_torch/launch/step_analysis.py, the
port's counterpart of the JAX package's launch/hlo_analysis.py) and the
kernel ops' meta branches and reports.

- The seven kernel ops on meta tensors: a result of the plain version's
  shapes and dtypes, no launch counted; under an analysis each reports
  the products FlopCounterMode counts of its plain version on the CPU at
  the same shapes.
- At smoke size on one device, for the six FLOP_ARCHS x 3 modes of
  tests/test_torch_dryrun.py, the meta measurement's flops equal
  FlopCounterMode over the CPU run of the same step (the kernels' plain
  versions), exactly.
- One rank stands for all: on one cell per arch family over a production
  mesh the last rank measures what rank 0 measures, field by field.
- The units: the segments and trips of the JAX package's
  _unit_lowerings on every cell; the generator runs nothing; one unit's
  flops composes the step (the step at one unit plus trip - 1 units).
- args_bytes is the bytes of the rank's inputs (bridge.rank_shards of
  the parameters, the rank's rows); measure_step refuses inside an
  initialised process group; the CLI with --no-units and --analytic,
  and its failure when the counts differ (count_step monkeypatched).
- The 64 cells of tests/_torch_step_cells.py's GROUPS are every case.

The 64 cells themselves: tests/test_torch_step_cells_<n>.py.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.utils.flop_counter import FlopCounterMode

import _torch_step_cells as cells_of
from repro.configs import cells as jcells
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs.base import default_plan as jdefault_plan
from repro.launch.roofline import _unit_lowerings
from repro.models.env import Env as JEnv

from repro_torch import bridge
from repro_torch.configs import cells, get_config, get_shape, get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig, default_plan
from repro_torch.kernels import ANALYSIS
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode_partials
from repro_torch.kernels.paged_decode.ops import (paged_flash_decode,
                                                  paged_flash_decode_quant)
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.sampling.ops import topk_topp_mask
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RF
from repro_torch.launch import step_analysis as SA
from repro_torch.launch import steps as St
from repro_torch.launch.memory_model import tree_bytes
from repro_torch.launch.mesh import ShapeMesh, make_production_mesh
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig, make_train_state

one_torch_thread = cells_of.one_torch_thread

# the same cases as tests/test_torch_dryrun.py's FlopCounterMode test
FLOP_ARCHS = ("yi-9b", "grok-1-314b", "recurrentgemma-9b", "rwkv6-1.6b",
              "qwen2-vl-7b", "whisper-small")
TRAIN_PLAN = ParallelPlan(fsdp=False, remat="nothing",
                          attn_impl="xla_chunked", attn_q_chunk=32,
                          attn_kv_chunk=32, kv_cache="replicated",
                          rwkv_chunk=16)
FLOP_SHAPES = {"train": (2, 64), "prefill": (2, 136), "decode": (3, 64)}


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _normal(g, shape, dtype=torch.float32):
    return _t(g.standard_normal(shape).astype(np.float32), dtype)


# ---- the seven kernel ops ---------------------------------------------------


def _op_cases():
    """(name, op, CPU arguments, keyword arguments) at small shapes."""
    g = _rng(1)
    bf = torch.bfloat16
    B, Hq, Hkv, hd, NB, bs, MB = 3, 4, 2, 16, 6, 8, 2
    tables = _t(g.integers(1, NB, (B, MB)).astype(np.int32))
    lengths = _t(np.array([0, 9, 15], dtype=np.int32))
    q = _normal(g, (B, Hq, hd), bf)
    kp, vp = _normal(g, (NB, Hkv, bs, hd), bf), _normal(g, (NB, Hkv, bs, hd),
                                                        bf)
    k8 = _t(g.integers(-127, 128, (NB, Hkv, bs, hd)).astype(np.int8))
    v8 = _t(g.integers(-127, 128, (NB, Hkv, bs, hd)).astype(np.int8))
    ks, vs = (_t(g.uniform(0.01, 0.1, (NB, Hkv, bs)).astype(np.float32))
              for _ in range(2))
    T, V = 3, 50
    S, Sk = 12, 12
    qa = _normal(g, (2, S, Hq, hd), bf)
    ka, va = _normal(g, (2, Sk, Hkv, hd), bf), _normal(g, (2, Sk, Hkv, hd),
                                                       bf)
    kc, vc = _normal(g, (B, Hkv, 20, hd), bf), _normal(g, (B, Hkv, 20, hd),
                                                       bf)
    a = _t(g.uniform(0.5, 1.0, (2, 7, 24)).astype(np.float32))
    b = _normal(g, (2, 7, 24))
    h0 = _normal(g, (2, 24))
    H = 2
    r, k, v = (_normal(g, (2, 5, H, hd), bf) for _ in range(3))
    logw = _t(-g.uniform(0.01, 2.0, (2, 5, H, hd)).astype(np.float32))
    u = _normal(g, (H, hd))
    return [
        ("paged_flash_decode", paged_flash_decode,
         (q, kp, vp, tables, lengths), {}),
        ("topk_topp_mask", topk_topp_mask,
         (_normal(g, (T, V)), _t(np.array([5, 0, 50], dtype=np.int32)),
          _t(np.array([0.9, 1.0, 0.5], dtype=np.float32))), {}),
        ("paged_flash_decode_quant", paged_flash_decode_quant,
         (q, k8, v8, ks, vs, tables, lengths), {}),
        ("flash_attention", flash_attention, (qa, ka, va),
         {"causal": True, "window": 5}),
        ("flash_decode_partials", flash_decode_partials,
         (q, kc, vc, _t(np.array([3, 19, 0], dtype=np.int32))), {}),
        ("rglru_scan", rglru_scan, (a, b, h0), {}),
        ("wkv6", wkv6, (r, k, v, logw, u), {}),
    ]


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", range(7), ids=[c[0] for c in _op_cases()])
def test_kernel_op_meta_branch_and_report(case):
    name, op, args, kw = _op_cases()[case]
    with FlopCounterMode(display=False) as fc:
        want = op(*args, **kw)
    meta = tuple(x.to("meta") for x in args)
    launches = op.launches
    bare = op(*meta, **kw)  # no analysis active: the shapes alone
    box = {}
    cost = SA.measure(lambda: box.update(out=op(*meta, **kw)), list(meta))
    assert op.launches == launches
    for got in (bare, box["out"]):
        assert len(_outs(got)) == len(_outs(want))
        for x, w in zip(_outs(got), _outs(want)):
            assert x.device.type == "meta"
            assert (tuple(x.shape), x.dtype) == (tuple(w.shape), w.dtype)
    assert cost.kernel_flops == fc.get_total_flops(), name
    assert cost.flops == cost.kernel_flops
    assert (cost.kernel_flops > 0) == (name not in ("topk_topp_mask",
                                                    "rglru_scan"))
    out_bytes = sum(x.numel() * x.element_size() for x in _outs(want))
    assert cost.bytes_accessed >= out_bytes + args[0].numel() * \
        args[0].element_size()
    assert ANALYSIS.sink is None and ANALYSIS.quiet == 0


def test_kernel_op_outside_an_analysis_reports_nothing():
    """A CPU call under an analysis runs the plain version: its tensor
    ops are what the meter counts, the op reports nothing itself."""
    _, op, args, kw = _op_cases()[3]
    cost = SA.measure(lambda: op(*args, **kw), list(args))
    assert cost.kernel_flops == 0 and cost.flops > 0


# ---- the meta measurement against FlopCounterMode on the CPU ----------------


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
def test_meta_measurement_equals_flop_counter(arch, mode):
    cfg = get_smoke(arch)
    env = Env(plan=TRAIN_PLAN) if mode == "train" else Env()
    B, S = FLOP_SHAPES[mode]
    shape = ShapeConfig("t", S, B, mode)
    opt = AdamWConfig()
    params = Mo.init_params(cfg, env, seed=0, device="cpu")
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
        run = lambda: St.greedy(step(params, cache, tok,
                                     torch.tensor(S // 2))[0], cfg, env)
    with FlopCounterMode(display=False) as fc:
        run()
    got = SA.measure_step(cfg, shape, env, opt, units=False)
    assert got.flops == fc.get_total_flops() > 0
    count = RF.count_step(cfg, shape, env, opt)
    assert got.flops + count.unmatmul == count.flops
    # prefill past 128 positions reaches #4 (#7 for RWKV), decode #1
    # (RWKV's decode none): their products come from the kernels'
    # reports; the train step reaches no kernel
    kernel = mode != "train" and not (arch == "rwkv6-1.6b"
                                      and mode == "decode")
    assert (got.kernel_flops > 0) == kernel, got.kernel_flops


# ---- one rank stands for all -------------------------------------------------

FAMILY_CELLS = [("yi-9b", "decode_32k", "single"),
                ("grok-1-314b", "decode_32k", "single"),
                ("recurrentgemma-9b", "long_500k", "multi"),
                ("rwkv6-1.6b", "decode_32k", "multi"),
                ("qwen2-vl-7b", "prefill_32k", "multi"),
                ("whisper-small", "decode_32k", "single")]


def _cell_env(arch, shape, mesh):
    cfg, sh = get_config(arch), get_shape(shape)
    return cfg, sh, Env(plan=default_plan(cfg, sh),
                        mesh=make_production_mesh(multi_pod=mesh == "multi",
                                                  abstract=True))


@pytest.mark.parametrize("arch,shape,mesh", FAMILY_CELLS)
def test_last_rank_measures_what_rank_zero_does(arch, shape, mesh):
    cfg, sh, env = _cell_env(arch, shape, mesh)
    last = env.mesh.size() - 1
    a = SA.measure_step(cfg, sh, env, units=False)
    b = SA.measure_step(cfg, sh, env, units=False, rank=last)
    for f in ("flops", "kernel_flops", "args_bytes", "temp_bytes",
              "bytes_accessed"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.coll.by_type == b.coll.by_type
    assert a.coll.by_axis == b.coll.by_axis
    assert not dist.is_initialized()


# ---- units -------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in jcells()])
def test_units_are_the_jax_packages(arch, shape, monkeypatch):
    jcfg, jsh = jget_config(arch), jget_shape(shape)
    jenv = JEnv(mesh=AbstractMesh((16, 16), ("data", "model")),
                plan=jdefault_plan(jcfg, jsh))
    want = [(n, t) for n, t, _ in _unit_lowerings(jcfg, jsh, jenv)]
    cfg, sh, env = _cell_env(arch, shape, "single")

    def nothing(*_):
        raise AssertionError("unit_runs ran a step before make()")

    monkeypatch.setattr(SA, "_measure_once", nothing)
    got = [(n, t) for n, t, _ in SA.unit_runs(cfg, sh, env)]
    assert got == want


@pytest.mark.parametrize("arch,mode", [("yi-9b", "train"),
                                       ("recurrentgemma-9b", "prefill"),
                                       ("whisper-small", "train"),
                                       ("rwkv6-1.6b", "decode")])
def test_units_compose_the_step(arch, mode):
    """The step at one unit (each segment) plus trip - 1 units of each
    segment is the whole step's measured flops."""
    base = get_smoke(arch)
    cfg = dataclasses.replace(base, n_layers=3 * len(base.block_pattern)
                              + len(base.pattern_tail),
                              **({"encoder_layers": 4}
                                 if base.is_encdec else {}))
    env = Env(plan=TRAIN_PLAN) if mode == "train" else Env()
    B, S = FLOP_SHAPES[mode]
    shape = ShapeConfig("t", S, B, mode)
    full = SA.measure_step(cfg, shape, env)
    segs = {u["segment"]: u for u in full.units}
    assert segs["main"]["trip"] == 3
    assert ("enc" in segs) == (cfg.is_encdec and mode != "decode")
    one = SA.measure_step(SA._depth(cfg, 1, 1 if cfg.is_encdec else None),
                          shape, env, units=False)
    assert all(u["unit_flops"] > 0 for u in full.units)
    assert full.flops == one.flops + sum(
        (u["trip"] - 1) * u["unit_flops"] for u in full.units)


# ---- the rank's arguments, the refusal, the coverage -------------------------


def test_args_bytes_are_the_rank_inputs():
    """One device: the train step's state and batch; over a (2, 4) mesh
    the prefill step's arguments are bridge.rank_shards of the
    one-device parameters and the rank's rows of the batch."""
    cfg = get_smoke("yi-9b")
    shape = ShapeConfig("t", 32, 8, "train")
    env = Env(plan=TRAIN_PLAN)
    opt = AdamWConfig()
    args, _ = St.input_specs(cfg, shape, env, opt)
    got = SA.measure_step(cfg, shape, env, opt, units=False)
    assert got.args_bytes == tree_bytes(list(args)) > 0

    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    plan = ParallelPlan(fsdp=True, remat="nothing", attn_impl="naive")
    shape = ShapeConfig("p", 32, 8, "prefill")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        menv = Env(plan=plan, mesh=mesh)
        whole = Mo.meta_params(cfg, Env(plan=plan))
        want = tree_bytes(bridge.rank_shards(whole, cfg, menv)) + sum(
            v.numel() * v.element_size() // 2
            for v in St.batch_struct(cfg, shape).values())
    finally:
        dist.destroy_process_group()
    got = SA.measure_step(cfg, shape, Env(plan=plan, mesh=ShapeMesh(
        (2, 4), ("data", "model"))), units=False)
    assert got.args_bytes == want


def test_refuses_inside_a_process_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    cfg, sh, env = _cell_env("qwen2-1.5b", "decode_32k", "single")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="process group"):
            SA.measure_step(cfg, sh, env, units=False)
        assert dist.get_world_size() == 4  # the group is left as it was
    finally:
        dist.destroy_process_group()


def test_cell_groups_cover_every_case():
    cases = [c for g in cells_of.GROUPS.values() for c in g]
    assert sorted(cases) == sorted(cells_of.ALL)
    assert len(cases) == len(set(cases)) == 64
    assert len(list(cells())) == 32


# ---- the CLI -----------------------------------------------------------------


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = dryrun.main(argv)
    return rc, buf.getvalue().splitlines()


def test_cli_no_units_and_analytic(tmp_path):
    rc, lines = _cli(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--mesh", "both", "--no-units", "--out",
                      str(tmp_path)])
    ok = [l for l in lines if l.startswith("OK")]
    assert rc == 0 and len(ok) == 2, lines
    assert all("counts=agree" in l for l in ok)
    with open(tmp_path / "multi_pod_2x16x16" / "qwen2-1.5b__decode_32k.json"
              ) as f:
        rep = json.load(f)
    assert rep["units"] == [] and rep["analytic_agrees"] is True
    mem = rep["memory"]
    assert 0 < mem["step_args_bytes"] and 0 < mem["step_temp_bytes"]
    assert mem["step_bytes_accessed"] > mem["step_args_bytes"]
    assert rep["flops_per_device"] + rep["analytic_unmatmul_per_device"] \
        == rep["analytic_flops_per_device"]
    assert rep["collective_by_type"] == rep["analytic_collective_by_type"]
    rc, lines = _cli(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--analytic", "--out", str(tmp_path)])
    ok = [l for l in lines if l.startswith("OK")]
    assert rc == 0 and len(ok) == 1 and "counts=analytic" in ok[0]


def test_cli_fails_when_the_counts_differ(tmp_path, monkeypatch):
    real = RF.count_step

    def off_by_one(*a, **k):
        out = real(*a, **k)
        out.flops += 1
        return out

    monkeypatch.setattr(RF, "count_step", off_by_one)
    rc, lines = _cli(["--arch", "qwen2-1.5b", "--shape", "decode_32k",
                      "--no-units", "--out", str(tmp_path)])
    assert rc == 1, lines
    fail = [l for l in lines if l.startswith("FAIL")]
    assert len(fail) == 1 and "differ" in fail[0]
    assert not any(l.startswith("OK") for l in lines)
