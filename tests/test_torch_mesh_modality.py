"""The two modality archs over the cluster's rendered mesh: qwen2-vl-7b (a
VLM, M-RoPE behind a vision-embedding stub) and whisper-small (an
encoder-decoder behind a frame stub) through the one-shot serve per rank
in both KV layouts, the sharded train step and the ElasticTrainer, over
eight gloo ranks on the CPU, against JAX's serve_batch and trainer over
its own rendered mesh of the same shape and the port's own one-device
results.

One spawn of eight rank children (torch and repro_torch only) runs every
port case: the VirtualCluster's rendered DeviceMesh under the process
group ((1, 2) and (1, 8), one device a node) or make_test_mesh's (2, 2)
and (1, 1), serve_batch submitted over it (zero stubs, as JAX's
serve_batch feeds), the teacher-forced logits of serve_logits, each
rank's prefill caches and logits on seeded nonzero stubs, run_oneshot,
the sharded train step and the ElasticTrainer over VirtualCluster(
n_compute=4, devices_per_node=2)'s mesh of eight. One JAX child on eight
forced host devices runs JAX's serve_batch over VirtualCluster(
n_compute=n).submit (or a (2, 2) Mesh), its prefill and decode logits
recorded by a host callback in its step builders; another runs JAX's
ElasticTrainer over its rendered mesh of eight; one torchrun of the
serve CLI over two gloo ranks runs `--arch whisper-small --trace
oneshot`. All cases use the JAX package's PRNGKey(0) smoke parameters
(the bridge), 8 prompts of 16 tokens and 8 generated tokens; whisper
also at 160 tokens (80 frames: the encoder past the flash branch's 128)
and at 24 (12 frames over tp 8: the seq_sharded cross cache whole on
every rank), qwen2-vl at 128 (8 vision + 128 positions, past 128).
Tolerances, and why:
- A 1 x 1 mesh: none. Under the replicated layout it computes the
  one-device products (the same row tiles): tokens and every step's
  logits bit for bit, its caches the one device's.
- JAX_TOL = 0.125 absolute on the prefill's last-position logits and
  on every decode step before the first token either side picks
  differently, with the near-tie oracle on the tokens (one flip changes
  every later token), as tests/test_torch_mesh_serving.py holds the
  text archs: the port sums a row product's tp shares in f32 and rounds
  once, keeps its decode probabilities in f32 (tests/test_torch_modality
  .py), and JAX's GSPMD program rounds otherwise.
- CACHE_TOL = 0.0625 absolute: each rank's prefill caches (xk / xv
  included) and its last-position logits on seeded nonzero stubs,
  against the one-device prefill's cut to the rank's rows, heads or
  positions (frames for the cross caches); a cache share the one device
  holds as zeros (a padding head's) is exactly zero.
- LAYOUT_TOL = 0.0625 absolute: the seq_sharded decode (kernel #5's
  plain version over the rank's positions and frames, merged across
  the ranks) against the replicated one, along the replicated run's
  tokens.
- TRAIN_TOL = 5e-4 relative: the sharded train step over (1, 2) and (2,
  2) (fsdp, three steps, seeded stubs) against the port's one-device
  losses on the same bridged state, as the text archs'.
- JAX8_TOL = 1e-3 relative: the ElasticTrainer over the eight ranks
  against JAX's over its mesh of eight, from one step-0 checkpoint of
  JAX's weights (heads padded for tp 8), as tests/test_torch_ranks.py
  holds yi-9b.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.configs.base import ShapeConfig as JShape
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro.parallel import rules as JR
from repro.serve import SERVE_PLAN as JSERVE_PLAN
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.data import add_modality_stubs
from repro_torch.launch import mesh as LM
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import rules as R

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 8
B, S, GEN = 8, 16, 8
JAX_TOL = 0.125
LAYOUT_TOL = 0.0625
CACHE_TOL = 0.0625
TRAIN_TOL = 5e-4
JAX8_TOL = 1e-3
LR = 1e-3
VLM, AUDIO = "qwen2-vl-7b", "whisper-small"
ARCHS = (VLM, AUDIO)
LAYOUTS = ("replicated", "seq_sharded")

# name: (arch, mesh (data, model), who renders it, kv_cache, prompt length)
SERVE = {f"{a}/1x{n}/{lay}": (a, (1, n), "cluster", lay, S)
         for a in ARCHS for n in (2, 8) for lay in LAYOUTS}
SERVE.update({f"{a}/2x2/{lay}": (a, (2, 2), "test", lay, S)
              for a in ARCHS for lay in LAYOUTS})
SERVE.update({f"{a}/1x8/{lay}/{n}": (a, (1, 8), "cluster", lay, n)
              for a, n in ((AUDIO, 160), (AUDIO, 24), (VLM, 128))
              for lay in LAYOUTS})
ONE = ARCHS  # a 1 x 1 mesh, the replicated layout
TRAIN = {f"{a}/{m[0]}x{m[1]}": (a, m) for a in ARCHS
         for m in ((1, 2), (2, 2))}
TRAIN_STEPS = 3
JAX_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_batch(cfg, n):
    """The train batch: 8 seeded sequences of n tokens and the arch's
    stubs (data/pipeline.py add_modality_stubs, the same numpy in both
    packages)."""
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, n)).astype(np.int32)
    return add_modality_stubs({"tokens": tokens, "labels": tokens}, cfg, 0)


_RANK = """
import argparse
import dataclasses
import json
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.data import add_modality_stubs
from repro_torch.launch import serve as cli
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models.env import SERVE_PLAN, Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
exec(sys.argv[5])  # _stub_batch, from the test module
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
with open(out + ".cases.json") as f:
    cases = json.load(f)
B, GEN = cases["B"], cases["GEN"]


def jax_params(arch):
    z = np.load(out + f".params.{arch}.npz")
    struct = Mo.init_params(get_smoke(arch), Env(), device="meta")
    i = iter(range(len(A.tree_leaves(struct))))
    return A.tree_map(lambda s: torch.from_numpy(z["p%%d" %% next(i)])
                      .view(s.dtype), struct)


PARAMS = {a: jax_params(a) for a in cases["archs"]}


def prompts(cfg, n):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, n),
                                             dtype=np.int32)


def stubs_of(cfg, n):
    # seeded nonzero stubs of the whole batch (numpy)
    g = np.random.default_rng(1)
    return {k: torch.from_numpy(g.standard_normal(v.shape).astype(
        np.float32)) for k, v in cli.modality_stubs(cfg, B, n, "cpu").items()}


def plan_of(layout):
    return dataclasses.replace(SERVE_PLAN, kv_cache=layout)


CLUSTERS = {n: VirtualCluster(n_compute=n, devices_per_node=1, device="cpu")
            for n in (2, 8)}
TEST_MESHES = {(2, 2): make_test_mesh(4, model=2, device_type="cpu"),
               (1, 1): make_test_mesh(1, model=1, device_type="cpu")}


def submit(source, shape, fn):
    if source == "cluster":
        c = CLUSTERS[shape[1]]
        assert tuple(c.rendering.mesh.shape) == tuple(shape)
        return c.submit(fn)
    mesh = TEST_MESHES[tuple(shape)]
    return None if mesh.get_coordinate() is None else fn(mesh)


def cut(kind, name, x, coord, shape, layout, cfg, env, stacked):
    # the one-device cache leaf x cut to the rank's share (see the test)
    d, r = coord
    lead = 1 if stacked else 0
    x = np.array_split(x, shape[0], axis=lead)[d]
    tp = shape[1]
    if layout == "seq_sharded":
        if name in ("k", "v") or x.shape[-2] %% tp == 0:
            return [np.array_split(x, tp, axis=-2)[r]]
        return [x]  # a cross cache tp does not split: whole
    hq = Mo.head_pad(cfg, env) // tp
    G = hq * tp // x.shape[lead + 1]
    idx = [(r * hq + i) // G for i in range(hq)]
    return [np.take(x, sorted(set(idx)), axis=lead + 1),
            np.take(x, idx, axis=lead + 1)]


def prefill_err(arch, cfg, params, toks, mesh, layout):
    # this rank's grown prefill caches and its last-position logits on
    # seeded nonzero stubs, against the one-device ones, cut
    env = Env(plan=plan_of(layout), mesh=mesh)
    local = bridge.rank_shards(params, cfg, env)
    rows = lambda x: R.local_shard(x, R.Spec(
        (("data",),) + (None,) * (x.dim() - 1)), env)
    stubs = stubs_of(cfg, toks.shape[1])
    batch = {"tokens": rows(torch.from_numpy(toks)),
             **{k: rows(v) for k, v in stubs.items()}}
    lg, caches = St.make_prefill_step(cfg, env)(local, batch)
    caches = Mo.grow_caches(caches, GEN, cfg, env)
    lg = C.gather(C.gather(lg, env, "model", 1), env, ("data",), 0)
    one = Env(plan=plan_of(layout))
    lg1, ref = St.make_prefill_step(cfg, one)(
        bridge.pad_for_mesh(params, cfg, env),
        {"tokens": torch.from_numpy(toks), **stubs})
    ref = Mo.grow_caches(ref, GEN, cfg)
    coord = mesh.get_coordinate()
    errs = {"logits": float((lg - lg1).float().abs().max()), "zeros": 0.0}
    zero_leaves = []
    units = [(k, u, st) for k, u, st in Mo._units(cfg, caches)]
    refs = [u for _, u, _ in Mo._units(cfg, ref)]
    for (kind, unit, st), runit in zip(units, refs):
        for name, x in unit.items():
            want = cut(kind, name, runit[name].float().numpy(), coord,
                       tuple(mesh.shape), layout, cfg, env, st)
            got = x.float().numpy()
            fits = [w for w in want if w.shape == got.shape]
            errs[name] = max(errs.get(name, 0.0), float(
                np.abs(got - fits[0]).max()) if fits else float("inf"))
            if fits and not fits[0].any():  # e.g. a padding head's share
                errs["zeros"] = max(errs["zeros"], float(np.abs(got).max()))
                zero_leaves.append(name)
    return {"errs": errs, "zero_leaves": zero_leaves,
            "shapes": {n: list(x.shape) for n, x in units[0][1].items()}}


report = {"serve": {}, "one": {}, "train": {}}
tokens_rep = {}
for name, (arch, shape, source, layout, n) in cases["serve"].items():
    cfg = get_smoke(arch)
    params = PARAMS[arch]
    toks = prompts(cfg, n)
    plan = plan_of(layout)
    run = lambda mesh: cli.serve_batch(cfg, params, toks, GEN,
                                       streamed_prefill=False, device="cpu",
                                       mesh=mesh, plan=plan)
    got = submit(source, shape, run)
    if got is None:
        continue
    own = submit(source, shape, lambda mesh: cli.serve_logits(
        cfg, params, toks, got, streamed_prefill=False, device="cpu",
        mesh=mesh, plan=plan))
    rec = {"tokens": got.tolist(),
           "prefill": submit(source, shape, lambda mesh: prefill_err(
               arch, cfg, params, toks, mesh, layout))}
    key = name.replace("seq_sharded", "replicated")
    if layout == "replicated":
        tokens_rep[key] = got
    else:  # along the replicated run's tokens
        forced = submit(source, shape, lambda mesh: cli.serve_logits(
            cfg, params, toks, tokens_rep[key], streamed_prefill=False,
            device="cpu", mesh=mesh, plan=plan))
        if rank == 0:
            np.save(out + f".forced.{name.replace('/', '_')}.npy", forced)
    if rank == 0:
        np.save(out + f".logits.{name.replace('/', '_')}.npy", own)
    report["serve"][name] = rec

for arch in cases["one"]:  # a 1 x 1 mesh against one device
    cfg = get_smoke(arch)
    params = PARAMS[arch]
    toks = prompts(cfg, cases["S"])
    mesh = TEST_MESHES[(1, 1)]
    if mesh.get_coordinate() is None:
        continue
    kw = dict(streamed_prefill=False, device="cpu")
    got = cli.serve_batch(cfg, params, toks, GEN, mesh=mesh, **kw)
    want = cli.serve_batch(cfg, params, toks, GEN, **kw)
    lg = cli.serve_logits(cfg, params, toks, got, mesh=mesh, **kw)
    lw = cli.serve_logits(cfg, params, toks, want, **kw)
    report["one"][arch] = {"tokens": np.array_equal(got, want),
                           "logits": bool(np.array_equal(lg, lw)),
                           "prefill": prefill_err(arch, cfg, params, toks,
                                                  mesh, "replicated")}

# run_oneshot under the process group, the serve CLI's parameters (seed 0)
cfg = get_smoke("whisper-small")
args = argparse.Namespace(nodes=2, device="cpu", requests=B,
                          prompt_len=cases["S"], gen=GEN, seed=0)
r = cli.run_oneshot(args, cfg, Mo.init_params(cfg, Env(), seed=0,
                                              device="cpu"))
report["run_oneshot"] = (None if r["tokens"] is None
                         else r["tokens"].tolist())

for name, (arch, shape) in cases["train"].items():
    cfg = get_smoke(arch)
    mesh = make_test_mesh(shape[0] * shape[1], model=shape[1],
                          device_type="cpu")
    if mesh.get_coordinate() is None:
        continue
    env = Env(plan=ParallelPlan(remat="nothing", attn_impl="naive",
                                fsdp=True), mesh=mesh)
    opt = A.AdamWConfig(lr=%(lr)r)
    params = bridge.pad_for_mesh(PARAMS[arch], cfg, env)
    state = {"params": params, "opt": A.adamw_init(params, opt)}
    st = R.apply_shardings(state, R.state_specs(state, cfg, env), env)
    batch = {k: torch.from_numpy(v) for k, v in
             _stub_batch(cfg, cases["S"]).items()}
    batch = R.apply_shardings(batch, R.batch_specs(
        batch, cfg, ShapeConfig("t", cases["S"], 8, "train"), env), env)
    step = St.make_train_step(cfg, env, opt)
    losses = []
    for _ in range(%(steps)d):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    report["train"][name] = losses

# the ElasticTrainer over the mesh the hostfile renders, from JAX's
# step-0 checkpoint
c = VirtualCluster(n_compute=4, devices_per_node=2, device="cpu")
report["jax8"] = {}
for arch in cases["archs"]:
    t = ElasticTrainer(c.template, get_smoke(arch),
                       ShapeConfig("t", cases["S"], 8, "train"),
                       out + f".jax8.{arch}.port", ckpt_every=100)
    report["jax8"][arch] = [t.run_steps(1)["loss"]
                            for _ in range(%(jax_steps)d)]
report["mesh8"] = list(c.rendering.mesh.shape)
c.shutdown()
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
""" % {"lr": LR, "steps": TRAIN_STEPS, "jax_steps": JAX_STEPS}

_JAX = """
import dataclasses
import json
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.core import VirtualCluster
from repro.launch import serve as S
from repro.launch import steps as St
from repro.models import model as Mo
from repro.models.env import Env
from repro.serve import SERVE_PLAN

out = sys.argv[1]
with open(out + ".cases.json") as f:
    cases = json.load(f)
B, GEN = cases["B"], cases["GEN"]
seen = []


def recorded(make):
    # the step's logits, whole, to the host as serve_batch runs it
    def make_step(cfg, env):
        step = make(cfg, env)

        def run(*a):
            logits, caches = step(*a)
            jax.debug.callback(
                lambda x: seen.append(np.asarray(x, np.float32)), logits)
            return logits, caches
        return run
    return make_step


St.make_prefill_step = recorded(St.make_prefill_step)
St.make_decode_step = recorded(St.make_decode_step)
clusters = {n: VirtualCluster(n_compute=n, devices_per_node=1)
            for n in (2, 8)}
report = {}
for name, (arch, shape, source, layout, n) in cases["serve"].items():
    cfg = get_smoke(arch)
    params = Mo.init_params(jax.random.PRNGKey(0), cfg,
                            Env(None, SERVE_PLAN))
    toks = jnp.asarray(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, n), dtype=np.int32))
    plan = dataclasses.replace(SERVE_PLAN, kv_cache=layout)
    seen.clear()
    try:
        if source == "cluster":
            c = clusters[shape[1]]
            assert tuple(c.rendering.mesh.devices.shape) == tuple(shape)
            got = c.submit(S.serve_batch, cfg, params, toks, GEN, plan)
        else:
            mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]])
                        .reshape(shape), ("data", "model"))
            with mesh:
                got = S.serve_batch(mesh, cfg, params, toks, GEN, plan)
        got = np.asarray(jax.block_until_ready(got))
    except Exception as e:  # reported to the test, which fails
        report[name] = f"{type(e).__name__}: {str(e)[:300]}"
        continue
    np.save(out + f".jax.{name.replace('/', '_')}.npy",
            np.stack(seen)[:, :, :cfg.vocab_size])
    report[name] = got.tolist()
with open(out + ".jax.json", "w") as f:
    json.dump(report, f)
"""

_JAX_TRAINER = """
import json
import sys
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.core import VirtualCluster
from repro.core.elastic import ElasticTrainer
out, steps, seq = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
c = VirtualCluster(n_compute=4, devices_per_node=2)
assert c.rendering.mesh.devices.size == 8
losses = {}
for arch in ("qwen2-vl-7b", "whisper-small"):
    t = ElasticTrainer(c.template, get_smoke(arch),
                       ShapeConfig("t", seq, 8, "train"),
                       out + f".jax8.{arch}.jax", ckpt_every=100)
    losses[arch] = [t.run_steps(1)["loss"] for _ in range(steps)]
with open(out + ".jax_trainer.json", "w") as f:
    json.dump(losses, f)
"""


def _bits(a):
    return np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else \
        np.asarray(a)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI_ARGS = ["--arch", AUDIO, "--smoke", "--device", "cpu", "--trace",
            "oneshot", "--nodes", "2", "--requests", str(B), "--prompt-len",
            str(S), "--gen", str(GEN)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of eight gloo children for every port case of the
    module, two JAX children on eight forced host devices (serve_batch,
    the trainer), and the serve CLI under torchrun's environment over two
    gloo ranks; the inputs they share (parameters, cases, the trainers'
    step-0 checkpoints) written by this process. Returns (output prefix,
    the ranks' reports, JAX's serve report, JAX's trainer losses, the
    CLI's two (stdout, stderr))."""
    import inspect
    tmp = tmp_path_factory.mktemp("mesh_modality")
    out = str(tmp / "run")
    jplan = JPlan(fsdp=False, remat="nothing", attn_impl="naive",
                  kv_cache="replicated")
    env8 = JEnv(mesh=AbstractMesh((1, 8), ("data", "model")), plan=jplan)
    for arch in ARCHS:
        p = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                            JEnv(None, JSERVE_PLAN))
        np.savez(out + f".params.{arch}.npz",
                 **{f"p{i}": _bits(x) for i, x in
                    enumerate(jax.tree.leaves(p))})
        # JAX's PRNGKey(0) train state shaped for tp 8 (its padded heads
        # drawn too), where both eight-way trainers start
        p8 = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch), env8)
        state = {"params": p8, "opt": JA.adamw_init(p8, JA.AdamWConfig())}
        for side in ("jax", "port"):
            JCheckpointManager(out + f".jax8.{arch}.{side}").save(
                0, state, {"epoch": 0})
    with open(out + ".cases.json", "w") as f:
        json.dump({"serve": SERVE, "one": ONE, "train": TRAIN,
                   "archs": ARCHS, "B": B, "S": S, "GEN": GEN}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    shared = textwrap.dedent(inspect.getsource(_stub_batch))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out, shared], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_TRAINER), out,
         str(JAX_STEPS), str(S)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    port = str(_free_port())
    clis = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *CLI_ARGS],
        env=dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=900)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-20000:]
    cli_out = []
    for p in clis:
        try:
            cli_out.append(p.communicate(timeout=300))
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in clis), cli_out
    reports = []
    for r in range(WORLD):
        with open(out + f".report.{r}.json") as f:
            reports.append(json.load(f))
    with open(out + ".jax.json") as f:
        jax_report = json.load(f)
    with open(out + ".jax_trainer.json") as f:
        jax_losses = json.load(f)
    yield out, reports, jax_report, jax_losses, cli_out
    shutil.rmtree(tmp, ignore_errors=True)


def _margin(logits):
    """The top-2 margin of each row of logits [..., V]."""
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def _near_tie_equal(a, b, la, lb, tol):
    """Tokens a, b [B, G] equal up to each row's first step where either
    side's top-2 margin (la, lb: [G, B, V], along each side's own
    tokens) is under tol."""
    for row in range(a.shape[0]):
        diff = np.nonzero(a[row] != b[row])[0]
        if diff.size:
            t = diff[0]
            if not min(_margin(la[t, row]), _margin(lb[t, row])) < tol:
                return False
    return True


def _agreed(a, b):
    """[G, B] mask of the steps before each row's first differing token
    (the logits there read the same context)."""
    same = np.cumprod(a == b, axis=1).astype(bool)
    first = np.concatenate([np.ones((a.shape[0], 1), bool),
                            same[:, :-1]], axis=1)
    return first.T


def _key(name):
    return name.replace("/", "_")


@pytest.mark.parametrize("name", sorted(SERVE))
def test_serve_batch_over_the_mesh_matches_jax(ranks, name):
    """serve_batch over the mesh (the (1, n) ones rendered by the
    VirtualCluster from its hostfile and submitted through it, the (2, 2)
    one make_test_mesh's), in both kv_cache layouts, zero stubs: every
    rank returns the same tokens; against JAX's serve_batch over its own
    mesh of the same shape, the prefill's last-position logits and every
    decode step before the first differing token within JAX_TOL, and the
    tokens equal under the near-tie oracle."""
    out, reports, jax_report, _, _ = ranks
    shape = SERVE[name][1]
    members = [rep["serve"][name] for rep in reports
               if name in rep["serve"]]
    assert len(members) == shape[0] * shape[1]
    got = np.asarray(members[0]["tokens"])
    assert got.shape == (B, GEN) and all(
        np.array_equal(got, m["tokens"]) for m in members)
    lg = np.load(out + f".logits.{_key(name)}.npy")
    assert not isinstance(jax_report[name], str), jax_report[name]
    want = np.asarray(jax_report[name])
    jl = np.load(out + f".jax.{_key(name)}.npy")
    assert jl.shape == lg.shape
    ok = _agreed(got, want)
    err = np.abs(lg - jl).max(-1)  # [G, B]
    assert err[0].max() <= JAX_TOL
    assert err[ok].max() <= JAX_TOL
    assert _near_tie_equal(got, want, lg, jl, JAX_TOL)


@pytest.mark.parametrize("name", sorted(SERVE))
def test_each_rank_prefill_holds_its_share(ranks, name):
    """Each rank's prefill on seeded nonzero stubs (its rows of the
    vision embeddings or frames): its last-position logits, gathered,
    and its grown caches, the cross caches xk / xv included, within
    CACHE_TOL of the one-device prefill's cut to its rows and to its KV
    heads (replicated) or its positions and frames (seq_sharded; a cross
    cache whole where tp does not divide the frames); a share the one
    device holds as zeros (a padding head's) exactly zero."""
    _, reports, _, _, _ = ranks
    arch, shape, _, layout, n = SERVE[name]
    cfg = torch_smoke(arch)
    members = [rep["serve"][name]["prefill"] for rep in reports
               if name in rep["serve"]]
    assert len(members) == shape[0] * shape[1]
    for m in members:
        assert all(e <= CACHE_TOL for e in m["errs"].values()), m
        assert m["errs"]["zeros"] == 0.0, m
    if cfg.is_encdec:
        se, tp = n // cfg.enc_downsample, shape[1]
        want = se // tp if layout == "seq_sharded" and se % tp == 0 else se
        assert all(m["shapes"]["xk"][-2] == want for m in members)


def test_padding_heads_hold_exact_zeros(ranks):
    """whisper-small smoke's 4 MHA heads pad to 8 over tp 8 (its KV heads
    alongside): ranks 4-7 own only padding heads, one KV head each, and
    their self and cross caches are exact zeros under the replicated
    layout."""
    _, reports, _, _, _ = ranks
    for rep in reports[4:]:
        m = rep["serve"][f"{AUDIO}/1x8/replicated"]["prefill"]
        assert m["shapes"]["xk"][2] == 1, m
        assert {"k", "v", "xk", "xv"} <= set(m["zero_leaves"]), m
        assert m["errs"]["zeros"] == 0.0, m


@pytest.mark.parametrize("name", sorted(k for k in SERVE
                                        if "seq_sharded" in k))
def test_seq_sharded_decode_tracks_the_replicated_one(ranks, name):
    """The seq_sharded layout's decode (flash-decoding over the
    positions and frames split across tp) along the replicated run's
    tokens: every step's logits within LAYOUT_TOL of the replicated
    run's; its own tokens equal the replicated run's under the near-tie
    oracle."""
    out, reports, _, _, _ = ranks
    rep_name = name.replace("seq_sharded", "replicated")
    forced = np.load(out + f".forced.{_key(name)}.npy")
    base = np.load(out + f".logits.{_key(rep_name)}.npy")
    assert np.abs(forced - base).max() <= LAYOUT_TOL
    got = np.asarray(reports[0]["serve"][name]["tokens"])
    want = np.asarray(reports[0]["serve"][rep_name]["tokens"])
    own = np.load(out + f".logits.{_key(name)}.npy")
    assert _near_tie_equal(got, want, own, base, LAYOUT_TOL)


@pytest.mark.parametrize("arch", ONE)
def test_one_rank_mesh_is_the_one_device_serve(ranks, arch):
    """serve_batch over a 1 x 1 DeviceMesh under the replicated layout:
    the one-device serve_batch's tokens and every step's logits bit for
    bit, and its prefill's caches and logits on nonzero stubs the one
    device's."""
    _, reports, _, _, _ = ranks
    got = reports[0]["one"][arch]
    assert got["tokens"] and got["logits"]
    assert all(e == 0.0 for e in got["prefill"]["errs"].values()), \
        got["prefill"]


def test_whisper_run_oneshot_and_the_cli_over_the_rendered_mesh(ranks):
    """run_oneshot of whisper-small under the process group (--nodes 2
    over eight ranks): ranks 0 and 1 form the rendered (1, 2) mesh and
    return the same tokens; the other ranks sit out. The serve CLI
    `--arch whisper-small --trace oneshot` under torchrun's environment
    over two gloo ranks: rank 0 ends with the JAX CLI's lines, its sample
    the tokens run_oneshot returned with the same (seed 0) parameters;
    rank 1 prints nothing."""
    _, reports, _, _, cli_out = ranks
    for r, rep in enumerate(reports):
        assert (rep["run_oneshot"] is None) == (r >= 2)
    assert reports[0]["run_oneshot"] == reports[1]["run_oneshot"]
    lines = cli_out[0][0].strip().splitlines()
    assert lines[-2].startswith(f"generated {B * GEN} tokens in ")
    want = np.asarray(reports[0]["run_oneshot"])[0][:16]
    assert lines[-1] == f"sample: {want}"
    assert cli_out[1][0] == ""


_SINGLE = {}


def _single_losses(arch):
    """The port's one-device train step, three steps from the bridged
    state on the children's batch."""
    if arch not in _SINGLE:
        cfg = torch_smoke(arch)
        p = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                            JEnv(None, JSERVE_PLAN))
        params = bridge.to_torch(jax.tree.map(np.asarray, p), "cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in _stub_batch(cfg, S).items()}
        opt = A.AdamWConfig(lr=LR)
        env = Env(plan=ParallelPlan(fsdp=False, remat="full",
                                    attn_impl="naive"))
        step = St.make_train_step(cfg, env, opt)
        state = {"params": params, "opt": A.adamw_init(params, opt)}
        losses = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        _SINGLE[arch] = losses
    return _SINGLE[arch]


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_train_step_over_a_mesh(ranks, name):
    """Both archs through the sharded train step over (1, 2) and (2, 2)
    (fsdp; the stubs placed over dp by batch_specs, the VLM's loss over
    its text positions, whisper's encoder per rank): three steps' losses
    the same on every rank of the mesh and within TRAIN_TOL of the port's
    one-device losses."""
    _, reports, _, _, _ = ranks
    arch, shape = TRAIN[name]
    members = [rep["train"][name] for rep in reports
               if name in rep["train"]]
    assert len(members) == shape[0] * shape[1]
    want = _single_losses(arch)
    for losses in members:
        assert losses == members[0]
        for a, b in zip(losses, want):
            assert abs(a - b) <= TRAIN_TOL * abs(b), (losses, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_elastic_trainer_over_eight_ranks_tracks_jax(ranks, arch):
    """JAX's ElasticTrainer over VirtualCluster(n_compute=4,
    devices_per_node=2)'s rendered mesh of eight host devices and the
    port's over the eight ranks' (1, 8) rendering resume one step-0
    checkpoint of JAX's weights (heads padded for tp 8) and take three
    steps on the data pipeline's batches (the stubs each rank's rows):
    every loss within JAX8_TOL of JAX's, on every rank."""
    _, reports, _, jax_losses, _ = ranks
    want = jax_losses[arch]
    for rep in reports:
        assert rep["mesh8"] == [1, 8]
        got = rep["jax8"][arch]
        assert len(got) == len(want) == JAX_STEPS
        assert all(abs(a - b) <= JAX8_TOL * abs(b)
                   for a, b in zip(got, want)), (got, want)


def _entries(tree):
    """(path, spec entries) of a spec tree's leaves, sorted by path."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (tuple, list)) and not isinstance(t, R.Spec) \
                and not type(t).__name__ == "PartitionSpec":
            for i, v in enumerate(t):
                walk(v, path + (i,))
        elif t is not None:
            out.append((path, tuple(t)))
    walk(tree, ())
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_modality_specs_equal_jax(arch, layout):
    """parallel/rules.py over the meshes this file serves on, against the
    JAX package's rules on its own structs, entry for entry: the
    parameters (whisper's enc_blocks tree, each dec block's xattn weights
    and lnx, qwen2-vl's qkv biases: bq with wq's columns over tp, bk / bv
    replicated as wk / wv), the decode caches in the layout (xk / xv as k /
    v; under seq_sharded their encoder positions over tp, dropped where tp
    does not divide them: whisper at 24 positions has 12 frames over tp
    8), and the batch with its stubs over dp."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    for dims in ((1, 2), (1, 8), (2, 2)):
        names = ("data", "model")
        jenv = JEnv(mesh=AbstractMesh(dims, names),
                    plan=JPlan(kv_cache=layout))
        env = Env(plan=ParallelPlan(kv_cache=layout),
                  mesh=LM.ShapeMesh(dims, names))
        jp = jax.eval_shape(lambda k: JMo.init_params(k, jcfg, jenv),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
        tp_ = Mo.init_params(cfg, env, device="meta")
        got = _entries(R.param_specs(tp_, cfg, env))
        assert got == _entries(JR.param_specs(jp, jcfg, jenv))
        specs = dict(got)
        if cfg.is_encdec:  # fsdp (the plan's default) over "data"
            assert specs[("enc_blocks", 0, "attn", "wq")] == (
                None, "data", "model")
            assert specs[("blocks", 0, "xattn", "wo")] == (
                None, "model", "data")
            assert specs[("blocks", 0, "lnx")] == (None, None)
        else:
            assert specs[("blocks", 0, "attn", "bq")] == (None, "model")
            assert specs[("blocks", 0, "attn", "bk")] == (None, None)
        for n in (32, 24):
            jc = JSt.cache_struct(jcfg, jenv, JShape("d", n, 8, "decode"))
            tc = jax.tree.map(lambda x: torch.empty(x.shape, device="meta"),
                              jc)
            cs = _entries(R.cache_specs(tc, cfg, env))
            assert cs == _entries(JR.cache_specs(jc, jcfg, jenv))
            if cfg.is_encdec:
                se, tp = n // cfg.enc_downsample, dims[1]
                split = layout == "seq_sharded" and se % tp == 0
                assert dict(cs)[("blocks", 0, "xk")] == (
                    None, "data", None, "model" if split else None, None)
        batch = {"tokens": jax.ShapeDtypeStruct((8, 16), jnp.int32),
                 "labels": jax.ShapeDtypeStruct((8, 16), jnp.int32)}
        add_modality_stubs(batch, cfg, 0)  # names and shapes only
        batch = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
                 if not isinstance(v, jax.ShapeDtypeStruct) else v
                 for k, v in batch.items()}
        tb = {k: torch.empty(v.shape, device="meta")
              for k, v in batch.items()}
        bs = _entries(R.batch_specs(tb, cfg, ShapeConfig("b", 16, 8,
                                                         "train"), env))
        assert bs == _entries(JR.batch_specs(
            batch, jcfg, JShape("b", 16, 8, "train"), jenv))
        stub = "vision_embeds" if cfg.family == "vlm" else "frames"
        assert dict(bs)[(stub,)] == ("data", None, None)
