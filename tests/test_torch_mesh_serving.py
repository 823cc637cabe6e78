"""The one-shot serve over the cluster's rendered mesh (prefill and decode
per rank, the KV cache replicated or split over tp) and the recurrent
archs' train step over a mesh, over eight gloo ranks on the CPU, against
JAX's serve_batch over its own rendered mesh of the same shape and the
port's own one-device results.

One spawn of eight rank children (torch and repro_torch only) runs every
port case: the VirtualCluster's rendered DeviceMesh under the process
group ((1, 2) and (1, 8), one device a node) or make_test_mesh's (2, 2)
and (1, 1), serve_batch submitted over it, the teacher-forced logits of
serve_logits, each rank's prefill caches, run_oneshot, and the sharded
train step. One JAX child on eight forced host devices runs JAX's
serve_batch over VirtualCluster(n_compute=n).submit, its prefill and
decode logits recorded by a host callback in its step builders; one
torchrun of the CLI over two gloo ranks runs `--trace oneshot`. All
cases use the JAX package's PRNGKey(0) smoke parameters (the bridge), 8
prompts of 16 tokens (one case 160, past the flash branch's 128) and 8
generated tokens. Tolerances, and why:
- A 1 x 1 mesh: none. Under the replicated layout it computes the
  one-device products (the same row tiles): tokens and every step's
  logits bit for bit.
- JAX_TOL = 0.125 absolute on the prefill's last-position logits and
  on every decode step before the first token either side picks
  differently: the port sums a row product's tp shares in f32 and
  rounds once, JAX's GSPMD program rounds otherwise (JAX over (1, n)
  against its own one device measured 0.027-0.0625 at logits up to
  3.9, and 0.18-0.20 for grok-1-314b). Measured against JAX over the
  same mesh: up to 0.0762 on the prefill, 0.111 on the decode steps
  (recurrentgemma-9b), at logits up to 4.4.
- The tokens equal JAX's up to the first step where either side's
  top-2 margin falls under the tolerance (the near-tie oracle of
  tests/test_torch_modality.py): one flip changes every later token.
- LAYOUT_TOL = 0.0625 absolute: the seq_sharded decode (flash-decoding
  over the positions split across tp, kernel #5's plain version, the
  partials merged across the ranks) against the replicated one (kernel
  #1's plain version over the rank's KV heads), both along the
  replicated run's tokens, at every step: two f32-probability
  attentions summed in another order, then the same bf16 stack
  (measured up to 0.0312).
- CACHE_TOL = 0.0625 absolute: each rank's prefill caches against the
  one-device prefill's cut to the rank's rows, heads, positions or
  channels (0 at tp 1; at tp > 1 the residual stream after the first
  layer carries the row products' other rounding; measured up to
  0.0234).
- TRAIN_TOL = 5e-4 relative: the recurrent train step over (1, 2) and
  (2, 2) (fsdp, three steps) against the port's one-device losses on
  the same bridged state (the first step's shares summed in f32; from
  the second the gradients' shares rounded per rank, as
  tests/test_torch_sharded.py's LATER_TOL; measured up to 1.1e-5 on
  the first step, 2.1e-4 on the third).

JAX's serve_batch runs over the (2, 2) Mesh(...) too (ROADMAP.md
section 3), so every case is held to it.
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

from repro.configs import get_smoke
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import SERVE_PLAN as JSERVE_PLAN
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A

import _torch_mesh_refusals as refusals

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 8
B, S, GEN, LONG = 8, 16, 8, 160
JAX_TOL = 0.125
LAYOUT_TOL = 0.0625
CACHE_TOL = 0.0625
TRAIN_TOL = 5e-4
LR = 1e-3
ARCHS = ("paper-demo", "yi-9b", "grok-1-314b", "recurrentgemma-9b",
         "rwkv6-1.6b")
LAYOUTS = ("replicated", "seq_sharded")

# name: (arch, mesh (data, model), who renders it, kv_cache, prompt length)
SERVE = {f"{a}/1x{n}/{lay}": (a, (1, n), "cluster", lay, S)
         for a in ARCHS for n in (2, 8) for lay in LAYOUTS}
SERVE.update({
    "paper-demo/1x8/replicated/160": ("paper-demo", (1, 8), "cluster",
                                      "replicated", LONG),
    "paper-demo/1x8/seq_sharded/160": ("paper-demo", (1, 8), "cluster",
                                       "seq_sharded", LONG),
    "paper-demo/2x2/replicated": ("paper-demo", (2, 2), "test",
                                  "replicated", S),
    "paper-demo/2x2/seq_sharded": ("paper-demo", (2, 2), "test",
                                   "seq_sharded", S),
    "rwkv6-1.6b/2x2/replicated": ("rwkv6-1.6b", (2, 2), "test",
                                  "replicated", S),
})
ONE = ARCHS  # a 1 x 1 mesh, the replicated layout
TRAIN = {f"{a}/{m[0]}x{m[1]}": (a, m) for a in ("recurrentgemma-9b",
                                                  "rwkv6-1.6b")
         for m in ((1, 2), (2, 2))}
TRAIN_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
from repro_torch.launch import serve as cli
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models.env import SERVE_PLAN, Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
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
    if name in ("k", "v"):
        if layout == "seq_sharded" and kind != "local":
            return [np.array_split(x, tp, axis=-2)[r]]
        hq = Mo.head_pad(cfg, env) // tp
        G = hq * tp // x.shape[lead + 1]
        idx = [(r * hq + i) // G for i in range(hq)]
        return [np.take(x, sorted(set(idx)), axis=lead + 1),
                np.take(x, idx, axis=lead + 1)]
    whole = {"rglru": cfg.rglru_width %% tp or 16 %% tp,
             "rwkv": cfg.n_heads %% tp}.get(kind, True)
    if name == "h" and not whole:
        return [np.array_split(x, tp, axis=-1)[r]]
    if name == "conv" and not whole:
        return [np.array_split(x, tp, axis=-1)[r]]
    if name == "s" and not whole:
        return [np.array_split(x, tp, axis=lead + 1)[r]]
    return [x]


def cache_err(arch, cfg, params, toks, mesh, layout):
    # this rank's grown prefill caches against the one-device ones, cut
    env = Env(plan=plan_of(layout), mesh=mesh)
    local = bridge.rank_shards(params, cfg, env)
    rows = R.local_shard(torch.from_numpy(toks), R.Spec((("data",), None)),
                         env)
    _, caches = St.make_prefill_step(cfg, env)(local, {"tokens": rows})
    caches = Mo.grow_caches(caches, GEN, cfg, env)
    one = Env(plan=plan_of(layout))
    _, ref = St.make_prefill_step(cfg, one)(
        bridge.pad_for_mesh(params, cfg, env),
        {"tokens": torch.from_numpy(toks)})
    ref = Mo.grow_caches(ref, GEN, cfg)
    coord = mesh.get_coordinate()
    errs = {}
    units = [(k, u, st) for k, u, st in Mo._units(cfg, caches)]
    refs = [u for _, u, _ in Mo._units(cfg, ref)]
    for (kind, unit, st), runit in zip(units, refs):
        for name, x in unit.items():
            want = cut(kind, name, runit[name].float().numpy(), coord,
                       tuple(mesh.shape), layout, cfg, env, st)
            got = x.float().numpy()
            fits = [w for w in want if w.shape == got.shape]
            key = f"{kind}.{name}"
            errs[key] = max(errs.get(key, 0.0), float(
                np.abs(got - fits[0]).max()) if fits else float("inf"))
    return errs


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
           "cache": submit(source, shape, lambda mesh: cache_err(
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
                           "cache": cache_err(arch, cfg, params, toks, mesh,
                                              "replicated")}

# run_oneshot under the process group, the CLI's parameters (seed 0)
cfg = get_smoke("paper-demo")
args = argparse.Namespace(nodes=2, device="cpu", requests=B,
                          prompt_len=cases["S"], gen=GEN, seed=0)
r = cli.run_oneshot(args, cfg, Mo.init_params(cfg, Env(), seed=0,
                                              device="cpu"))
report["run_oneshot"] = (None if r["tokens"] is None
                         else r["tokens"].tolist())
r = cli.run_oneshot(args, cfg, PARAMS["paper-demo"])
report["run_oneshot_bridged"] = (None if r["tokens"] is None
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
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (8, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens}
    batch = R.apply_shardings(batch, R.batch_specs(
        batch, cfg, ShapeConfig("t", 16, 8, "train"), env), env)
    step = St.make_train_step(cfg, env, opt)
    losses = []
    for _ in range(%(steps)d):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    report["train"][name] = losses

mesh = make_test_mesh(world, model=2, device_type="cpu")
exec(sys.argv[5])  # tests/_torch_mesh_refusals.py RANK_CODE: `refused`
report["refused"] = refused
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
""" % {"lr": LR, "steps": TRAIN_STEPS}

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


def _bits(a):
    return np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else \
        np.asarray(a)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


CLI_ARGS = ["--smoke", "--device", "cpu", "--trace", "oneshot", "--nodes",
            "2", "--requests", str(B), "--prompt-len", str(S), "--gen",
            str(GEN)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of eight gloo children for every port case of the
    module, one JAX child on eight forced host devices, and the CLI
    under torchrun's environment over two gloo ranks; the inputs they
    share written by this process. Returns (output prefix, the ranks'
    reports, JAX's report, the CLI's two (stdout, stderr))."""
    tmp = tmp_path_factory.mktemp("mesh_serving")
    out = str(tmp / "run")
    for arch in ARCHS:
        p = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                            JEnv(None, JSERVE_PLAN))
        np.savez(out + f".params.{arch}.npz",
                 **{f"p{i}": _bits(x) for i, x in
                    enumerate(jax.tree.leaves(p))})
    with open(out + ".cases.json", "w") as f:
        json.dump({"serve": SERVE, "one": ONE, "train": TRAIN,
                   "archs": ARCHS, "B": B, "S": S, "GEN": GEN}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out, refusals.RANK_CODE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out], env=jenv,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
    yield out, reports, jax_report, cli_out
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
    one make_test_mesh's), in both kv_cache layouts: every rank returns
    the same tokens; against JAX's serve_batch over its own mesh of the
    same shape, the prefill's last-position logits and every decode step
    before the first differing token within JAX_TOL, and the tokens
    equal under the near-tie oracle. Every rank's prefill
    caches equal the one-device ones cut to its share within
    CACHE_TOL."""
    out, reports, jax_report, _ = ranks
    shape = SERVE[name][1]
    members = [rep["serve"][name] for rep in reports
               if name in rep["serve"]]
    assert len(members) == shape[0] * shape[1]
    got = np.asarray(members[0]["tokens"])
    assert got.shape == (B, GEN) and all(
        np.array_equal(got, m["tokens"]) for m in members)
    for m in members:
        assert all(e <= CACHE_TOL for e in m["cache"].values()), m["cache"]
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


@pytest.mark.parametrize("name", sorted(k for k in SERVE
                                        if "seq_sharded" in k))
def test_seq_sharded_decode_tracks_the_replicated_one(ranks, name):
    """The seq_sharded layout's decode (flash-decoding over the
    positions split across tp) along the replicated run's tokens: every
    step's logits within LAYOUT_TOL of the replicated run's; its own
    tokens equal the replicated run's under the near-tie oracle."""
    out, reports, _, _ = ranks
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
    bit, and its caches the one device's."""
    _, reports, _, _ = ranks
    got = reports[0]["one"][arch]
    assert got["tokens"] and got["logits"]
    assert all(e == 0.0 for e in got["cache"].values()), got["cache"]


def test_run_oneshot_submits_over_the_rendered_mesh(ranks):
    """run_oneshot under the process group (the CLI's --nodes 2 over
    eight ranks): ranks 0 and 1 form the rendered (1, 2) mesh and return
    the same tokens, those of serve_batch submitted over the same
    cluster's mesh; the other ranks sit out (None). The CLI under
    torchrun's environment over two gloo ranks: rank 0 ends with the JAX
    CLI's lines, its sample the tokens run_oneshot returned with the
    same (seed 0) parameters; rank 1 prints nothing."""
    _, reports, _, cli_out = ranks
    for r, rep in enumerate(reports):
        assert (rep["run_oneshot"] is None) == (r >= 2)
        assert (rep["run_oneshot_bridged"] is None) == (r >= 2)
    assert reports[0]["run_oneshot"] == reports[1]["run_oneshot"]
    assert reports[0]["run_oneshot_bridged"] == \
        reports[0]["serve"]["paper-demo/1x2/replicated"]["tokens"]
    lines = cli_out[0][0].strip().splitlines()
    assert lines[-2].startswith(f"generated {B * GEN} tokens in ")
    want = np.asarray(reports[0]["run_oneshot"])[0][:16]
    assert lines[-1] == f"sample: {want}"
    assert cli_out[1][0] == ""


_SINGLE = {}


def _jax_params(arch):
    p = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                        JEnv(None, JSERVE_PLAN))
    return jax.tree.map(np.asarray, p)


def _single_losses(arch):
    """The port's one-device train step, three steps from the bridged
    state on the children's batch."""
    if arch not in _SINGLE:
        cfg = torch_smoke(arch)
        params = bridge.to_torch(_jax_params(arch), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (8, 16)).astype(np.int32))
        opt = A.AdamWConfig(lr=LR)
        env = Env(plan=ParallelPlan(fsdp=False, remat="full",
                                    attn_impl="naive"))
        step = St.make_train_step(cfg, env, opt)
        state = {"params": params, "opt": A.adamw_init(params, opt)}
        losses = []
        for _ in range(TRAIN_STEPS):
            state, m = step(state, {"tokens": tokens, "labels": tokens})
            losses.append(float(m["loss"]))
        _SINGLE[arch] = losses
    return _SINGLE[arch]


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_recurrent_train_step_over_a_mesh(ranks, name):
    """recurrentgemma-9b and rwkv6-1.6b smoke through the sharded train
    step over (1, 2) and (2, 2) (fsdp; the RG-LRU's channels and RWKV's
    heads over tp, the plain scans under autograd): three steps' losses
    the same on every rank of the mesh and within TRAIN_TOL of the
    port's one-device losses."""
    _, reports, _, _ = ranks
    arch, shape = TRAIN[name]
    members = [rep["train"][name] for rep in reports
               if name in rep["train"]]
    assert len(members) == shape[0] * shape[1]
    want = _single_losses(arch)
    for losses in members:
        assert losses == members[0]
        for a, b in zip(losses, want):
            assert abs(a - b) <= TRAIN_TOL * abs(b), (losses, want)


def test_a_modality_arch_over_a_mesh_names_item_8_4(ranks):
    """ROADMAP item 8.4 is closed: qwen2-vl-7b and whisper-small over the
    eight ranks' DeviceMesh are accepted, as every arch is, on every rank
    (their serve over a mesh: tests/test_torch_mesh_modality.py); block
    tables and row slots over the mesh (the engines' pools, ROADMAP item
    12) decode in either KV layout, a 1 x 1 mesh as one device does (row
    slots under seq_sharded within LAYOUT_TOL); an axis the plan does
    not name is still refused, and over a
    shape-only (1, 2) mesh the modality archs get the JAX package's
    padded shapes and refuse to compute (tests/_torch_mesh_refusals.py)."""
    _, reports, _, _ = ranks
    refusals.check([rep["refused"] for rep in reports])


def test_greedy_on_one_device_is_the_argmax():
    """Without a mesh the greedy pick is the argmax over the first
    vocab_size columns, as serve_batch took it before it ran over
    ranks."""
    cfg = torch_smoke("paper-demo")
    logits = torch.randn(3, Mo.vocab_pad(cfg, Env())).to(torch.bfloat16)
    assert torch.equal(St.greedy(logits, cfg, Env())[:, 0],
                       torch.argmax(logits[:, :cfg.vocab_size], -1)
                       .to(torch.int32))
