"""The serving engines over the cluster's rendered mesh: ServingEngine and
ReplicaSet per rank (serve/scheduler.py, serve/router.py) on the bf16
paged pool, the int8 pool and the slot pool, over four gloo ranks on the
CPU, against the port's own one-device engine, its one-shot over the
same mesh and JAX's ServingEngine over its own mesh of the same shape.

One spawn of four rank children (torch and repro_torch only), started
when the module starts, runs every port case: the (1, 2) mesh the
VirtualCluster renders from its hostfile (one device a node), and
make_test_mesh's (2, 2) and (1, 1). Two JAX children on eight forced
host devices, two archs each, run JAX's ServingEngine over
VirtualCluster(n_compute=2, devices_per_node=1).rendering.mesh and over
a (2, 2) Mesh, and write the JAX package's PRNGKey(0) smoke parameters
first, which every case uses (the ranks load them as the bridge
does). 4 requests
(8 under VirtualCluster.serve) of 16 prompt tokens and 8 generated
tokens, greedy unless a case says seeded (temperature 0.8, top-k 50,
top-p 0.9, a seed a request). Tolerances, and why:
- (a) A 1 x 1 mesh: none. It computes the one-device products (the same
  row tiles, the same dispatch), so its tokens equal the one-device
  engine's on every pool, greedy and seeded.
- (b) Inside the port over (1, 2) and (2, 2): none. Every rank picks the
  same tokens (the engine checks it every step; a case whose data ranks
  hold different params stops with RuntimeError); chunked lanes equal
  the streamed one-shot over the same mesh and classic admission the
  full-prefill one (the `--verify` contract); the paged pool by classic
  admission equals the slot pool; 4 slots equal 2 slots (the int8 pool,
  greedy, and the bf16 pool, seeded); a ReplicaSet under
  VirtualCluster.serve through a scale-up and a scale-down equals one
  engine. grok-1-314b (MoE) is held only to the every-rank check and to
  JAX: its capacity depends on the rows one dispatch holds, and JAX's
  own `--verify` mismatches on it (ROADMAP.md section 3).
- (c) Against JAX's engine over the same mesh: the tokens are equal up
  to each request's first step where the port's top-2 margin is under
  JAX_TOL = 0.125 (the near-tie oracle of tests/test_torch_mesh_serving.py:
  the port sums a row product's tp shares in f32 and rounds once, JAX's
  GSPMD program rounds otherwise; the one-shot's logits lay within 0.111
  of JAX's over the same mesh there). The margins are the port's
  one-shot logits over the same mesh along the port's tokens (the
  engine's own, by (b)); before the first differing token both sides
  read the same context. For grok-1-314b the one-shot's dispatch is not
  the engine's, so its margins are the one-shot's, an approximation
  (measured: 29 of its 32 tokens equal JAX's over (2, 2); recurrentgemma-9b
  29 of 32 over (1, 2); every other case 32 of 32).
Speculative decoding, the host swap tier and the slot pool under a
seq_sharded plan over the mesh are tests/test_torch_mesh_spec_swap.py's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
N, S, GEN = 4, 16, 8
JAX_TOL = 0.125
ARCHS = ("paper-demo", "grok-1-314b", "recurrentgemma-9b", "rwkv6-1.6b")
MESHES = ("1x2", "2x2")


def _case(arch, mesh, kv="paged", chunk=None, slots=4, sample=False,
          serve=False):
    return {"arch": arch, "mesh": mesh, "kv": kv, "chunk": chunk,
            "slots": slots, "sample": sample, "serve": serve}


# name: the engine's arguments; chunk None admits by lanes where the pool
# and arch can, 0 by classic prefill
CASES = {}
for m in ("1x1",) + MESHES:
    CASES[f"paper-demo/{m}/paged"] = _case("paper-demo", m)
    CASES[f"paper-demo/{m}/slot"] = _case("paper-demo", m, "slot")
    CASES[f"paper-demo/{m}/quant"] = _case("paper-demo", m, "quant")
    CASES[f"paper-demo/{m}/paged/seeded"] = _case("paper-demo", m,
                                                  sample=True)
    CASES[f"grok-1-314b/{m}/paged"] = _case("grok-1-314b", m)
    CASES[f"recurrentgemma-9b/{m}/paged"] = _case("recurrentgemma-9b", m)
    CASES[f"rwkv6-1.6b/{m}/paged"] = _case("rwkv6-1.6b", m)
    CASES[f"rwkv6-1.6b/{m}/slot"] = _case("rwkv6-1.6b", m, "slot")
CASES["paper-demo/1x1/slot/seeded"] = _case("paper-demo", "1x1", "slot",
                                            sample=True)
CASES["paper-demo/1x1/quant/seeded"] = _case("paper-demo", "1x1", "quant",
                                             sample=True)
for m in MESHES:
    CASES[f"paper-demo/{m}/paged/classic"] = _case("paper-demo", m,
                                                   chunk=0)
    CASES[f"paper-demo/{m}/quant/2"] = _case("paper-demo", m, "quant",
                                             slots=2)
    CASES[f"paper-demo/{m}/paged/seeded/2"] = _case("paper-demo", m,
                                                    slots=2, sample=True)
    CASES[f"paper-demo/{m}/quant/serve"] = _case("paper-demo", m, "quant",
                                                 slots=2, serve=True)
    CASES[f"rwkv6-1.6b/{m}/quant"] = _case("rwkv6-1.6b", m, "quant")
    CASES[f"rwkv6-1.6b/{m}/quant/2"] = _case("rwkv6-1.6b", m, "quant",
                                             slots=2)
CASES["recurrentgemma-9b/1x2/paged/serve"] = _case(
    "recurrentgemma-9b", "1x2", slots=2, serve=True)
ONE = sorted(k for k, c in CASES.items() if c["mesh"] == "1x1")
# the JAX child's cases (greedy, the engine's default admission)
JAX_CASES = ("paper-demo/1x2/paged", "paper-demo/1x2/quant",
             "paper-demo/2x2/paged", "grok-1-314b/2x2/paged",
             "recurrentgemma-9b/1x2/paged", "rwkv6-1.6b/1x2/slot")
# the archs of each of the two JAX children (run side by side), in the
# order they write their params
JAX_GROUPS = (("paper-demo", "rwkv6-1.6b"),
              ("grok-1-314b", "recurrentgemma-9b"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RANK = """
import json
import os
import sys
import time
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke
from repro_torch.core import VirtualCluster
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.serve.request import Request
from repro_torch.serve.router import ReplicaSet
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import ServingEngine, run_to_completion

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
with open(out + ".cases.json") as f:
    spec = json.load(f)
CASES, JAX_CASES = spec["cases"], spec["jax"]
N, S, GEN = spec["N"], spec["S"], spec["GEN"]


PARAMS = {}


def jax_params(arch):
    # the JAX child's PRNGKey(0) params, once it has written them
    if arch not in PARAMS:
        path, t0 = out + f".params.{arch}.npz", time.time()
        while not os.path.exists(path):
            assert time.time() - t0 < 600, "no params from the JAX child"
            time.sleep(0.2)
        z = np.load(path)
        struct = Mo.init_params(get_smoke(arch), Env(), device="meta")
        i = iter(range(len(A.tree_leaves(struct))))
        PARAMS[arch] = A.tree_map(lambda s: torch.from_numpy(
            z["p%d" % next(i)]).view(s.dtype), struct)
    return PARAMS[arch]


def prompts(cfg, n):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (n, S),
                                             dtype=np.int32)


def requests(cfg, n, sample):
    P = prompts(cfg, n)
    sp = lambda i: (SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                   seed=7 + i) if sample
                    else SamplingParams())
    return [Request(rid=i, prompt=P[i], gen_len=GEN, sampling=sp(i))
            for i in range(n)]


def ordered(res):
    return [list(map(int, res[i])) for i in sorted(res)]


def engine_kw(c):
    return dict(num_slots=c["slots"], prompt_len=S, max_gen=GEN,
                kv=c["kv"], prefill_chunk=c["chunk"], device="cpu")


def serve_over_cluster(cfg, params, c):
    # a 2-replica ReplicaSet under VirtualCluster.serve over the mesh the
    # cluster renders (every rank builds the cluster alike), through a
    # scale-up and a scale-down; 2 x N requests
    if c["mesh"] == "1x2":
        cl = VirtualCluster(n_compute=2, devices_per_node=1, device="cpu")
    else:  # a (2, 2) rendering of four nodes
        cl = VirtualCluster(n_compute=4, devices_per_node=1, device="cpu")
        cl.template.mesh_rule = lambda n: ((2, n // 2), ("data", "model"))
        cl.template.poll(force=True)
    mesh = cl.rendering.mesh
    n0 = len(cl.compute_nodes())
    fleet = None
    if mesh.get_coordinate() is not None:
        assert tuple(mesh.shape) == tuple(map(int, c["mesh"].split("x")))
        fleet = ReplicaSet(cfg, params, replicas=2, clock=cl.clock,
                           mesh=mesh, **engine_kw(c))

    def on_step(i, snap, cluster):
        if i == 1:
            cluster.scale_to(n0 + 1)
        elif i == 4:
            cluster.scale_to(1)

    res = cl.serve(fleet, requests(cfg, 2 * N, c["sample"]), on_step=on_step)
    if res is None:
        return None
    one = ServingEngine(cfg, params, mesh=mesh, **engine_kw(c))
    return {"tokens": ordered(res), "warmups": fleet.replica_warmups,
            "released": len(fleet.released),
            "one": ordered(run_to_completion(
                one, requests(cfg, 2 * N, c["sample"])))}


CLUSTER = VirtualCluster(n_compute=2, devices_per_node=1, device="cpu")
MESH = {"1x1": make_test_mesh(1, model=1, device_type="cpu"),
        "1x2": CLUSTER.rendering.mesh,
        "2x2": make_test_mesh(4, model=2, device_type="cpu")}
assert tuple(MESH["1x2"].shape) == (1, 2)

report = {"cases": {}, "one": {}, "oneshot": {}}
for name, c in sorted(CASES.items(),  # arch by arch, as the params come
                      key=lambda kv: spec["archs"].index(kv[1]["arch"])):
    cfg = get_smoke(c["arch"])
    params = jax_params(c["arch"])
    if c["serve"]:
        got = serve_over_cluster(cfg, params, c)
        if got is not None:
            report["cases"][name] = got
        continue
    mesh = MESH[c["mesh"]]
    if mesh.get_coordinate() is None:
        continue
    eng = ServingEngine(cfg, params, mesh=mesh, **engine_kw(c))
    got = ordered(run_to_completion(eng, requests(cfg, N, c["sample"])))
    report["cases"][name] = {"tokens": got}
    if c["mesh"] == "1x1":
        one = ServingEngine(cfg, params, **engine_kw(c))
        report["one"][name] = ordered(run_to_completion(
            one, requests(cfg, N, c["sample"])))
    if name in JAX_CASES:
        # the near-tie oracle's margins: the one-shot's logits over the
        # mesh along the port's tokens
        lanes = eng.prefill_chunk > 0
        lg = cli.serve_logits(cfg, params, prompts(cfg, N), np.asarray(got),
                              streamed_prefill=lanes, device="cpu",
                              mesh=mesh)
        if rank == 0:
            np.save(out + ".logits." + name.replace("/", "_") + ".npy", lg)

for arch in spec["archs"]:  # the one-shots over each mesh
    cfg = get_smoke(arch)
    for m in ("1x2", "2x2"):
        if MESH[m].get_coordinate() is None:
            continue
        for streamed in (True, False):
            if streamed and arch in ("recurrentgemma-9b", "rwkv6-1.6b"):
                continue
            toks = cli.serve_batch(cfg, jax_params(arch), prompts(cfg, N),
                                   GEN, streamed_prefill=streamed,
                                   device="cpu", mesh=MESH[m])
            key = f"{arch}/{m}/" + ("streamed" if streamed else "full")
            report["oneshot"][key] = toks.tolist()

# the data ranks of the (2, 2) mesh hold different params: their tp groups
# pick different tokens, and every rank stops the run
if MESH["2x2"].get_coordinate() is not None:
    cfg = get_smoke("paper-demo")
    d = MESH["2x2"].get_coordinate()[0]
    params = Mo.init_params(cfg, Env(), seed=d, device="cpu")
    eng = ServingEngine(cfg, params, mesh=MESH["2x2"], num_slots=4,
                        prompt_len=S, max_gen=GEN, device="cpu")
    try:
        run_to_completion(eng, requests(cfg, N, False))
        report["diverged"] = ""
    except RuntimeError as e:
        report["diverged"] = str(e)

assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
"""

_JAX = """
import json
import os
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.core import VirtualCluster
from repro.models import model as Mo
from repro.models.env import Env
from repro.serve import SERVE_PLAN
from repro.serve.request import Request
from repro.serve.scheduler import ServingEngine, run_to_completion

out, group = sys.argv[1], int(sys.argv[2])
with open(out + ".cases.json") as f:
    spec = json.load(f)
N, S, GEN = spec["N"], spec["S"], spec["GEN"]
archs = spec["jax_groups"][group]
meshes = {"1x2": VirtualCluster(n_compute=2,
                                devices_per_node=1).rendering.mesh,
          "2x2": Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                      ("data", "model"))}
params = {}
for arch in archs:  # written first: the rank children load them
    params[arch] = Mo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                                  Env(None, SERVE_PLAN))
    leaves = [np.asarray(x) for x in jax.tree.leaves(params[arch])]
    tmp = out + f".params.{arch}.part.npz"
    np.savez(tmp, **{f"p{i}": x.view(np.uint16) if x.dtype == jnp.bfloat16
                     else x for i, x in enumerate(leaves)})
    os.replace(tmp, out + f".params.{arch}.npz")
report = {}
for name in spec["jax"]:
    c = spec["cases"][name]
    if c["arch"] not in archs:
        continue
    cfg = get_smoke(c["arch"])
    P = np.random.default_rng(0).integers(0, cfg.vocab_size, (N, S),
                                          dtype=np.int32)
    mesh = meshes[c["mesh"]]
    assert mesh.devices.shape == tuple(map(int, c["mesh"].split("x")))
    try:
        with mesh:
            eng = ServingEngine(cfg, params[c["arch"]], num_slots=c["slots"],
                                prompt_len=S, max_gen=GEN, kv=c["kv"],
                                prefill_chunk=c["chunk"], mesh=mesh)
            res = run_to_completion(eng, [Request(rid=i, prompt=P[i],
                                                  gen_len=GEN)
                                          for i in range(N)])
        report[name] = [list(map(int, res[i])) for i in sorted(res)]
    except Exception as e:  # reported to the test, which fails
        report[name] = f"{type(e).__name__}: {str(e)[:300]}"
with open(out + f".jax.{group}.json", "w") as f:
    json.dump(report, f)
"""


@pytest.fixture(autouse=True, scope="module")
def children(tmp_path_factory):
    """The four rank children and the JAX child, started when the module
    starts (the JAX child writes the params the ranks wait for)."""
    tmp = tmp_path_factory.mktemp("mesh_engines")
    out = str(tmp / "run")
    with open(out + ".cases.json", "w") as f:
        json.dump({"cases": CASES, "jax": JAX_CASES, "archs": ARCHS,
                   "jax_groups": JAX_GROUPS, "N": N, "S": S, "GEN": GEN},
                  f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs += [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out, str(g)],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for g in range(len(JAX_GROUPS))]
    state = {"procs": procs, "out": out, "reports": None}
    yield state
    for p in procs:
        p.kill()


def _results(state):
    """(output prefix, the ranks' reports, JAX's report), once the
    children have ended."""
    if state["reports"] is None:
        logs = []
        for p in state["procs"]:
            try:
                logs.append(p.communicate(timeout=600)[0])
            finally:
                p.kill()
        assert all(p.returncode == 0 for p in state["procs"]), \
            "\n".join(logs)[-20000:]
        reports = []
        for r in range(WORLD):
            with open(state["out"] + f".report.{r}.json") as f:
                reports.append(json.load(f))
        jax_report = {}
        for g in range(len(JAX_GROUPS)):
            with open(state["out"] + f".jax.{g}.json") as f:
                jax_report.update(json.load(f))
        state["reports"] = (reports, jax_report)
    return (state["out"],) + state["reports"]


def _ranks_of(mesh):
    d, m = map(int, mesh.split("x"))
    return d * m


def _tokens(reports, name):
    """The case's tokens, after checking every rank of its mesh reported
    the same ones."""
    got = [rep["cases"][name] for rep in reports if name in rep["cases"]]
    assert len(got) == _ranks_of(CASES[name]["mesh"]), name
    assert all(g == got[0] for g in got), name
    return np.asarray(got[0]["tokens"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_picks_the_same_tokens(children, name):
    """Every case runs to the end on every rank of its mesh, and each
    rank's tokens (and, under VirtualCluster.serve, its fleet's scale
    events) are the same: N (2 N under serve) requests of GEN tokens."""
    _, reports, _ = _results(children)
    toks = _tokens(reports, name)
    n = 2 * N if CASES[name]["serve"] else N
    assert toks.shape == (n, GEN)


@pytest.mark.parametrize("name", ONE)
def test_one_rank_mesh_is_the_one_device_engine(children, name):
    """(a) The engine over a 1 x 1 DeviceMesh: the one-device engine's
    tokens bit for bit, on every pool, greedy and seeded, for the dense,
    MoE and recurrent archs."""
    _, reports, _ = _results(children)
    assert _tokens(reports, name).tolist() == reports[0]["one"][name]


def _oneshot(reports, arch, mesh, streamed):
    key = f"{arch}/{mesh}/" + ("streamed" if streamed else "full")
    got = [rep["oneshot"][key] for rep in reports if key in rep["oneshot"]]
    assert len(got) == _ranks_of(mesh) and all(g == got[0] for g in got)
    return np.asarray(got[0])


VERIFY = [(a, m, kv) for m in MESHES
          for a, kv in (("paper-demo", "paged"), ("paper-demo", "slot"),
                        ("paper-demo", "paged/classic"),
                        ("recurrentgemma-9b", "paged"),
                        ("rwkv6-1.6b", "paged"), ("rwkv6-1.6b", "slot"))]


@pytest.mark.parametrize("arch,mesh,kv", VERIFY)
def test_engine_equals_the_oneshot_over_the_mesh(children, arch, mesh, kv):
    """(b) The `--verify` contract over the mesh: chunked lanes equal the
    streamed one-shot (serve_batch over the same mesh), classic admission
    (the slot pool, the paged pool with prefill_chunk 0, the recurrent
    archs) the full-prefill one, bit for bit."""
    _, reports, _ = _results(children)
    name = f"{arch}/{mesh}/{kv}"
    lanes = kv == "paged" and arch == "paper-demo"
    assert CASES[name]["chunk"] != 0 or not lanes
    assert np.array_equal(_tokens(reports, name),
                          _oneshot(reports, arch, mesh, streamed=lanes))


PAIRS = [(f"{a}/{m}/{x}", f"{a}/{m}/{y}") for m in MESHES
         for a, x, y in (("paper-demo", "paged/classic", "slot"),
                         ("rwkv6-1.6b", "paged", "slot"),
                         ("paper-demo", "quant", "quant/2"),
                         ("rwkv6-1.6b", "quant", "quant/2"),
                         ("paper-demo", "paged/seeded", "paged/seeded/2"))]


@pytest.mark.parametrize("a,b", PAIRS)
def test_pools_and_slot_counts_agree_over_the_mesh(children, a, b):
    """(b) Over the mesh, bit for bit: the paged pool by classic admission
    equals the slot pool; 4 slots equal 2 slots (the int8 pool greedy,
    the bf16 pool seeded: seeded rows are lane-placement-invariant)."""
    _, reports, _ = _results(children)
    assert np.array_equal(_tokens(reports, a), _tokens(reports, b))


SERVED = sorted(k for k, c in CASES.items() if c["serve"])


@pytest.mark.parametrize("name", SERVED)
def test_replica_set_under_serve_equals_one_engine(children, name):
    """(b) A 2-replica ReplicaSet under VirtualCluster.serve over the
    cluster's rendered mesh (the ranks outside it get None), through a
    scale-up (a cold replica spawned) and a scale-down (replicas drained
    and released): the tokens of one engine over the same mesh on the
    same 2 N requests, request for request."""
    _, reports, _ = _results(children)
    c = CASES[name]
    got = [rep["cases"][name] for rep in reports if name in rep["cases"]]
    assert len(got) == _ranks_of(c["mesh"])
    assert all(g["warmups"] >= 1 and g["released"] >= 1 for g in got)
    assert _tokens(reports, name).tolist() == got[0]["one"]


def _margin(logits):
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


@pytest.mark.parametrize("name", JAX_CASES)
def test_engine_over_the_mesh_matches_jax(children, name):
    """(c) JAX's ServingEngine over its mesh of the same shape (the
    cluster's rendered (1, 2) one, a (2, 2) Mesh): the port's tokens equal
    JAX's up to each request's first step where the port's top-2 margin
    (the one-shot's logits over the mesh along the port's tokens) is under
    JAX_TOL."""
    out, reports, jax_report = _results(children)
    assert not isinstance(jax_report[name], str), jax_report[name]
    want = np.asarray(jax_report[name])
    got = _tokens(reports, name)
    lg = np.load(out + ".logits." + name.replace("/", "_") + ".npy")
    assert lg.shape[:2] == (GEN, N)
    for row in range(N):
        diff = np.nonzero(got[row] != want[row])[0]
        if diff.size:
            t = diff[0]
            assert _margin(lg[t, row]) < JAX_TOL, (name, row, t)


def test_ranks_that_disagree_stop_the_run(children):
    """Over the (2, 2) mesh with data rank 1's params drawn from another
    seed, its tp group picks other tokens than data rank 0's: every rank
    stops the run with the engine's RuntimeError."""
    _, reports, _ = _results(children)
    assert all("picked different tokens" in rep["diverged"]
               for rep in reports)
