"""The elastic runtime over ranks: the template renders a DeviceMesh from
the hostfile over a process group's ranks, an ElasticTrainer trains over
the rendered mesh through a planned scale and a lost node, and the
training CLI runs under torchrun's environment; eight and two gloo ranks
on the CPU, against the JAX package and the port's one-device trainer.

Every rank builds the same seeded VirtualCluster and drives it alike, so
every rank sees the same membership epochs and renders the same meshes
(core/template.py). One spawn of eight rank children (torch and
repro_torch only) runs the rendering and trainer cases; one JAX child on
eight forced host devices runs JAX's ElasticTrainer over its own rendered
mesh of eight; the CLI runs as two processes of its own.

Tolerances: a restored state equals the state saved at its step, gathered,
bit for bit (the checkpoint stores the whole leaves and each rank takes
its shard of them). Losses against JAX's trainer over eight host
devices from one step-0 checkpoint: within JAX8_TOL = 1e-3 relative
(measured up to 1.0e-4): on one device the two packages lie within
LOSS_TOL, and each side's tp shares of a row product are summed in
another order, JAX's rounded to bf16 before its psum. Losses against the
port's one-device trainer on the same schedule: within TRACK_TOL = 1e-3
relative (tests/test_torch_sharded.py measures the sharded step's
rounding against one device's: 1.1e-4 by the third step; these runs
take 12).
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
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.launch import steps as St
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig, tree_leaves

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 8
JAX8_TOL = 1e-3
TRACK_TOL = 1e-3
JAX_STEPS = 3
# the 4-rank schedule: a planned scale to 2 nodes before step SCALE_AT, a
# lost node before step CRASH_AT, checkpoints every CKPT_EVERY steps
STEPS, SCALE_AT, CRASH_AT, CKPT_EVERY = 12, 5, 9, 3
CLI_ARGS = ["--smoke", "--device", "cpu", "--steps", "20", "--nodes", "2",
            "--scale-to", "3@8", "--crash-at", "14", "--ckpt-every", "5",
            "--log-every", "5"]
DONE = "done: 20 steps; epochs=3 reshards=2 restores=1 steps_lost=1"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def schedule(cluster, trainer, steps=STEPS):
    """The 4-rank case's schedule, as the training CLI drives it: losses
    by iteration (a rank outside the mesh gets None)."""
    losses = []
    for i in range(steps):
        if i == SCALE_AT:
            cluster.scale_to(2)
            trainer.ensure_ready(planned=True)
        if i == CRASH_AT:
            cluster.crash_node(cluster.compute_nodes()[-1])
            cluster.pump(dt=10.0)  # let the TTL lapse
            trainer.ensure_ready(planned=False)
        cluster.pump(dt=0.1)
        losses.append(trainer.run_steps(1).get("loss"))
    return losses


def stats(t):
    s = t.stats
    return [s.epoch_changes, s.reshards, s.restores, s.steps_lost, t.step]


_RANK = """
import json
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.launch import steps as St
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
exec(sys.argv[5])  # schedule() and its constants, from the test module
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
report = {}
# a copy of every leaf, gathered (the step updates the state in place)
whole = lambda t: tree_map(lambda x: (x.full_tensor() if isinstance(
    x, DTensor) else x).clone(), t)

# 1. the hostfile renders a mesh over the ranks; the trainer over it
# resumes JAX's step-0 checkpoint and takes JAX_STEPS steps
c = VirtualCluster(n_compute=4, devices_per_node=2, device="cpu")
r = c.rendering
report["mesh8"] = [list(r.mesh.shape), r.oversubscribed,
                   sorted(r.mesh.mesh.flatten().tolist())]
t = ElasticTrainer(c.template, get_smoke("yi-9b"),
                   ShapeConfig("t", 16, 8, "train"), out + ".jax8.port",
                   ckpt_every=100)
report["jax8"] = [t.run_steps(1)["loss"] for _ in range(%(jax_steps)d)]
c.scale_to(2)
report["mesh_after_scale"] = c.rendering.mesh.size()
c.shutdown()

# 2. four of the eight ranks through a planned scale and a lost node
c = VirtualCluster(n_compute=4, devices_per_node=1, ttl=2.0, device="cpu")
cfg = get_smoke("paper-demo")
opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
t = ElasticTrainer(c.template, cfg, ShapeConfig("t", 16, 8, "train"),
                   out + ".elastic", opt=opt, ckpt_every=CKPT_EVERY)
t.ckpt.keep = 100
snaps, restored, orig = {}, [], {}
for name in ("save", "save_async", "restore"):
    fn = orig[name] = getattr(t.ckpt, name)

    def wrapped(*a, fn=fn, name=name, **kw):
        if name != "restore":  # every rank enters; members hold a state
            if a[1] is not None:
                snaps[a[0]] = whole(a[1])
            return fn(*a, **kw)
        step = t.ckpt.latest_step()
        got = fn(*a, **kw)
        restored.append([step, all(
            torch.equal(x, y) for x, y in zip(tree_leaves(whole(got)),
                                               tree_leaves(snaps[step])))])
        return got

    setattr(t.ckpt, name, wrapped)
meshes = []
c.template.on_change(lambda rr, d: meshes.append(
    None if rr.mesh is None else list(rr.mesh.shape)))
report["losses"] = schedule(c, t)
t.finalize()
report["stats"] = stats(t)
report["restored"] = restored
report["meshes"] = meshes
report["last_mesh_ranks"] = sorted(c.rendering.mesh.mesh.flatten().tolist())

# 3. the checkpoint the four ranks wrote at step CKPT_EVERY, restored onto
# two ranks and onto one device
struct = St.state_struct(cfg, Env(plan=t.base_plan), opt)
two = DeviceMesh("cpu", torch.tensor([[0, 1]]),
                 mesh_dim_names=("data", "model"))
env2 = Env(plan=t.base_plan, mesh=two)
if rank < 2:
    specs = R.state_specs(struct, cfg, env2)
    got = orig["restore"](struct, step=CKPT_EVERY,
                          shardings=R.to_shardings(specs, env2))
    report["onto2"] = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(whole(got)), tree_leaves(snaps[CKPT_EVERY])))
    report["onto2_sharded"] = sum(
        x.to_local().shape != x.shape for x in tree_leaves(got))
if rank == 0:
    got = orig["restore"](struct, step=CKPT_EVERY, device="cpu")
    report["onto1"] = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(got), tree_leaves(snaps[CKPT_EVERY])))
c.shutdown()
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
"""

_JAX = """
import sys
from repro.configs import get_smoke
from repro.configs.base import ShapeConfig
from repro.core import VirtualCluster
from repro.core.elastic import ElasticTrainer
out, steps = sys.argv[1], int(sys.argv[2])
c = VirtualCluster(n_compute=4, devices_per_node=2)
assert c.rendering.mesh.devices.size == 8
t = ElasticTrainer(c.template, get_smoke("yi-9b"),
                   ShapeConfig("t", 16, 8, "train"), out + ".jax8.jax",
                   ckpt_every=100)
print("LOSSES", [t.run_steps(1)["loss"] for _ in range(steps)])
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of eight gloo children for the module's rank cases, and a
    JAX child on eight host devices; the step-0 checkpoint both eight-way
    trainers resume written here. Returns (the ranks' reports, JAX's
    losses, the output prefix)."""
    tmp = tmp_path_factory.mktemp("ranks")
    out = str(tmp / "run")
    # JAX's PRNGKey(0) state, shaped for a tp of 8 (the mesh the hostfile
    # renders: default_mesh_rule(8) = (1, 8)), its padded heads drawn too
    jcfg = get_smoke("yi-9b")
    plan = JPlan(fsdp=False, remat="nothing", attn_impl="naive",
                 kv_cache="replicated")
    env = JEnv(mesh=AbstractMesh((1, 8), ("data", "model")), plan=plan)
    params = JMo.init_params(jax.random.PRNGKey(0), jcfg, env)
    state = {"params": params, "opt": JA.adamw_init(params,
                                                    JA.AdamWConfig())}
    for side in ("jax", "port"):
        JCheckpointManager(out + ".jax8." + side).save(0, state,
                                                       {"epoch": 0})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    import inspect
    shared = (f"STEPS, SCALE_AT, CRASH_AT, CKPT_EVERY = {STEPS}, "
              f"{SCALE_AT}, {CRASH_AT}, {CKPT_EVERY}\n"
              + textwrap.dedent(inspect.getsource(schedule))
              + textwrap.dedent(inspect.getsource(stats)))
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         textwrap.dedent(_RANK) % {"jax_steps": JAX_STEPS}, str(r),
         str(WORLD), str(tmp / "store"), out, shared], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out, str(JAX_STEPS)],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-20000:]
    reports = []
    for r in range(WORLD):
        with open(out + f".report.{r}.json") as f:
            reports.append(json.load(f))
    jax_losses = eval(logs[-1].split("LOSSES", 1)[1].strip().splitlines()[0])
    return reports, jax_losses, out


def test_hostfile_renders_a_mesh_over_the_ranks(ranks):
    """VirtualCluster(n_compute=4, devices_per_node=2) over eight ranks
    renders a mesh of all eight, not oversubscribed ((1, 8):
    default_mesh_rule); scale_to(2) renders one of 4-6 (the JAX
    package's tests/test_multidevice.py::
    test_hostfile_renders_real_multidevice_mesh)."""
    reports, _, _ = ranks
    for rep in reports:
        assert rep["mesh8"] == [[1, 8], False, list(range(8))]
        assert rep["mesh_after_scale"] in (4, 5, 6)


def test_trainer_over_the_rendered_mesh_tracks_jax(ranks):
    """JAX's ElasticTrainer over its rendered mesh of eight host devices
    and the port's over the eight ranks resume one step-0 checkpoint of
    JAX's weights (heads padded for tp 8) and take three steps: every
    loss within JAX8_TOL of JAX's, on every rank."""
    reports, jax_losses, _ = ranks
    for rep in reports:
        got = rep["jax8"]
        assert len(got) == len(jax_losses) == JAX_STEPS
        assert all(abs(a - b) <= JAX8_TOL * abs(b)
                   for a, b in zip(got, jax_losses)), (got, jax_losses)


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The port's one-device trainer on the 4-rank case's schedule."""
    c = VirtualCluster(n_compute=4, devices_per_node=1, ttl=2.0,
                       device="cpu")
    t = ElasticTrainer(c.template, torch_smoke("paper-demo"),
                       ShapeConfig("t", 16, 8, "train"),
                       str(tmp_path_factory.mktemp("one")),
                       opt=AdamWConfig(lr=1e-3, warmup_steps=0,
                                       weight_decay=0.0),
                       ckpt_every=CKPT_EVERY)
    losses = schedule(c, t)
    t.finalize()
    c.shutdown()
    return losses, stats(t)


def test_elastic_trainer_over_four_ranks(ranks, one_device):
    """Four ranks of the eight (4 nodes of one device: the other four sit
    out) train paper-demo smoke through a planned scale to 2 nodes and a
    lost node: the meshes go 4 -> 2 -> 1 ranks, every restored state
    equals the state saved at its step (gathered, torch.equal), the
    counters equal the one-device trainer's on the same schedule, and the
    losses track it within TRACK_TOL."""
    reports, _, _ = ranks
    want_losses, want_stats = one_device
    # saves at 3 and 8 (async) and 5 (planned); the crash at 9 loses one
    last = (CRASH_AT // CKPT_EVERY) * CKPT_EVERY - 1
    assert want_stats == [3, 2, 1, CRASH_AT - last, STEPS - CRASH_AT + last]
    for rep in reports:
        assert rep["stats"] == want_stats
        assert rep["meshes"] == [[1, 2], [1, 1]]
        assert rep["last_mesh_ranks"] == [0]
    assert reports[0]["restored"] == [[SCALE_AT, True], [last, True]]
    assert reports[1]["restored"] == [[SCALE_AT, True]]
    assert all(rep["restored"] == [] for rep in reports[2:])
    rank0 = reports[0]
    for got, want in zip(rank0["losses"], want_losses):
        assert abs(got - want) <= TRACK_TOL * abs(want), (
            rank0["losses"], want_losses)
    # ranks outside the mesh computed nothing
    assert all(x is None for x in reports[7]["losses"])
    assert reports[1]["losses"][CRASH_AT] is None


def test_a_four_rank_checkpoint_restores_onto_two_ranks_and_one_device(
        ranks):
    """The step-3 checkpoint the four ranks wrote restores onto a 1 x 2
    mesh of ranks 0 and 1 (sharded) and onto one device, each equal to
    the state saved, gathered, bit for bit."""
    reports, _, _ = ranks
    assert reports[0]["onto1"] is True
    for rep in reports[:2]:
        assert rep["onto2"] is True and rep["onto2_sharded"] > 0


def test_jax_restores_the_four_rank_checkpoint(ranks):
    """The JAX package's CheckpointManager reads the checkpoint the four
    ranks wrote (gathered leaves, JAX's on-disk format) into its own
    train state's tree, leaf for leaf equal to the port's one-device
    restore of it."""
    _, _, out = ranks
    jcfg = get_smoke("paper-demo")
    plan = JPlan(fsdp=False, remat="nothing", attn_impl="naive",
                 kv_cache="replicated")
    opt = JA.AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    struct = jax.eval_shape(lambda k: (lambda p: {
        "params": p, "opt": JA.adamw_init(p, opt)})(JMo.init_params(
            k, jcfg, JEnv(mesh=None, plan=plan))),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    got = JCheckpointManager(out + ".elastic").restore(struct,
                                                       step=CKPT_EVERY)
    mine = CheckpointManager(out + ".elastic").restore(
        St.state_struct(torch_smoke("paper-demo"), Env(plan=ParallelPlan(
            fsdp=False, remat="nothing", attn_impl="naive",
            kv_cache="replicated")), AdamWConfig(
                lr=1e-3, warmup_steps=0, weight_decay=0.0)),
        step=CKPT_EVERY, device="cpu")
    jl, tl = jax.tree.leaves(got), tree_leaves(mine)
    assert len(jl) == len(tl) > 0
    for j, t in zip(jl, tl):
        j = np.asarray(j)
        t = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy())
        assert np.array_equal(j.view(np.uint16) if j.dtype == jnp.bfloat16
                              else j, t)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_over_two_gloo_ranks_prints_the_done_line(tmp_path):
    """`python -m repro_torch.launch.train` as torchrun starts it (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) over two gloo ranks
    with the JAX CLI's flags: rank 0 prints the run and ends with the JAX
    CLI's `done:` line; rank 1 prints nothing."""
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
                   RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS,
             "--ckpt-dir", str(tmp_path / "ck")], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    out = []
    for p in procs:
        try:
            out.append(p.communicate(timeout=300))
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), out
    lines = out[0][0].strip().splitlines()
    assert lines[-1] == DONE
    for line in ("--- scaling to 3 nodes", "--- crashing compute003",
                 "step    15 loss="):
        assert line in out[0][0], line
    assert out[1][0] == ""
    shutil.rmtree(tmp_path / "ck", ignore_errors=True)
