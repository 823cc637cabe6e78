"""The port's elastic runtime (core/elastic.py ElasticTrainer, the training
CLI launch/train.py) against the JAX package's, on the CPU.

Counters (epoch changes, reshards, restores, steps lost, the trainer's
step) must equal the reference's in every scenario, its surprises
included: a crash before the first durable checkpoint raises
FileNotFoundError, and after a rollback the trainer counts steps again
from the checkpoint's.

Losses: the port's own stream across a planned reshard equals an
uninterrupted run's bit for bit (the state round-trips through the
checkpoint exactly and the CPU step is deterministic), where the
reference's test allows rtol 2e-2. Against JAX's trainer from one step-0
checkpoint (JAX's weights, the same data stream), the first loss within
LOSS_TOL and every later one within 1e-2: the bounds of
tests/test_torch_train.py::test_train_step_tracks_jax_and_the_loss_falls,
and why (each step rounds the new weights to bf16 and the gradients move
apart from there).
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.configs.base import ShapeConfig as JShape
from repro.core import VirtualCluster as JVirtualCluster
from repro.core.elastic import ElasticTrainer as JElasticTrainer
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.configs.paper_demo import CLUSTER
from repro_torch.core import ClusterImage, VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.core.template import Rendering
from repro_torch.launch import train as cli

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PLAN = ParallelPlan(fsdp=False, remat="full", attn_impl="naive",
                    kv_cache="replicated")
SHAPE = ShapeConfig("t", seq_len=16, global_batch=4, kind="train")
JSHAPE = JShape("t", seq_len=16, global_batch=4, kind="train")
LOSS_TOL = 5e-4
CLI_ARGS = ["--smoke", "--steps", "20", "--nodes", "2", "--scale-to", "3@8",
            "--crash-at", "14", "--ckpt-every", "5", "--log-every", "5"]
DONE = "done: 20 steps; epochs=3 reshards=2 restores=1 steps_lost=1"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mk_trainer(tmp_path, cluster, **kw):
    return ElasticTrainer(cluster.template, torch_smoke("yi-9b"), SHAPE,
                          str(tmp_path), plan=PLAN, ckpt_every=5, **kw)


def _stats(t):
    s = t.stats
    return (s.epoch_changes, s.reshards, s.restores, s.steps_lost, t.step)


# ---- the reference's four elastic tests -------------------------------------------


def test_planned_scale_preserves_progress(tmp_path):
    c = VirtualCluster(n_compute=2, device="cpu")
    t = mk_trainer(tmp_path, c)
    t.run_steps(4)
    assert t.step == 4
    c.scale_to(3)
    t.run_steps(2)  # triggers checkpoint->restore->resume
    assert t.step == 6, "no steps lost on planned scale"
    assert t.stats.reshards == 1
    assert t.stats.steps_lost == 0
    assert t.ckpt.metadata(4) == {"epoch": 1}
    c.shutdown()


def test_crash_rolls_back_to_durable_checkpoint(tmp_path):
    c = VirtualCluster(n_compute=3, ttl=2.0, device="cpu")
    t = mk_trainer(tmp_path, c)
    t.run_steps(7)  # ckpt_every=5 -> durable at step 5
    t.ckpt.wait()
    victim = c.compute_nodes()[-1]
    c.crash_node(victim)
    c.pump(dt=3.0)
    t.run_steps(1, planned_changes=False)
    assert t.stats.restores == 1
    assert t.stats.steps_lost == 2  # steps 6,7 rolled back
    assert t.step == 6  # restored 5, ran 1
    assert t.stats.reshards == 1  # a restore counts as a reshard
    c.shutdown()


def test_loss_continuity_across_reshard_is_bit_equal(tmp_path):
    """The loss stream after a planned reshard equals an uninterrupted run
    (same data order, same state) bit for bit."""
    c1 = VirtualCluster(n_compute=2, device="cpu")
    t1 = mk_trainer(tmp_path / "a", c1)
    losses_ref = [t1.run_steps(1)["loss"] for _ in range(6)]
    c1.shutdown()
    c2 = VirtualCluster(n_compute=2, device="cpu")
    t2 = mk_trainer(tmp_path / "b", c2)
    losses = []
    for i in range(6):
        if i == 3:
            c2.scale_to(3)
        losses.append(t2.run_steps(1)["loss"])
    c2.shutdown()
    assert t2.stats.reshards == 1
    assert losses == losses_ref


def test_training_reduces_loss(tmp_path):
    c = VirtualCluster(n_compute=2, device="cpu")
    t = mk_trainer(tmp_path, c)
    first = t.run_steps(1)["loss"]
    last = t.run_steps(30)["loss"]
    assert last < first, (first, last)
    c.shutdown()


# ---- the reference's surprises, on both sides ----------------------------------------


def test_crash_before_the_first_checkpoint_raises_on_both_sides(tmp_path):
    """Two steps, then a node lost with no durable checkpoint yet: the
    rollback restores a checkpoint that does not exist, in JAX's trainer
    and in the port's alike; both count the loss and the restore first."""
    jc = JVirtualCluster(n_compute=3, ttl=2.0)
    jt = JElasticTrainer(jc.template, get_smoke("yi-9b"), JSHAPE,
                         str(tmp_path / "jax"),
                         plan=JPlan(fsdp=False, remat="full",
                                    attn_impl="naive",
                                    kv_cache="replicated"), ckpt_every=5)
    c = VirtualCluster(n_compute=3, ttl=2.0, device="cpu")
    t = mk_trainer(tmp_path / "torch", c)
    for cluster, trainer in ((jc, jt), (c, t)):
        trainer.run_steps(2)
        cluster.crash_node(cluster.compute_nodes()[-1])
        cluster.pump(dt=3.0)
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            trainer.run_steps(1, planned_changes=False)
        cluster.shutdown()
    assert _stats(t) == _stats(jt) == (1, 0, 1, 2, 2)


def test_elastic_trainer_tracks_jax_from_one_checkpoint(tmp_path):
    """JAX writes the step-0 state of its PRNGKey(0) weights into two
    directories; JAX's trainer and the port's each start from one (their
    first build restores it), run 6 steps with a planned scale_to(3)
    before the fourth, and give equal counters; their losses agree within
    LOSS_TOL on the first step and 1e-2 after."""
    jcfg = get_smoke("yi-9b")
    plan = JPlan(fsdp=False, remat="nothing", attn_impl="naive",
                 kv_cache="replicated")
    params = JMo.init_params(jax.random.PRNGKey(0), jcfg,
                             JEnv(mesh=None, plan=plan))
    state = {"params": params, "opt": JA.adamw_init(params,
                                                    JA.AdamWConfig())}
    for d in ("jax", "torch"):
        JCheckpointManager(str(tmp_path / d)).save(0, state, {"epoch": 0})
    jc = JVirtualCluster(n_compute=2)
    jt = JElasticTrainer(jc.template, jcfg, JSHAPE, str(tmp_path / "jax"),
                         ckpt_every=5)
    c = VirtualCluster(n_compute=2, device="cpu")
    t = ElasticTrainer(c.template, torch_smoke("yi-9b"), SHAPE,
                       str(tmp_path / "torch"), ckpt_every=5)
    jl, tl = [], []
    for i in range(6):
        if i == 3:
            jc.scale_to(3)
            c.scale_to(3)
        jl.append(jt.run_steps(1)["loss"])
        tl.append(t.run_steps(1)["loss"])
    jc.shutdown()
    c.shutdown()
    assert _stats(t) == _stats(jt) == (2, 2, 0, 0, 6)
    assert abs(tl[0] - jl[0]) <= LOSS_TOL, (tl, jl)
    assert all(abs(a - b) <= 1e-2 for a, b in zip(tl, jl)), (tl, jl)


def test_paper_figure_sequence(tmp_path):
    """tests/test_system.py's demo on the port: 1 head + 2 compute,
    auto-registration, hostfile, a 16-domain job over the rendered
    devices, scale-out to 4, then a training job that survives a scale
    down to 2 with no step lost."""
    cfg = torch_smoke("paper-demo")
    plan = ParallelPlan(fsdp=False, remat="full", attn_impl="naive")
    image = ClusterImage.build("mpi-computenode", cfg, plan, "train")
    assert "FROM repro:base" in image.dockerfile()

    c = VirtualCluster(n_compute=CLUSTER.n_compute_nodes, image=image,
                       device="cpu")
    assert len(c.compute_nodes()) == 2
    assert c.verify_images()
    hf = c.hostfile
    assert hf.count("compute") >= 2 and "head000" in hf

    def mpi_job(devices):
        n = CLUSTER.mpi_ranks
        x = torch.linspace(0, 1, n * 8, device=devices[0]).reshape(n, 8)
        for _ in range(4):  # laplace-like halo exchange
            x = 0.25 * (2 * x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0))
        return x.cpu().numpy()

    out = c.submit(mpi_job)
    assert out.shape == (16, 8) and np.isfinite(out).all()

    c.scale_to(4)
    assert len(c.compute_nodes()) == 4

    shape = ShapeConfig("t", 16, 4, "train")
    t = ElasticTrainer(c.template, cfg, shape, str(tmp_path), plan=plan,
                       ckpt_every=4)
    t.run_steps(3)
    c.scale_to(2)
    t.run_steps(2)
    assert t.step == 5 and t.stats.steps_lost == 0
    assert t.device == torch.device("cpu")
    c.shutdown()


# ---- devices: the rendering's, never a fallback ------------------------------------


class _Template:
    """A template whose rendering is fixed (the trainer's only input)."""

    def __init__(self, devices):
        self.rendering = Rendering(epoch=1, hostfile="", devices=devices,
                                   oversubscribed=False, view=None)

    def poll(self):
        return None


def test_a_rendering_of_several_devices_or_none_is_refused(tmp_path):
    two = ElasticTrainer(_Template((torch.device("cpu"),
                                    torch.device("meta"))),
                         torch_smoke("yi-9b"), SHAPE, str(tmp_path / "a"))
    with pytest.raises(ValueError, match="one process per rank"):
        two.ensure_ready()
    empty = ElasticTrainer(_Template(()), torch_smoke("yi-9b"), SHAPE,
                           str(tmp_path / "b"))
    with pytest.raises(AssertionError, match="no rendered"):
        empty.ensure_ready()


def test_entry_points_default_to_the_card(tmp_path):
    """VirtualCluster (the trainer's devices) and the CLI default to
    "cuda": without a card they fail, and nothing moves to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualCluster(n_compute=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--smoke", "--steps", "1", "--ckpt-dir",
                  str(tmp_path)])


def test_cli_prints_jax_done_line(tmp_path):
    """`python -m repro_torch.launch.train --smoke --device cpu` with the
    reference CLI's flags (scale to 3 at 8, crash at 14, checkpoints every
    5) ends with the JAX CLI's `done:` line; both run as subprocesses."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {
        "jax": subprocess.Popen(
            [sys.executable, "-m", "repro.launch.train", *CLI_ARGS,
             "--ckpt-dir", str(tmp_path / "jax")], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
        "torch": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *CLI_ARGS,
             "--device", "cpu", "--ckpt-dir", str(tmp_path / "torch")],
            env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)}
    out = {}
    for name, p in procs.items():
        try:
            out[name] = p.communicate(timeout=600)[0]
        finally:
            p.kill()
        assert p.returncode == 0, out[name]
    last = {k: v.strip().splitlines()[-1] for k, v in out.items()}
    assert last["torch"] == last["jax"] == DONE
    for line in ("--- scaling to 3 nodes", "--- crashing compute003",
                 "step    15 loss="):
        assert line in out["torch"] and line in out["jax"], line
