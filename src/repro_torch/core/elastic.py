"""ElasticTrainer: auto-scaling made safe for a stateful training job
(port of the JAX package's core/elastic.py).

The paper scales by powering up machines whose containers self-register;
the MPI hostfile re-renders and the *next* job uses the new size. A
training job cannot wait for "the next job": this runtime reacts to
membership-epoch changes mid-run:

  planned change (scale up/down, drain): checkpoint -> re-render ->
      restore the state onto the new rendering -> continue (no progress
      lost)
  unplanned loss (crash/partition, TTL reap): restore the last durable
      checkpoint on the survivors (progress since that checkpoint is lost,
      counted in `steps_lost`)

The counters and their order are the reference's, surprises included:
a restore counts as a reshard too; a crash before the first durable
checkpoint raises FileNotFoundError; after any restore `step` is the
checkpoint's, so run_steps counts again from there.

The data plane is the port's: make_train_step (eager, the optimizer state
updated in place). Without a process group it runs on the one device the
rendering holds (a one-card or CPU cluster, oversubscribed by its
simulated nodes). Under a process group (one process per rank, as
torchrun starts them; launch/train.py) every rank runs this trainer over
the same seeded cluster and sees the same membership epochs; the
rendering's DeviceMesh over the live members' ranks is the data plane's
mesh (the sharded train step, its state DTensors placed by
parallel/rules.py), and a rank outside it sits out the steps while
keeping the control plane's count. A planned change saves and restores
the state onto the new mesh's placements; a lost node rolls every rank
back to the last durable checkpoint.

What stays out: a rank process that really dies. The simulation's crash
drops a node from the membership and the rendered mesh, and the process
behind it lives on (outside the mesh); a process group cannot lose a
member and go on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core.template import MeshTemplate, Rendering
from repro_torch.data import ShardedLoader, SyntheticLM
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.parallel import rules

Pytree = Any


@dataclass
class ElasticStats:
    epoch_changes: int = 0
    reshards: int = 0
    restores: int = 0
    steps_lost: int = 0


def rendering_device(rendering: Rendering) -> torch.device:
    """The device this process trains on: its rank's (the card it set, or
    the CPU) over a rendered mesh, else the one real device the
    rendering holds."""
    if rendering.mesh is not None:
        if rendering.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(rendering.mesh.device_type)
    devices = set(rendering.devices)
    if len(devices) > 1:
        raise ValueError(
            f"the rendering holds {len(devices)} devices and no mesh: the "
            "port trains over several devices with one process per rank, "
            "under a process group (torchrun)")
    return rendering.devices[0]


class ElasticTrainer:
    def __init__(self, template: MeshTemplate, cfg: ModelConfig,
                 shape: ShapeConfig, ckpt_dir: str, *,
                 opt: Optional[AdamWConfig] = None,
                 plan: Optional[ParallelPlan] = None,
                 ckpt_every: int = 10, seed: int = 0,
                 data_source=None):
        self.template = template
        self.cfg = cfg
        self.shape = shape
        self.opt = opt or AdamWConfig()
        self.base_plan = plan or ParallelPlan(
            fsdp=False, remat="nothing", attn_impl="naive",
            kv_cache="replicated")
        self.ckpt = CheckpointManager(ckpt_dir, keep=3)
        self.ckpt_every = ckpt_every
        self.seed = seed
        self.data_source = data_source or SyntheticLM(
            cfg.vocab_size, shape.seq_len, seed)
        self.stats = ElasticStats()
        self.step = 0
        self._epoch = -1
        self._last_ckpt_step = 0
        self.env: Optional[Env] = None
        self.member = True  # this rank is in the rendered mesh
        self.device: Optional[torch.device] = None
        self.state: Optional[Pytree] = None
        self._step_fn = None
        self._loader: Optional[ShardedLoader] = None

    # -- (re)build ------------------------------------------------------------
    def _build(self, rendering: Rendering, *, planned: bool) -> None:
        """Re-render the data plane for a new membership epoch."""
        mesh = rendering.mesh
        new_env = Env(plan=self.base_plan, mesh=mesh)
        device = rendering_device(rendering)
        member = mesh is None or mesh.get_coordinate() is not None
        first = self._epoch < 0
        self.ckpt.wait()  # every rank reads the same directory from here
        if not first:
            if planned:
                # planned change: persist *current* progress synchronously
                self.ckpt.save(self.step, self.state,
                               {"epoch": self._epoch})
                self._last_ckpt_step = self.step
            else:
                # unplanned loss: roll back to last durable checkpoint
                last = self.ckpt.latest_step()
                lost = self.step - (last if last is not None else 0)
                self.stats.steps_lost += max(lost, 0)
                self.stats.restores += 1
        struct = St.state_struct(self.cfg, new_env, self.opt)
        specs = rules.state_specs(struct, self.cfg, new_env)
        self.state = None
        if first and self.ckpt.latest_step() is None:
            if member:
                params = Mo.init_params(self.cfg, new_env, seed=self.seed,
                                        device=device)
                self.state = rules.apply_shardings(
                    {"params": params, "opt": adamw_init(params, self.opt)},
                    specs, new_env)
        else:
            if member:
                self.state = self.ckpt.restore(
                    struct, device=device,
                    shardings=rules.to_shardings(specs, new_env))
            self.step = self.ckpt.latest_step()
            self.stats.reshards += 1
        self.env = new_env
        self.member = member
        self.device = device
        self._loader = self._step_fn = None
        if member:
            self._loader = ShardedLoader(self.data_source, self.cfg,
                                         self.shape, new_env, self.seed,
                                         device=device)
            self._step_fn = St.make_train_step(self.cfg, new_env, self.opt)
        self._epoch = rendering.epoch
        self.stats.epoch_changes += 1

    # -- run loop ----------------------------------------------------------------
    def ensure_ready(self, planned: bool = True) -> None:
        r = self.template.poll() or self.template.rendering
        assert r is not None and r.devices, "no rendered devices"
        if r.epoch != self._epoch:
            self._build(r, planned=planned)

    def run_steps(self, n: int, on_step: Optional[Callable] = None,
                  planned_changes: bool = True) -> Dict[str, float]:
        """n steps (a rank outside the rendered mesh counts them without
        computing: its metrics are empty)."""
        metrics = {}
        for _ in range(n):
            self.ensure_ready(planned=planned_changes)
            if self.member:
                batch = self._loader.batch(self.step)
                self.state, m = self._step_fn(self.state, batch)
                metrics = {k: float(v) for k, v in m.items()}
            self.step += 1
            if self.step - self._last_ckpt_step >= self.ckpt_every:
                self.ckpt.save_async(self.step, self.state,
                                     {"epoch": self._epoch})
                self._last_ckpt_step = self.step
            if on_step:
                on_step(self.step, metrics)
        return metrics

    def finalize(self) -> None:
        self.ckpt.wait()
        if self._epoch >= 0:  # built: every rank enters the save
            self.ckpt.save(self.step, self.state, {"epoch": self._epoch})
