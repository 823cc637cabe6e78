"""VirtualCluster — the paper's Fig. 4 system as one facade.

Port of the JAX package's core/cluster.py. Wires together:
ReplicatedRegistry (Consul trio) + SimCluster (blades & containers) +
MeshTemplate (consul-template) + AutoScaler. `submit()` is the `mpirun`
analogue: run a function over the current rendering (the hostfile's
devices, or under a process group the DeviceMesh of their ranks). A
training job that lives through the cluster's membership epochs is
core/elastic.py's ElasticTrainer over `template`.
Under a process group every rank builds the same cluster (a seeded
control plane under its manual clock) and the template renders a
DeviceMesh over the ranks the live members contribute.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch.core.autoscaler import (AutoScaler, Policy, ScalePlan,
                                         TargetSizePolicy)
from repro_torch.core.clock import Clock, ManualClock
from repro_torch.core.image import ClusterImage, ImageHub
from repro_torch.core.membership import HPC_SERVICE
from repro_torch.core.registry import ReplicatedRegistry
from repro_torch.core.simnet import SimCluster
from repro_torch.core.template import MeshTemplate, Rendering


def device_pool(device) -> List:
    """What simulated nodes' device ids index. Under an initialised
    process group (one process per rank, torchrun's layout): the world's
    ranks, id i being rank i, whose device is cuda:LOCAL_RANK (the card
    its process set) or the CPU under gloo; the template renders a
    DeviceMesh over them. Otherwise the real devices of this process:
    every card for "cuda", the one named device ("cuda:1", "cpu")."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' for a "
                               "cluster whose nodes map onto the CPU")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev]


class VirtualCluster:
    def __init__(self, *, n_compute: int = 2, devices_per_node: int = 1,
                 n_registry_replicas: int = 3, ttl: float = 2.0,
                 clock: Optional[Clock] = None,
                 image: Optional[ClusterImage] = None,
                 policy: Optional[Policy] = None,
                 cooldown_s: float = 0.0,
                 metrics_ttl_s: Optional[float] = None,
                 device="cuda"):
        self.clock = clock or ManualClock()
        self.registry = ReplicatedRegistry(n_registry_replicas, self.clock)
        self.hub = ImageHub()
        self.image = image
        digest = ""
        if image is not None:
            digest = self.hub.push(image)
        devices = device_pool(device)
        self.sim = SimCluster(self.registry, clock=self.clock,
                              devices_per_node=devices_per_node, ttl=ttl,
                              image_digest=digest, n_devices=len(devices))
        ranks = isinstance(devices[0], int)
        self.template = MeshTemplate(
            self.registry, devices, clock=self.clock,
            device_type=torch.device(device).type if ranks else None)
        self.scaler = AutoScaler(policy or TargetSizePolicy(n_compute),
                                 provisioner=self.sim, clock=self.clock,
                                 cooldown_s=cooldown_s,
                                 metrics_ttl_s=metrics_ttl_s)
        self.head_id = self.sim.add_head()
        self.sim.add_nodes(n_compute)
        self.pump()

    # -- control-plane pump ------------------------------------------------------
    def pump(self, dt: float = 0.0, autoscale: bool = False) -> Rendering:
        self.sim.pump(dt)
        if autoscale:
            view = self.current_view()
            metrics = self.scaler.read_metrics(self.registry)
            self.scaler.step(view, metrics)
            self.sim.pump()
        return self.template.poll() or self.template.rendering

    def current_view(self):
        self.template.poll()
        return self.template.tracker.view

    @property
    def rendering(self) -> Rendering:
        r = self.template.rendering
        assert r is not None
        return r

    @property
    def hostfile(self) -> str:
        return self.rendering.hostfile

    # -- image checks (paper §III-A: no version-skew clusters) ---------------------
    def verify_images(self) -> bool:
        entries = self.registry.catalog(HPC_SERVICE)
        digests = {e.meta.get("image", "") for e in entries}
        return len(digests) <= 1

    # -- the mpirun analogue --------------------------------------------------------
    def submit(self, fn: Callable, *args, **kwargs):
        """Run `fn(target, *args, **kwargs)` SPMD over the rendering, as
        the JAX package passes its rendered mesh. Under a process group
        the target is the rendered DeviceMesh over the members' ranks:
        every rank of the group calls submit alike, the ranks of the mesh
        run fn, and a rank outside it runs nothing and gets None.
        Otherwise it is the rendered device list (hostfile order; an
        oversubscribed simulation renders each real device once)."""
        r = self.rendering
        assert r.devices, "cluster has no devices"
        if r.mesh is not None:
            if r.mesh.get_coordinate() is None:
                return None
            return fn(r.mesh, *args, **kwargs)
        return fn(list(r.devices), *args, **kwargs)

    # -- scaling API -------------------------------------------------------------------
    def scale_to(self, n: int) -> Rendering:
        """Operator-issued one-shot resize. Applies a single plan directly;
        a metric-driven autoscaling policy stays in charge of subsequent
        reconcile iterations (it is NOT replaced). A TargetSizePolicy —
        including the constructor default — is retargeted to `n` so later
        autoscale pumps (e.g. straggler healing) hold the operator's size
        instead of reverting to the old pin."""
        if isinstance(self.scaler.policy, TargetSizePolicy):
            self.scaler.policy.target = n
        view = self.current_view()
        self.scaler.apply_plan(view, ScalePlan(n, reason=f"scale_to({n})"))
        self.sim.pump()
        return self.template.poll() or self.rendering

    # -- long-running serving (continuous batching; serve/scheduler.py) ------------------
    def serve(self, engine, requests=(), *, dt=0.05, autoscale: bool = True,
              max_steps: int = 100_000, on_step=None):
        """Drive a serving engine to completion against this cluster —
        a single ServingEngine, or a multi-replica ReplicaSet
        (serve/router.py), detected by its reconcile/metric_sources
        surface.

        Each iteration: one scheduler step (admit / mixed-batch decode +
        prefill lanes / retire), publish the engine's metrics through the
        head node's agent into the registry KV, then pump the control
        plane with autoscaling — so the installed policy
        (QueueDepthPolicy, LatencyPolicy, ...) resizes the cluster
        *mid-serve* from live load.

        With a ReplicaSet the loop closes all the way through the data
        plane: each replica's snapshot is published as its own metric
        source, released replicas have their keys tombstoned immediately,
        and after every pump the fleet is reconciled to the applied
        plan's compute-node count — a scale-up spawns a cold replica, a
        scale-down drains one for real (serve/router.py).

        `dt` is the simulated wall time of one decode step: a float, or a
        callable (n_compute -> seconds). With a single engine the callable
        models data-parallel speedup; a ReplicaSet's speedup is real —
        every live replica decodes its own batch within the tick — so a
        constant dt is the honest choice there. The engine must share this
        cluster's clock.

        Under a process group the engine is one over the rendered mesh
        (built with mesh=rendering.mesh, serve/scheduler.py): every rank
        of the mesh drives the same loop, and the control plane's
        decisions are the same on each because the clock and the metrics
        (host state, the same on every rank) are. A rank outside the
        rendered mesh does nothing and gets None, as submit does (its
        `engine` may be None). The engine's mesh is fixed for its life,
        as in the JAX package, so while the loop runs the template's
        renders keep that mesh (MeshTemplate.hold_mesh): a new DeviceMesh
        is built by every rank of the world, and the ranks outside this
        one do not run the loop. Those ranks' control planes stay where
        the serve found them.

        Returns engine.results() (rid -> tokens).
        """
        mesh = self.rendering.mesh
        if mesh is not None and mesh.get_coordinate() is None:
            return None
        assert engine.clock is self.clock, \
            "engine must be built with clock=cluster.clock"
        with self.template.hold_mesh(mesh):
            return self._serve(engine, requests, dt, autoscale, max_steps,
                               on_step)

    def _serve(self, engine, requests, dt, autoscale, max_steps, on_step):
        engine.submit(requests)
        head_agent = self.sim.nodes[self.head_id].agent
        reconcile = getattr(engine, "reconcile", None)
        sources = getattr(engine, "metric_sources", None)
        steps = 0
        while not engine.drained() and steps < max_steps:
            snap = engine.step()
            if sources is not None:
                for src, m in sources().items():
                    head_agent.report_serving(m, source=src)
                for src in engine.pop_retired_sources():
                    head_agent.retire_source(src)
            else:
                head_agent.report_serving(snap)
            n = max(len(self.current_view().compute), 1)
            step_dt = dt(n) if callable(dt) else dt
            self.pump(dt=step_dt, autoscale=autoscale)
            if reconcile is not None:
                reconcile(max(len(self.current_view().compute), 1))
            if on_step is not None:
                on_step(steps, snap, self)
            steps += 1
        if not engine.drained():
            raise RuntimeError(f"serve did not drain in {max_steps} steps")
        return engine.results()

    # -- fault injection passthrough -----------------------------------------------------
    def crash_node(self, node_id: str) -> None:
        self.sim.crash(node_id)

    def compute_nodes(self) -> List[str]:
        view = self.current_view()
        return [m.node_id for m in view.compute]

    def shutdown(self) -> None:
        self.sim.remove_nodes(list(self.sim.nodes))
