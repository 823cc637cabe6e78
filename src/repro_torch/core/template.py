"""MeshTemplate — the consul-template analogue (paper §IV, Fig. 5).

consul-template watched the Consul catalog and re-rendered the MPI hostfile.
Here the rendered artifacts are (a) the hostfile text (kept for fidelity and
published to the KV store like the template's output file), (b) the list
of devices the live members contribute and (c) over the ranks of a
process group, the torch DeviceMesh they form — the port's analogue of
the JAX package's rendered jax.sharding.Mesh ("the device mesh is the
hostfile"). Re-rendering is triggered by registry-index watches and
debounced.

A one-card machine runs "oversubscribed": many simulated nodes map onto the
one real device (the card, or the CPU when the caller asks for it), as the
JAX package's simulation maps them onto its one CPU device. Under a
process group (one process per rank) a member's device ids are ranks,
and members that own disjoint ranks render a DeviceMesh over them. Every
rank runs the same control plane (one seeded cluster under a manual
clock), so every rank renders the same meshes at the same polls, as
DeviceMesh construction requires: each one enters every new sub-group.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.membership import (HPC_SERVICE, ClusterView, ViewDiff,
                                         ViewTracker)

HOSTFILE_KEY = "rendered/hostfile"


@dataclass(frozen=True)
class Rendering:
    epoch: int
    hostfile: str
    devices: Tuple[torch.device, ...]
    oversubscribed: bool
    view: ClusterView
    mesh: Optional[Any] = None  # a DeviceMesh over the ranks, or None


def render_hostfile(view: ClusterView) -> str:
    """The paper's hostfile, one line per live node (mpirun format)."""
    lines = [f"# epoch {view.epoch}; rendered from {HPC_SERVICE} catalog"]
    for m in view.members:
        lines.append(f"{m.node_id} slots={m.n_devices}  # {m.address} "
                     f"role={m.role}")
    return "\n".join(lines) + "\n"


def render_devices(view: ClusterView, devices: Sequence[torch.device]
                   ) -> Tuple[Tuple[torch.device, ...], bool]:
    """The devices the members contribute, in hostfile order (the ids in
    each member's address index `devices`).

    Returns (devices, oversubscribed). Falls back to the available real
    devices when members reference overlapping or out-of-range ids (the
    one-card simulation)."""
    devices = list(devices)
    if not view.members:
        return (), False
    want: List[int] = []
    for m in view.members:
        ids = [int(x) for x in
               (m.address.split("devices=")[-1].split(",") if "devices=" in
                m.address else []) if x != ""]
        want.extend(ids if ids else [-1] * m.n_devices)
    usable = [devices[i] for i in want if 0 <= i < len(devices)]
    oversub = False
    if len(set(usable)) != len(want):
        # overlapping or missing ids -> oversubscribed simulation
        oversub = True
        usable = devices[: max(1, min(len(devices), view.total_devices))]
    return tuple(usable), oversub


def default_mesh_rule(n: int, max_model: int = 16) -> Tuple[Tuple[int, int],
                                                            Tuple[str, str]]:
    """Factor n devices into ("data","model") with the largest model degree
    <= max_model that divides n."""
    model = 1
    for cand in range(min(max_model, n), 0, -1):
        if n % cand == 0:
            model = cand
            break
    return (n // model, model), ("data", "model")


def render_mesh(view: ClusterView, ranks: Sequence[int], device_type: str,
                mesh_rule: Callable = default_mesh_rule):
    """The DeviceMesh over the ranks the members contribute (hostfile
    order; render_devices's oversubscription rule), shaped by mesh_rule.
    Returns (mesh or None without members, oversubscribed). Every rank of
    the process group must call it alike."""
    from torch.distributed.device_mesh import DeviceMesh
    usable, oversub = render_devices(view, ranks)
    if not usable:
        return None, oversub
    shape, axes = mesh_rule(len(usable))
    return DeviceMesh(device_type, torch.tensor(usable).reshape(shape),
                      mesh_dim_names=axes), oversub


class MeshTemplate:
    """Watches the registry; re-renders (hostfile, devices, mesh) on
    membership change. devices: the pool member ids index (torch devices,
    or a process group's ranks; device_type given, a DeviceMesh is
    rendered over them)."""

    def __init__(self, registry, devices: Sequence,
                 min_render_interval: float = 0.0, clock=None,
                 device_type: Optional[str] = None,
                 mesh_rule: Callable = default_mesh_rule):
        self.registry = registry
        self.devices = tuple(devices)
        self.device_type = device_type
        self.mesh_rule = mesh_rule
        self.tracker = ViewTracker()
        self.min_render_interval = min_render_interval
        self.clock = clock
        self._last_render_t = -1e30
        self._last_index = -1
        self._rendering: Optional[Rendering] = None
        self._callbacks: List[Callable[[Rendering, ViewDiff], None]] = []
        self._lock = threading.RLock()
        self._held: Optional[Any] = None  # hold_mesh's mesh, while held

    @contextlib.contextmanager
    def hold_mesh(self, mesh):
        """While the block runs, renders keep `mesh` instead of building a
        DeviceMesh (a collective that every rank of the world enters): a
        loop run by the ranks of one mesh alone (VirtualCluster.serve)
        re-renders its hostfile and devices without the other ranks."""
        with self._lock:
            prev, self._held = self._held, mesh
        try:
            yield
        finally:
            with self._lock:
                self._held = prev

    def on_change(self, fn: Callable[[Rendering, ViewDiff], None]) -> None:
        self._callbacks.append(fn)

    @property
    def rendering(self) -> Optional[Rendering]:
        with self._lock:
            return self._rendering

    def poll(self, force: bool = False) -> Optional[Rendering]:
        """One watch iteration: sweep TTLs, diff the catalog, re-render on
        change. Returns the new Rendering if one was produced."""
        with self._lock:
            self.registry.sweep()
            idx = self.registry.index
            if not force and idx == self._last_index:
                return None
            self._last_index = idx
            entries = self.registry.catalog(HPC_SERVICE)
            view, d = self.tracker.update(entries)
            if not force and not d.changed and self._rendering is not None:
                return None
            if self.clock is not None and self.min_render_interval > 0:
                now = self.clock.now()
                if now - self._last_render_t < self.min_render_interval:
                    return None  # debounced; next poll retries
                self._last_render_t = now
            devices, oversub = render_devices(view, self.devices)
            mesh = self._held
            if self.device_type is not None and mesh is None:
                mesh, _ = render_mesh(view, self.devices, self.device_type,
                                      self.mesh_rule)
            hostfile = render_hostfile(view)
            r = Rendering(epoch=view.epoch, hostfile=hostfile,
                          devices=devices, oversubscribed=oversub, view=view,
                          mesh=mesh)
            self._rendering = r
            # publish like consul-template writing the file
            self.registry.kv_put(HOSTFILE_KEY, hostfile)
            self._last_index = self.registry.index
            for fn in self._callbacks:
                fn(r, d)
            return r

    def wait_for_epoch(self, epoch: int, timeout: float = 5.0,
                       poll_interval: float = 0.01) -> Rendering:
        """Blocking-query loop (threaded mode)."""
        import time
        # replint: ignore[R001] -- host-side blocking wait for threaded mode; never on a replayed sim path
        deadline = time.monotonic() + timeout
        while True:
            r = self.poll() or self.rendering
            if r is not None and r.epoch >= epoch:
                return r
            # replint: ignore[R001] -- host-side blocking wait for threaded mode; never on a replayed sim path
            if time.monotonic() > deadline:
                raise TimeoutError(f"epoch {epoch} not reached")
            self.registry.wait(self.registry.index, timeout=poll_interval)
