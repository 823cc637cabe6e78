"""simnet — the simulated multi-node control plane (a copy of the JAX
package's core/simnet.py).

The paper ran 3 physical blades; this is one process, so physical nodes are
simulated: each SimNode owns a NodeAgent plus a slice of the cluster's
device ids, and all registry traffic flows through a Network that can
inject partitions, delays, and crashes. The *data plane* stays real
PyTorch on the devices the MeshTemplate renders (core/template.py).

Deterministic by construction: tests drive a ManualClock and call pump().
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.core.agent import NodeAgent
from repro_torch.core.clock import Clock, ManualClock
from repro_torch.core.registry import RegistryError


class Network:
    """Interposes agent->registry calls; injects partitions/outages."""

    def __init__(self):
        self._partitioned: Set[str] = set()
        self._lock = threading.Lock()

    def partition(self, node_id: str) -> None:
        with self._lock:
            self._partitioned.add(node_id)

    def heal(self, node_id: str) -> None:
        with self._lock:
            self._partitioned.discard(node_id)

    def reachable(self, node_id: str) -> bool:
        with self._lock:
            return node_id not in self._partitioned


class _GuardedRegistry:
    """Registry proxy enforcing network reachability for one node."""

    def __init__(self, registry, network: Network, node_id: str):
        self._r = registry
        self._net = network
        self._id = node_id

    def _check(self):
        if not self._net.reachable(self._id):
            raise RegistryError(f"{self._id} partitioned from registry")

    def register(self, *a, **kw):
        self._check()
        return self._r.register(*a, **kw)

    def deregister(self, *a, **kw):
        self._check()
        return self._r.deregister(*a, **kw)

    def heartbeat(self, *a, **kw):
        self._check()
        return self._r.heartbeat(*a, **kw)

    def kv_put(self, *a, **kw):
        self._check()
        return self._r.kv_put(*a, **kw)


@dataclass
class SimNode:
    node_id: str
    agent: NodeAgent
    device_ids: Sequence[int]
    step_time_bias: float = 0.0  # injected slowness (straggler simulation)
    alive: bool = True


class SimCluster:
    """Provisioner + world: creates/destroys SimNodes against a registry.

    Device assignment: round-robins the real device pool across nodes
    (devices_per_node each). When the pool is exhausted, ids repeat and the
    MeshTemplate falls back to the oversubscribed single-host mesh.
    """

    def __init__(self, registry, *, clock: Optional[Clock] = None,
                 devices_per_node: int = 1, ttl: float = 2.0,
                 image_digest: str = "", n_devices: Optional[int] = None):
        self.registry = registry
        self.clock = clock or ManualClock()
        self.network = Network()
        self.devices_per_node = devices_per_node
        self.ttl = ttl
        self.image_digest = image_digest
        self.nodes: Dict[str, SimNode] = {}
        self._counter = itertools.count()
        # the size of the device pool the ids index (VirtualCluster
        # passes its own; one device — the card or the CPU — otherwise)
        self._n_devices = n_devices if n_devices is not None else 1
        self._next_dev = 0

    # -- provisioner interface (AutoScaler) -----------------------------------
    def add_nodes(self, n: int, role: str = "compute",
                  devices_per_node: int | None = None) -> List[str]:
        dpn = (self.devices_per_node if devices_per_node is None
               else devices_per_node)
        out = []
        for _ in range(n):
            nid = f"{role}{next(self._counter):03d}"
            ids = [(self._next_dev + i) % max(self._n_devices, 1)
                   for i in range(dpn)]
            self._next_dev += dpn
            agent = NodeAgent(
                nid, _GuardedRegistry(self.registry, self.network, nid),
                n_devices=dpn, role=role, ttl=self.ttl,
                device_ids=ids, clock=self.clock,
                image_digest=self.image_digest)
            agent.start()
            self.nodes[nid] = SimNode(nid, agent, ids)
            out.append(nid)
        return out

    def add_head(self) -> str:
        # the head coordinates (renders the hostfile, submits jobs); it
        # contributes no accelerators to the mesh
        return self.add_nodes(1, role="head", devices_per_node=0)[0]

    def remove_nodes(self, node_ids: List[str]) -> None:
        for nid in node_ids:
            node = self.nodes.pop(nid, None)
            if node is not None:
                node.agent.drain()
                node.alive = False

    # -- fault injection --------------------------------------------------------
    def crash(self, node_id: str) -> None:
        """Hard kill: no dereg; TTL reaps it (paper's unplanned-loss case)."""
        node = self.nodes.pop(node_id)
        node.agent.crash()
        node.alive = False

    def partition(self, node_id: str) -> None:
        self.network.partition(node_id)

    def heal(self, node_id: str) -> None:
        self.network.heal(node_id)

    def make_straggler(self, node_id: str, bias_s: float) -> None:
        self.nodes[node_id].step_time_bias = bias_s

    # -- simulation pump ---------------------------------------------------------
    def pump(self, dt: float = 0.0) -> None:
        """Advance time and deliver one heartbeat round (manual mode)."""
        if dt and isinstance(self.clock, ManualClock):
            self.clock.advance(dt)
        for node in list(self.nodes.values()):
            if node.alive:
                try:
                    node.agent.tick()
                except RegistryError:
                    pass  # partitioned: heartbeat lost

    def report_step_times(self, step: int, base_s: float) -> None:
        """Publish per-node step metrics (straggler bias applied)."""
        for node in self.nodes.values():
            if node.alive and node.agent.role == "compute":
                try:
                    node.agent.report_step_time(step,
                                                base_s + node.step_time_bias)
                except RegistryError:
                    pass
