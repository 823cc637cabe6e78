"""NodeAgent — the per-container Consul agent (paper §III-C / Fig. 5).

Each (simulated) node runs an agent that registers its HPC service in the
registry, heartbeats its TTL check, publishes metrics (step times for the
straggler policy), and deregisters on graceful drain. A crashed node simply
stops heartbeating and is reaped by TTL expiry — exactly the paper's
auto-deregistration behavior.

A copy of the JAX package's core/agent.py: the port imports nothing of
that package.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.membership import HPC_SERVICE


class NodeAgent:
    def __init__(self, node_id: str, registry, *, n_devices: int = 1,
                 role: str = "compute", ttl: float = 2.0,
                 device_ids: Optional[Sequence[int]] = None,
                 clock: Optional[Clock] = None, image_digest: str = ""):
        self.node_id = node_id
        self.registry = registry
        self.n_devices = n_devices
        self.role = role
        self.ttl = ttl
        self.device_ids = tuple(device_ids or ())
        self.clock = clock or RealClock()
        self.image_digest = image_digest
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # serving metric names last published, per source (this node's own
        # snapshot plus any replica sources it publishes on behalf of)
        self._serving_keys: Dict[str, set] = {}
        self._plain_keys: set = set()  # step_time / queue_depth published

    # -- lifecycle ------------------------------------------------------------
    @property
    def address(self) -> str:
        devs = ",".join(map(str, self.device_ids))
        return f"simnet://{self.node_id}?devices={devs}"

    def start(self) -> None:
        meta = {"n_devices": str(self.n_devices), "role": self.role,
                "image": self.image_digest,
                "devices": ",".join(map(str, self.device_ids))}
        self.registry.register(HPC_SERVICE, self.node_id, self.address,
                               ttl=self.ttl, meta=meta)
        self._running = True

    def tick(self) -> bool:
        """One heartbeat (manual-clock mode). Returns registration liveness."""
        if not self._running:
            return False
        return self.registry.heartbeat(HPC_SERVICE, self.node_id)

    def drain(self) -> None:
        """Graceful leave (scale-down path). Tombstones every metric key
        this agent ever published — its own step_time/queue_depth and all
        serving sources — *immediately*: registry KV entries have no TTL,
        so without this a departed node's last readings linger forever and
        keep skewing the fleet aggregates (the straggler policy's median,
        the summed queue depth) long after the node left the catalog.

        A crash() cannot clean up after itself, and a node partitioned
        mid-drain loses its tombstone writes — for those cases every
        report_serving stamps a __ts liveness key and
        AutoScaler.read_metrics (metrics_ttl_s) skips sources whose stamp
        went stale, so a ghost's last serving snapshot ages out of the
        fleet aggregates instead of lingering. Plain step_time /
        queue_depth keys still rely on the drain tombstones (their
        publishers die with the node the catalog TTL-reaps)."""
        self._running = False
        self._stop_evt.set()
        try:
            for src in list(self._serving_keys):
                self.retire_source(src)
            for name in sorted(self._plain_keys):
                self.registry.kv_put(f"metrics/{self.node_id}/{name}", "")
            self._plain_keys = set()
        except Exception:
            pass  # partitioned mid-drain: keys linger (see docstring)
        try:
            self.registry.deregister(HPC_SERVICE, self.node_id)
        except Exception:
            pass

    def crash(self) -> None:
        """Fault injection: vanish without deregistering (TTL will reap)."""
        self._running = False
        self._stop_evt.set()

    # -- metrics ----------------------------------------------------------------
    def report_step_time(self, step: int, seconds: float) -> None:
        if not self._running:
            return
        self.registry.kv_put(f"metrics/{self.node_id}/step_time",
                             f"{step}:{seconds:.6f}")
        self._plain_keys.add("step_time")

    def report_queue_depth(self, depth: int) -> None:
        if not self._running:
            return
        self.registry.kv_put(f"metrics/{self.node_id}/queue_depth", str(depth))
        self._plain_keys.add("queue_depth")

    def report_serving(self, metrics: Dict[str, float],
                       source: Optional[str] = None) -> None:
        """Publish a ServingMetrics snapshot (queue depth, tokens/s,
        latency percentiles, slot occupancy) — the signals the serving-aware
        scaling policies consume.

        `source` namespaces the keys (metrics/<source>/<name>) so one
        agent can publish on behalf of several serving replicas (the
        multi-replica head does); it defaults to this node's id. The
        autoscaler aggregates across sources exactly as across nodes.

        Keys the snapshot omits (ServingMetrics' "no data in window"
        contract) are tombstoned with an empty value so stale readings
        can't keep driving the policy after their window lapses —
        AutoScaler.read_metrics skips non-numeric values.

        Every report also stamps metrics/<source>/__ts with the agent's
        clock: the liveness signal AutoScaler.read_metrics (metrics_ttl_s)
        uses to skip sources that stopped reporting without a drain — a
        crashed replica can't tombstone its own keys, so its last snapshot
        would otherwise skew fleet aggregates forever."""
        if not self._running:
            return
        src = source or self.node_id
        seen = self._serving_keys.get(src, set())
        for name in sorted(seen - set(metrics) - {"__ts"}):
            self.registry.kv_put(f"metrics/{src}/{name}", "")
        for name, val in metrics.items():
            self.registry.kv_put(f"metrics/{src}/{name}",
                                 f"{float(val):.6f}")
        self.registry.kv_put(f"metrics/{src}/__ts",
                             f"{self.clock.now():.6f}")
        # __ts is tracked so drain()/retire_source tombstone it too
        self._serving_keys[src] = set(metrics) | {"__ts"}

    def retire_source(self, source: str) -> None:
        """A serving source left for good (replica drained + released):
        tombstone ALL its keys *now*. Waiting for the next report_serving
        diff can't work — a departed source never reports again — and
        waiting for a TTL window to lapse leaves its last snapshot
        skewing every fleet aggregate in the meantime."""
        for name in self._serving_keys.pop(source, ()):  # idempotent
            self.registry.kv_put(f"metrics/{source}/{name}", "")

    # -- threaded mode (examples/benchmarks; tests use tick()) -------------------
    def run_threaded(self, interval: Optional[float] = None) -> None:
        interval = interval if interval is not None else self.ttl / 3.0

        def loop():
            while not self._stop_evt.wait(interval):
                if not self._running:
                    break
                try:
                    self.tick()
                except Exception:
                    break

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"agent-{self.node_id}")
        self._thread.start()

    def stop(self) -> None:
        self.drain()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
