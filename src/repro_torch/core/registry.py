"""ServiceRegistry — the Consul analogue (paper §III-C).

Implements the subset of Consul semantics the paper relies on, plus the HA
behavior Consul provides and the paper cites:

  * service catalog with register/deregister and TTL health checks
    (a node that stops heartbeating is marked critical and reaped),
  * a versioned KV store (ModifyIndex per key, monotonically increasing
    global index),
  * blocking queries ("watches"): wait until the global index passes a
    given value — this is what consul-template (core/template.py) uses,
  * replicated deployment with leader election and failover
    (ReplicatedRegistry): writes need a quorum ack; a partitioned or killed
    leader triggers election of the next healthy replica.

Everything is clock-injected so tests drive TTL expiry deterministically.

A copy of the JAX package's core/registry.py: the port imports nothing of
that package.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.clock import Clock, RealClock


@dataclass(frozen=True)
class ServiceEntry:
    node_id: str
    service: str
    address: str  # opaque locator; here: "simnet://<node>" + device ids
    meta: Dict[str, str]
    ttl: float
    registered_at: float
    last_heartbeat: float
    create_index: int

    def healthy(self, now: float) -> bool:
        return (now - self.last_heartbeat) <= self.ttl


@dataclass(frozen=True)
class KVEntry:
    value: str
    modify_index: int


class RegistryError(RuntimeError):
    pass


class NotLeader(RegistryError):
    pass


class ServiceRegistry:
    """Single-replica registry (see ReplicatedRegistry for the HA wrapper)."""

    def __init__(self, clock: Optional[Clock] = None, name: str = "consul-0"):
        self.name = name
        self.clock = clock or RealClock()
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._index = 0
        self._services: Dict[Tuple[str, str], ServiceEntry] = {}
        self._kv: Dict[str, KVEntry] = {}
        self.alive = True  # fault injection: a dead replica raises

    # -- internals ----------------------------------------------------------
    def _bump(self) -> int:
        self._index += 1
        self._cond.notify_all()
        return self._index

    def _check_alive(self):
        if not self.alive:
            raise RegistryError(f"{self.name} is down")

    # -- catalog ------------------------------------------------------------
    def register(self, service: str, node_id: str, address: str,
                 ttl: float = 2.0, meta: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            self._check_alive()
            now = self.clock.now()
            idx = self._bump()
            self._services[(service, node_id)] = ServiceEntry(
                node_id=node_id, service=service, address=address,
                meta=dict(meta or {}), ttl=ttl, registered_at=now,
                last_heartbeat=now, create_index=idx)
            return idx

    def deregister(self, service: str, node_id: str) -> int:
        with self._lock:
            self._check_alive()
            if self._services.pop((service, node_id), None) is not None:
                return self._bump()
            return self._index

    def heartbeat(self, service: str, node_id: str) -> bool:
        """TTL check-in. Returns False if the entry is gone (must re-register)."""
        with self._lock:
            self._check_alive()
            e = self._services.get((service, node_id))
            if e is None:
                return False
            self._services[(service, node_id)] = replace(
                e, last_heartbeat=self.clock.now())
            return True

    def sweep(self) -> List[ServiceEntry]:
        """Reap entries whose TTL lapsed (Consul's critical->dereg path).
        Returns the reaped entries; bumps the index if any."""
        with self._lock:
            self._check_alive()
            now = self.clock.now()
            dead = [k for k, e in self._services.items() if not e.healthy(now)]
            reaped = [self._services.pop(k) for k in dead]
            if reaped:
                self._bump()
            return reaped

    def catalog(self, service: str, healthy_only: bool = True
                ) -> List[ServiceEntry]:
        with self._lock:
            self._check_alive()
            now = self.clock.now()
            out = [e for (s, _), e in self._services.items() if s == service
                   and (not healthy_only or e.healthy(now))]
            return sorted(out, key=lambda e: (e.create_index, e.node_id))

    # -- kv -----------------------------------------------------------------
    def kv_put(self, key: str, value: str) -> int:
        with self._lock:
            self._check_alive()
            idx = self._bump()
            self._kv[key] = KVEntry(value, idx)
            return idx

    def kv_get(self, key: str) -> Optional[KVEntry]:
        with self._lock:
            self._check_alive()
            return self._kv.get(key)

    def kv_prefix(self, prefix: str) -> Dict[str, KVEntry]:
        with self._lock:
            self._check_alive()
            return {k: v for k, v in self._kv.items() if k.startswith(prefix)}

    # -- blocking query -----------------------------------------------------
    @property
    def index(self) -> int:
        with self._lock:
            return self._index

    def wait(self, after_index: int, timeout: float = 0.0) -> int:
        """Block until global index > after_index (or timeout). Returns the
        current index. With a ManualClock this only polls once (tests pump
        state explicitly)."""
        with self._cond:
            if self._index > after_index or timeout <= 0:
                return self._index
            self._cond.wait(timeout)
            return self._index

    # -- snapshot (for replica catch-up) -------------------------------------
    def _snapshot(self):
        with self._lock:
            return (self._index, dict(self._services), dict(self._kv))

    def _install(self, snap):
        with self._lock:
            self._index, self._services, self._kv = (
                snap[0], dict(snap[1]), dict(snap[2]))
            self._cond.notify_all()


class ReplicatedRegistry:
    """Quorum-replicated registry with leader failover (Consul server trio).

    Writes go through the leader and are applied synchronously to every
    *reachable* replica; a write needs acks from a majority or it raises.
    `failover()` elects the lowest-indexed healthy replica. A revived
    stale replica catches up from the leader snapshot before serving.
    """

    def __init__(self, n_replicas: int = 3, clock: Optional[Clock] = None):
        assert n_replicas >= 1
        self.clock = clock or RealClock()
        self.replicas = [ServiceRegistry(self.clock, name=f"consul-{i}")
                         for i in range(n_replicas)]
        self._leader_idx = 0
        self._lock = threading.RLock()

    @property
    def leader(self) -> ServiceRegistry:
        with self._lock:
            return self.replicas[self._leader_idx]

    @property
    def quorum(self) -> int:
        return len(self.replicas) // 2 + 1

    def _replicate(self, op: Callable[[ServiceRegistry], object]):
        with self._lock:
            leader = self.replicas[self._leader_idx]
            if not leader.alive:
                raise NotLeader(f"{leader.name} (leader) is down")
            acks = 0
            result = None
            for r in self.replicas:
                try:
                    res = op(r)
                    acks += 1
                    if r is leader:
                        result = res
                except RegistryError:
                    continue
            if acks < self.quorum:
                raise RegistryError(
                    f"no quorum: {acks}/{len(self.replicas)} acks")
            return result

    # mirrored write API
    def register(self, *a, **kw):
        return self._replicate(lambda r: r.register(*a, **kw))

    def deregister(self, *a, **kw):
        return self._replicate(lambda r: r.deregister(*a, **kw))

    def heartbeat(self, *a, **kw):
        return self._replicate(lambda r: r.heartbeat(*a, **kw))

    def sweep(self):
        return self._replicate(lambda r: r.sweep())

    def kv_put(self, *a, **kw):
        return self._replicate(lambda r: r.kv_put(*a, **kw))

    # reads from leader
    def catalog(self, *a, **kw):
        return self.leader.catalog(*a, **kw)

    def kv_get(self, *a, **kw):
        return self.leader.kv_get(*a, **kw)

    def kv_prefix(self, *a, **kw):
        return self.leader.kv_prefix(*a, **kw)

    @property
    def index(self) -> int:
        return self.leader.index

    def wait(self, *a, **kw):
        return self.leader.wait(*a, **kw)

    # -- failover -------------------------------------------------------------
    def kill_leader(self):
        with self._lock:
            self.replicas[self._leader_idx].alive = False

    def failover(self) -> str:
        """Elect the first healthy replica as leader; it must hold the most
        recent state among healthy replicas (synchronous replication makes
        any healthy replica current)."""
        with self._lock:
            healthy = [i for i, r in enumerate(self.replicas) if r.alive]
            if len(healthy) < self.quorum:
                raise RegistryError("cannot elect: no quorum of replicas")
            # choose the healthy replica with the highest index (raft-ish)
            best = max(healthy, key=lambda i: self.replicas[i].index)
            self._leader_idx = best
            return self.replicas[best].name

    def revive(self, i: int):
        with self._lock:
            r = self.replicas[i]
            r.alive = True
            r._install(self.leader._snapshot())
