"""Router + ReplicaSet — the multi-replica serving data plane.

Port of the JAX package's serve/router.py. A Router front-end owns the
global RequestQueue and admits each arrived request to one of N
`ReplicaEngine`s (serve/scheduler.py), each with its *own* KVBackend —
own block pool, own prefix cache — stepped round-robin on the shared sim
clock (every live replica takes one fused decode step per tick: N
replicas decode N batches in the simulated time of one). Every replica
reads the one set of parameter tensors on the device; a spawn allocates a
KV pool and never copies weights.

WHERE a request lands is a pluggable `RoutingPolicy`, orthogonal to the
`SchedulerPolicy` that decides WHICH arrived request admits next:

  LeastOccupancyRouting  route to the replica with the least committed KV
                         (kv_block_occupancy), in-flight count breaking
                         ties — the classic load-balancer, blind to cache
                         state.
  PrefixAffineRouting    probe every replica's prefix cache with the
                         prompt's blake2b hash chain (serve/blocks.py) and
                         route to the longest cached prefix; fall back to
                         least-occupancy on a universal miss.

Scaling is a real lifecycle, not a number: `reconcile(n)` follows the
autoscaler's applied ScalePlans (VirtualCluster.serve calls it with the
live compute-node count each tick). Scale-up first un-drains any replica
still draining (its cache is warm), then instantiates fresh replicas
(cold cache, counted in `replica_warmups`). Scale-down puts replicas in
**drain** mode: no new admissions; running requests either finish
(drain_mode "finish") or are restart-preempted back to the router queue
(drain_mode "preempt" — safe because sampling is position-keyed); once
idle, the replica's pool is released with leak checking and its metric
keys are tombstoned out of the registry.

Fleet metrics: each replica keeps its own ServingMetrics; `snapshot()`
rolls them up (sums for throughput/counters, means for occupancies, true
fleet percentiles over the union of the replicas' latency windows) and
`metric_sources()` exposes the per-replica snapshots plus a "router"
source (queue depth, live count, warmups) for per-source registry
publication.

With swap=True the fleet shares ONE host swap pool: a request
swap-preempted off a draining replica (drain_mode "preempt") resumes on
whichever replica the router re-routes it to, with nothing recomputed;
swapped victims get a standing resume reservation on one live replica
before fresh requests may claim the capacity. The rollup sums the swap
counters and computes speculative acceptance from summed counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

from repro_torch.core.clock import Clock, ManualClock
from repro_torch.serve.blocks import HostSwapPool
from repro_torch.serve.metrics import percentile
from repro_torch.serve.policy import FIFOPolicy, SchedulerPolicy
from repro_torch.serve.request import Request, RequestQueue
from repro_torch.serve.scheduler import (ReplicaEngine, ServingEngine,
                                         validate_requests)


@runtime_checkable
class RoutingPolicy(Protocol):
    name: str

    def route(self, replicas: Sequence[ReplicaEngine], req: Request,
              now: float) -> Optional[ReplicaEngine]:
        """Pick the replica `req` admits to, or None for fleet-wide
        backpressure. Only replicas that can accept the request right now
        may be returned (candidates are pre-checked via can_accept, which
        is admission-accurate because admissions commit immediately)."""
        ...


def _least_loaded(cands: Sequence[ReplicaEngine]) -> ReplicaEngine:
    """Deterministic least-occupancy pick: committed-KV, then in-flight
    count, then fleet position (stable under equal load)."""
    return min(enumerate(cands), key=lambda t: (t[1].load_score(), t[0]))[1]


@dataclass
class LeastOccupancyRouting:
    """Route by committed KV / queue depth — cache-blind load balancing."""
    name: str = "occupancy"

    def route(self, replicas, req, now):
        cands = [r for r in replicas if r.can_accept(req)]
        return _least_loaded(cands) if cands else None


@dataclass
class PrefixAffineRouting:
    """Route to the replica whose prefix cache already holds the longest
    prefix of the prompt (the blake2b chain probe is read-only); fall back
    to least-occupancy when nobody has it. Ties keep the earliest replica
    so a template stays pinned to one cache instead of smearing across
    the fleet."""
    name: str = "prefix"

    def route(self, replicas, req, now):
        cands = [r for r in replicas if r.can_accept(req)]
        if not cands:
            return None
        best, best_len = None, 0
        for r in cands:
            cached = r.pool.probe_prefix(r.prompt_arg(req))
            if cached > best_len:
                best, best_len = r, cached
        return best if best is not None else _least_loaded(cands)


def make_routing_policy(name: str, **kwargs) -> RoutingPolicy:
    """CLI/config-facing registry (launch/serve.py --routing)."""
    if name == "occupancy":
        return LeastOccupancyRouting(**kwargs)
    if name == "prefix":
        return PrefixAffineRouting(**kwargs)
    raise ValueError(f"unknown routing policy {name!r} "
                     "(expected 'occupancy' or 'prefix')")


@dataclass
class _RetiredCounters:
    """Cumulative counters of released replicas — fleet totals must stay
    monotonic across drains (LatencyPolicy's miss-delta logic depends on
    deadline_misses never rewinding)."""
    deadline_misses: float = 0.0
    preemptions: float = 0.0
    prefill_tokens: float = 0.0
    recomputed_tokens: float = 0.0
    completed: int = 0
    prefix_hit_tokens: int = 0
    prefix_lookup_tokens: int = 0
    decode_steps: int = 0
    swapped_blocks: float = 0.0
    swap_out_bytes: float = 0.0
    swap_in_bytes: float = 0.0
    spec_steps: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    spec_emitted: int = 0

    def absorb(self, replica) -> None:
        m = replica.metrics
        pm = replica.pool.metrics()  # absorb runs before release()
        self.swapped_blocks += pm.get("swapped_blocks", 0.0)
        self.swap_out_bytes += pm.get("swap_out_bytes", 0.0)
        self.swap_in_bytes += pm.get("swap_in_bytes", 0.0)
        self.spec_steps += m.spec_steps
        self.spec_proposed += m.spec_proposed
        self.spec_accepted += m.spec_accepted
        self.spec_emitted += m.spec_emitted
        self.deadline_misses += m.deadline_misses
        self.preemptions += m.preemptions
        self.prefill_tokens += m.prefill_tokens
        self.recomputed_tokens += m.recomputed_tokens
        self.completed += m.completed
        self.prefix_hit_tokens += replica.pool.prefix_hit_tokens
        self.prefix_lookup_tokens += replica.pool.prefix_lookup_tokens
        self.decode_steps += replica.decode_steps


class ReplicaSet:
    """The Router + N ReplicaEngines, drivable anywhere a ServingEngine is
    (submit / step / drained / results / snapshot share the surface):
    run_to_completion loops it standalone; VirtualCluster.serve drives it
    with autoscaling and calls reconcile() so the fleet follows the
    cluster's compute-node count."""

    def __init__(self, cfg, params, *, replicas: int = 2,
                 routing="occupancy",
                 policy: Optional[SchedulerPolicy] = None,
                 drain_mode: str = "finish",
                 clock: Optional[Clock] = None,
                 metrics_window_s: float = 10.0,
                 **replica_kw):
        """`replica_kw` is forwarded to every ReplicaEngine (num_slots,
        prompt_len, max_gen, kv, block_size, kv_blocks, prefix_cache,
        max_shared_fraction, prefill_chunk, spec, spec_k, swap,
        swap_budget_blocks, plan, mesh, device) — each replica builds its
        own drafter, but swap=True builds ONE HostSwapPool shared
        fleet-wide — and kv_blocks is PER REPLICA: a fleet at an equal
        total KV budget to a single engine passes total/N here. With
        mesh= (a DeviceMesh) every replica runs over that mesh, per rank
        (serve/scheduler.py), cut from the whole params given here; every
        rank of the mesh builds the same fleet and routes alike, and the
        shared HostSwapPool is the rank's (each rank swaps its own share
        of a victim, so a request drained off one replica resumes on
        another on every rank alike)."""
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if drain_mode not in ("finish", "preempt"):
            raise ValueError(f"unknown drain_mode {drain_mode!r} "
                             "(expected 'finish' or 'preempt')")
        self.cfg = cfg
        self.params = params
        self.clock = clock or ManualClock()
        self.queue = RequestQueue()
        self.policy: SchedulerPolicy = policy or FIFOPolicy()
        self.routing: RoutingPolicy = (make_routing_policy(routing)
                                       if isinstance(routing, str)
                                       else routing)
        self.drain_mode = drain_mode
        self._replica_kw = dict(replica_kw)
        if self._replica_kw.get("swap") and \
                self._replica_kw.get("swap_pool") is None:
            # ONE host pool for the whole fleet (host RAM is node-local): a
            # request swap-preempted off a draining replica must be
            # restorable by whichever replica the router re-routes it to
            self._replica_kw["swap_pool"] = HostSwapPool(
                self._replica_kw.get("swap_budget_blocks"))
        self._window_s = metrics_window_s
        self._next_id = 0
        self.replicas: List[ReplicaEngine] = []
        self.released: List[str] = []  # names, in release order
        self._retired = _RetiredCounters()
        self._retired_sources: List[str] = []  # pending tombstones
        self._results: Dict[int, List[int]] = {}  # archived at release
        self.replica_warmups = 0  # cold spawns after construction
        for _ in range(replicas):
            self._spawn()
        first = self.replicas[0]
        self.prompt_len = first.prompt_len
        self.max_gen = first.max_gen
        self.prefill_chunk = first.prefill_chunk
        self.kv = first.kv

    # -- lifecycle -----------------------------------------------------------
    def _spawn(self) -> ReplicaEngine:
        r = ReplicaEngine(self.cfg, self.params,
                          name=f"replica-{self._next_id}",
                          clock=self.clock,
                          metrics_window_s=self._window_s,
                          **self._replica_kw)
        self._next_id += 1
        self.replicas.append(r)
        return r

    def live_replicas(self) -> List[ReplicaEngine]:
        return [r for r in self.replicas if not r.draining]

    def reconcile(self, n: int) -> None:
        """Make the fleet track `n` live replicas — the autoscaler's
        applied ScalePlan becomes real lifecycle events. Scale-up:
        un-drain still-draining replicas first (warm cache — the cheapest
        capacity), then spawn cold ones (counted in replica_warmups).
        Scale-down: put the newest live replicas in drain mode (no new
        admissions; drain_mode='preempt' restart-preempts their in-flight
        requests straight back to the router queue). Released pools are
        reaped in step()."""
        n = max(int(n), 1)  # a serving fleet never reaches zero
        live = self.live_replicas()
        if n > len(live):
            for r in self.replicas:
                if len(live) >= n:
                    break
                if r.draining:
                    r.cancel_drain()
                    live.append(r)
            while len(live) < n:
                live.append(self._spawn())
                self.replica_warmups += 1
        elif n < len(live):
            for r in live[n:]:
                for req in r.start_drain(
                        preempt=self.drain_mode == "preempt"):
                    self.queue.push(req)

    def _reap_drained(self) -> None:
        """Release draining replicas that have gone idle: archive their
        results and counters, leak-check + drop their pool, and queue
        their metric keys for tombstoning."""
        for r in [r for r in self.replicas if r.draining and not r.busy]:
            for req in r.completed:
                self._results[req.rid] = list(req.tokens)
            self._retired.absorb(r)
            r.release()
            self.replicas.remove(r)
            self.released.append(r.name)
            self._retired_sources.append(r.name)

    def pop_retired_sources(self) -> List[str]:
        """Names of replicas released since the last call — the cluster
        loop tombstones their registry keys immediately (a departed
        source must not keep skewing fleet aggregates)."""
        out, self._retired_sources = self._retired_sources, []
        return out

    # -- state ---------------------------------------------------------------
    @property
    def busy(self) -> bool:
        return any(r.busy for r in self.replicas)

    def pending(self) -> int:
        return len(self.queue)

    def drained(self) -> bool:
        return not self.busy and not self.pending()

    def set_params(self, params) -> None:
        """Swap the serving weights on every replica, and the weights that
        replicas spawned later start from (a post-training loop publishing
        its updated policy). The fleet must be idle: a replica holding
        requests refuses (ReplicaEngine.set_params)."""
        for r in self.replicas:
            r.set_params(params)
        self.params = params

    def submit(self, requests: Sequence[Request]) -> None:
        validate_requests(requests, self.prompt_len, self.max_gen,
                          allow_shorter=self.prefill_chunk > 0)
        for r in requests:
            self.queue.push(r)

    # -- scheduler iteration ---------------------------------------------------
    def step(self) -> Dict[str, float]:
        """One fleet tick: route admissions out of the global queue, step
        every replica's fused decode batch (all within this tick — the
        data-parallel speedup is real, not a dt rescale), reap drained
        replicas, return the fleet snapshot."""
        now = self.clock.now()
        self._admit_ready(now)
        for r in self.replicas:
            r.step_decode(now)
        self._reap_drained()
        return self.snapshot()

    def _admit_ready(self, now: float) -> None:
        """The router admission loop: SchedulerPolicy picks WHO admits
        next, RoutingPolicy picks WHERE. When nobody can take the pick,
        the policy may issue one fleet-wide preemption verdict per tick
        (the victim's replica must actually free enough — same rules as
        the single-engine loop); otherwise the queue holds backpressure."""
        # swap-aware admission, fleet edition: every arrived swapped-out
        # victim gets a standing resume reservation on ONE replica (least
        # loaded first; the shared HostSwapPool arbitrates ownership)
        # before fresh requests can claim the capacity. A draining owner
        # cancels its plans, so the records re-plan onto a live peer
        arrived = self.queue.ready(now)
        if any(r.pool.has_swapped(q.rid)
               for q in arrived for r in self.replicas):
            by_load = sorted(self.live_replicas(),
                             key=lambda r: r.load_score())
            for q in arrived:
                for rep in by_load:
                    if rep.pool.has_swapped(q.rid) \
                            and rep.pool.plan_resume(q.rid):
                        break
        preempted = False
        ready = None
        while True:
            live = [r for r in self.live_replicas() if r.admission_room()]
            if not live:
                return
            if self.queue.peek_ready(now) is None:
                return  # O(1) hot-path exit: nothing has arrived
            if ready is None:
                ready = self.queue.ready(now)
            req = self.policy.select(ready, now)
            if req is None:
                return
            target = self.routing.route(live, req, now)
            if target is None:
                # resume-first: the pick may be blocked by a victim's
                # standing reservation; resuming the victim (pre-reserved,
                # it needs only a slot) makes progress where returning
                # would deadlock the admission loop
                resumed = False
                for q in ready:
                    if q is req or not any(r.pool.has_swapped(q.rid)
                                           for r in live):
                        continue
                    rep = next((r for r in live if r.can_accept(q)), None)
                    if rep is not None:
                        self.queue.remove(q)
                        ready.remove(q)
                        rep.admit(q, now)
                        resumed = True
                        break
                if resumed:
                    continue
                if preempted:
                    return
                target, victim, vslot = self._preemption_target(live, req,
                                                                now)
                if target is None:
                    return  # fleet-wide exhaustion -> queue backpressure
                self.queue.push(target.preempt(victim, vslot, now))
                preempted = True
                ready = None  # the victim re-joined the arrived set
                if not target.can_accept(req):
                    return  # preempt_frees promised room; belt and braces
            self.queue.remove(req)
            if ready is not None:
                ready.remove(req)
            target.admit(req, now)

    def _preemption_target(self, live, req: Request, now: float):
        """Ask the SchedulerPolicy for a victim among every live
        replica's running set; map the verdict back to its replica and
        vet it exactly like the single-engine loop (stale verdicts, open
        lanes, and evictions that cannot make room are all 'no')."""
        running = [r for rep in live for r in rep.running()]
        victim = self.policy.victim(running, req, now)
        if victim is None:
            return None, None, None
        for rep in live:
            vslot = rep.slot_of(victim)
            if vslot is None:
                continue
            if rep.lane_open(vslot):
                return None, None, None
            if not rep.pool.preempt_frees(vslot, req.eff_gen_len,
                                          prompt=rep.prompt_arg(req)):
                return None, None, None
            return rep, victim, vslot
        return None, None, None  # stale verdict: the victim already retired

    # -- reporting -------------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Fleet rollup: throughput and cumulative counters sum (released
        replicas' counters stay absorbed so totals never rewind),
        occupancies average over live pools, and the latency percentiles
        are computed over the UNION of the replicas' sample windows —
        true fleet percentiles, not a max of maxes."""
        now = self.clock.now()
        snaps = [r.snapshot(queue_depth=None) for r in self.replicas]
        out: Dict[str, float] = {
            "queue_depth": float(self.queue.depth(now)),
            "replicas_live": float(len(self.live_replicas())),
            "replica_warmups": float(self.replica_warmups),
            "tokens_per_s": sum(s["tokens_per_s"] for s in snaps),
        }
        for name in ("slot_occupancy", "kv_block_occupancy",
                     "kv_shared_occupancy", "kv_quant_divergence"):
            # fractions OF each pool: a plain mean is exact while pools
            # are homogeneous (one replica_kw builds them all)
            vals = [s[name] for s in snaps if name in s]
            if vals:
                out[name] = sum(vals) / len(vals)
        # the fleet hit rate is computed from summed token COUNTS, not a
        # mean of per-replica ratios (idle replicas reporting 0.0 would
        # drag the mean down in proportion to how well routing works)
        hits = self._retired.prefix_hit_tokens
        lookups = self._retired.prefix_lookup_tokens
        for r in self.replicas:
            hits += r.pool.prefix_hit_tokens
            lookups += r.pool.prefix_lookup_tokens
        if any("prefix_hit_rate" in s for s in snaps) or lookups:
            out["prefix_hit_rate"] = hits / max(lookups, 1)
        for name in ("deadline_misses", "preemptions", "prefill_tokens",
                     "recomputed_tokens"):
            out[name] = (sum(s.get(name, 0.0) for s in snaps)
                         + getattr(self._retired, name))
        # swap traffic (per-backend cumulative counters, summable over a
        # shared host pool); published only where a swap tier exists
        for name in ("swapped_blocks", "swap_out_bytes", "swap_in_bytes"):
            if any(name in s for s in snaps) or getattr(self._retired,
                                                        name):
                out[name] = (sum(s.get(name, 0.0) for s in snaps)
                             + getattr(self._retired, name))
        # speculative acceptance from summed COUNTS, as the hit rate
        rt = self._retired
        steps = rt.spec_steps + sum(r.metrics.spec_steps
                                    for r in self.replicas)
        if steps:
            total = lambda n: getattr(rt, n) + sum(
                getattr(r.metrics, n) for r in self.replicas)
            out["accepted_per_step"] = total("spec_emitted") / steps
            out["spec_acceptance_rate"] = (total("spec_accepted")
                                           / max(total("spec_proposed"), 1))
        lats: List[float] = []
        ttfts: List[float] = []
        for r in self.replicas:
            ls, ts = r.metrics.window_samples(now)
            lats += ls
            ttfts += ts
        if lats:
            out["latency_p50_ms"] = percentile(lats, 50.0) * 1e3
            out["latency_p95_ms"] = percentile(lats, 95.0) * 1e3
        if ttfts:
            out["ttft_p95_ms"] = percentile(ttfts, 95.0) * 1e3
        return out

    def metric_sources(self) -> Dict[str, Dict[str, float]]:
        """Per-source registry publication: one snapshot per replica
        (namespaced under its name) plus the router's own signals. The
        autoscaler aggregates across sources the same way it aggregates
        across nodes — per-replica occupancy averages, worst-replica
        latency, summed throughput."""
        now = self.clock.now()
        out = {"router": {
            "queue_depth": float(self.queue.depth(now)),
            "replicas_live": float(len(self.live_replicas())),
            "replica_warmups": float(self.replica_warmups),
        }}
        for r in self.replicas:
            out[r.name] = r.snapshot(queue_depth=None)
        return out

    def results(self) -> Dict[int, List[int]]:
        """rid -> generated tokens, across live and released replicas."""
        out = dict(self._results)
        for r in self.replicas:
            for req in r.completed:
                out[req.rid] = list(req.tokens)
        return out

    @property
    def decode_steps(self) -> int:
        """Fused decode steps run by every replica, released ones included
        (one forward each: the fleet's cost on the host)."""
        return (self._retired.decode_steps
                + sum(r.decode_steps for r in self.replicas))

    @property
    def completed_count(self) -> int:
        return (self._retired.completed
                + sum(len(r.completed) for r in self.replicas))

    def describe(self) -> str:
        first = self.replicas[0]
        return (f"{len(self.replicas)} replicas ({first.pool.describe()} "
                f"each), routing={self.routing.name}, "
                f"drain={self.drain_mode}")


def make_serving_engine(cfg, params, *, replicas: int = 1,
                        routing="occupancy", drain_mode: str = "finish",
                        policy=None, clock=None, **replica_kw):
    """One constructor for both data planes: a plain ServingEngine when
    replicas == 1 (the zero-router path), a Router + ReplicaSet beyond.
    replica_kw takes the JAX package's plan= and mesh= too (the engines
    over a mesh, serve/scheduler.py)."""
    if replicas == 1:
        return ServingEngine(cfg, params, policy=policy, clock=clock,
                             **replica_kw)
    return ReplicaSet(cfg, params, replicas=replicas, routing=routing,
                      drain_mode=drain_mode, policy=policy, clock=clock,
                      **replica_kw)
