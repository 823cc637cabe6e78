"""AutoScaler — the paper's scaling loop (§III/§IV) plus the policies its
conclusion defers: "power up more machines, deploy new HPC containers, they
register themselves and become part of the computing cluster."

Policies compute a desired compute-node count (or replacement set) from the
current view + metrics; the controller applies plans through a provisioner
(simnet in this repo; a cloud/cluster API in production) under cooldowns and
min/max bounds. Straggler mitigation (deadline on reported step times) is a
replacement policy — the paper's future-work item made concrete.

A copy of the JAX package's core/autoscaler.py: the port imports nothing of
that package.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

from repro_torch.core.clock import Clock, RealClock
from repro_torch.core.membership import ClusterView

# How read_metrics() folds per-source serving metrics into one fleet
# value, keyed by metric name (every name must be in serve/metrics.py's
# METRIC_SCHEMA — replint R005 checks, tests/test_metric_schema.py holds
# the three tables to the schema set):
#   max  — worst-source passthrough: fleet latency is the worst replica's
#          (a single overloaded replica is a scale-up case even when the
#          mean looks healthy); replicas_live/replica_warmups come from
#          the router source only, so max is identity
#   sum  — volume counters: throughput, misses, preemptions, prefill and
#          recompute work, swap traffic, post-training phase volume
#   mean — levels: occupancies, hit/acceptance rates, reward and loss
SERVING_MAX_METRICS = (
    "latency_p50_ms", "latency_p95_ms", "ttft_p95_ms",
    "replicas_live", "replica_warmups")
SERVING_SUM_METRICS = (
    "tokens_per_s", "deadline_misses", "preemptions", "prefill_tokens",
    "recomputed_tokens", "swapped_blocks", "swap_out_bytes",
    "swap_in_bytes", "rollout_tokens", "pairs_per_round")
SERVING_MEAN_METRICS = (
    "slot_occupancy", "kv_block_occupancy", "prefix_hit_rate",
    "kv_shared_occupancy", "kv_quant_divergence", "accepted_per_step",
    "spec_acceptance_rate", "reward_mean", "train_loss")


@dataclass(frozen=True)
class ScalePlan:
    target: int  # desired compute-node count
    replace: Tuple[str, ...] = ()  # node_ids to drain & replace (stragglers)
    reason: str = ""

    def is_noop(self, current: int) -> bool:
        return self.target == current and not self.replace


class Policy(Protocol):
    def decide(self, view: ClusterView, metrics: Dict[str, float]) -> ScalePlan:
        ...


@dataclass
class TargetSizePolicy:
    """Operator-pinned size (the paper's manual 'power up more machines')."""
    target: int

    def decide(self, view, metrics):
        return ScalePlan(self.target, reason=f"target-size={self.target}")


@dataclass
class QueueDepthPolicy:
    """Scale so each node holds ~target_per_node queued work items."""
    target_per_node: int = 4
    min_nodes: int = 1
    max_nodes: int = 64

    def decide(self, view, metrics):
        depth = metrics.get("queue_depth", 0.0)
        want = max(self.min_nodes,
                   min(self.max_nodes,
                       int(-(-depth // self.target_per_node)) or self.min_nodes))
        return ScalePlan(want, reason=f"queue_depth={depth}")


@dataclass
class StepTimePolicy:
    """Scale up while the measured step time exceeds the target (assumes
    near-linear DP scaling; the increment is one node per decision)."""
    target_step_s: float
    min_nodes: int = 1
    max_nodes: int = 64
    headroom: float = 0.85  # scale down if faster than headroom*target

    def decide(self, view, metrics):
        n = len(view.compute)
        st = metrics.get("step_time", None)
        if st is None:
            return ScalePlan(n, reason="no-data")
        if st > self.target_step_s and n < self.max_nodes:
            return ScalePlan(n + 1, reason=f"slow step {st:.3f}s")
        if st < self.headroom * self.target_step_s and n > self.min_nodes:
            return ScalePlan(n - 1, reason=f"fast step {st:.3f}s")
        return ScalePlan(n, reason="in-band")


@dataclass
class LatencyPolicy:
    """Serve-driven scaling: grow while p95 request latency exceeds the
    target OR completed requests are blowing their deadlines; shrink only
    once latency is comfortably inside the target AND the arrival queue is
    empty (draining a backlog at low latency still needs the capacity).

    deadline_misses is the cumulative counter an EDF scheduler feeds back
    through ServingMetrics: EDF reorders admissions within a node, but once
    requests miss anyway the node is simply oversubscribed — each *new*
    miss since the last decision is a scale-up vote that outranks a
    healthy-looking p95 (misses lead completions, p95 trails them).

    kv_shared_occupancy (the paged backend's fraction of blocks currently
    referenced by >= 2 live requests) is a *scale-hold* signal: a replica
    actively deduplicating shared prefixes would make every one of those
    in-flight tenants pay cold prefill again if it were drained — so the
    latency-headroom shrink is held while shared occupancy is at/above
    hold_shared_above. The signal decays to zero as sharing traffic
    drains, so idle clusters still shrink."""
    target_p95_ms: float
    min_nodes: int = 1
    max_nodes: int = 64
    headroom: float = 0.5  # scale down below headroom*target
    scale_on_misses: bool = True
    # hold shrink while >= this fraction of the pool is actively shared.
    # The signal's ceiling is (shared prefix blocks)/(pool size) — a pool
    # sized for many requests holds a handful of shared template blocks —
    # so the threshold must sit well below 1.0 to be reachable (the smoke
    # bench peaks at ~0.13 with one template on a 32-block pool)
    hold_shared_above: float = 0.05
    _seen_misses: float = field(default=0.0, init=False)

    def decide(self, view, metrics):
        n = len(view.compute)
        p95 = metrics.get("latency_p95_ms", None)
        depth = metrics.get("queue_depth", 0.0)
        # paged KV publishes block occupancy (the signal that actually
        # gates admission); fall back to slot occupancy
        occ = max(metrics.get("slot_occupancy", 0.0),
                  metrics.get("kv_block_occupancy", 0.0))
        misses = metrics.get("deadline_misses", 0.0)
        new_misses = misses - self._seen_misses
        self._seen_misses = max(self._seen_misses, misses)
        if (self.scale_on_misses and new_misses > 0 and n < self.max_nodes):
            return ScalePlan(n + 1, reason=f"deadline misses +"
                                           f"{new_misses:.0f} ({misses:.0f}"
                                           " total)")
        if p95 is None:
            # no completions in the metrics window: hold while anything is
            # queued or in flight (mid-burst warmup), shrink once truly idle
            if depth == 0 and occ == 0 and n > self.min_nodes:
                return ScalePlan(n - 1, reason="idle")
            return ScalePlan(n, reason="no-data")
        if p95 > self.target_p95_ms and n < self.max_nodes:
            return ScalePlan(n + 1, reason=f"p95 {p95:.0f}ms > "
                                           f"{self.target_p95_ms:.0f}ms")
        if (p95 < self.headroom * self.target_p95_ms and depth == 0
                and n > self.min_nodes):
            shared = metrics.get("kv_shared_occupancy", 0.0)
            if shared >= self.hold_shared_above:
                return ScalePlan(n, reason=f"prefix cache hot "
                                           f"({shared:.2f} shared)")
            return ScalePlan(n - 1, reason=f"p95 {p95:.0f}ms in headroom")
        return ScalePlan(n, reason="in-band")


@dataclass
class StragglerPolicy:
    """Replace nodes whose reported step time exceeds factor x median."""
    factor: float = 2.0
    min_samples: int = 2

    def decide(self, view, metrics):
        times = {k[len("node_step_time/"):]: v for k, v in metrics.items()
                 if k.startswith("node_step_time/")}
        n = len(view.compute)
        if len(times) < self.min_samples:
            return ScalePlan(n, reason="insufficient samples")
        med = statistics.median(times.values())
        bad = tuple(sorted(nid for nid, t in times.items()
                           if med > 0 and t > self.factor * med))
        return ScalePlan(n, replace=bad,
                         reason=f"median={med:.3f}s stragglers={bad}")


class Provisioner(Protocol):
    def add_nodes(self, n: int) -> List[str]: ...
    def remove_nodes(self, node_ids: List[str]) -> None: ...


@dataclass
class AutoScaler:
    policy: Policy
    provisioner: Provisioner
    cooldown_s: float = 0.0
    min_nodes: int = 1
    max_nodes: int = 256
    # serving-metrics liveness TTL: skip sources whose last report
    # (metrics/<src>/__ts, stamped by NodeAgent.report_serving) is older
    # than this many sim seconds — a crashed replica never tombstones its
    # keys, and without the filter its final snapshot would skew fleet
    # aggregates forever. None disables the filter; sources without a
    # stamp (plain step_time / queue_depth publishers) are always fresh.
    metrics_ttl_s: Optional[float] = None
    clock: Clock = field(default_factory=RealClock)
    _last_action_t: float = field(default=-1e30, init=False)
    history: List[Tuple[float, str]] = field(default_factory=list, init=False)

    def read_metrics(self, registry) -> Dict[str, float]:
        kv = registry.kv_prefix("metrics/")
        stale = set()
        if self.metrics_ttl_s is not None:
            now = self.clock.now()
            for key, entry in kv.items():
                _, node, name = key.split("/", 2)
                if name != "__ts" or not entry.value:
                    continue
                try:
                    ts = float(entry.value)
                except ValueError:
                    continue
                if now - ts > self.metrics_ttl_s:
                    stale.add(node)
        out: Dict[str, float] = {}
        for key, entry in kv.items():
            _, node, name = key.split("/", 2)
            if name == "__ts" or node in stale:
                continue  # liveness stamp itself / source past its TTL
            val = entry.value.split(":")[-1]
            if not val:  # tombstone: metric's window lapsed (report_serving)
                continue
            try:
                out[f"node_{name}/{node}"] = float(val)
            except ValueError:
                continue
        steps = [v for k, v in out.items() if k.startswith("node_step_time/")]
        if steps:
            out["step_time"] = statistics.median(steps)
        depths = [v for k, v in out.items() if k.startswith("node_queue_depth/")]
        if depths:
            out["queue_depth"] = sum(depths)
        # serving metrics (NodeAgent.report_serving snapshots — one source
        # per node, or one per serving *replica* when a ReplicaSet head
        # publishes on the fleet's behalf) fold by the module-level
        # SERVING_* tables above — every published name must appear in
        # exactly one of them, or the fleet value silently never exists
        for names, agg in ((SERVING_MAX_METRICS, max),
                           (SERVING_SUM_METRICS, sum)):
            for name in names:
                vals = [v for k, v in out.items()
                        if k.startswith(f"node_{name}/")]
                if vals:
                    out[name] = agg(vals)
        for name in SERVING_MEAN_METRICS:
            occ = [v for k, v in out.items()
                   if k.startswith(f"node_{name}/")]
            if occ:
                out[name] = sum(occ) / len(occ)
        return out

    def apply_plan(self, view: ClusterView, plan: ScalePlan
                   ) -> Optional[ScalePlan]:
        """Clamp and apply one plan through the provisioner (no cooldown
        check — callers gate). Returns the applied plan, or None if noop.
        This is also the one-shot path for operator actions
        (VirtualCluster.scale_to), which must not disturb the installed
        policy."""
        target = max(self.min_nodes, min(self.max_nodes, plan.target))
        plan = ScalePlan(target, plan.replace, plan.reason)
        current = len(view.compute)
        if plan.is_noop(current):
            return None
        if plan.replace:
            self.provisioner.remove_nodes(list(plan.replace))
            self.provisioner.add_nodes(len(plan.replace))
        if target > current:
            self.provisioner.add_nodes(target - current)
        elif target < current:
            victims = [m.node_id for m in view.compute[target:]]
            self.provisioner.remove_nodes(victims)
        self._last_action_t = self.clock.now()
        self.history.append((self._last_action_t, plan.reason))
        return plan

    def step(self, view: ClusterView, metrics: Dict[str, float]
             ) -> Optional[ScalePlan]:
        """One reconcile iteration. Returns the applied plan (or None)."""
        now = self.clock.now()
        if now - self._last_action_t < self.cooldown_s:
            return None
        return self.apply_plan(view, self.policy.decide(view, metrics))
