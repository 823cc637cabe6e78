"""ServingMetrics — the exporter that closes the serving → autoscaler loop.

Counters and sliding windows over the serving clock, snapshotted into the
flat metric names AutoScaler.read_metrics() aggregates:

    queue_depth       arrived-but-unadmitted requests (summed across nodes)
    tokens_per_s      decode throughput over the trailing window
    latency_p50_ms /  request completion latency percentiles
    latency_p95_ms    (arrival -> last token, trailing window)
    ttft_p95_ms       time to first token percentile
    slot_occupancy    fraction of KV slots in use
    deadline_misses   completed requests that blew their deadline (cumulative)
    preemptions       restart-preemptions issued by the scheduler policy
    prefill_tokens    prompt positions actually computed (cumulative;
                      prefix-cache hits are the gap vs tokens submitted)
    recomputed_tokens prompt positions computed a second time after a
                      restart preemption discarded them (swap keeps it 0)
    accepted_per_step tokens emitted per speculating slot-step (> 1.0 is
                      the speculative win; omitted when not speculating)
    spec_acceptance_rate  accepted / proposed draft tokens (ditto)

plus whatever extra load signals the KVBackend reports (the paged
BlockManager adds kv_block_occupancy — committed blocks, the signal that
actually gates admission — and the prefix-cache pair prefix_hit_rate /
kv_shared_occupancy; the metrics path itself never branches on the cache
kind).

NodeAgent.report_serving(snapshot()) writes each as metrics/<node>/<name> —
the same KV path the straggler policy's step-time metrics use, so serving
load is just another signal the reconcile loop reads.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.request import Request

# The declared key set of the whole metrics plane. Everything published
# into the registry (ServingMetrics.snapshot, KVBackend.metrics,
# ReplicaSet.snapshot, the rollout loop's phase counters) and everything
# the autoscaler aggregates or a policy .get()s must be named here —
# the plane is stringly typed end to end, so a key missing from this set
# is a silent no-op on the reading side (the symptom is an autoscaler
# that stops reacting). replint rule R005 enforces membership statically;
# tests/test_metric_schema.py holds the aggregation and tombstone paths
# to the same set.
METRIC_SCHEMA = frozenset({
    # serving core (ServingMetrics.snapshot)
    "queue_depth", "tokens_per_s", "slot_occupancy", "deadline_misses",
    "preemptions", "prefill_tokens", "recomputed_tokens",
    "accepted_per_step", "spec_acceptance_rate",
    "latency_p50_ms", "latency_p95_ms", "ttft_p95_ms",
    # KV backend load signals (BlockManager/QuantBlockManager.metrics)
    "kv_block_occupancy", "prefix_hit_rate", "kv_shared_occupancy",
    "swapped_blocks", "swap_out_bytes", "swap_in_bytes",
    "kv_quant_divergence",
    # fleet rollup extras (ReplicaSet.snapshot)
    "replicas_live", "replica_warmups",
    # training-plane signals (NodeAgent step reports, rollout/loop.py)
    "step_time", "rollout_tokens", "reward_mean", "pairs_per_round",
    "train_loss",
})


def percentile(values, q: float) -> float:
    vs = list(values)
    if not vs:
        return 0.0
    return float(np.percentile(vs, q))


class ServingMetrics:
    def __init__(self, *, window_s: float = 10.0):
        self.window_s = window_s
        self._tokens: Deque[Tuple[float, int]] = deque()  # (t, n_tokens)
        self._latency: Deque[Tuple[float, float]] = deque()  # (t_done, s)
        self._ttft: Deque[Tuple[float, float]] = deque()
        self.total_tokens = 0
        self.completed = 0
        self.deadline_misses = 0
        self.preemptions = 0
        self.prefill_tokens = 0  # prompt positions actually computed
        # prompt positions computed a SECOND time because a restart
        # preemption discarded them (split out of prefill_tokens so
        # swap-out's savings are measurable: with swap this stays 0)
        self.recomputed_tokens = 0
        # speculative decoding (cumulative; only speculating slot-steps
        # count — a replica running --spec off reports none of them)
        self.spec_steps = 0     # slot-steps that carried >= 1 draft
        self.spec_proposed = 0  # draft tokens submitted to verify rows
        self.spec_accepted = 0  # draft tokens accepted (prefix-matched)
        self.spec_emitted = 0   # tokens emitted by speculating slot-steps

    # -- recording ----------------------------------------------------------
    def record_tokens(self, now: float, n: int) -> None:
        if n > 0:
            self._tokens.append((now, n))
            self.total_tokens += n

    def record_first_token(self, req: Request, now: float) -> None:
        self._ttft.append((now, now - req.arrival_t))

    def record_done(self, req: Request, now: float) -> None:
        self.completed += 1
        self._latency.append((now, now - req.arrival_t))
        if req.missed_deadline:
            self.deadline_misses += 1

    def record_preempt(self, now: float) -> None:
        self.preemptions += 1

    def record_spec(self, proposed: int, accepted: int,
                    emitted: int) -> None:
        """One speculating slot-step: `proposed` drafts rode verify rows,
        `accepted` prefix-matched the target, `emitted` tokens came out
        (accepted + 1 unless a stop token cut the run short)."""
        self.spec_steps += 1
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    def record_prefill_tokens(self, n: int, *, recompute: bool = False) -> None:
        """Prompt positions run through prefill (lane rows or classic
        batch-1) — prefix-cache hits never get here, so this cumulative
        counter is the denominator bench_serve_prefix compares.
        `recompute=True` routes the count to recomputed_tokens instead:
        the positions were already paid for once, and a restart preemption
        threw them away (host swap-out exists to keep this at 0)."""
        if n > 0:
            if recompute:
                self.recomputed_tokens += n
            else:
                self.prefill_tokens += n

    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        for dq in (self._tokens, self._latency, self._ttft):
            while dq and dq[0][0] < horizon:
                dq.popleft()

    def window_samples(self, now: float) -> Tuple[List[float], List[float]]:
        """(latency_s, ttft_s) samples still inside the window. Fleet
        rollups merge these across replicas so the published percentiles
        are true fleet percentiles over every completion, not a
        percentile-of-percentiles."""
        self._trim(now)
        return ([s for _, s in self._latency], [s for _, s in self._ttft])

    # -- snapshot -----------------------------------------------------------
    def snapshot(self, now: float, *, queue_depth: Optional[int],
                 slot_occupancy: float,
                 **backend_metrics: float) -> Dict[str, float]:
        """Latency keys are OMITTED until a request completes (resp. emits a
        first token) inside the window — publishing 0ms for "no data" would
        read as excellent latency and make LatencyPolicy scale down
        mid-flight (its no-data branch keys off the absence).

        queue_depth=None omits the key entirely: a replica inside a
        ReplicaSet holds no arrival queue (the router owns it), and
        publishing 0 per replica would multiply the fleet's summed depth.

        **backend_metrics passes the KVBackend's own load signals through
        verbatim (ServingEngine.snapshot feeds pool.metrics() here)."""
        self._trim(now)
        toks = sum(n for _, n in self._tokens)
        span = self.window_s
        if self._tokens:
            # all in-window tokens at one timestamp (first step, or after an
            # idle gap): fall back to the window span rather than ~0
            span = now - self._tokens[0][0]
            if span <= 0.0:
                span = self.window_s
        out = {
            "tokens_per_s": toks / span if toks else 0.0,
            "slot_occupancy": slot_occupancy,
            "deadline_misses": float(self.deadline_misses),
            "preemptions": float(self.preemptions),
            "prefill_tokens": float(self.prefill_tokens),
            "recomputed_tokens": float(self.recomputed_tokens),
        }
        if queue_depth is not None:
            out["queue_depth"] = float(queue_depth)
        if self.spec_steps:  # omitted entirely when not speculating
            out["accepted_per_step"] = self.spec_emitted / self.spec_steps
            out["spec_acceptance_rate"] = (self.spec_accepted
                                           / max(self.spec_proposed, 1))
        for name, val in backend_metrics.items():
            out[name] = float(val)
        lats = [s for _, s in self._latency]
        ttfts = [s for _, s in self._ttft]
        if lats:
            out["latency_p50_ms"] = percentile(lats, 50.0) * 1e3
            out["latency_p95_ms"] = percentile(lats, 95.0) * 1e3
        if ttfts:
            out["ttft_p95_ms"] = percentile(ttfts, 95.0) * 1e3
        return out
