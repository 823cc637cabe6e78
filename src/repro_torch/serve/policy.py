"""SchedulerPolicy — who admits next, and who gets preempted for whom.

The engine used to hard-code FIFO admission inside _admit_ready; v2 makes
the order a swappable policy, mirroring how cluster sizing is a swappable
autoscaler Policy (core/autoscaler.py) — the same policy-driven-cluster
argument from the source paper applied one level down, to requests.

A policy answers two questions each scheduler iteration:

  select(ready, now)            -> which arrived request admits next
  victim(running, candidate, …) -> which running request (if any) to evict
                                   so `candidate` can admit when the KV
                                   backend is full — the preemption verdict

Preemption here is restart-style: the engine returns the victim's blocks,
clears its progress, and re-queues it at its original arrival time. That
is *safe* because sampling is position-keyed (serve/sampling.py): a
restarted request regenerates bit-identical tokens, greedy or seeded.

FIFOPolicy is the extracted legacy behavior. EDFPolicy admits by
slack-to-deadline (earliest absolute deadline first) and, when
preemptive=True, evicts the running request with the most slack to make
room for one that would otherwise blow its deadline; deadline_misses flow
through ServingMetrics into LatencyPolicy (core/autoscaler.py), which
scales the cluster up on new misses — EDF reorders within a node,
the autoscaler buys capacity when reordering is no longer enough.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence, runtime_checkable

from repro_torch.serve.request import Request


@runtime_checkable
class SchedulerPolicy(Protocol):
    name: str

    def select(self, ready: Sequence[Request], now: float
               ) -> Optional[Request]:
        """Pick the next request to admit from the arrived set (in arrival
        order), or None to admit nothing this iteration."""
        ...

    def victim(self, running: Sequence[Request], candidate: Request,
               now: float) -> Optional[Request]:
        """Preemption verdict: a running request to evict so `candidate`
        can admit, or None to apply queue backpressure instead. Called only
        when the KV backend cannot admit `candidate` as-is; the engine
        enforces at most one preemption per scheduler iteration."""
        ...


@dataclass
class FIFOPolicy:
    """Arrival order, never preempts — the legacy _admit_ready behavior."""
    name: str = "fifo"

    def select(self, ready, now):
        return ready[0] if ready else None

    def victim(self, running, candidate, now):
        return None


@dataclass
class EDFPolicy:
    """Earliest-deadline-first admission.

    Among arrived requests, admit the one whose absolute deadline
    (arrival_t + deadline_s) is soonest; ties fall back to arrival order
    (ready() is arrival-sorted and min() keeps the first minimum, so a
    deadline-free trace degenerates to FIFO exactly).

    preemptive=True enables the restart-preemption verdict (the textbook
    EDF rule, restart-style): a candidate that is *urgent but still
    salvageable* — nonnegative slack, at most `min_slack_s` of it — may
    evict the slackest runner, provided that runner has at least
    `slack_margin` times the candidate's slack (deadline-free runners
    always qualify). A candidate already past its deadline never preempts:
    destroying a runner's progress cannot save a request that is doomed
    anyway.
    """
    name: str = "edf"
    preemptive: bool = False
    min_slack_s: float = math.inf  # only candidates this urgent may preempt
    slack_margin: float = 2.0   # victim must have this x candidate's slack

    def select(self, ready, now):
        if not ready:
            return None
        return min(ready, key=lambda r: r.abs_deadline)

    def victim(self, running, candidate, now):
        if not self.preemptive or not running:
            return None
        cand_slack = candidate.abs_deadline - now
        if cand_slack < 0.0 or cand_slack > self.min_slack_s:
            return None  # doomed, or not urgent enough to justify a restart
        slackest = max(running, key=lambda r: r.abs_deadline)
        vic_slack = slackest.abs_deadline - now
        if vic_slack <= cand_slack * self.slack_margin:
            return None  # nobody is meaningfully better off than the candidate
        return slackest


def make_scheduler_policy(name: str, **kwargs) -> SchedulerPolicy:
    """CLI/config-facing registry (launch/serve.py --sched)."""
    if name == "fifo":
        return FIFOPolicy(**kwargs)
    if name == "edf":
        return EDFPolicy(**kwargs)
    raise ValueError(f"unknown scheduler policy {name!r} "
                     "(expected 'fifo' or 'edf')")
