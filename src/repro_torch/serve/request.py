"""Requests, the arrival queue, and trace generators.

A Request is one generation job: a prompt (chunk-prefill backends accept
any length up to the engine's prompt_len budget; classic one-shot prefill
jits one shape and needs exact-length prompts), a per-request generation
length, an arrival time on the serving clock, an optional latency
deadline, and a SamplingParams contract (serve/sampling.py) that shapes
its token distribution. A retired request can seed the next conversation
turn via follow_up() — the seed-derivation lineage and arrival ordering
survive, which is what makes multi-turn rollouts reproducible. The RequestQueue gates admission on
arrival time so a whole trace can be loaded up front and replayed
deterministically under a ManualClock; a SchedulerPolicy (serve/policy.py)
decides *which* arrived request admits next.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from itertools import takewhile
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.serve.sampling import SamplingParams, effective_gen_len


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [prompt_len] int32
    gen_len: int
    arrival_t: float = 0.0
    deadline_s: float = math.inf  # budget from arrival to completion
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # -- filled in by the engine ------------------------------------------
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    # restart preemptions suffered: a re-admission with restarts > 0 is
    # recomputing prompt positions it already paid for once — the engine
    # books those into recomputed_tokens, not prefill_tokens. A swap-out
    # preemption keeps progress on the host tier and does NOT count.
    restarts: int = 0
    # conversation turn this request represents (0 = the opening prompt;
    # follow_up() children increment it). Part of the seed-derivation
    # lineage: turn t samples with sampling.derive_turn(t)'s seed.
    turn: int = 0

    @property
    def done(self) -> bool:
        return self.t_done is not None

    def follow_up(self, new_tokens: Sequence[int] = (), *, rid: int,
                  gen_len: Optional[int] = None,
                  arrival_t: Optional[float] = None, gap_s: float = 0.0,
                  deadline_s: Optional[float] = None) -> "Request":
        """A retired request's output seeding the next conversation turn.

        The child prompt is this request's full context — prompt, its
        generated tokens, and any `new_tokens` the caller appends (a user
        reply, a tool result) — so every turn of a lineage shares a grown
        prefix the cache dedups. Seed lineage is preserved, not copied:
        the child samples with sampling.derive_turn(turn + 1), a pure
        function of the opening request's params, so multi-turn rollouts
        replay bit-identically. Arrival ordering is preserved too —
        the child arrives at this request's completion time (plus an
        optional think-time gap) unless the caller pins `arrival_t`.
        """
        if not self.done:
            raise ValueError(f"request {self.rid} is still in flight; "
                             f"follow_up needs its completed output")
        prompt = np.concatenate([
            np.asarray(self.prompt, np.int32),
            np.asarray(self.tokens, np.int32),
            np.asarray(list(new_tokens), np.int32),
        ]) if (self.tokens or len(new_tokens)) else np.asarray(
            self.prompt, np.int32)
        at = (self.t_done + gap_s) if arrival_t is None else arrival_t
        return Request(
            rid=rid,
            prompt=prompt,
            gen_len=self.gen_len if gen_len is None else gen_len,
            arrival_t=at,
            deadline_s=self.deadline_s if deadline_s is None else deadline_s,
            sampling=self.sampling.derive_turn(self.turn + 1),
            turn=self.turn + 1,
        )

    @property
    def eff_gen_len(self) -> int:
        """gen_len capped by the sampling contract's max_tokens — what the
        engine admits and reserves for. Derived, never written back:
        submit() must not mutate caller state (re-submitting the same
        Request objects, e.g. the CLI --verify re-serve, must see the
        declared gen_len unchanged)."""
        return effective_gen_len(self.gen_len, self.sampling)

    @property
    def abs_deadline(self) -> float:
        """Completion deadline on the serving clock (EDF sorts by this)."""
        return self.arrival_t + self.deadline_s

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None:
            return None
        return self.t_done - self.arrival_t

    @property
    def missed_deadline(self) -> bool:
        lat = self.latency_s
        return lat is not None and lat > self.deadline_s


class RequestQueue:
    """Arrival-sorted queue with time-gated admission.

    push() keeps the deque sorted by arrival time: the common case (traces
    and re-pushes arriving in order) is an O(1) append; an out-of-order
    online push — a late injector, a preempted request re-queued with its
    original arrival time — inserts at its sorted position (ties keep push
    order), so it can never hide an already-due request behind a future
    one. pop_ready(now)/ready(now) release only requests whose arrival
    time has passed, from the front in O(1).
    """

    def __init__(self, requests: Optional[Sequence[Request]] = None):
        self._pending: Deque[Request] = deque(
            sorted(requests or [], key=lambda r: r.arrival_t))

    def push(self, req: Request) -> None:
        dq = self._pending
        if not dq or req.arrival_t >= dq[-1].arrival_t:
            dq.append(req)
            return
        # out-of-order: scan from the tail (the insertion point is near it
        # for slightly-late arrivals; preempted re-pushes pay O(depth))
        idx = len(dq) - 1
        while idx > 0 and dq[idx - 1].arrival_t > req.arrival_t:
            idx -= 1
        dq.insert(idx, req)

    def ready(self, now: float) -> List[Request]:
        """All arrived-but-unadmitted requests, in arrival order — the
        candidate set a SchedulerPolicy picks from."""
        return list(takewhile(lambda r: r.arrival_t <= now, self._pending))

    def remove(self, req: Request) -> None:
        """Commit an admission the policy selected out of ready()."""
        self._pending.remove(req)

    def peek_ready(self, now: float) -> Optional[Request]:
        """Next admissible request in arrival order without popping it —
        admission control must see gen_len (block reservation) before
        committing."""
        if self._pending and self._pending[0].arrival_t <= now:
            return self._pending[0]
        return None

    def pop_ready(self, now: float) -> Optional[Request]:
        if self._pending and self._pending[0].arrival_t <= now:
            return self._pending.popleft()
        return None

    def depth(self, now: float) -> int:
        """Requests that have arrived but not been admitted."""
        return sum(1 for _ in takewhile(lambda r: r.arrival_t <= now,
                                        self._pending))

    def __len__(self) -> int:  # total pending, arrived or not
        return len(self._pending)


def _poisson_requests(n_requests: int, rate_rps: float, prompt_fn, rng, *,
                      gen_len: int, gen_len_max: Optional[int],
                      deadline_s: float,
                      sampling: Optional[SamplingParams]) -> List[Request]:
    """Shared Poisson-arrival loop: exponential inter-arrivals, per-rid
    decorrelated sampling seeds, uniform gen lengths. `prompt_fn(rid)`
    builds each prompt (it draws from `rng` between the arrival and the
    gen-length draw, so every trace family keeps a stable stream for a
    given seed)."""
    gmax = gen_len if gen_len_max is None else gen_len_max
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate_rps))
        sp = SamplingParams() if sampling is None else sampling.derive(rid)
        out.append(Request(
            rid=rid,
            prompt=prompt_fn(rid),
            gen_len=int(rng.integers(gen_len, gmax + 1)),
            arrival_t=t,
            deadline_s=deadline_s,
            sampling=sp,
        ))
    return out


def poisson_trace(n_requests: int, rate_rps: float, *, prompt_len: int,
                  vocab_size: int, gen_len: int = 16,
                  gen_len_max: Optional[int] = None,
                  deadline_s: float = math.inf,
                  sampling: Optional[SamplingParams] = None,
                  seed: int = 0) -> List[Request]:
    """Poisson arrivals (exponential inter-arrival at `rate_rps`) with random
    prompts and uniform gen lengths in [gen_len, gen_len_max]. Deterministic
    for a given seed. `sampling` applies to every request (per-request PRNG
    seeds are derived as sampling.seed + rid so requests don't correlate)."""
    rng = np.random.default_rng(seed)
    prompt_fn = lambda rid: rng.integers(0, vocab_size, size=(prompt_len,),
                                         dtype=np.int32)
    return _poisson_requests(n_requests, rate_rps, prompt_fn, rng,
                             gen_len=gen_len, gen_len_max=gen_len_max,
                             deadline_s=deadline_s, sampling=sampling)


def sysprompt_trace(n_requests: int, rate_rps: float, *, prompt_len: int,
                    vocab_size: int, prefix_len: int, gen_len: int = 16,
                    gen_len_max: Optional[int] = None, n_prefixes: int = 1,
                    deadline_s: float = math.inf,
                    sampling: Optional[SamplingParams] = None,
                    seed: int = 0) -> List[Request]:
    """Poisson arrivals whose prompts share system-prompt prefixes: each
    prompt is one of `n_prefixes` fixed templates of `prefix_len` tokens
    followed by a random per-request suffix — the multi-tenant traffic
    shape prefix caching dedups. Deterministic for a given seed (the CLI
    --verify path regenerates it for a second engine)."""
    if not 0 < prefix_len < prompt_len:
        raise ValueError(f"prefix_len must be in (0, prompt_len), got "
                         f"{prefix_len} vs prompt_len {prompt_len}")
    rng = np.random.default_rng(seed)
    prefixes = rng.integers(0, vocab_size, size=(n_prefixes, prefix_len),
                            dtype=np.int32)

    def prompt_fn(rid):
        suffix = rng.integers(0, vocab_size, size=(prompt_len - prefix_len,),
                              dtype=np.int32)
        return np.concatenate([prefixes[rid % n_prefixes], suffix])

    return _poisson_requests(n_requests, rate_rps, prompt_fn, rng,
                             gen_len=gen_len, gen_len_max=gen_len_max,
                             deadline_s=deadline_s, sampling=sampling)


def repetitive_trace(n_requests: int, rate_rps: float, *, prompt_len: int,
                     vocab_size: int, gen_len: int = 16,
                     gen_len_max: Optional[int] = None, motif_len: int = 1,
                     deadline_s: float = math.inf,
                     sampling: Optional[SamplingParams] = None,
                     seed: int = 0) -> List[Request]:
    """Poisson arrivals whose prompts are a short random motif tiled to
    `prompt_len` — templated/boilerplate traffic (form letters, log lines,
    code scaffolding) whose continuations are themselves highly repetitive.
    This is the trace family prompt-lookup speculative decoding is built
    for: the generated stream keeps revisiting n-grams already in the
    request's own history, so NgramDrafter proposals land. Deterministic
    for a given seed (the CLI --verify path regenerates it)."""
    if not 0 < motif_len <= prompt_len:
        raise ValueError(f"motif_len must be in (0, prompt_len], got "
                         f"{motif_len} vs prompt_len {prompt_len}")
    rng = np.random.default_rng(seed)

    def prompt_fn(rid):
        motif = rng.integers(0, vocab_size, size=(motif_len,),
                             dtype=np.int32)
        reps = -(-prompt_len // motif_len)  # ceil
        return np.tile(motif, reps)[:prompt_len]

    return _poisson_requests(n_requests, rate_rps, prompt_fn, rng,
                             gen_len=gen_len, gen_len_max=gen_len_max,
                             deadline_s=deadline_s, sampling=sampling)


def burst_trace(n_requests: int, *, prompt_len: int, vocab_size: int,
                gen_len: int = 16, at: float = 0.0,
                deadline_s: float = math.inf,
                sampling: Optional[SamplingParams] = None,
                seed: int = 0) -> List[Request]:
    """All requests arrive at once — the worst-case queue spike the
    autoscaler must absorb."""
    rng = np.random.default_rng(seed)
    sp = lambda rid: (SamplingParams() if sampling is None
                      else sampling.derive(rid))
    return [Request(rid=rid,
                    prompt=rng.integers(0, vocab_size, size=(prompt_len,),
                                        dtype=np.int32),
                    gen_len=gen_len, arrival_t=at, deadline_s=deadline_s,
                    sampling=sp(rid))
            for rid in range(n_requests)]
