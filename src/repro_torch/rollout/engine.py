"""RolloutEngine — the serving fleet as a reproducible generation engine
(port of the JAX package's rollout/engine.py).

Post-training needs N sampled completions per prompt ("rollouts"). The
serving plane already batches, pages, routes and autoscales that
traffic, so this module drives it as a generator: a prompt set fans out
as a burst of n_samples requests per prompt, each with a SamplingParams
seed derived from (prompt_id, sample_idx), and the engine's
position-keyed sampling makes every completion a pure function of
(params, prompt, seed). Slot count, replica count, lane placement and
preemptions do not show in the tokens, so rollouts generated on a fleet
are bit-identical to the same prompts on one engine.

Multi-turn rollouts re-enter the queue as follow_up() requests whose
prompts grow by each turn's completion (siblings share the base prompt; a
lineage's turns share ever-longer prefixes: the prefix cache's traffic).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.request import Request
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import run_to_completion


@dataclass
class Rollout:
    """One completion of one prompt at one conversation turn.

    `tokens` is this turn's completion only; `prompt` is the full context
    it was generated from (turn > 0: the lineage's grown prefix). `seed`
    is the derived per-request sampling root: with the prompt and the
    params it determines `tokens`."""
    prompt_id: int
    sample_idx: int
    rid: int
    turn: int
    prompt: np.ndarray
    tokens: Tuple[int, ...]
    seed: int
    reward: float = 0.0


def rollout_signature(rollouts: Sequence[Rollout]
                      ) -> Dict[int, Tuple[int, ...]]:
    """rid -> tokens: two generations match iff their signatures are
    equal."""
    return {r.rid: tuple(r.tokens) for r in rollouts}


class RolloutEngine:
    """Fan a prompt set out over a serving engine as seeded rollouts.

    `engine` is a ServingEngine or a ReplicaSet (serve/router.py). Request
    rids are laid out as

        rid = turn * stride + prompt_id * n_samples + sample_idx,
        stride = n_prompts * n_samples

    so every (prompt, sample, turn) coordinate has one rid whatever the
    completion order; turn-0 seeds derive as sampling.derive(rid), later
    turns through the lineage (SamplingParams.derive_turn via
    Request.follow_up), not the child rid."""

    def __init__(self, engine, *, n_samples: int = 4, gen_len: int = 8,
                 sampling: Optional[SamplingParams] = None,
                 deadline_s: float = math.inf):
        if n_samples < 1:
            raise ValueError(f"n_samples must be >= 1, got {n_samples}")
        self.engine = engine
        self.n_samples = n_samples
        self.gen_len = gen_len
        self.sampling = sampling if sampling is not None else SamplingParams()
        self.deadline_s = deadline_s
        self.last_tokens = 0  # completion tokens of the last generate()

    def requests_for(self, prompts: Sequence[np.ndarray], *,
                     at: float = 0.0) -> List[Request]:
        """The turn-0 burst: n_samples seeded requests per prompt, all
        arriving at `at`; a pure function of (prompts, engine config)."""
        out = []
        for pid, prompt in enumerate(prompts):
            p = np.asarray(prompt, np.int32)
            for k in range(self.n_samples):
                rid = pid * self.n_samples + k
                out.append(Request(rid=rid, prompt=p, gen_len=self.gen_len,
                                   arrival_t=at, deadline_s=self.deadline_s,
                                   sampling=self.sampling.derive(rid)))
        return out

    def generate(self, prompts: Sequence[np.ndarray], *, cluster=None,
                 dt=0.05, turns: int = 1, max_steps: int = 100_000,
                 on_step=None) -> List[Rollout]:
        """Run the prompt set to completion; every rollout, by rid.

        turns > 1: each completed request re-enters the queue as a
        follow_up() whose prompt is the grown context, submitted from the
        serve loop's on_step callback (which runs before the loop checks
        drained(), so a follow-up keeps it going). With `cluster`, the
        phase runs through cluster.serve(): the metrics reach the registry
        and the autoscaler resizes the fleet mid-rollout."""
        if turns < 1:
            raise ValueError(f"turns must be >= 1, got {turns}")
        stride = len(prompts) * self.n_samples
        reqs = self.requests_for(prompts)
        # our own Request references: the engine updates them in place, so
        # completion is visible here even after a drained replica archived
        # its completed list
        pending: Dict[int, Request] = {r.rid: r for r in reqs}
        coords: Dict[int, Tuple[int, int]] = {
            r.rid: (r.rid // self.n_samples, r.rid % self.n_samples)
            for r in reqs}
        rollouts: List[Rollout] = []

        def harvest():
            for rid in [r for r, q in pending.items() if q.done]:
                req = pending.pop(rid)
                pid, k = coords[rid]
                rollouts.append(Rollout(
                    prompt_id=pid, sample_idx=k, rid=rid, turn=req.turn,
                    prompt=req.prompt, tokens=tuple(req.tokens),
                    seed=req.sampling.seed))
                if req.turn + 1 < turns:
                    child = req.follow_up(rid=rid + stride,
                                          gen_len=self.gen_len)
                    coords[child.rid] = (pid, k)
                    pending[child.rid] = child
                    self.engine.submit([child])

        def cb(i, snap, *rest):
            harvest()
            if on_step is not None:
                on_step(i, snap, *rest)

        if cluster is not None:
            cluster.serve(self.engine, reqs, dt=dt, max_steps=max_steps,
                          on_step=cb)
        else:
            run_to_completion(self.engine, reqs, dt=dt, max_steps=max_steps,
                              on_step=cb)
        harvest()  # requests that retired on the final step
        if pending:
            raise RuntimeError(f"undrained rollouts: {sorted(pending)}")
        rollouts.sort(key=lambda r: r.rid)
        self.last_tokens = sum(len(r.tokens) for r in rollouts)
        return rollouts
