"""SamplingParams — the per-request generation contract.

Every Request carries one: temperature / top_k / top_p / seed shape the
token distribution, stop_tokens and max_tokens bound the generation, and
the seed makes sampled output *deterministic and lane-placement-invariant*:
the decode step derives each row's PRNG key as

    random.fold_in(random.PRNGKey(seed), position)

(repro_torch/random.py: threefry2x32, bit-identical to jax.random) where
position is the request-logical token index (0 for the first generated
token), never the batch row — so a request emits bit-identical tokens
whether it decodes alone, inside a busy mixed-depth batch, or after a
preemption restart. temperature=0 (the default) lowers to the existing
fused argmax, which is what keeps the greedy token-exactness baselines
meaningful.

The device-side sampler lives in launch/steps.py (make_sample_fn); the
fused top-k/top-p mask is kernels/sampling (a CUDA kernel on the GPU, the
sort-based plain version on the CPU). This module is the host-side surface: the params
dataclass and the packed per-row metadata layout the engine uploads once
per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Optional, Tuple

# The packed per-row step metadata layout ([META_I_ROWS,T] int32 +
# [META_F_ROWS,T] float32, one upload per decode step) is the device-side
# contract and lives in launch/steps.py (ROW_* constants there).


@dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens.

    temperature <= 0 means greedy argmax (top_k/top_p/seed are ignored on
    that path, so the default params reproduce the pre-v2 engine exactly).
    """
    temperature: float = 0.0
    top_k: int = 0           # keep the k highest logits (<=0: disabled)
    top_p: float = 1.0       # keep the smallest prob mass >= top_p (>=1: off)
    seed: int = 0            # per-request PRNG root (fold_in'd per position)
    stop_tokens: Tuple[int, ...] = ()  # emitting any of these ends the request
    max_tokens: Optional[int] = None   # caps the request's gen_len

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        if not (-2**31 <= self.seed < 2**31):
            # the seed rides the int32 step-metadata row; reject here
            # instead of overflowing mid-serve with requests in flight
            raise ValueError(f"seed must fit int32, got {self.seed}")
        # stop_set is consulted once per emitted token in the serving hot
        # loop — build it once (frozen dataclass, so through __setattr__)
        object.__setattr__(self, "_stop_set", frozenset(self.stop_tokens))

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def derive(self, rid: int) -> "SamplingParams":
        """Per-request copy with a decorrelated seed (trace generators
        apply one SamplingParams to many requests). Wraps into int32 so a
        base seed near the boundary cannot push a derived request past the
        metadata row's dtype."""
        from dataclasses import replace
        return replace(self, seed=(self.seed + rid) % 2**31)

    def derive_turn(self, turn: int) -> "SamplingParams":
        """Follow-up copy for turn `turn` of a multi-turn lineage. The
        multiplicative mix keeps turn lineages disjoint from the additive
        rid derivation: turn t of rid r never collides with rid r+t of
        turn 0, so a rollout's completions stay decorrelated across both
        axes. Deterministic — the lineage's seeds are a pure function of
        (base seed, rid, turn), which is what makes multi-turn rollouts
        bit-reproducible regardless of placement."""
        from dataclasses import replace
        return replace(self, seed=(self.seed * 1_000_003 + turn) % 2**31)

    @property
    def stop_set(self) -> FrozenSet[int]:
        return self._stop_set


GREEDY = SamplingParams()


def effective_gen_len(gen_len: int, params: SamplingParams) -> int:
    """The token budget admission reserves for: the request's declared
    gen_len capped by its sampling contract's max_tokens."""
    if params.max_tokens is None:
        return gen_len
    return min(gen_len, params.max_tokens)
