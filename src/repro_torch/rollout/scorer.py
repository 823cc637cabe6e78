"""Scorers — per-completion rewards over a batch of rollouts (port of the
JAX package's rollout/scorer.py).

A Scorer maps rollouts to scalar rewards; the preference stage
(rollout/preference.py) sees only the numbers. Three are provided: a
length target, keyword matching over the completion, and the mean
completion log-probability under a reference model (through the same
masked log-prob path as the DPO loss). Scorers are deterministic
functions of the rollout tokens, so rewards re-derive wherever the
rollouts do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch.models.env import Env
from repro_torch.rollout.engine import Rollout
from repro_torch.rollout.preference import completion_logprobs, pack_sequences


@runtime_checkable
class Scorer(Protocol):
    name: str

    def score(self, rollouts: Sequence[Rollout]) -> List[float]:
        """One reward per rollout, same order. Pure in the tokens."""
        ...


@dataclass
class LengthScorer:
    """0 at exactly `target` generated tokens, -1 per token of miss
    (normalised by the target)."""
    target: int
    name: str = "length"

    def score(self, rollouts):
        d = max(self.target, 1)
        return [-abs(len(r.tokens) - self.target) / d for r in rollouts]


@dataclass
class KeywordScorer:
    """The fraction of completion tokens in the keyword set."""
    keywords: Tuple[int, ...]
    name: str = "keyword"

    def score(self, rollouts):
        kw = set(self.keywords)
        return [sum(t in kw for t in r.tokens) / max(len(r.tokens), 1)
                for r in rollouts]


class LogprobScorer:
    """Mean per-token completion log-probability under the reference
    params the caller snapshots (typically the serving params before
    training, the DPO anchor). Runs train mode's forward without
    gradients on the params' device."""
    name = "logprob"

    def __init__(self, cfg, params, *, env: Optional[Env] = None):
        self.cfg = cfg
        self.env = env if env is not None else Env()
        self.params = params

    def score(self, rollouts):
        if not rollouts:
            return []
        toks, mask = pack_sequences(rollouts)
        dev = self.params["final_norm"].device
        with torch.no_grad():
            lp = completion_logprobs(
                self.params, torch.as_tensor(toks, device=dev),
                torch.as_tensor(mask, device=dev), self.cfg, self.env)
        n = np.maximum(mask.sum(axis=-1), 1.0)
        return [float(x) for x in lp.cpu().numpy() / n]


def make_scorer(kind: str, **kw) -> Scorer:
    """The scorer of a kind: "length", "keyword" or "logprob"."""
    if kind == "length":
        return LengthScorer(**kw)
    if kind == "keyword":
        return KeywordScorer(**kw)
    if kind == "logprob":
        return LogprobScorer(**kw)
    raise ValueError(f"unknown scorer {kind!r} "
                     "(expected 'length', 'keyword', or 'logprob')")
