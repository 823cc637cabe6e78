"""How `correct` is decided: the served tokens against the plain
reference (bench/reference/), once the window has closed and the
program's state is freed.

A sample of the requests the run finished (where fewer finished than the
sample holds, also those still running at the close), drawn from the
seed with the longest among them (and, where the mix shares documents,
one whose document a request before it had already brought into the
cache), is run through the reference once: each prompt with its served tokens,
teacher-forced, in float32. At every served position the reference
scores the vocabulary: greedy rows by their logits; sampled rows by
logits / temperature + the row's Gumbel noise (its seed and position),
over the nucleus. The number compared is the widest gap by which a
served token's score lies below the reference's best. Where a row
samples, rounding may move a token across the nucleus's edge, so the
edge is a band NUCLEUS_SLACK of probability mass wide on either side of
top_p: the reference's best is taken over the tokens inside the band's
inner edge (which any sound sampler keeps), and a served token beyond its
outer edge reads as a gap of INF_GAP (1e30).

The control is the same reference with its products in float8 e4m3 (the
precision below the configuration's bf16), read the same way: at each
position the token the control puts first, its gap in the float32
reference.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.reference import sampler as RS
from bench.reference.model import Reference
from bench.traffic import rng_of

# probability mass the reference's nucleus keeps past top_p: the program's
# bf16 logits shift a token's mass-above by far less than this
NUCLEUS_SLACK = 0.01
INF_GAP = 1e30


def choose(items, reqs, k: int, seed: int) -> List[int]:
    """Indices of the requests to compare, among those the run finished
    (and, where fewer than k finished, those it was still serving): the
    longest (prompt and tokens), one that reused a document already
    brought in by an earlier request (where the mix has documents), the
    rest drawn from the seed."""
    served = [i for i, r in enumerate(reqs)
              if r.t_done is not None and len(r.tokens) > 0]
    if len(served) < k:  # a window that stops at its close: add requests
        # still running, with the tokens they were served
        served += [i for i, r in enumerate(reqs)
                   if r.t_done is None and len(r.tokens) > 0]
    if not served:
        return []
    rng = rng_of(seed, 4)
    longest = max(served, key=lambda i: (len(items[i].prompt)
                                         + len(reqs[i].tokens), -i))
    picked = [longest]
    seen = set()
    reuse = []
    for i in sorted(served, key=lambda i: reqs[i].t_admit):
        d = items[i].doc
        if d >= 0 and d in seen:
            reuse.append(i)
        seen.add(d)
    reuse = [i for i in reuse if i not in picked]
    if reuse:
        picked.append(reuse[int(rng.integers(len(reuse)))])
    rest = [i for i in served if i not in picked]
    order = rng.permutation(len(rest))
    for j in order[:max(k - len(picked), 0)]:
        picked.append(rest[int(j)])
    return picked


def scores(logits: torch.Tensor, item, position: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(score [V], inner [V], outer [V]) of one row: greedy rows their
    logits, every token in both sets; sampled rows logits / T + noise,
    the nucleus band's inner and outer keep-sets."""
    if item.temperature <= 0:
        every = torch.ones_like(logits, dtype=torch.bool)
        return logits, every, every
    g = RS.gumbel(item.sample_seed, position, logits.shape[-1],
                  logits.device)
    s = logits / item.temperature + g
    inner = RS.keep_set(logits, item.temperature, item.top_p, item.top_k,
                        -NUCLEUS_SLACK)
    outer = RS.keep_set(logits, item.temperature, item.top_p, item.top_k,
                        NUCLEUS_SLACK)
    return s, inner, outer


def gap_of(s: torch.Tensor, inner: torch.Tensor, outer: torch.Tensor,
           tok: int) -> float:
    if not bool(outer[tok]):
        return INF_GAP
    best = torch.where(inner, s, torch.full_like(s, -math.inf)).max()
    return max(0.0, float(best - s[tok]))


def first_choice(logits: torch.Tensor, item, position: int) -> int:
    """The token a model with these logits puts first (the control's):
    the argmax, or the sampled draw over its own exact keep-set."""
    if item.temperature <= 0:
        return int(torch.argmax(logits))
    g = RS.gumbel(item.sample_seed, position, logits.shape[-1],
                  logits.device)
    keep = RS.keep_set(logits, item.temperature, item.top_p, item.top_k)
    s = torch.where(keep, logits / item.temperature + g,
                    torch.full_like(logits, -math.inf))
    return int(torch.argmax(s))


def compare(cfg: dict, tree: dict, layer, items, reqs, picked: List[int],
            device, control: bool = False) -> Dict[str, float]:
    """The widest gap over the picked requests' served tokens (and with
    control=True the control's, at the same positions)."""
    ref = Reference(cfg, tree, layer)
    ctl = Reference(cfg, tree, layer, quant=True) if control else None
    out = {"positions": 0, "requests": len(picked), "gap": 0.0}
    if control:
        out["control_gap"] = 0.0
    for i in picked:
        it, rq = items[i], reqs[i]
        toks = list(rq.tokens)
        P = len(it.prompt)
        seq = np.concatenate([np.asarray(it.prompt, np.int64),
                              np.asarray(toks[:-1], np.int64)])
        t = torch.as_tensor(seq, device=device)
        rows = slice(P - 1, P - 1 + len(toks))
        lg = ref.logits(t, rows)
        lc = ctl.logits(t, rows) if control else None
        for j, tok in enumerate(toks):
            s, inner, outer = scores(lg[j], it, j)
            out["gap"] = max(out["gap"], gap_of(s, inner, outer, tok))
            if control:
                out["control_gap"] = max(out["control_gap"], gap_of(
                    s, inner, outer, first_choice(lc[j], it, j)))
        out["positions"] += len(toks)
        del lg, lc
    return out
