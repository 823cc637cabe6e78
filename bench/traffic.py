"""The one traffic generator of the benchmark.

A mix is a data file, bench/traffic/<name>.json; this module reads its
parameters and draws the requests from --seed. Every seed gets the same
set of sizes (lengths at fixed quantiles of the stated distribution) and
the same set of gaps between arrivals, in an order of its own, so a seed
changes which request is which and the token ids, and not the work. A mix
that gives "order_seed" draws that order from it in place of the run's
seed: every seed then replays one schedule (which request comes when,
with which lengths and which document), and the seed draws the token ids.
A tail over a few tens of requests swings with the order (which cold
documents meet which bursts); such a mix holds the order still.

Arrivals:
  {"kind": "backlog", "requests": n}   n requests due at the window's open
  {"kind": "poisson", "rate_rps": r}   round(r x seconds) requests, the
      gaps Exp(r) quantiles in a seeded order, all due inside the window
Prompts:
  {"kind": "random", median, sigma, min, max}   lognormal lengths, ids
      uniform over the vocabulary
  {"kind": "documents", documents, doc_min, doc_max, zipf_s, shared,
   question: {median, sigma, min, max}}   a document then the request's
      own question; shared: `documents` documents (lengths at uniform
      quantiles, paired with their Zipf rank by a fixed order) picked by
      Zipf(zipf_s) popularity, the counts per rank fixed; not shared:
      every request its own document
Outputs: lognormal lengths {median, sigma, min, max}; no stop token.
Sampling: {"temperature", "top_p", "top_k"}, the same for every request
  (temperature 0: greedy).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np


@dataclass
class Item:
    """One request as the generator draws it (the harness turns it into
    the program's Request)."""
    rid: int
    prompt: np.ndarray  # int32 token ids
    gen_len: int
    offset_s: float  # due this long after the window opens
    temperature: float
    top_p: float
    top_k: int
    sample_seed: int  # int32 root of the request's sampling keys
    doc: int = -1  # document index (-1: none)
    doc_len: int = 0


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """A generator for one stream of one seed; any whole number is a
    seed, negative or past 64 bits."""
    s = int(seed)
    words = [stream, 1 if s < 0 else 0]
    s = abs(s)
    while True:
        words.append(s & 0xFFFFFFFF)
        s >>= 32
        if not s:
            break
    return np.random.default_rng(np.random.SeedSequence(words))


def lognormal_set(n: int, median: float, sigma: float, lo: int,
                  hi: int) -> np.ndarray:
    """n lengths at the (i + 1/2) / n quantiles of a lognormal, clipped
    to [lo, hi]."""
    nd = NormalDist()
    q = [(i + 0.5) / n for i in range(n)]
    x = [median * math.exp(sigma * nd.inv_cdf(p)) for p in q]
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def uniform_set(n: int, lo: int, hi: int) -> np.ndarray:
    return np.rint([lo + (i + 0.5) / n * (hi - lo) for i in range(n)]
                   ).astype(np.int64)


def zipf_counts(n: int, ranks: int, s: float) -> np.ndarray:
    """Requests per popularity rank: n split by Zipf(s) weights, rounded
    by largest remainder (every seed the same counts)."""
    w = np.array([1.0 / (r + 1) ** s for r in range(ranks)])
    exact = n * w / w.sum()
    c = np.floor(exact).astype(np.int64)
    for r in np.argsort(-(exact - c), kind="stable")[:n - int(c.sum())]:
        c[r] += 1
    return c


def count(mix: dict, seconds: float) -> int:
    a = mix["arrivals"]
    if a["kind"] == "backlog":
        return int(a["requests"])
    if a["kind"] == "poisson":
        return max(1, int(round(float(a["rate_rps"]) * seconds)))
    raise ValueError(f"unknown arrivals kind {a['kind']!r}")


def offsets(mix: dict, n: int, seconds: float,
            rng: np.random.Generator) -> np.ndarray:
    a = mix["arrivals"]
    if a["kind"] == "backlog":
        return np.zeros(n)
    rate = float(a["rate_rps"])
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) / rate
                     for i in range(n)])
    gaps = gaps[rng.permutation(n)]
    t = np.cumsum(gaps)
    # the whole set due inside the window: the first at gaps[0], the last
    # one mean gap before the close
    return t * (seconds * n / (n + 1)) / t[-1]


def generate(mix: dict, vocab: int, seed: int, seconds: float) -> List[Item]:
    """The requests of one run of `mix`: deterministic in (mix, vocab,
    seed, seconds)."""
    n = count(mix, seconds)
    key = int(mix.get("order_seed", seed))
    order = rng_of(key, 0)
    toks = rng_of(seed, 1)
    due = offsets(mix, n, seconds, rng_of(key, 2))
    o = mix["output"]
    gen = lognormal_set(n, o["median"], o["sigma"], o["min"], o["max"])
    gen = gen[order.permutation(n)]
    p = mix["prompt"]
    docs: List[np.ndarray] = []
    if p["kind"] == "random":
        plen = lognormal_set(n, p["median"], p["sigma"], p["min"], p["max"])
        plen = plen[order.permutation(n)]
        doc_of = np.full(n, -1)
    elif p["kind"] == "documents":
        qs = p["question"]
        qlen = lognormal_set(n, qs["median"], qs["sigma"], qs["min"],
                             qs["max"])[order.permutation(n)]
        if p["shared"]:
            k = int(p["documents"])
            # rank r's length by a fixed order, so the hot documents'
            # lengths are the same for every seed
            lens = uniform_set(k, p["doc_min"], p["doc_max"])
            lens = lens[np.random.default_rng(0).permutation(k)]
            docs = [toks.integers(0, vocab, size=int(m), dtype=np.int32)
                    for m in lens]
            counts = zipf_counts(n, k, float(p["zipf_s"]))
            doc_of = np.repeat(np.arange(k), counts)[order.permutation(n)]
        else:
            lens = uniform_set(n, p["doc_min"], p["doc_max"])
            lens = lens[order.permutation(n)]
            docs = [toks.integers(0, vocab, size=int(m), dtype=np.int32)
                    for m in lens]
            doc_of = np.arange(n)
        plen = qlen  # the question's length; the document goes before it
    else:
        raise ValueError(f"unknown prompt kind {p['kind']!r}")
    s = mix.get("sampling", {})
    temp = float(s.get("temperature", 0.0))
    items = []
    for rid in range(n):
        own = toks.integers(0, vocab, size=int(plen[rid]), dtype=np.int32)
        d = int(doc_of[rid])
        prompt = own if d < 0 else np.concatenate([docs[d], own])
        greedy = temp <= 0.0
        items.append(Item(
            rid=rid, prompt=prompt, gen_len=int(gen[rid]),
            offset_s=float(due[rid]),
            temperature=0.0 if greedy else temp,
            top_p=1.0 if greedy else float(s.get("top_p", 1.0)),
            top_k=0 if greedy else int(s.get("top_k", 0)),
            sample_seed=int((int(seed) * 1_000_003 + rid) % 2**31),
            doc=d, doc_len=0 if d < 0 else len(docs[d])))
    return items


def warmup(mix: dict, vocab: int, seed: int) -> List[Item]:
    """The set-up's request: a short prompt and a few tokens, sampled as
    the mix samples, so that the window's two step shapes (decode rows
    alone, decode rows with the lane rows) and its sampler have run once."""
    rng = rng_of(seed, 3)
    s = mix.get("sampling", {})
    t = float(s.get("temperature", 0.0))
    size = min(48, int(mix["engine"]["prompt_len"]))
    return [Item(
        rid=-1, prompt=rng.integers(0, vocab, size=size, dtype=np.int32),
        gen_len=4, offset_s=0.0, temperature=t,
        top_p=float(s.get("top_p", 1.0)) if t > 0 else 1.0,
        top_k=int(s.get("top_k", 0)) if t > 0 else 0,
        sample_seed=int(rng.integers(0, 2**31)))]
