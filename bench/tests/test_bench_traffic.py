"""The one traffic generator: deterministic per seed, the same set of
sizes for every seed, lengths in range, Zipf sharing, Poisson gaps."""
import json

import numpy as np
import pytest

from bench import spec, traffic

MIXES = {n: json.loads((spec.BENCH_DIR / "traffic" / f"{n}.json")
                       .read_text())
         for n in ("rollout-batch", "rag-shared")}
SEEDS = [0, 7, 2**31 + 11, -5, 3**40]


def _sig(items):
    return [(i.rid, i.prompt.tobytes(), i.gen_len, i.offset_s,
             i.temperature, i.sample_seed, i.doc) for i in items]


@pytest.mark.parametrize("name", sorted(MIXES))
@pytest.mark.parametrize("seed", SEEDS)
def test_deterministic_per_seed(name, seed):
    a = traffic.generate(MIXES[name], 64000, seed, 25)
    b = traffic.generate(MIXES[name], 64000, seed, 25)
    assert _sig(a) == _sig(b)
    c = traffic.generate(MIXES[name], 64000, seed + 1, 25)
    assert _sig(a) != _sig(c)


@pytest.mark.parametrize("name", sorted(MIXES))
def test_same_sizes_every_seed(name):
    sets = []
    for seed in SEEDS:
        it = traffic.generate(MIXES[name], 64000, seed, 25)
        # a prompt's own part (a document goes before it, one of a fixed
        # set of document lengths)
        sets.append((sorted(len(i.prompt) - i.doc_len for i in it)
                     + sorted({(i.doc, i.doc_len) for i in it}),
                     sorted(i.gen_len for i in it),
                     sorted(np.diff([0.0] + [i.offset_s for i in it]))))
    for s in sets[1:]:
        assert s[0] == sets[0][0] and s[1] == sets[0][1]
        assert np.allclose(s[2], sets[0][2])


def test_rollout_lengths_and_backlog():
    m = MIXES["rollout-batch"]
    it = traffic.generate(m, 64000, 3, 25)
    assert len(it) == m["arrivals"]["requests"]
    assert all(i.offset_s == 0.0 for i in it)
    p, o = m["prompt"], m["output"]
    assert all(p["min"] <= len(i.prompt) <= p["max"] for i in it)
    assert all(o["min"] <= i.gen_len <= o["max"] for i in it)
    assert np.median([len(i.prompt) for i in it]) == pytest.approx(
        p["median"], rel=0.02)
    assert np.median([i.gen_len for i in it]) == pytest.approx(
        o["median"], rel=0.02)
    assert all(0 <= int(i.prompt.min()) and int(i.prompt.max()) < 64000
               for i in it)
    # every request samples, at the mix's temperature and top-p
    assert all(i.temperature == m["sampling"]["temperature"] > 0
               and i.top_p == m["sampling"]["top_p"] for i in it)


def test_rag_documents_zipf_and_poisson():
    m = MIXES["rag-shared"]
    rate, secs = m["arrivals"]["rate_rps"], 25
    it = traffic.generate(m, 151936, 9, secs)
    assert len(it) == round(rate * secs)
    t = [i.offset_s for i in it]
    assert t == sorted(t) and 0 < t[0] and t[-1] < secs
    gaps = np.diff([0.0] + t)
    # exponential gaps: mean 1 / rate (rescaled into the window), the
    # quartiles of Exp at their places
    assert gaps.mean() == pytest.approx(secs / (len(it) + 1) * len(it)
                                        / len(it), rel=0.05)
    assert np.median(gaps) / gaps.mean() == pytest.approx(np.log(2),
                                                          rel=0.1)
    p = m["prompt"]
    docs = {}
    for i in it:
        assert p["doc_min"] <= i.doc_len <= p["doc_max"]
        d = i.prompt[:i.doc_len].tobytes()
        assert docs.setdefault(i.doc, d) == d  # a document is one text
        q = len(i.prompt) - i.doc_len
        assert p["question"]["min"] <= q <= p["question"]["max"]
        assert i.temperature == 0.0
    counts = np.bincount([i.doc for i in it], minlength=p["documents"])
    assert list(counts) == list(traffic.zipf_counts(len(it),
                                                    p["documents"], 1.0))
    assert counts[0] == max(counts) and counts[0] > 4 * counts[-1]


def test_zipf_counts_sum_and_order():
    c = traffic.zipf_counts(100, 16, 1.0)
    assert c.sum() == 100 and all(np.diff(c) <= 0)
    assert c[0] == round(100 / sum(1 / r for r in range(1, 17)))


def test_unshared_documents_are_each_requests_own():
    m = json.loads(json.dumps(MIXES["rag-shared"]))
    m["prompt"]["shared"] = False
    it = traffic.generate(m, 1000, 4, 25)
    assert sorted(i.doc for i in it) == list(range(len(it)))


def test_warmup_fits_the_engine():
    for name, m in MIXES.items():
        w = traffic.warmup(m, 1000, 5)
        assert all(len(i.prompt) <= m["engine"]["prompt_len"] for i in w)
        assert any(i.temperature > 0 for i in w) == (
            m["sampling"].get("temperature", 0) > 0)


def _schedule(items):
    return [(i.rid, len(i.prompt), i.gen_len, i.offset_s, i.doc,
             i.doc_len) for i in items]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_order_seed_holds_the_schedule(name):
    m = dict(MIXES[name], order_seed=3)
    a = traffic.generate(m, 64000, SEEDS[1], 25)
    b = traffic.generate(m, 64000, SEEDS[2], 25)
    # one schedule for both seeds; the token ids are the seed's
    assert _schedule(a) == _schedule(b)
    assert [i.prompt.tobytes() for i in a] != [i.prompt.tobytes()
                                               for i in b]
    # without it, the order is the seed's
    m.pop("order_seed")
    c = traffic.generate(m, 64000, SEEDS[1], 25)
    d = traffic.generate(m, 64000, SEEDS[2], 25)
    assert _schedule(c) != _schedule(d)
