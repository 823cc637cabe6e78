"""The port's speculative decoding (serve/spec.py, the verify rows of
serve/scheduler.py) and the QKV bias its draft model needs, on the CPU.

Against the JAX package: the n-gram drafter proposes what JAX's proposes
on the same histories; the draft model proposes what JAX's does over
served histories (catch-ups, slot reuse, re-admission after a retire),
and what JAX's draft model's full forward takes the argmax of, outside
near-ties of its logits; on repetitive traces the port's engine accepts
the tokens per step JAX's does and emits its tokens, with the n-gram
drafter and with the draft model (its weights bridged from JAX's
`Mo.init_params(PRNGKey(0), draft_config(cfg), env)`); the QKV
projection with a bias equals JAX's `_project_qkv` bit for bit.

Inside the port, as tests/test_spec_decode.py, tests/test_spec_quant.py
and the spec-k cases of tests/test_tiered_kv.py hold the JAX package:
speculative serving emits bit for bit what serving with --spec off
emits — greedy and seeded, on the slot, paged and int8 pools, with both
drafters, at spec_k 4, 8 (past one 128-row tile) and auto; an oracle
drafter forces every accept/reject boundary, block boundaries included;
spec composes with the prefix cache; truncate rolls rejected drafts back
(free list, reservations, shared-prefix guard, the int8 pool's scales);
the row-to-slot step equals sequential steps; AdaptiveSpecK converges
both ways; the CLI's spec commands verify.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.models import layers as JL
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import NgramDrafter as JaxNgram
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro.serve.spec import draft_config as jax_draft_config
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch import steps as St
from repro_torch.launch.serve import parse_args, run_trace
from repro_torch.models import layers as L
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.serve import (AdaptiveSpecK, BlockManager, Drafter,
                               ModelDrafter, NgramDrafter, Request,
                               SamplingParams, ServingEngine, SlotPool,
                               draft_config, make_drafter, poisson_trace,
                               run_to_completion)
from repro_torch.serve import request as torch_request

PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
JCFG = jax_smoke("paper-demo")
CFG = get_smoke("paper-demo")
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), JCFG,
                          JEnv(mesh=None, plan=PALLAS))
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
# the draft model JAX's ModelDrafter builds (PRNGKey(0)), bridged
JDRAFT = JMo.init_params(jax.random.PRNGKey(0), jax_draft_config(JCFG),
                         JEnv(mesh=None, plan=PALLAS))
DRAFT = bridge.to_torch(jax.tree.map(np.asarray, JDRAFT), "cpu")
P = 16
BS = 4
SP = dict(temperature=0.9, top_k=40, top_p=0.95, seed=7)
SAMPLED = SamplingParams(**SP)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Smoke engines run thousands of tiny ops a step: torch's intra-op
    thread pool only adds contention under a multi-worker test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _model_drafter(num_slots, max_gen, spec_k):
    return ModelDrafter(CFG, Env(), num_slots=num_slots, prompt_len=P,
                        max_gen=max_gen, spec_k=spec_k, params=DRAFT,
                        device="cpu")


def _engine(spec=None, spec_k=4, num_slots=3, max_gen=8, kv="paged", **kw):
    if spec == "model":  # the bridged draft weights, not the port's seed
        spec = _model_drafter(num_slots, max_gen,
                              4 if spec_k == "auto" else spec_k)
    return ServingEngine(CFG, PARAMS, num_slots=num_slots, prompt_len=P,
                         max_gen=max_gen, kv=kv, block_size=BS, spec=spec,
                         spec_k=spec_k, clock=ManualClock(), device="cpu",
                         **kw)


def _rep_trace(mod=torch_request, n=8, gen_len=6, sampling=None, seed=0,
               motif_len=1):
    """Tiled-motif prompts: the trace family n-gram drafting feeds on."""
    return mod.repetitive_trace(n, 48.0, prompt_len=P,
                                vocab_size=CFG.vocab_size, gen_len=gen_len,
                                motif_len=motif_len, sampling=sampling,
                                seed=seed)


def _mix_trace(n=8, gen_len=6, sampling=None, seed=0):
    """Random prompts, staggered arrivals: mixed-depth busy batches."""
    return poisson_trace(n, 48.0, prompt_len=P, vocab_size=CFG.vocab_size,
                         gen_len=gen_len, sampling=sampling, seed=seed)


def _req(mod, prompt, tokens=()):
    r = mod.Request(rid=0, prompt=np.asarray(prompt, np.int32), gen_len=8,
                    arrival_t=0.0)
    r.tokens = list(tokens)
    return r


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

# (history prompt, generated tokens, k, proposal): JAX's five n-gram
# cases — the continuation of the most recent match; the match that
# supplies all k tokens (a constant run); the longest partial
# continuation; a novel suffix; a motif only the generated tokens repeat
NGRAM = [([1, 2, 3, 4, 1, 2, 3], (), 3, [4, 1, 2]),
         ([7] * 12, (), 4, [7, 7, 7, 7]),
         ([7, 7, 7, 7], (), 4, [7]),
         ([1, 2, 3, 4, 5, 6, 7, 8], (), 4, []),
         ([9, 1, 2, 3], (5, 1, 2, 3), 2, [5, 1])]


@pytest.mark.parametrize("prompt,tokens,k,want", NGRAM,
                         ids=["recent", "full-k", "partial", "novel",
                              "generated"])
def test_ngram_proposals_equal_jax(prompt, tokens, k, want):
    got = NgramDrafter(max_n=3).propose(_req(torch_request, prompt, tokens),
                                        k)
    ref = JaxNgram(max_n=3).propose(_req(jax_request, prompt, tokens), k)
    assert got == ref == want


def test_ngram_proposals_equal_jax_on_served_histories():
    rng = np.random.default_rng(0)
    for _ in range(200):
        motif = rng.integers(0, 6, size=rng.integers(1, 5))
        hist = np.tile(motif, 8)[:rng.integers(2, 24)]
        noise = rng.integers(0, 6, size=hist.shape) * (rng.random(
            hist.shape) < 0.2)
        hist = (hist + noise) % 6
        cut = int(rng.integers(1, len(hist) + 1))
        k = int(rng.integers(1, 9))
        args = (hist[:cut], tuple(int(t) for t in hist[cut:]))
        assert (NgramDrafter().propose(_req(torch_request, *args), k)
                == JaxNgram().propose(_req(jax_request, *args), k))


def test_make_drafter_dispatch_and_draft_config():
    kw = dict(num_slots=2, prompt_len=P, max_gen=8, spec_k=4, device="cpu")
    assert make_drafter(None, CFG, Env(), **kw) is None
    assert make_drafter("off", CFG, Env(), **kw) is None
    d = make_drafter("ngram", CFG, Env(), **kw)
    assert isinstance(d, NgramDrafter) and isinstance(d, Drafter)
    m = make_drafter("model", CFG, Env(), **kw)
    assert isinstance(m, ModelDrafter)
    with pytest.raises(ValueError):
        make_drafter("medusa", CFG, Env(), **kw)
    # the draft config is JAX's, field for field, and so are its shapes
    assert dataclasses.asdict(draft_config(CFG)) == dataclasses.asdict(
        jax_draft_config(JCFG))
    shapes = lambda t: [tuple(x.shape) for x in jax.tree.leaves(t)]
    assert shapes(jax.tree.map(lambda x: np.empty(x.shape), m.params,
                               is_leaf=torch.is_tensor)) == shapes(JDRAFT)


def test_spec_k_must_be_positive():
    with pytest.raises(ValueError, match="spec_k"):
        _engine(spec="ngram", spec_k=0)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_spec_refuses_window_and_recurrent_archs(arch):
    cfg = get_smoke(arch)
    params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
    with pytest.raises(ValueError, match="speculat"):
        ServingEngine(cfg, params, num_slots=2, prompt_len=P, max_gen=8,
                      spec="ngram", clock=ManualClock(), device="cpu")


# ---------------------------------------------------------------------------
# QKV bias
# ---------------------------------------------------------------------------


def test_project_qkv_with_bias_equals_jax():
    """The draft model's biased projection: x @ w rounded to bf16, plus
    the bf16 bias rounded again, as JAX's _project_qkv computes it — held
    bit for bit (tolerance 0) on the same numpy inputs, nonzero biases."""
    dcfg = draft_config(CFG)
    rng = np.random.default_rng(1)
    bf = lambda *shape: jnp.asarray(rng.normal(size=shape),
                                    jnp.float32).astype(jnp.bfloat16)
    hq, hkv, hd, d = dcfg.n_heads, dcfg.n_kv_heads, dcfg.head_dim, \
        dcfg.d_model
    p = {"wq": bf(d, hq * hd) / 7, "wk": bf(d, hkv * hd) / 7,
         "wv": bf(d, hkv * hd) / 7, "bq": bf(hq * hd), "bk": bf(hkv * hd),
         "bv": bf(hkv * hd)}
    x = bf(3, 5, d)
    want = JL._project_qkv(p, x, x, jax_draft_config(JCFG),
                           JEnv(mesh=None, plan=PALLAS))
    tp = bridge.to_torch(jax.tree.map(np.asarray, p), "cpu")
    got = L._project_qkv(tp, bridge.to_torch(np.asarray(x), "cpu"), dcfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.float().numpy(),
                              np.asarray(w.astype(jnp.float32)))
    no_bias = dataclasses.replace(dcfg, qkv_bias=False)
    assert not torch.equal(L._project_qkv(tp, bridge.to_torch(
        np.asarray(x), "cpu"), no_bias)[0], got[0])


def test_draft_model_init_has_zero_biases():
    params = Mo.init_params(draft_config(CFG), Env(), seed=0, device="cpu")
    attn = params["blocks"][0]["attn"]
    assert attn["bq"].shape == (2, 48) and attn["bk"].shape == (2, 16)
    assert all(float(attn[b].abs().max()) == 0.0 for b in ("bq", "bk", "bv"))


# ---------------------------------------------------------------------------
# bit-exactness: spec == spec off
# ---------------------------------------------------------------------------

# (pool, drafter, spec_k): both drafters on every pool at k 4; the n-gram
# drafter at k 8 over 15 slots, where the step's 15 decode rows, 120
# verify rows (and 16 lane rows on the paged pools) pass one 128-row
# tile; and auto
SPEC = [(kv, d, 4) for kv in ("slot", "paged", "quant")
        for d in ("ngram", "model")] + \
    [(kv, "ngram", 8) for kv in ("slot", "paged", "quant")] + \
    [("paged", "ngram", "auto"), ("slot", "model", "auto")]


@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded"])
@pytest.mark.parametrize("kv,spec,k", SPEC,
                         ids=[f"{kv}-{d}-{k}" for kv, d, k in SPEC])
def test_spec_is_bit_identical_to_spec_off(kv, spec, k, sampling):
    slots = 15 if k == 8 else 3
    trace = lambda: _rep_trace(sampling=sampling, gen_len=8, motif_len=2)
    base = run_to_completion(_engine(kv=kv, num_slots=slots), trace(),
                             dt=0.05)
    eng = _engine(kv=kv, num_slots=slots, spec=spec, spec_k=k)
    out = run_to_completion(eng, trace(), dt=0.05)
    assert out == base
    snap = eng.snapshot()
    assert snap["accepted_per_step"] >= 1.0
    if k == 8:  # a second row tile
        assert slots + eng.prefill_chunk + slots * 8 > L.ROW_TILE
    if spec == "ngram" and sampling is None:
        assert snap["accepted_per_step"] > 1.0, "no draft ever landed"


class _OracleDrafter(Drafter):
    """Forces arbitrary accept/reject boundaries: knows the expected
    output and proposes j correct tokens then wrong ones, j drawn per call
    from a seeded RNG, so every boundary 0..k is taken."""

    name = "oracle"

    def __init__(self, expected, vocab):
        self.expected = expected
        self.vocab = vocab
        self.rng = np.random.default_rng(0)

    def propose(self, req, k):
        fut = self.expected[req.rid][len(req.tokens):]
        j = int(self.rng.integers(0, k + 1))
        out = list(fut[:j])
        while len(out) < k:
            nxt = fut[len(out)] if len(out) < len(fut) else 0
            out.append((nxt + 1) % self.vocab)  # guaranteed wrong
        return out


@pytest.mark.parametrize("kv", ["paged", "quant", "slot"])
@pytest.mark.parametrize("sampling", [None, SAMPLED],
                         ids=["greedy", "seeded"])
def test_forced_boundaries_stay_bit_identical(kv, sampling):
    """Block size 4 and k 4: rejected suffixes end inside blocks and on
    their boundaries, so truncate frees whole blocks and keeps partial
    ones, and the next step overwrites the junk."""
    base = run_to_completion(_engine(kv=kv), _mix_trace(sampling=sampling),
                             dt=0.05)
    eng = _engine(kv=kv, spec=_OracleDrafter(base, CFG.vocab_size))
    out = run_to_completion(eng, _mix_trace(sampling=sampling), dt=0.05)
    assert out == base
    snap = eng.snapshot()
    assert snap["accepted_per_step"] > 1.0
    assert 0.0 < snap["spec_acceptance_rate"] < 1.0


def test_spec_composes_with_prefix_cache():
    rng = np.random.default_rng(3)
    pre = rng.integers(0, CFG.vocab_size, (12,), dtype=np.int32)

    def trace():
        return [Request(rid=i, prompt=np.concatenate(
            [pre, np.full((P - 12,), int(pre[i % 12]), np.int32)]),
            gen_len=6, arrival_t=0.05 * i, sampling=SAMPLED.derive(i))
            for i in range(6)]

    base = run_to_completion(_engine(prefix_cache=True), trace(), dt=0.05)
    eng = _engine(prefix_cache=True, spec="ngram")
    assert run_to_completion(eng, trace(), dt=0.05) == base
    assert eng.snapshot()["prefix_hit_rate"] > 0.0


def test_spec_metrics_only_when_speculating():
    eng = _engine(spec="ngram")
    out = run_to_completion(eng, _rep_trace(), dt=0.05)
    snap = eng.snapshot()
    assert snap["accepted_per_step"] >= 1.0
    assert snap["spec_acceptance_rate"] > 0.0
    assert sum(len(t) for t in out.values()) > eng.decode_steps
    plain = _engine()
    run_to_completion(plain, _rep_trace(), dt=0.05)
    assert "accepted_per_step" not in plain.snapshot()
    assert "spec_acceptance_rate" not in plain.snapshot()


# ---------------------------------------------------------------------------
# against JAX's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["ngram", "model"])
def test_accepted_per_step_equals_jax(spec):
    """On repetitive_trace, greedy, paged pool: the port's engine emits
    JAX's tokens (JAX under the pallas plan, f32 probabilities) and
    accepts the same drafts in the same steps: equal acceptance counts
    and accepted tokens per step. The draft model runs JAX's weights
    (its contiguous attention rounds probabilities to bf16 in JAX, so a
    proposal may differ past a near-tie; the random draft model's
    proposals are all rejected on both sides)."""
    kw = dict(num_slots=3, prompt_len=P, max_gen=8, block_size=BS)
    jeng = JaxEngine(JCFG, JPARAMS, spec=spec, spec_k=4, clock=JaxClock(),
                     plan=PALLAS, **kw)
    jout = jax_run(jeng, _rep_trace(jax_request, gen_len=8, motif_len=2),
                   dt=0.05)
    eng = _engine(spec=spec)
    out = run_to_completion(eng, _rep_trace(gen_len=8, motif_len=2),
                            dt=0.05)
    assert out == jout
    m, jm = eng.metrics, jeng.metrics
    assert (m.spec_steps, m.spec_proposed, m.spec_accepted,
            m.spec_emitted) == (jm.spec_steps, jm.spec_proposed,
                                jm.spec_accepted, jm.spec_emitted)
    apt = eng.snapshot()["accepted_per_step"]
    assert apt == jeng.snapshot()["accepted_per_step"]
    # the n-gram drafter lands drafts here; a random draft model's
    # proposals are rejected at every step, by JAX's engine as by the port
    assert apt > 1.0 if spec == "ngram" else apt == 1.0
    assert eng.decode_steps == jeng.decode_steps


# Where JAX's draft logits' top two are this close, the port may order
# them the other way: JAX's slot pool rounds attention probabilities to
# bf16 before P.V and the port keeps f32. The draft model's bf16 logits
# (|logit| < 5) differ between the port and JAX by up to 0.035 at the
# smoke shapes, so two of them can swap places within twice that.
DRAFT_MARGIN = 3 / 32
# the full forward below pads every sequence to one length (one trace)
DRAFT_SEQ = P + 16 + 8


@jax.jit
def _jax_draft_logits(tokens):
    """JAX's draft model on the bridged weights over a whole padded
    sequence (causal, so the padding does not reach earlier rows): the
    logits whose argmax is each position's next draft token."""
    lg, _, _ = JMo.forward(JDRAFT, tokens[None], jax_draft_config(JCFG),
                           JEnv(mesh=None, plan=ParallelPlan(
                               fsdp=False, remat="full", attn_impl="naive",
                               kv_cache="replicated")), mode="train")
    return lg[0, :, :CFG.vocab_size].astype(jnp.float32)


def _draft_ref(seq):
    padded = np.zeros((DRAFT_SEQ,), np.int32)
    padded[:len(seq)] = seq
    return np.asarray(_jax_draft_logits(jnp.asarray(padded)))


def _top_two_gap(row):
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def test_model_drafter_proposes_what_jax_proposes():
    """The port's ModelDrafter against JAX's ModelDrafter (whose weights
    are the PRNGKey(0) draft weights the port gets bridged) over served
    histories on a three-slot draft pool: requests interleaved, catch-ups
    of 1 to k + 1 target tokens (a random accepted prefix of the drafts
    plus one token of the target's own), k from 1 to 8, a request retired
    mid-stream (a preemption or a swap-out) and re-admitted lazily into
    another slot with its whole generated history to catch up, and a new
    request in a freed slot whose stale KV lies past its prompt.

    Each proposal equals JAX's token for token up to the first position
    where JAX's draft logits' top two lie within DRAFT_MARGIN. Every
    proposed token is the argmax of JAX's draft model's full forward over
    the history and the drafts before it, wherever the top two lie more
    than DRAFT_MARGIN apart. About 70% of the positions lie so (54 of 77);
    the test asks for 60%, and for at most 4 proposals that part from
    JAX's at a near-tie (2 do)."""
    from repro.serve.spec import ModelDrafter as JaxModelDrafter
    kw = dict(num_slots=3, prompt_len=P, max_gen=16, spec_k=8)
    jd = JaxModelDrafter(JCFG, JEnv(mesh=None, plan=PALLAS), **kw)
    td = ModelDrafter(CFG, Env(), params=DRAFT, device="cpu", **kw)
    rng = np.random.default_rng(5)
    reqs = {}

    def request(rid):
        prompt = rng.integers(0, CFG.vocab_size, (P,), dtype=np.int32)
        first = [int(rng.integers(0, CFG.vocab_size))]  # prefill's token
        reqs[rid] = tuple(mod.Request(rid=rid, prompt=prompt, gen_len=16,
                                      arrival_t=0.0)
                          for mod in (torch_request, jax_request))
        for r in reqs[rid]:
            r.tokens = list(first)

    for rid in range(3):
        request(rid)
    # (requests that propose this round, rids retired after it)
    rounds = [((0, 1, 2), (1,)), ((0, 2), ()), ((0, 2, 3), (0,)),
              ((1, 2, 3), (3,)), ((1, 2, 4), ()), ((1, 4), ()),
              ((2, 4), ())]
    held = total = diverged = 0
    for live, retire in rounds:
        for rid in live:
            if rid not in reqs:
                request(rid)
            treq, jreq = reqs[rid]
            if len(treq.tokens) >= treq.gen_len:
                continue  # finished: the engine proposes no more
            k = int(rng.integers(1, 9))
            hist = [int(t) for t in treq.prompt] + treq.tokens
            assert len(hist) + k <= DRAFT_SEQ + 1
            got, want = td.propose(treq, k), jd.propose(jreq, k)
            assert len(got) == len(want) == k, (rid, got, want)
            ref = _draft_ref(hist + got[:-1])
            for j, tok in enumerate(got):
                row = ref[len(hist) - 1 + j]
                gap = _top_two_gap(row)
                if tok != want[j]:  # JAX's chain went its own way from here
                    assert got[:j] == want[:j] and gap <= DRAFT_MARGIN, \
                        (rid, j, got, want, gap)
                    diverged += 1
                    break
            for j, tok in enumerate(got):
                row = ref[len(hist) - 1 + j]
                total += 1
                if _top_two_gap(row) > DRAFT_MARGIN:
                    assert tok == int(row.argmax()), (rid, j, got)
                    held += 1
            take = got[:int(rng.integers(0, k + 1))] + [
                int(rng.integers(0, CFG.vocab_size))]
            for r in (treq, jreq):
                r.tokens = r.tokens + take[:r.gen_len - len(r.tokens)]
        for rid in retire:
            td.retire(rid)
            jd.retire(rid)
    assert total >= 60 and held >= 0.6 * total, (held, total)
    assert diverged <= 4, diverged


# ---------------------------------------------------------------------------
# truncate: rejected-draft rollback
# ---------------------------------------------------------------------------


def _bm(num_slots=3, max_gen=8, **kw):
    return BlockManager(CFG, Env(), num_slots=num_slots, prompt_len=P,
                        max_gen=max_gen, block_size=BS, device="cpu", **kw)


def _prefill(bm, rid, prompt, gen_len=8):
    slot = bm.admit(rid, gen_len, prefilling=True, prompt=prompt)
    for pos in range(bm.cached_prefix_len(slot), P):
        bm.ensure(slot, pos)
    bm.finish_prefill(slot)
    return slot


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (P,),
                                                dtype=np.int32)


def test_truncate_releases_blocks_and_recredits_reservation():
    bm = _bm()
    slot = _prefill(bm, 0, _prompt())
    for pos in range(P, P + 6):  # grow into gen blocks 4 and 5
        bm.ensure(slot, pos)
    s = bm.info(slot)
    assert s.alloc_g == 6
    used, res = bm.blocks_in_use, s.reserved
    bm.truncate(slot, P + 1)  # keep ceil(17/4) = 5 blocks
    assert bm.info(slot).alloc_g == 5
    assert bm.blocks_in_use == used - 1
    assert bm.info(slot).reserved == res + 1  # rejection costs nothing


def test_truncate_within_boundary_block_is_free():
    bm = _bm()
    slot = _prefill(bm, 0, _prompt())
    bm.ensure(slot, P)  # one gen block, positions 16..19
    used = bm.blocks_in_use
    bm.truncate(slot, P + 1)  # junk at 17..19 stays inside the kept block
    assert bm.blocks_in_use == used
    assert bm.info(slot).alloc_g == 5


def test_truncate_then_regrow_round_trips():
    bm = _bm()
    slot = _prefill(bm, 0, _prompt())
    for _ in range(3):  # speculate, reject, re-speculate
        for pos in range(P, P + 6):
            bm.ensure(slot, pos)
        bm.truncate(slot, P)
    assert bm.info(slot).alloc_g == 4
    bm.evict(slot)  # every block back or retained, no double free
    assert bm.blocks_in_use == 0
    bm.release()


def test_truncate_never_reaches_shared_prefix_blocks():
    bm = _bm()
    p = _prompt()
    _prefill(bm, 0, p)  # registers the prompt's blocks in the prefix cache
    slot2 = bm.admit(1, 8, prefilling=True, prompt=p)
    assert bm.cached_prefix_len(slot2) == P - 1
    for pos in range(bm.cached_prefix_len(slot2), P):
        bm.ensure(slot2, pos)
    bm.finish_prefill(slot2)
    shared = bm.info(slot2).shared_g
    assert shared >= 1
    bm.truncate(slot2, shared * BS)  # keep == shared_g: a legal no-op
    with pytest.raises(AssertionError, match="shared prefix"):
        bm.truncate(slot2, (shared - 1) * BS)


def test_slot_pool_truncate_is_a_noop():
    pool = SlotPool(CFG, Env(), num_slots=2, prompt_len=P, max_gen=8,
                    device="cpu")
    before = [x.clone() for u in pool.caches["blocks"] for x in u.values()]
    pool.truncate(0, P + 3)
    after = [x for u in pool.caches["blocks"] for x in u.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_truncate_rollback_keeps_scale_leaves_intact():
    """On the int8 pool a rejection returns whole blocks (values and f32
    scales): through every rollback the surviving prefix's raw int8 rows
    and scales stay as written, and its dequantized KV stays finite."""
    eng = _engine(kv="quant", spec="ngram")
    seen = {}
    checked = [0]

    def on_step(i, snap):
        for slot in eng.pool.active_slots():
            s = eng.pool.info(slot)
            raw = BlockManager.read_slot(eng.pool, slot)["blocks"][0]
            upto = s.cur_len  # committed positions
            key = s.rid
            if key in seen:  # what was committed stays byte-equal
                old_len, old = seen[key]
                for n in ("k", "v", "k_scale", "v_scale"):
                    a = old[n][:, :, :, :old_len]
                    b = raw[n][:, :, :, :old_len]
                    assert torch.equal(a, b), (n, slot)
            seen[key] = (upto, {n: x.clone() for n, x in raw.items()})
            kv = eng.pool.read_slot(slot)
            for u in kv["blocks"]:
                for x in u.values():
                    assert torch.isfinite(x.float()).all()
            checked[0] += 1

    out = run_to_completion(eng, _rep_trace(sampling=SAMPLED, gen_len=8,
                                            motif_len=4), dt=0.05,
                            on_step=on_step)
    assert checked[0] > 0
    snap = eng.snapshot()
    assert snap["spec_acceptance_rate"] < 1.0, "no rejection happened"
    assert all(len(t) == 8 for t in out.values())
    assert snap["kv_quant_divergence"] < 0.05


# ---------------------------------------------------------------------------
# the row-to-slot step
# ---------------------------------------------------------------------------


def test_row_slot_step_equals_sequential_steps():
    """Three rows of one slot at depths d, d+1, d+2 plus a masked row, in
    one row-indirected step over a 4-slot cache, give the logits and the
    cache that three one-row steps give, and the masked row writes only
    the never-attended tail position."""
    env = Env()
    Smax = 12
    gen = torch.Generator().manual_seed(0)
    cache = Mo.init_cache(CFG, env, 4, Smax, device="cpu")
    for leaf in cache["blocks"][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    ref = {"blocks": tuple({n: x.clone() for n, x in u.items()}
                           for u in cache["blocks"]), "tail": ()}
    toks = torch.tensor([[5], [9], [3], [7]])
    d = 4
    row_slots = torch.tensor([2, 2, 2, -1])
    cur = torch.tensor([d, d + 1, d + 2, 0])
    lg, cache = Mo.forward(PARAMS, toks, CFG, env, mode="decode",
                           caches=cache, cur_len=cur, row_slots=row_slots)
    for j in range(3):  # one row at a time, over the same slot
        lj, ref = Mo.forward(PARAMS, toks[j:j + 1], CFG, env, mode="decode",
                             caches=ref, cur_len=cur[j:j + 1],
                             row_slots=row_slots[j:j + 1])
        assert torch.equal(lj[0], lg[j])
    for a, b in zip(cache["blocks"][0].values(), ref["blocks"][0].values()):
        assert torch.equal(a[:, 1:], b[:, 1:])  # slots 1-3 as sequential
        assert torch.equal(a[:, 0, :, :Smax - 1], b[:, 0, :, :Smax - 1])


def test_fused_spec_step_matches_jax():
    """launch/steps.py make_spec_decode_step against JAX's on the same
    contiguous cache: the same greedy tokens, and the first layer's K/V
    written at the same (slot, position) cells bit for bit. (JAX's
    contiguous attention rounds probabilities to bf16, the port keeps
    f32, so later layers' inputs differ in the last bits.)"""
    env = Env()
    gen = torch.Generator().manual_seed(1)
    cache = Mo.init_cache(CFG, env, 3, 24, device="cpu")
    for leaf in cache["blocks"][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    to_j = lambda t: (jnp.asarray(t.view(torch.int16).numpy()).view(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
        t.numpy()))
    jcache = jax.tree.map(to_j, cache, is_leaf=torch.is_tensor)
    T = 6
    mi = np.zeros((St.META_I_ROWS, T), np.int32)
    mi[St.ROW_TOK_SRC] = -1
    mi[St.ROW_FRESH] = [11, 22, 33, 44, 55, 66]
    mi[St.ROW_CUR_LEN] = [7, 8, 9, 3, 15, 0]
    rs = np.asarray([1, 1, 1, 0, 2, -1], np.int32)
    mf = np.zeros((St.META_F_ROWS, T), np.float32)
    prev = torch.zeros((3,), dtype=torch.int32)
    nxt, cache = St.make_spec_decode_step(CFG, env)(
        PARAMS, cache, prev, torch.from_numpy(mi), torch.from_numpy(mf),
        torch.from_numpy(rs))
    from repro.launch import steps as JSt
    jnxt, jcache = JSt.make_spec_decode_step(JCFG, JEnv(
        mesh=None, plan=PALLAS))(JPARAMS, jcache, jnp.zeros((3,), jnp.int32),
                                 jnp.asarray(mi), jnp.asarray(mf),
                                 jnp.asarray(rs))
    assert np.array_equal(nxt.numpy()[:5], np.asarray(jnxt)[:5])
    for n in ("k", "v"):
        got = cache["blocks"][0][n][0].view(torch.int16).numpy()
        want = np.asarray(jcache["blocks"][0][n][0]).view(np.int16)
        assert np.array_equal(got[:, :, :23], want[:, :, :23])


# ---------------------------------------------------------------------------
# adaptive draft depth
# ---------------------------------------------------------------------------


def test_adaptive_spec_k_converges_both_ways():
    ctl = AdaptiveSpecK(cap=4)
    assert ctl.k(0) == 4  # optimistic start
    for _ in range(8):  # rejected drafts: multiplicative decrease
        ctl.update(0, proposed=ctl.k(0), accepted=0)
    assert ctl.k(0) == 1
    for _ in range(8):  # clean acceptance: additive recovery to the cap
        ctl.update(0, proposed=ctl.k(0), accepted=ctl.k(0))
    assert ctl.k(0) == 4
    ctl.update(1, proposed=4, accepted=2)  # half kept: hold
    assert ctl.k(1) == 4
    ctl.retire(0)
    assert ctl.k(0) == 4  # state dies with the request


def test_spec_k_auto_engine_is_bit_exact_and_adapts():
    """--spec-k auto keeps spec == spec off while depths move: random
    prompts give the n-gram drafter near-zero acceptance, so depths decay
    from the cap."""
    trace = lambda: _mix_trace(n=6, gen_len=8)
    base = run_to_completion(_engine(), trace(), dt=0.05)
    eng = _engine(spec="ngram", spec_k="auto")
    ctl = eng.replica._spec_ctl
    assert ctl is not None and eng.spec_k == 4
    seen = {}
    eng.submit(trace())
    while not eng.drained():
        eng.step()
        seen.update(ctl._k)
        eng.clock.sleep(0.05)
    assert eng.results() == base, "adaptive depth broke spec exactness"
    assert seen and min(seen.values()) < 4
    assert not ctl._k, "retired requests must leave no depth state"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [["--spec", "ngram", "--trace", "repetitive"],
       ["--spec", "model", "--spec-k", "auto", "--kv", "slot"],
       ["--spec", "ngram", "--spec-k", "8", "--kv", "quant", "--trace",
        "repetitive", "--temperature", "0.8", "--top-k", "50", "--top-p",
        "0.9", "--sample-seed", "7"]]


@pytest.mark.parametrize("argv", CLI, ids=["ngram", "model-auto-slot",
                                           "ngram-8-quant-seeded"])
def test_cli_spec_runs_verify(argv, capsys):
    args = parse_args(["--smoke", "--device", "cpu", "--verify"] + argv)
    run = run_trace(args, CFG, PARAMS)
    out = capsys.readouterr().out
    assert run["rc"] == 0
    assert f"vs --spec off: bit-identical MATCH" in out
    assert "speculative (" in out and "accepted/step" in out
