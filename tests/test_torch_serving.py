"""The PyTorch port's serving engine on the smoke config (CPU).

Against the JAX package: the same seeded traces through the port's
ServingEngine and through JAX's ServingEngine under the pallas plan (the
paged kernel in interpret mode, f32 softmax probabilities — the semantics
the port implements) emit the same greedy tokens.

Inside the port, as the JAX package holds them inside itself: the engine
equals the streamed-prefill one-shot baseline, prefix cache on equals off,
seeded sampling is bit-identical across slot counts, a mid-decode
admission never disturbs running requests, and release() checks for
leaks.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import ServingEngine as JaxEngine
from repro.serve import run_to_completion as jax_run
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch.serve import serve_batch
from repro_torch.serve import (BlockManager, EDFPolicy, Request,
                               SamplingParams, ServingEngine, burst_trace,
                               poisson_trace, run_to_completion,
                               sysprompt_trace)
from repro_torch.serve import request as torch_request
from repro.serve import request as jax_request
from repro_torch.models.env import Env

JCFG = get_smoke("paper-demo")
CFG = torch_smoke("paper-demo")
PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), JCFG,
                          JEnv(mesh=None, plan=PALLAS))
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
P = 16
SAMPLED = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager CPU ops at these sizes gain nothing from torch's
    intra-op pool, and under several test workers its spinning threads
    only take cores from the others: one thread while this module runs,
    the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine(num_slots=2, max_gen=8, prompt_len=P, **kw):
    return ServingEngine(CFG, PARAMS, num_slots=num_slots,
                         prompt_len=prompt_len, max_gen=max_gen,
                         clock=ManualClock(), device="cpu", **kw)


def _trace(n, gen_len=4, seed=0, sampling=None):
    rng = np.random.default_rng(seed)
    sp = lambda i: SamplingParams() if sampling is None else sampling.derive(i)
    return [Request(rid=i, prompt=rng.integers(0, CFG.vocab_size, (P,),
                                               dtype=np.int32),
                    gen_len=gen_len, sampling=sp(i)) for i in range(n)]


def _baseline(trace, gen):
    return serve_batch(CFG, PARAMS, np.stack([r.prompt for r in trace]), gen,
                       device="cpu")


# ---------------------------------------------------------------------------
# parity with the JAX package's engine
# ---------------------------------------------------------------------------

# (trace family, trace kwargs, engine kwargs). The sysprompt trace shares
# a 24-token system prompt (one full 16-token block, so the prefix cache
# hits). Its seed 0 is left out: one first token there is a 1-ulp bf16
# near-tie (top logits 3.046875 vs 3.03125) that the Pallas kernel's
# blockwise online softmax and a full softmax round apart (ROADMAP.md).
PARITY = [
    ("poisson", dict(prompt_len=16, seed=0), dict(num_slots=4,
                                                  prompt_len=16)),
    ("sysprompt", dict(prompt_len=32, prefix_len=24, seed=1),
     dict(num_slots=3, prompt_len=32)),
]


@pytest.mark.parametrize("family,tkw,ekw", PARITY, ids=[p[0] for p in PARITY])
def test_greedy_tokens_equal_the_jax_pallas_engine(family, tkw, ekw):
    mk = lambda mod: getattr(mod, f"{family}_trace")(
        8, 16.0, vocab_size=JCFG.vocab_size, gen_len=16, **tkw)
    jout = jax_run(JaxEngine(JCFG, JPARAMS, max_gen=16, clock=JaxClock(),
                             plan=PALLAS, **ekw),
                   mk(jax_request), dt=0.05)
    eng = _engine(max_gen=16, **ekw)
    out = run_to_completion(eng, mk(torch_request), dt=0.05)
    assert out == jout
    if family == "sysprompt":
        assert eng.snapshot()["prefix_hit_rate"] > 0.0


# ---------------------------------------------------------------------------
# exactness inside the port
# ---------------------------------------------------------------------------


def test_chunked_engine_matches_the_streamed_one_shot():
    """Staggered admissions and mixed depths emit, token for token, what
    the streamed-prefill one-shot uniform batch emits."""
    gen = 8
    trace = poisson_trace(6, 12.0, prompt_len=P, vocab_size=CFG.vocab_size,
                          gen_len=gen, seed=11)
    eng = _engine(num_slots=2, max_gen=gen)
    assert eng.kv == "paged" and eng.prefill_chunk == P
    out = run_to_completion(eng, trace, dt=0.05)
    base = _baseline(trace, gen)
    for r in trace:
        assert np.array_equal(base[r.rid], np.array(out[r.rid])), r.rid


def test_chunk_size_does_not_change_tokens():
    gen = 6
    trace = lambda: poisson_trace(3, 10.0, prompt_len=P,
                                  vocab_size=CFG.vocab_size, gen_len=gen,
                                  seed=2)
    outs = [run_to_completion(
        _engine(num_slots=2, max_gen=gen, prefill_chunk=c, block_size=8),
        trace(), dt=0.05) for c in (P, 8, 5)]
    assert outs[0] == outs[1] == outs[2]


def test_block_exhaustion_applies_queue_backpressure():
    """A pool with blocks for ~2 requests but 4 slots defers admissions
    instead of overcommitting, and still drains token-exact."""
    gen = 8
    need = 3  # blocks_for(8) at block_size=8: ceil(23/8)
    eng = _engine(num_slots=4, max_gen=gen, block_size=8,
                  kv_blocks=1 + 2 * need)
    trace = burst_trace(4, prompt_len=P, vocab_size=CFG.vocab_size,
                        gen_len=gen, seed=9)
    peak = []
    out = run_to_completion(eng, trace, dt=0.05, on_step=lambda i, s: peak.append(
        len(eng.pool.occupied_slots())))
    assert max(peak) <= 2, "reservation must cap concurrency at the pool"
    base = _baseline(trace, gen)
    for r in trace:
        assert np.array_equal(base[r.rid], np.array(out[r.rid])), r.rid
    assert eng.pool.blocks_in_use == 0


def test_admitting_mid_decode_does_not_disturb_running_requests():
    """A request joining the batch (its prompt riding the lane rows)
    leaves an already-running slot's tokens unchanged, bit for bit."""
    tr = _trace(2, gen_len=6, seed=7)
    tr[1].arrival_t = 0.12  # joins while request 0 is mid-decode
    solo = run_to_completion(_engine(num_slots=1),
                             [_trace(2, gen_len=6, seed=7)[0]], dt=0.05)
    out = run_to_completion(_engine(num_slots=2), tr, dt=0.05)
    assert out[0] == solo[0]


def test_prefix_cache_on_equals_off_greedy_and_seeded():
    for sampling in (None, SAMPLED):
        mk = lambda pc: run_to_completion(
            _engine(num_slots=3, prompt_len=32, max_gen=6, block_size=8,
                    prefix_cache=pc),
            sysprompt_trace(5, 20.0, prompt_len=32, prefix_len=24,
                            vocab_size=CFG.vocab_size, gen_len=6,
                            sampling=sampling, seed=3), dt=0.05)
        assert mk(True) == mk(False)


@pytest.mark.parametrize("slots", [1, 3])
def test_seeded_sampling_is_invariant_to_slot_count(slots):
    """Seeded output is a pure function of (seed, position): other lane
    placements and batch compositions emit bit-identical tokens."""
    mk = lambda n: run_to_completion(
        _engine(num_slots=n, max_gen=8),
        poisson_trace(6, 20.0, prompt_len=P, vocab_size=CFG.vocab_size,
                      gen_len=8, sampling=SAMPLED, seed=4), dt=0.05)
    ref = mk(2)
    assert mk(slots) == ref
    greedy = run_to_completion(_engine(num_slots=2, max_gen=8), poisson_trace(
        6, 20.0, prompt_len=P, vocab_size=CFG.vocab_size, gen_len=8, seed=4),
        dt=0.05)
    assert ref != greedy, "sampling must actually sample"


def test_edf_preemption_restarts_the_victim_with_identical_tokens():
    """Restart preemption frees a slot for an urgent arrival; the victim
    regenerates exactly what an undisturbed run emits."""
    tr = _trace(2, gen_len=8, seed=5)
    tr[1].arrival_t = 0.1
    tr[1].deadline_s = 1.0
    eng = _engine(num_slots=1, policy=EDFPolicy(preemptive=True))
    out = run_to_completion(eng, tr, dt=0.05)
    assert eng.metrics.preemptions >= 1
    base = _baseline(tr, 8)
    for r in tr:
        assert np.array_equal(base[r.rid], np.array(out[r.rid])), r.rid


# ---------------------------------------------------------------------------
# BlockManager accounting
# ---------------------------------------------------------------------------


def _bm(num_slots=3, max_gen=8, **kw):
    return BlockManager(CFG, Env(), num_slots=num_slots, prompt_len=P,
                        max_gen=max_gen, block_size=4, device="cpu", **kw)


def _prefill(bm, rid, prompt, gen_len=8):
    slot = bm.admit(rid, gen_len, prefilling=True, prompt=prompt)
    for pos in range(bm.cached_prefix_len(slot), P):
        bm.ensure(slot, pos)
    bm.finish_prefill(slot)
    return slot


def test_release_checks_for_leaks_and_double_frees():
    eng = _engine(num_slots=2)
    run_to_completion(eng, _trace(3), dt=0.05)
    eng.replica.release()  # drained: every block free or cache-retained
    assert eng.pool.caches is None
    bm = _bm()
    prompt = _trace(1)[0].prompt
    a = _prefill(bm, 0, prompt)
    with pytest.raises(RuntimeError, match="occupied"):
        bm.release()
    bm.evict(a)
    with pytest.raises(RuntimeError, match="double free"):
        bm.evict(a)
    bm._free_blocks.pop()  # a block lost from the accounting
    with pytest.raises(RuntimeError, match="leaked"):
        bm.release()


def test_prefix_hit_shares_blocks_and_copy_on_write_keeps_the_kv():
    bm = _bm()
    prompt = _trace(1)[0].prompt
    a = _prefill(bm, 0, prompt)
    b = bm.admit(1, 8, prefilling=True, prompt=prompt)
    assert bm.cached_prefix_len(b) == P - 1
    assert list(bm.table[b][:4]) == list(bm.table[a][:4])
    assert bm.info(b).reserved == bm.blocks_for(8) - 4 + 1
    boundary = int(bm.table[a][3])
    bm.ensure(b, P - 1)  # the first divergent write: copy-on-write
    assert int(bm.table[b][3]) != boundary and bm._cow_copies == 1
    ra, rb = bm.read_slot(a), bm.read_slot(b)
    for name in ("k", "v"):
        x, y = ra["blocks"][0][name], rb["blocks"][0][name]
        assert np.array_equal(x[..., :P - 1, :].float().numpy(),
                              y[..., :P - 1, :].float().numpy())
    bm.evict(a)
    bm.evict(b)
    assert bm.blocks_in_use == 0 and bm.free_unreserved == bm.usable_blocks
    again = bm.admit(2, 8, prefilling=True, prompt=prompt)
    assert bm.cached_prefix_len(again) == P - 1, "retained blocks come back"


def test_truncate_returns_blocks_and_reservation():
    """Rolling a slot back frees whole blocks past the kept positions and
    re-credits their reservation; shared prefix blocks are never freed."""
    bm = _bm()
    prompt = _trace(1)[0].prompt
    slot = _prefill(bm, 0, prompt)
    bm.ensure(slot, P + 6)  # 23 positions -> 6 blocks of 4
    info = bm.info(slot)
    assert info.alloc_g == 6 and info.reserved == 0
    bm.truncate(slot, P + 1)  # keep 17 positions -> 5 blocks
    assert info.alloc_g == 5 and info.reserved == 1
    assert bm.table[slot][5] == 0
    other = _prefill(bm, 1, prompt)  # shares 3 prompt blocks (+1 COW)
    assert bm.info(other).shared_g == 3
    with pytest.raises(AssertionError, match="shared prefix"):
        bm.truncate(other, 4)


def test_evict_zeroes_only_the_blocks_it_frees():
    """evict(zero=True) is hygiene: blocks returned to the free list read
    back as zeros; blocks the prefix cache retains keep their KV."""
    for prefix_cache in (False, True):
        bm = _bm(prefix_cache=prefix_cache)
        slot = _prefill(bm, 0, _trace(1)[0].prompt)
        bm.ensure(slot, P + 2)  # one private generation block
        ids = [int(b) for b in bm.table[slot][:5]]
        for leaf in bm.caches["blocks"][0].values():
            leaf[:, ids] = 1.0
        bm.evict(slot, zero=True)
        k = bm.caches["blocks"][0]["k"]
        kept = ids[:4] if prefix_cache else []
        for b in ids:
            assert float(k[:, b].abs().max()) == (1.0 if b in kept else 0.0)
