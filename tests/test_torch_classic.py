"""The port's classic admission (batch-1 prefill + insert) on the CPU.

Inside the port, as tests/test_serving.py holds the JAX package: the
classic engine emits, token for token, what the full-prefill one-shot
batch emits, and the slot pool emits bit-identically what paged classic
admission emits (greedy and seeded). Against the JAX package: the same
seeded traces through the port's classic engine and JAX's under the
pallas plan give the same greedy tokens and the same seeded tokens,
at a 16-token prompt (attention_naive) and a 256-token prompt (the flash
branch: JAX's Pallas kernel in interpret mode); the int8 pool's classic
insert writes JAX's int8 rows and scales; restart preemption re-prefills
and books the same recomputed tokens. And the CLI's classic paths run and
verify.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import EDFPolicy as JaxEDF
from repro.serve import QuantBlockManager as JaxQuantBM
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro.serve.sampling import SamplingParams as JaxSampling
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch import steps as St
from repro_torch.launch.serve import (parse_args, run_oneshot, run_trace,
                                      serve_batch)
from repro_torch.models.env import Env
from repro_torch.serve import (EDFPolicy, QuantBlockManager, SamplingParams,
                               ServingEngine, SlotPool, make_kv_backend,
                               poisson_trace, run_to_completion)
from repro_torch.serve import request as torch_request

JCFG = get_smoke("paper-demo")
CFG = torch_smoke("paper-demo")
PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), JCFG,
                          JEnv(mesh=None, plan=PALLAS))
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
P = 16
SAMPLED = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=7)
JSAMPLED = JaxSampling(temperature=0.9, top_k=40, top_p=0.95, seed=7)


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


def _baseline(trace, gen):
    return serve_batch(CFG, PARAMS, np.stack([r.prompt for r in trace]), gen,
                       streamed_prefill=False, device="cpu")


# ---------------------------------------------------------------------------
# exactness inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["paged", "slot"])
@pytest.mark.parametrize("prompt_len", [P, 160])
def test_classic_engine_matches_the_full_prefill_one_shot(kv, prompt_len):
    """Staggered admissions, mid-serve evictions: classic prefill + insert
    is the same computation as the batched full prefill (160-token
    prompts take the flash branch)."""
    gen = 8
    trace = poisson_trace(6, 12.0, prompt_len=prompt_len,
                          vocab_size=CFG.vocab_size, gen_len=gen, seed=11)
    eng = _engine(max_gen=gen, prompt_len=prompt_len,
                  **({"kv": "slot"} if kv == "slot" else
                     {"prefill_chunk": 0}))
    assert eng.prefill_chunk == 0 and eng.kv == kv
    out = run_to_completion(eng, trace, dt=0.05)
    base = _baseline(trace, gen)
    for r in trace:
        assert np.array_equal(base[r.rid], np.array(out[r.rid])), r.rid
    snap = eng.snapshot()
    assert snap["prefill_tokens"] == 6 * prompt_len
    eng.pool.release()  # every slot and block came back


@pytest.mark.parametrize("sampling", [None, SAMPLED], ids=["greedy", "seeded"])
def test_slot_pool_matches_paged_classic_token_for_token(sampling):
    """The paged block-table plane reproduces the slot pool bit for bit
    (mid-serve admissions and evictions, mixed generation lengths)."""
    gen = 8
    mk = lambda: poisson_trace(5, 10.0, prompt_len=P,
                               vocab_size=CFG.vocab_size, gen_len=2,
                               gen_len_max=gen, sampling=sampling, seed=5)
    out_slot = run_to_completion(_engine(max_gen=gen, kv="slot"), mk(),
                                 dt=0.05)
    out_paged = run_to_completion(_engine(max_gen=gen, prefill_chunk=0),
                                  mk(), dt=0.05)
    assert out_slot == out_paged


def test_slot_pool_contract():
    """The slot backend: worst-case reservation per slot, no lanes, no
    prefix cache, leak-checked release, and insert/read round trips."""
    pool = make_kv_backend("slot", CFG, Env(), num_slots=2, prompt_len=P,
                           max_gen=8, device="cpu")
    assert isinstance(pool, SlotPool) and not pool.chunk_prefill_ok
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(kv="slot", prefill_chunk=P)
    assert _engine(kv="slot").prefill_chunk == 0
    _, caches = St.make_prefill_step(CFG, Env())(
        PARAMS, {"tokens": torch.zeros((1, P), dtype=torch.int64)})
    slot = pool.admit(0, 8)
    pool.insert(slot, 0, caches, 8)
    back = pool.read_slot(slot)["blocks"][0]["k"]
    assert torch.equal(back[..., :P, :], caches["blocks"][0]["k"])
    assert float(back[..., P:, :].abs().max()) == 0.0
    assert pool.info(slot).cur_len == P and pool.probe_prefix([1, 2]) == 0
    with pytest.raises(RuntimeError, match="occupied"):
        pool.release()
    pool.evict(slot, zero=True)
    assert float(pool.read_slot(slot)["blocks"][0]["k"].abs().max()) == 0.0
    pool.release()


def test_classic_admission_keeps_the_exact_prompt_length():
    """Classic prefill admits prompts of exactly prompt_len, as the JAX
    package's does (chunked admission takes shorter ones)."""
    trace = poisson_trace(2, 10.0, prompt_len=P - 4,
                          vocab_size=CFG.vocab_size, gen_len=4, seed=0)
    with pytest.raises(ValueError, match="prompt_len"):
        _engine(prefill_chunk=0).submit(trace)
    _engine().submit(trace)


# ---------------------------------------------------------------------------
# parity with the JAX package's classic engine
# ---------------------------------------------------------------------------

# (trace kwargs, engine kwargs): 16-token prompts (attention_naive in both
# packages) and 256-token prompts (the flash branch; 200 would stop JAX's
# kernel at its Sq % 128 assert)
CLASSIC = [
    (dict(n=8, prompt_len=16, gen_len=16, seed=0), dict(num_slots=4)),
    (dict(n=8, prompt_len=16, gen_len=16, seed=1), dict(num_slots=3)),
    (dict(n=3, prompt_len=256, gen_len=6, seed=0), dict(num_slots=2)),
]


def _classic_pair(tkw, ekw, sampling=None):
    n, plen, gen = tkw["n"], tkw["prompt_len"], tkw["gen_len"]
    mk = lambda mod, sp: mod.poisson_trace(
        n, 16.0, prompt_len=plen, vocab_size=JCFG.vocab_size, gen_len=gen,
        sampling=sp, seed=tkw["seed"])
    jsp = None if sampling is None else JSAMPLED
    jout = jax_run(JaxEngine(JCFG, JPARAMS, prompt_len=plen, max_gen=gen,
                             prefill_chunk=0, clock=JaxClock(), plan=PALLAS,
                             **ekw), mk(jax_request, jsp), dt=0.05)
    out = run_to_completion(_engine(prompt_len=plen, max_gen=gen,
                                    prefill_chunk=0, **ekw),
                            mk(torch_request, sampling), dt=0.05)
    return out, jout


@pytest.mark.parametrize("tkw,ekw", CLASSIC,
                         ids=["p16-s0", "p16-s1", "p256-flash"])
def test_classic_greedy_tokens_equal_the_jax_classic_engine(tkw, ekw):
    out, jout = _classic_pair(tkw, ekw)
    assert out == jout


@pytest.mark.parametrize("tkw,ekw", CLASSIC[:2], ids=["p16-s0", "p16-s1"])
def test_classic_seeded_first_tokens_equal_the_jax_classic_engine(tkw, ekw):
    """Each request's first token is sampled from its prefill logits with
    the seeded Gumbel draw at position 0 (the mask kernel's plain version
    in the port); on these traces the whole seeded streams agree too."""
    out, jout = _classic_pair(tkw, ekw, sampling=SAMPLED)
    assert sorted(out) == sorted(jout)
    assert [out[r][0] for r in sorted(out)] == [jout[r][0] for r in
                                                sorted(jout)]
    assert out == jout
    greedy, _ = _classic_pair(tkw, ekw)
    assert out != greedy, "sampling must actually sample"


def _to_jax(t):
    """A torch tensor as the jax array of the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def test_quant_classic_insert_matches_jax():
    """QuantBlockManager.insert quantizes the prefill cache into int8
    rows and per-row f32 scales where JAX's does: int8 values equal; the
    scales equal or 1 ulp apart (XLA computes absmax / 127 as absmax *
    (1/127) under jit; ROADMAP.md, queue 3)."""
    gen, tok = 8, np.random.default_rng(2).integers(
        0, CFG.vocab_size, (1, P)).astype(np.int32)
    _, caches = St.make_prefill_step(CFG, Env())(
        PARAMS, {"tokens": torch.from_numpy(tok)})
    jcaches = jax.tree.map(_to_jax, caches)
    bm = QuantBlockManager(CFG, Env(), num_slots=2, prompt_len=P,
                           max_gen=gen, block_size=4, device="cpu")
    jbm = JaxQuantBM(JCFG, JEnv(mesh=None, plan=PALLAS), num_slots=2,
                     prompt_len=P, max_gen=gen, block_size=4)
    for pool in (bm, jbm):
        pool.insert(pool.admit(0, gen), 0, caches if pool is bm else jcaches,
                    gen)
    assert np.array_equal(bm.table, jbm.table)
    got, want = bm.caches["blocks"][0], jbm.caches["blocks"][0]
    for n in ("k", "v"):
        assert np.array_equal(got[n].numpy(), np.asarray(want[n]))
        gs = got[f"{n}_scale"].numpy()
        ws = np.asarray(want[f"{n}_scale"])
        assert np.all(np.abs(gs.view(np.int32) - ws.view(np.int32)) <= 1)
    assert bm.info(0).cur_len == P and bm.info(0).tokens_done == 1



def test_restart_preemption_recompute_matches_jax():
    """An EDF-preemptive classic engine with one slot evicts a deadline-
    free runner for an urgent arrival; the victim re-prefills (booked as
    recomputed tokens) and regenerates what an undisturbed run emits —
    the same tokens and counters as JAX's classic engine."""
    def reqs(mod, sampling):
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, CFG.vocab_size, (P,), dtype=np.int32)
                   for _ in range(2)]
        return [mod.Request(rid=0, prompt=prompts[0], gen_len=8,
                            sampling=sampling),
                mod.Request(rid=1, prompt=prompts[1], gen_len=2,
                            arrival_t=0.12, deadline_s=0.4,
                            sampling=type(sampling)())]

    sp = SAMPLED
    eng = _engine(num_slots=1, prefill_chunk=0,
                  policy=EDFPolicy(preemptive=True, min_slack_s=1.0))
    out = run_to_completion(eng, reqs(torch_request, sp), dt=0.05)
    jeng = JaxEngine(JCFG, JPARAMS, num_slots=1, prompt_len=P, max_gen=8,
                     prefill_chunk=0, clock=JaxClock(), plan=PALLAS,
                     policy=JaxEDF(preemptive=True, min_slack_s=1.0))
    jout = jax_run(jeng, reqs(jax_request, JSAMPLED), dt=0.05)
    assert out == jout
    m, jm = eng.metrics, jeng.metrics
    assert m.preemptions == jm.preemptions >= 1
    assert m.recomputed_tokens == jm.recomputed_tokens >= P
    assert m.prefill_tokens == jm.prefill_tokens == 2 * P
    solo = run_to_completion(_engine(num_slots=1, prefill_chunk=0),
                             reqs(torch_request, sp)[:1], dt=0.05)
    assert out[0] == solo[0], "the victim's stream survives the restart"


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI = [
    (["--prefill-chunk", "0", "--verify"], "verify vs one-shot baseline: "
     "token-for-token MATCH"),
    (["--kv", "slot", "--verify"], "verify vs one-shot baseline: "
     "token-for-token MATCH"),
    (["--replicas", "2", "--prefill-chunk", "0", "--verify"],
     "vs 1: bit-identical MATCH"),
]


@pytest.mark.parametrize("argv,line", CLI, ids=["classic", "slot", "fleet"])
def test_cli_classic_runs_verify(argv, line, capsys):
    run = run_trace(parse_args(["--smoke", "--device", "cpu"] + argv), CFG,
                    PARAMS)
    log = capsys.readouterr().out
    assert run["rc"] == 0 and line in run["verify"] and line in log
    assert "chunked prefill=off (classic)" in log
    assert len(run["out"]) == 24


def test_cli_oneshot_serves_the_full_prefill_batch(capsys):
    args = parse_args(["--smoke", "--device", "cpu", "--trace", "oneshot",
                       "--requests", "4"])
    run = run_oneshot(args, CFG, PARAMS)
    assert run["rc"] == 0 and run["tokens"].shape == (4, args.gen)
    assert np.array_equal(run["tokens"], serve_batch(
        CFG, PARAMS, run["prompts"], args.gen, streamed_prefill=False,
        device="cpu"))
    assert "generated 64 tokens" in capsys.readouterr().out
