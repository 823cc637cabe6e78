"""The port's host swap tier (serve/blocks.py HostSwapPool) on the CPU.

Against the JAX package: an EDF-preemptive engine with one slot swaps a
deadline-free victim out for an urgent arrival and resumes it from the
host tier, greedy and seeded, on the paged and int8 pools of paper-demo
and the paged and int8 pools (ring tables with their scales, state rows)
of recurrentgemma-9b and rwkv6-1.6b (smoke configs, weights bridged from
JAX): the port's tokens
equal JAX's swap run's and the unpreempted run's, nothing is recomputed,
and the bytes swapped out equal the bytes restored.

Inside the port, as tests/test_tiered_kv.py holds the JAX package: a
swap round trip restores the pool byte for byte (into another slot's
state row too), a zero host budget falls back to restart preemption, the
host pool's budget and leak check, a preempt-drain of a fleet migrates
requests through its one shared host pool with nothing recomputed, the
slot pool declines to swap, and the CLI's swap commands verify.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import EDFPolicy as JaxEDF
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch.serve import parse_args, run_trace
from repro_torch.models.env import Env
from repro_torch.serve import (BlockManager, EDFPolicy, HostSwapPool,
                               ReplicaSet, SamplingParams, ServingEngine,
                               SlotPool, make_kv_backend, poisson_trace,
                               run_to_completion)
from repro_torch.serve import request as torch_request

PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
PD, RG, RW = "paper-demo", "recurrentgemma-9b", "rwkv6-1.6b"
P = 16  # prompt length used throughout
_PARAMS = {}
SP = dict(temperature=0.9, top_k=40, top_p=0.95, seed=7)


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


def _params(arch):
    """(JAX params, the port's bridged copy) of the arch's smoke config."""
    if arch not in _PARAMS:
        jp = JMo.init_params(jax.random.PRNGKey(0), jax_smoke(arch),
                             JEnv(mesh=None, plan=PALLAS))
        _PARAMS[arch] = (jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _PARAMS[arch]


def _block_size(arch):
    return 4 if arch == PD else 8


def _engine(arch=PD, num_slots=1, max_gen=8, **kw):
    return ServingEngine(get_smoke(arch), _params(arch)[1],
                         num_slots=num_slots, prompt_len=P, max_gen=max_gen,
                         block_size=_block_size(arch), clock=ManualClock(),
                         device="cpu", **kw)


def _reqs(mod, arch, sampled, victim_only=False):
    """A deadline-free victim (8 tokens) and, at t=0.12, an urgent
    request (2 tokens, deadline 0.4 s) that preempts it on one slot."""
    rng = np.random.default_rng(5)
    vocab = get_smoke(arch).vocab_size
    prompts = [rng.integers(0, vocab, (P,), dtype=np.int32)
               for _ in range(2)]
    sp = mod.SamplingParams(**SP) if sampled else mod.SamplingParams()
    out = [mod.Request(rid=0, prompt=prompts[0], gen_len=8, sampling=sp)]
    if not victim_only:
        out.append(mod.Request(rid=1, prompt=prompts[1], gen_len=2,
                               arrival_t=0.12, deadline_s=0.4))
    return out


def _edf(mod):
    return mod(preemptive=True, min_slack_s=1.0)


CASES = [(PD, "paged"), (PD, "quant"), (RG, "paged"), (RW, "paged"),
         (RG, "quant"), (RW, "quant")]


@pytest.mark.parametrize("arch,kv", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_swap_preemption_resumes_without_recompute(arch, kv):
    for sampled in (False, True):
        solo = run_to_completion(_engine(arch, kv=kv),
                                 _reqs(torch_request, arch, sampled, True),
                                 dt=0.05)
        eng = _engine(arch, kv=kv, swap=True, policy=_edf(EDFPolicy))
        out = run_to_completion(eng, _reqs(torch_request, arch, sampled),
                                dt=0.05)
        assert eng.metrics.preemptions >= 1
        assert out[0] == solo[0], "the victim's stream survives the swap"
        assert eng.metrics.recomputed_tokens == 0
        pm = eng.pool.metrics()
        assert pm["swap_out_bytes"] == pm["swap_in_bytes"] > 0
        if arch != RW:  # rwkv6 holds no blocks: its state rows swap
            assert pm["swapped_blocks"] > 0
        assert eng.snapshot()["recomputed_tokens"] == 0.0
        jeng = JaxEngine(jax_smoke(arch), _params(arch)[0], num_slots=1,
                         prompt_len=P, max_gen=8, kv=kv,
                         block_size=_block_size(arch), swap=True,
                         policy=_edf(JaxEDF), clock=JaxClock(), plan=PALLAS)
        jout = jax_run(jeng, _reqs(jax_request, arch, sampled), dt=0.05)
        assert out == jout
        assert jeng.metrics.recomputed_tokens == 0
        jm = jeng.pool.metrics()
        assert (pm["swapped_blocks"], pm["swap_out_bytes"]) == (
            jm["swapped_blocks"], jm["swap_out_bytes"])
        eng.pool.release()


@pytest.mark.parametrize("arch,kv", CASES,
                         ids=[f"{a}-{k}" for a, k in CASES])
def test_swap_round_trip_restores_the_pool_byte_for_byte(arch, kv):
    """swap_out copies a slot's blocks and state row to the host; swap_in
    scatters them into fresh blocks and another free slot: the slot reads
    back byte-equal (int8 values and f32 scales in the quant pool), and
    the record counts the payload's bytes."""
    cfg = get_smoke(arch)
    pool = make_kv_backend(kv, cfg, Env(), num_slots=3, prompt_len=P,
                           max_gen=8, block_size=_block_size(arch),
                           swap=True, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for unit in pool.caches["blocks"] + pool.caches["tail"]:
        for leaf in unit.values():
            x = torch.randn(leaf.shape, generator=gen) * 20
            leaf.copy_(x.to(leaf.dtype))
    raw = lambda slot: BlockManager.read_slot(pool, slot)  # int8 as is
    a = pool.admit(0, 8)
    b = pool.admit(1, 8)
    for pos in range(P + 3):
        pool.ensure(a, pos)
    s = pool.info(a)
    s.cur_len, s.tokens_done = P + 3, 4
    before, old_table = raw(a), pool.table[a].copy()
    assert pool.swap_out(a)
    assert pool.has_swapped(0) and pool.info(a) is None
    rec = pool.swap_pool.peek(0)
    assert rec.nbytes == sum(x.numel() * x.element_size()
                             for u in rec.payload["blocks"] +
                             rec.payload["tail"] for x in u.values())
    new = pool.swap_in(0)
    assert new not in (a, b) and pool.info(new).cur_len == P + 3
    if pool.has_global:  # fresh physical blocks
        assert not np.array_equal(pool.table[new], old_table)
    after = raw(new)
    for u0, u1 in zip(before["blocks"] + before["tail"],
                      after["blocks"] + after["tail"]):
        for n in u0:
            assert torch.equal(u0[n].view(torch.uint8),
                               u1[n].view(torch.uint8)), n
    m = pool.metrics()
    assert m["swap_in_bytes"] == m["swap_out_bytes"] == rec.nbytes
    pool.evict(new)
    pool.evict(b)
    pool.release()


def test_swap_budget_exhaustion_falls_back_to_restart():
    """A zero-block host budget can never store a victim: swap_out
    declines and the engine restart-preempts (same output, recompute
    billed) instead of deadlocking."""
    solo = run_to_completion(_engine(), _reqs(torch_request, PD, True, True),
                             dt=0.05)
    eng = _engine(swap=True, swap_budget_blocks=0, policy=_edf(EDFPolicy))
    out = run_to_completion(eng, _reqs(torch_request, PD, True), dt=0.05)
    assert out[0] == solo[0]
    assert eng.metrics.preemptions >= 1
    assert eng.metrics.recomputed_tokens > 0, "budget 0 must restart"
    assert eng.pool.metrics()["swapped_blocks"] == 0.0


def test_host_pool_budget_and_leak_check():
    pool = HostSwapPool(budget_blocks=4)
    assert pool.can_store(4) and not pool.can_store(5)
    with pytest.raises(ValueError):
        HostSwapPool(budget_blocks=-1)
    cfg = get_smoke(PD)
    # a backend that releases while a request is still swapped out leaks
    host = HostSwapPool()
    backend = make_kv_backend("paged", cfg, Env(), num_slots=1,
                              prompt_len=P, max_gen=8, swap=True,
                              swap_pool=host, device="cpu")
    slot = backend.admit(0, 8)
    backend.ensure(slot, P - 1)
    assert backend.swap_out(slot)
    assert backend.has_swapped(0) and host.blocks_resident > 0
    with pytest.raises(RuntimeError, match="leaked"):
        backend.release()  # a stranded swap record is a leak
    host.drop(0)
    assert host.blocks_resident == 0
    # a drop through the backend detaches clean; a resume plan is a
    # standing reservation that the drop hands back
    host2 = HostSwapPool()
    b2 = make_kv_backend("paged", cfg, Env(), num_slots=1, prompt_len=P,
                         max_gen=8, swap=True, swap_pool=host2, device="cpu")
    slot = b2.admit(1, 8)
    b2.ensure(slot, P - 1)
    assert b2.swap_out(slot)
    free = b2.free_unreserved
    assert b2.plan_resume(1) and b2.free_unreserved < free
    assert host2.planner(1) is b2 and b2.can_resume(1)
    b2.drop_swapped(1)
    assert b2.free_unreserved == free
    b2.release()


def test_fleet_drain_preempt_with_swap_migrates_requests():
    """drain_mode="preempt" + swap: victims swap out of the draining
    replica and resume on the survivor through the fleet's one host pool;
    the outputs equal one undrained engine's, nothing is recomputed."""
    cfg = get_smoke(PD)
    trace = poisson_trace(12, 32.0, prompt_len=P, vocab_size=cfg.vocab_size,
                          gen_len=6, sampling=SamplingParams(
                              temperature=0.8, top_k=40, top_p=0.95,
                              seed=11), seed=0)
    fresh = lambda: [dataclasses.replace(r, tokens=[], t_admit=None,
                                         t_first_token=None, t_done=None,
                                         restarts=0) for r in trace]
    base = run_to_completion(_engine(num_slots=2), fresh(), dt=0.05)
    rs = ReplicaSet(cfg, _params(PD)[1], replicas=2, routing="occupancy",
                    num_slots=2, prompt_len=P, max_gen=8, block_size=4,
                    clock=ManualClock(), drain_mode="preempt", swap=True,
                    device="cpu")
    host = rs.replicas[0].pool.swap_pool
    rs.submit(fresh())
    steps = 0
    while not rs.drained() and steps < 5000:
        rs.step()
        if steps == 6:
            rs.reconcile(1)  # preempt-drain one replica mid-serve
        rs.clock.sleep(0.05)
        steps += 1
    assert rs.drained() and rs.released
    assert rs.results() == base
    snap = rs.snapshot()
    assert snap["preemptions"] > 0, "the drain caught no in-flight work"
    assert snap["recomputed_tokens"] == 0.0
    assert snap["swapped_blocks"] > 0
    assert snap["swap_in_bytes"] == snap["swap_out_bytes"] > 0
    assert host.blocks_resident == 0
    for r in rs.replicas:
        r.release()  # the last detach leak-checks the shared pool


def test_slot_pool_declines_to_swap():
    """The slot pool has no host tier: swap_out returns False, so an
    engine asked for swap restart-preempts on it."""
    cfg = get_smoke(PD)
    pool = SlotPool(cfg, Env(), num_slots=1, prompt_len=P, max_gen=8,
                    device="cpu")
    assert not pool.swap_out(0)
    assert not pool.has_swapped(0) and not pool.can_resume(0)
    assert not pool.plan_resume(0)
    pool.cancel_resume_plans()
    pool.drop_swapped(0)
    with pytest.raises(NotImplementedError):
        pool.swap_in(0)
    solo = run_to_completion(_engine(kv="slot"),
                             _reqs(torch_request, PD, True, True), dt=0.05)
    eng = _engine(kv="slot", swap=True, policy=_edf(EDFPolicy))
    out = run_to_completion(eng, _reqs(torch_request, PD, True), dt=0.05)
    assert out[0] == solo[0]
    assert eng.metrics.preemptions >= 1 and eng.metrics.recomputed_tokens > 0


CLI = [
    (["--swap", "on", "--sched", "edf", "--edf-preempt", "--verify"],
     "verify vs streamed-prefill one-shot baseline: token-for-token MATCH"),
    (["--replicas", "2", "--kv", "quant", "--drain", "preempt", "--swap",
      "on", "--trace", "burst", "--requests", "16", "--max-nodes", "4",
      "--verify"], "verify 2 replicas (occupancy routing) vs 1: "
     "bit-identical MATCH"),
]


@pytest.mark.parametrize("argv,line", CLI, ids=["edf", "fleet-drain"])
def test_cli_swap_runs_verify(argv, line, capsys):
    run = run_trace(parse_args(["--smoke", "--device", "cpu"] + argv),
                    get_smoke(PD), _params(PD)[1])
    out = capsys.readouterr().out
    assert run["rc"] == 0 and line in out
    assert "swap tier:" in out and "recomputed tokens 0" in out
    if "--replicas" in argv:  # the scale-down drain swapped requests out
        assert run["snapshot"]["swap_out_bytes"] > 0
