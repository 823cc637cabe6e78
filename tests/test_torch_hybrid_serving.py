"""Serving the recurrent archs (recurrentgemma-9b, rwkv6-1.6b) in the port
on the CPU, smoke configs.

Against the JAX package: on weights bridged from `Mo.init_params(
PRNGKey(0), ...)`, the port's engine emits the greedy tokens JAX's engine
emits under the pallas plan, for recurrentgemma in both ring regimes of
tests/test_serving.py (prompt 24 over a 16-token window: prefill rolls the
ring and decode wraps it; prompt 8: the ring fills during decode) and for
rwkv6. Inside the port: classic admission equals the full-prefill one-shot
baseline bit for bit (paged pool, and the slot pool for rwkv), chunked
prefill is refused, the slot pool refuses window archs, the BlockManager
sizes and frees ring tables and state rows, `--kv quant` raises, and the
CLI serves and verifies both archs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.core.clock import ManualClock as JaxClock
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch import steps as St
from repro_torch.launch.serve import parse_args, run_trace, serve_batch
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.serve import (BlockManager, ServingEngine, make_kv_backend,
                               poisson_trace, run_to_completion)
from repro_torch.serve import request as torch_request

PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
RG, RW = "recurrentgemma-9b", "rwkv6-1.6b"
_PARAMS = {}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke engines run thousands of tiny ops a step: torch's
    intra-op thread pool only adds contention, the more so under a
    multi-worker test run sharing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(arch):
    if arch not in _PARAMS:
        jp = JMo.init_params(jax.random.PRNGKey(1), get_smoke(arch),
                             JEnv(mesh=None, plan=PALLAS))
        _PARAMS[arch] = (jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _PARAMS[arch]


def _requests(mod, arch, n, prompt_len, gen, seed):
    rng = np.random.default_rng(seed)
    vocab = get_smoke(arch).vocab_size
    return [mod.Request(rid=i, prompt=rng.integers(
        0, vocab, (prompt_len,), dtype=np.int32), gen_len=gen,
        arrival_t=0.05 * i) for i in range(n)]


def _engine(arch, prompt_len, gen, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("block_size", 8)
    return ServingEngine(torch_smoke(arch), _params(arch)[1],
                         prompt_len=prompt_len, max_gen=gen,
                         clock=ManualClock(), device="cpu", **kw)


# (arch, prompt_len, gen, requests, trace seed); seeds free of bf16
# near-ties between the two packages' scans (see tests/test_torch_recurrent)
PARITY = [(RG, 24, 6, 3, 4), (RG, 8, 10, 3, 4), (RW, 16, 8, 4, 0)]


def _record_jax_logits(jeng, cfg):
    """Wrap the JAX engine's greedy paged step so that every decode step
    also records, per (request id, token index), the logits row it took
    the argmax of: a jitted copy of the step that returns the logits runs
    on the same arguments first (the step donates its caches)."""
    pool = jeng.replica.pool
    step = pool._decode[False]
    env = JEnv(mesh=None, plan=PALLAS)
    logits_of = jax.jit(lambda p, c, prev, mi, mf, tb: JMo.forward(
        p, JSt._select_tokens(prev, mi)[:, None], cfg, env, mode="decode",
        caches=c, cur_len=mi[JSt.ROW_CUR_LEN], block_tables=tb)[0][
            :, 0, :cfg.vocab_size].astype(jnp.float32))
    seen = {}

    def logged(p, c, prev, mi, mf, tb):
        lg = np.asarray(logits_of(p, c, prev, mi, mf, tb))
        nxt, new = step(p, c, prev, mi, mf, tb)
        for row, s in enumerate(pool._slots):
            if s is not None and not s.prefilling:
                assert int(lg[row].argmax()) == int(nxt[row])
                seen[(s.rid, s.tokens_done)] = lg[row]
        return nxt, new

    pool._decode[False] = logged
    return seen


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("arch,prompt_len,gen,n,seed", PARITY,
                         ids=["rg-ring-rolled", "rg-ring-short", "rwkv"])
def test_engine_greedy_tokens_equal_the_jax_engine(arch, prompt_len, gen, n,
                                                   seed):
    """Each request's tokens equal JAX's up to the first position where
    they differ, if any; there JAX's own logits must hold a near-tie: its
    top two within one bf16 ulp, and the port's token one of them. The
    two packages' f32 transcendentals round apart in the last bit on some
    CPUs (PyTorch's vectorised exp on AVX-512, see
    tests/test_torch_recurrent.py), which can flip such a tie: rg-ring-
    short's request 0 at its second token on such a CPU. A difference at
    any other position fails."""
    jcfg = get_smoke(arch)
    jeng = JaxEngine(jcfg, _params(arch)[0], num_slots=2,
                     prompt_len=prompt_len, max_gen=gen, block_size=8,
                     clock=JaxClock(), plan=PALLAS)
    assert jeng.prefill_chunk == 0
    seen = _record_jax_logits(jeng, jcfg)
    jout = jax_run(jeng, _requests(jax_request, arch, n, prompt_len, gen,
                                   seed), dt=0.05)
    eng = _engine(arch, prompt_len, gen)
    assert eng.prefill_chunk == 0, "recurrent state => classic admission"
    reqs = _requests(torch_request, arch, n, prompt_len, gen, seed)
    out = run_to_completion(eng, reqs, dt=0.05)
    assert sorted(out) == sorted(jout)
    for r in reqs:
        mine, ref = out[r.rid], jout[r.rid]
        assert len(mine) == len(ref)
        d = next((i for i, (a, b) in enumerate(zip(mine, ref)) if a != b),
                 None)
        if d is None:
            continue
        if d == 0:  # the first token: JAX's batch-1 prefill logits
            lg, _ = jeng.replica._prefill(
                jeng.params, {"tokens": jnp.asarray(r.prompt)[None]})
            lg = np.asarray(lg[0, :jcfg.vocab_size].astype(jnp.float32))
        else:
            lg = seen[(r.rid, d)]
        assert int(lg.argmax()) == ref[d]
        top = np.sort(lg)[::-1]
        ulp = _bf16_ulp(top[0])
        assert top[0] - top[1] <= ulp, (r.rid, d, top[:2])
        assert lg[mine[d]] >= top[0] - ulp, (r.rid, d, lg[mine[d]], top[0])
    eng.pool.release()


@pytest.mark.parametrize("arch,prompt_len,kv", [
    (RG, 24, "paged"), (RG, 8, "paged"), (RW, 16, "paged"), (RW, 16, "slot")])
def test_engine_equals_the_full_prefill_one_shot(arch, prompt_len, kv):
    """Staggered admissions and retirements over 2 slots: every token of
    the engine equals the one-shot batch's (full prefill, grown rings,
    contiguous decode) bit for bit."""
    gen = 7
    trace = poisson_trace(5, 12.0, prompt_len=prompt_len,
                          vocab_size=torch_smoke(arch).vocab_size,
                          gen_len=gen, seed=3)
    eng = _engine(arch, prompt_len, gen, kv=kv)
    out = run_to_completion(eng, trace, dt=0.05)
    base = serve_batch(torch_smoke(arch), _params(arch)[1],
                       np.stack([r.prompt for r in trace]), gen,
                       streamed_prefill=False, device="cpu")
    for r in trace:
        assert np.array_equal(base[r.rid], np.array(out[r.rid])), r.rid
    eng.pool.release()


def test_recurrent_pools_refuse_what_they_cannot_serve():
    cfg = torch_smoke(RG)
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(RG, 24, 6, prefill_chunk=8)
    with pytest.raises(ValueError, match="sliding-window"):
        make_kv_backend("slot", cfg, Env(), num_slots=2, prompt_len=24,
                        max_gen=6, device="cpu")
    # the int8 pool beside rings and state rows is served since the
    # quant-recurrent slice (tests/test_torch_quant_recurrent.py): both
    # archs build it, and it keeps refusing chunked lanes
    for arch, P in ((RG, 24), (RW, 16)):
        _engine(arch, P, 6, kv="quant").pool.release()
    with pytest.raises(ValueError, match="chunked prefill"):
        _engine(RG, 24, 6, kv="quant", prefill_chunk=8)


def test_block_manager_sizes_rings_and_state_rows():
    """A window arch gets one ring table per slot of ceil(min(w, prompt +
    gen) / bs) blocks and no global table; its state rows live in the
    pool at the slot's row; an attention-free arch's pool holds only the
    null block. Insert, read and evict round-trip, and release finds no
    leak."""
    cfg, params = torch_smoke(RG), _params(RG)[1]
    P, gen, bs = 24, 6, 8
    bm = BlockManager(cfg, Env(), num_slots=2, prompt_len=P, max_gen=gen,
                      block_size=bs, device="cpu")
    assert (bm.has_local, bm.has_global, bm.has_state) == (True, False, True)
    assert not bm.chunk_prefill_ok and not bm.prefix_cache
    assert bm.mb_global == 0 and bm.mb_local == 2  # ceil(16 / 8)
    assert bm.num_blocks == 1 + 2 * 2
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, P)))
    _, caches = St.make_prefill_step(cfg, Env())(params, {"tokens": tok})
    slot = bm.admit(0, gen)
    bm.insert(slot, 0, caches, gen)
    assert bm.info(slot).alloc_l == 2 and bm.info(slot).alloc_g == 0
    back = bm.read_slot(slot)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(caches)):
        assert torch.equal(got, want)
    bm.evict(slot, zero=True)
    assert float(bm.caches["tail"][0]["h"][slot].abs().max()) == 0.0
    bm.release()
    rw = BlockManager(torch_smoke(RW), Env(), num_slots=3, prompt_len=16,
                      max_gen=4, device="cpu")
    assert rw.num_blocks == 1 and rw.blocks_for(4) == 0
    assert rw.caches["blocks"][0]["s"].shape[1] == 3


@pytest.mark.parametrize("arch,argv", [
    (RG, ["--prompt-len", "24"]), (RW, []),
    (RW, ["--kv", "slot"]), (RG, ["--replicas", "2"])],
    ids=["rg", "rwkv", "rwkv-slot", "rg-fleet"])
def test_cli_serves_and_verifies(arch, argv, capsys):
    args = parse_args(["--smoke", "--device", "cpu", "--arch", arch,
                       "--requests", "8", "--verify"] + argv)
    run = run_trace(args, torch_smoke(arch), _params(arch)[1])
    assert run["rc"] == 0 and "MATCH" in run["verify"]
    assert "chunked prefill=off (classic)" in capsys.readouterr().out
    assert len(run["out"]) == 8
