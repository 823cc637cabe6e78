"""The int8 KV pool (`--kv quant`) for the recurrent archs, against the
JAX package on the CPU.

recurrentgemma-9b keeps its local layers' K/V in window rings of the int8
pool (values plus one f32 scale per (block, head, token)) beside its
RG-LRU state rows; rwkv6-1.6b has no attention, so its int8 pool holds
only the null block beside its state rows. Weights are the JAX package's
(`Mo.init_params(PRNGKey(0), ...)`) through the numpy bridge; inputs are
made with numpy from a seed; JAX runs its pallas plan (the quant kernel
in interpret mode) unless a test says otherwise.

Tolerances, and why:
- The quantizer is bit-equal to JAX's (the same f32 absmax / 127, round
  half to even): a prefill's K/V quantized and inserted into the ring
  reads back equal to JAX's int8 values and scales, bit for bit.
- One decode step over a random pool: logits within LOGIT_TOL = 3e-2
  (bf16 logits, attention sums in another order, as
  tests/test_torch_recurrent.py holds the bf16 pool); f32 states within
  STATE_TOL = 1e-4; the int8 rows the step writes within one step of
  JAX's and their scales within SCALE_TOL = 1e-2 relative (the K/V row
  is a bf16 value that may round one step apart after the scans).
- Served greedy tokens equal JAX's engine up to a first difference, if
  any, which must be a near-tie in JAX's own logits (its top two within
  one bf16 step, the port's token one of them), the rule of
  tests/test_torch_hybrid_serving.py.
- The CLI's verdicts (`--verify` at another slot count; `--replicas 2`
  against one engine) and its pool description print JAX's words.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ParallelPlan
from repro.core import VirtualCluster as JaxCluster
from repro.core.clock import ManualClock as JaxClock
from repro.launch import serve as jax_serve
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import ServingEngine as JaxEngine
from repro.serve import request as jax_request
from repro.serve import run_to_completion as jax_run
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch.serve import parse_args, run_trace
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.serve import QuantBlockManager, ServingEngine
from repro_torch.serve import request as torch_request
from repro_torch.serve import run_to_completion

PALLAS = ParallelPlan(fsdp=False, remat="full", attn_impl="pallas",
                      kv_cache="replicated")
RG, RW = "recurrentgemma-9b", "rwkv6-1.6b"
LOGIT_TOL = 3e-2
STATE_TOL = 1e-4
SCALE_TOL = 1e-2
_PARAMS = {}


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


def _params(arch):
    """(JAX params, the port's bridged copy) of the smoke config: the
    JAX CLI's own weights (PRNGKey(0); the draw reads no field of the
    plan)."""
    if arch not in _PARAMS:
        jp = JMo.init_params(jax.random.PRNGKey(0), jax_smoke(arch),
                             JEnv(mesh=None, plan=PALLAS))
        _PARAMS[arch] = (jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _PARAMS[arch]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _leaf_pairs(jtree, ttree):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(jl, tl)]


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.array, tree), "cpu")


# ---------------------------------------------------------------------------
# the pool: quantize-on-insert, ring tables, state rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,P", [(RG, 24), (RW, 16)])
def test_prefill_insert_quantizes_the_rings_as_jax_does(arch, P):
    """A batch-1 prefill (recurrentgemma-9b's 24 tokens roll its
    16-token ring) quantized by quantize_paged_request and inserted
    through the ring table: the pool's int8 values, f32 scales and state
    rows equal JAX's make_paged_insert of JAX's quantize_paged_request,
    bit for bit, and read_slot dequantizes what JAX's
    dequantize_paged_request gives."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jp, _ = _params(arch)
    env = JEnv(mesh=None, plan=PALLAS)
    tok = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (1, P)).astype(np.int32)
    _, jreq = jax.jit(JSt.make_prefill_step(jcfg, env))(
        jp, {"tokens": jnp.asarray(tok)})
    bs, slots, gen = 8, 2, 6
    pool = QuantBlockManager(cfg, Env(), num_slots=slots, prompt_len=P,
                             max_gen=gen, block_size=bs, device="cpu")
    slot = pool.admit(0, gen)
    pool.insert(slot, 0, _to_torch(jreq), gen)
    tg, tl = pool._tables_of(slot)
    jpool = JMo.init_paged_cache(jcfg, env, slots, pool.num_blocks, bs,
                                 quant=True)
    jpool = JMo.make_paged_insert(jcfg, bs)(
        jpool, JMo.quantize_paged_request(jcfg, jreq), slot,
        jnp.asarray(tg.numpy()), jnp.asarray(tl.numpy()))
    names = set()
    for path, want, got in _leaf_pairs(jpool, pool.caches):
        names.add(path.split("'")[-2])
        want = np.asarray(want)
        assert str(got.dtype) == f"torch.{want.dtype.name}", path
        assert np.array_equal(want.view(np.uint8),
                              got.contiguous().view(torch.uint8).numpy()), path
    if arch == RG:
        assert {"k", "v", "k_scale", "v_scale", "h", "conv"} <= names
        assert pool.caches["blocks"][2]["k"].dtype == torch.int8
        ring = pool.info(slot).alloc_l
        assert ring == 2 and pool.info(slot).alloc_g == 0  # ceil(16 / 8)
    else:
        assert pool.num_blocks == 1 and "k" not in names
    back = pool.read_slot(slot)
    valid = lambda width, n: jnp.arange(width) < n
    jback = JMo.dequantize_paged_request(jcfg, JMo.make_paged_read(jcfg)(
        jpool, slot, jnp.asarray(tg.numpy()), jnp.asarray(tl.numpy()),
        valid(pool.table.shape[1], pool.info(slot).alloc_g),
        valid(pool.table_local.shape[1], pool.info(slot).alloc_l)))
    for path, want, got in _leaf_pairs(jback, back):
        assert np.array_equal(_f32(want), _f32(got)), path
    pool.evict(slot)
    pool.release()


def test_decode_after_the_ring_wraps_matches_jax():
    """One decode step of recurrentgemma-9b over a random int8 pool
    (values, scales, states): depths 0, 9 and 40, the last past the
    16-token window, so it writes at 40 % 16 and attends over the whole
    ring (lengths min(cur_len, window - 1)). Logits and states against
    JAX's quant decode; the rows the step writes against JAX's."""
    jcfg, cfg = jax_smoke(RG), get_smoke(RG)
    jp, tp = _params(RG)
    B, NB, bs, MB = 3, 12, 8, 2
    rng = np.random.default_rng(5)

    def draw(x):
        if x.dtype == jnp.int8:
            return jnp.asarray(rng.integers(-127, 128, x.shape), jnp.int8)
        v = rng.standard_normal(x.shape).astype(np.float32)
        if x.dtype == jnp.float32 and x.ndim == 4:  # [L,NB,H,bs] scales
            v = np.abs(v) / 127
        return jnp.asarray(v).astype(x.dtype)

    pool = jax.tree.map(draw, JMo.init_paged_cache(
        jcfg, JEnv(mesh=None, plan=PALLAS), B, NB, bs, quant=True))
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    tables = tables.astype(np.int32)
    cl = np.asarray([0, 9, 40], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    bt = {"global": tables, "local": tables}
    jl, jc, _ = jax.jit(lambda p, c, t, l, b: JMo.forward(
        p, t, jcfg, JEnv(mesh=None, plan=PALLAS), mode="decode", caches=c,
        cur_len=l, block_tables=b))(jp, pool, tok, cl, bt)
    tpool = _to_torch(pool)
    before = _to_torch(pool)
    tl, tc = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(), caches=tpool,
                        cur_len=torch.from_numpy(cl),
                        block_tables={k: torch.from_numpy(v)
                                      for k, v in bt.items()})
    assert float(np.abs(_f32(tl)[:, 0] - _f32(jl)[:, 0]).max()) < LOGIT_TOL
    phys = tables[np.arange(B), (cl % jcfg.local_window) // bs]
    off = cl % bs
    for (path, want, got), (_, _, old) in zip(_leaf_pairs(jc, tc),
                                              _leaf_pairs(pool, before)):
        if path.endswith("['k']") or path.endswith("['v']"):  # int8
            want, got = np.asarray(want, np.int32), got.numpy().astype(
                np.int32)
            diff = np.abs(want - got)
            assert diff.max() <= 1, path
            written = np.zeros(diff.shape, bool)
            written[:, phys, :, off] = True
            assert not diff[~written].any(), path
            assert not np.array_equal(got, old.numpy()), path
        elif "scale" in path:
            assert np.allclose(_f32(got), _f32(want), rtol=SCALE_TOL,
                               atol=0), path
        elif got.dtype == torch.float32:  # the RG-LRU's h
            assert np.abs(_f32(want) - _f32(got)).max() <= STATE_TOL, path


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------


def _requests(mod, vocab, n, prompt_len, gen, seed):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(
        0, vocab, (prompt_len,), dtype=np.int32), gen_len=gen,
        arrival_t=0.05 * i) for i in range(n)]


def _record_jax_logits(jeng, cfg):
    """Every greedy decode step of JAX's engine also records, per
    (request id, token index), the logits row it took the argmax of (a
    jitted copy of the step's forward runs on the same arguments first:
    the step donates its caches)."""
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
                seen[(s.rid, s.tokens_done)] = lg[row]
        return nxt, new

    pool._decode[False] = logged
    return seen


@pytest.mark.parametrize("arch,prompt_len,gen,n", [
    (RG, 24, 6, 3), (RG, 8, 12, 3), (RW, 16, 8, 4)],
    ids=["rg-ring-rolled", "rg-ring-wraps-in-decode", "rwkv"])
def test_quant_engine_greedy_tokens_equal_the_jax_quant_engine(
        arch, prompt_len, gen, n):
    """Classic admission into the int8 pool over 2 slots, staggered
    arrivals; each request's tokens against JAX's quant engine under the
    near-tie rule of the module docstring."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    jp, tp = _params(arch)
    jeng = JaxEngine(jcfg, jp, num_slots=2, prompt_len=prompt_len,
                     max_gen=gen, block_size=8, kv="quant",
                     clock=JaxClock(), plan=PALLAS)
    seen = _record_jax_logits(jeng, jcfg)
    jout = jax_run(jeng, _requests(jax_request, jcfg.vocab_size, n,
                                   prompt_len, gen, 4), dt=0.05)
    eng = ServingEngine(cfg, tp, num_slots=2, prompt_len=prompt_len,
                        max_gen=gen, block_size=8, kv="quant",
                        clock=ManualClock(), device="cpu")
    assert eng.prefill_chunk == 0 and eng.pool.kind == "quant"
    assert eng.pool.describe() == jeng.replica.pool.describe()
    reqs = _requests(torch_request, cfg.vocab_size, n, prompt_len, gen, 4)
    out = run_to_completion(eng, reqs, dt=0.05)
    assert sorted(out) == sorted(jout)
    for r in reqs:
        mine, ref = out[r.rid], jout[r.rid]
        assert len(mine) == len(ref) == gen
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
        top = np.sort(lg)[::-1]
        ulp = 2.0 ** (np.floor(np.log2(abs(top[0]))) - 7)
        assert top[0] - top[1] <= ulp, (r.rid, d, top[:2])
        assert lg[mine[d]] >= top[0] - ulp, (r.rid, d)
    snap = eng.snapshot()
    assert snap["kv_quant_divergence"] == pytest.approx(
        jeng.snapshot()["kv_quant_divergence"], rel=1e-5)
    eng.pool.release()


CLI = [(RG, []), (RG, ["--replicas", "2"]), (RW, []),
       (RW, ["--replicas", "2"])]


@pytest.mark.parametrize("arch,extra", CLI,
                         ids=["rg", "rg-fleet", "rwkv", "rwkv-fleet"])
def test_cli_verdicts_print_the_jax_clis_words(arch, extra, monkeypatch,
                                               capsys):
    """`--kv quant --verify` on the smoke config, 4 requests of 16
    tokens, gen 8: one engine against a fresh one at half the slots, or
    a 2-replica fleet against one engine. The port's run on the JAX
    CLI's weights prints JAX's pool line, its verdict and its tokens."""
    argv = ["--arch", arch, "--smoke", "--kv", "quant", "--requests", "4",
            "--prompt-len", "16", "--gen", "8", "--verify"] + extra
    seen = {}
    serve = JaxCluster.serve

    def spy(self, engine, requests=(), **kw):
        out = serve(self, engine, requests, **kw)
        seen["out"] = out
        return out

    monkeypatch.setattr(JaxCluster, "serve", spy)
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    assert jax_serve.main() == 0
    jax_log = capsys.readouterr().out
    run = run_trace(parse_args(argv + ["--device", "cpu"]), get_smoke(arch),
                    _params(arch)[1])
    log = capsys.readouterr().out
    assert run["rc"] == 0
    jverdict = [ln for ln in jax_log.splitlines() if ln.startswith("verify")]
    assert [run["verify"]] == jverdict
    assert "bit-identical MATCH" in run["verify"]
    plane = lambda text: next(ln for ln in text.splitlines()
                              if "int8 quant KV" in ln)
    assert plane(jax_log).split(", chunked")[0] in plane(log)
    assert run["out"] == seen["out"]
