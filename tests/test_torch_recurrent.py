"""The port's recurrent slice against the JAX package on the CPU.

Configs: the port's copies of recurrentgemma-9b and rwkv6-1.6b describe
the same models (CONFIG and smoke()). Kernels: the plain versions of the
RG-LRU scan and the WKV6 recurrence (the CPU path of kernels/rglru and
kernels/rwkv6) against the JAX package's sequential oracles and its
Pallas kernels in interpret mode, at tests/test_kernels.py's shapes,
within its 2e-3; at S=100, which JAX's kernels and its chunked RWKV
prefill refuse (an S % chunk assert), against the sequential oracles
alone. Blocks and model: on weights bridged from the JAX package
(`Mo.init_params(PRNGKey(0), ...)`), rglru_block, rwkv_time_mix and
rwkv_channel_mix in prefill and decode, and forward's prefill and decode
logits for both smoke configs, against the JAX functions under the
pallas plan. bf16 outputs are held within 1/32 (two bf16 steps at
magnitudes up to 4: the scans sum in another order than JAX's
associative and chunked scans, which moves an f32 state by ~1e-6 and can
push a bf16 rounding the other way), f32 states within 1e-4, logits
within 3e-2; a 256-token prefill looser, as PREFILLS says why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.kernels.rglru.ops import rglru_scan as jax_rglru_kernel
from repro.kernels.rglru.ref import rglru_ref_loop as jax_rglru_loop
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6_kernel
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import model as JMo
from repro.models import recurrent as JR
from repro.models.env import Env as JEnv
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke as torch_smoke
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models import model as Mo
from repro_torch.models import recurrent as R
from repro_torch.models.env import Env

ARCHS = ("recurrentgemma-9b", "rwkv6-1.6b")
PALLAS = JEnv(mesh=None, plan=ParallelPlan(fsdp=False, remat="full",
                                           attn_impl="pallas",
                                           kv_cache="replicated"))
BF16_TOL = 1 / 32
STATE_TOL = 1e-4
LOGIT_TOL = 3e-2
_PARAMS = {}


def _params(arch):
    """(JAX params, bridged torch params) of the smoke config, cached."""
    if arch not in _PARAMS:
        jp = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch), PALLAS)
        _PARAMS[arch] = (jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _PARAMS[arch]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _maxdiff(a, b):
    return float(np.abs(_f32(a) - _f32(b)).max())


def _bf16_pair(rng, shape):
    """The same bf16 values for both packages."""
    x = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(
        jnp.bfloat16)
    return x, torch.from_numpy(_f32(x)).to(torch.bfloat16)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_equal_the_jax_configs(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (torch_smoke(arch), get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_blocks == ref.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_jax_tree_shapes_and_dtypes(arch):
    jp, tp = _params(arch)
    own = Mo.init_params(torch_smoke(arch), Env(), seed=0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(own))
    for (path, jl), tl, ol in zip(jleaves, jax.tree.leaves(tp),
                                  jax.tree.leaves(own)):
        assert tuple(ol.shape) == tuple(tl.shape) == tuple(jl.shape), path
        assert ol.dtype == tl.dtype, path


# ---------------------------------------------------------------------------
# kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,S,W,bt,bw,decay", [
    pytest.param(*c, None, id="-".join(map(str, c))) for c in (
        (2, 128, 64, 32, 64), (1, 256, 128, 64, 128), (2, 64, 256, 16, 128))
] + [pytest.param(1, 128, 64, 32, 64, 6.0, id="strong-decay-6"),
     pytest.param(2, 64, 128, 16, 128, 0.01, id="weak-decay-0.01")])
def test_rglru_scan_matches_the_jax_oracle_and_kernel(B, S, W, bt, bw,
                                                      decay):
    """decay None: a uniform in [0.05, 0.999]; else, as
    tests/test_kernels.py's extreme-decay property, a = exp(-decay * U)
    with U uniform in [0.5, 1]."""
    rng = np.random.default_rng(S + W)
    a = (rng.uniform(0.05, 0.999, (B, S, W)) if decay is None else np.exp(
        -decay * rng.uniform(0.5, 1.0, (B, S, W)))).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    got = rglru_scan(*map(torch.from_numpy, (a, b, h0)))
    assert got.shape == (B, S, W) and got.dtype == torch.float32
    assert _maxdiff(got, jax_rglru_loop(a, b, h0)) < 2e-3
    assert _maxdiff(got, jax_rglru_kernel(a, b, h0, block_t=bt, block_w=bw,
                                          interpret=True)) < 2e-3
    # without h0 the recurrence starts from zeros
    assert _maxdiff(rglru_scan(torch.from_numpy(a), torch.from_numpy(b)),
                    jax_rglru_loop(a, b)) < 2e-3


@pytest.mark.parametrize("B,S,H,hd,chunk,strong", [
    pytest.param(*c, False, id="-".join(map(str, c))) for c in (
        (2, 128, 2, 32, 32), (1, 64, 4, 64, 16), (1, 96, 1, 16, 32))
] + [pytest.param(*c, True, id="strong-decay-" + "-".join(map(str, c)))
     for c in ((2, 128, 2, 32, 16), (1, 64, 4, 64, 16))])
def test_wkv6_matches_the_jax_oracle_and_kernel(B, S, H, hd, chunk, strong):
    """strong: each channel's decay fixed over time, logw = -exp(x) with x
    uniform in [-20, 8] per (head, channel), the whole range the model's
    rwkv_decay clamp allows (w from exp(-2981) = 0 to 1 - 2e-9): finite,
    and within 2e-3 of both JAX functions. JAX's chunked kernel drifts
    from its own oracle at such decays as its chunk grows (the test below
    pins it), so the strong cases run it at 16-step chunks."""
    rng = np.random.default_rng(S + hd)
    mk = lambda: (rng.standard_normal((B, S, H, hd)) * 0.5).astype(
        np.float32)
    r, k, v = mk(), mk(), mk()
    logw = (-np.exp(np.broadcast_to(rng.uniform(-20.0, 8.0, (H, hd)),
                                    (B, S, H, hd))).astype(np.float32)
            if strong else -np.exp(mk() - 1.0))
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    o, s = wkv6(*map(torch.from_numpy, (r, k, v, logw, u)))
    assert o.shape == (B, S, H, hd) and s.shape == (B, H, hd, hd)
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    jo, js = jax_wkv6_kernel(r, k, v, logw, u, chunk=chunk, interpret=True)
    assert _maxdiff(o, jo) < 2e-3 and _maxdiff(s, js) < 2e-3
    ro, rs = jax_wkv6_ref(*(x.transpose(0, 2, 1, 3) for x in (r, k, v,
                                                               logw)), u)
    assert _maxdiff(o, np.asarray(ro).transpose(0, 2, 1, 3)) < 2e-3
    assert _maxdiff(s, rs) < 2e-3


def test_jax_chunked_wkv6_drifts_at_strong_decays_and_the_port_does_not():
    """A reference-side finding, pinned. JAX's wkv6_kernel sums a chunk's
    log decays in f32 (kernel.py: L = cumsum(lw)) and takes each pairwise
    weight as exp(Lprev_t - L_s). At logw near -2981 the sum reaches
    ~2981 x chunk, where one f32 ulp is ~1e-2, so the weight of the
    previous step, exactly exp(0) = 1, comes out up to ~1% off. At 64-step
    chunks its output leaves its own sequential oracle by more than the
    2e-3 bound; the port's op, which takes w one step at a time, stays
    within 1e-4 of that oracle."""
    rng = np.random.default_rng(7)
    B, S, H, hd = 1, 64, 2, 64
    mk = lambda: (rng.standard_normal((B, S, H, hd)) * 0.5).astype(
        np.float32)
    r, k, v = mk(), mk(), mk()
    logw = -np.exp(np.broadcast_to(rng.uniform(-20.0, 8.0, (H, hd)),
                                   (B, S, H, hd))).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    ro, _ = jax_wkv6_ref(*(x.transpose(0, 2, 1, 3) for x in (r, k, v,
                                                             logw)), u)
    ro = np.asarray(ro).transpose(0, 2, 1, 3)
    jo, _ = jax_wkv6_kernel(r, k, v, logw, u, chunk=64, interpret=True)
    o, _ = wkv6(*map(torch.from_numpy, (r, k, v, logw, u)))
    assert _maxdiff(jo, ro) > 2e-3
    assert _maxdiff(o, ro) < 1e-4


def test_ragged_length_is_refused_by_jax_and_taken_by_the_port():
    """S = 100 is no multiple of JAX's 64-step chunk: its Pallas kernels
    and its chunked RWKV prefill assert; the port's ops (plain versions
    here, kernels on the card) take it and match the sequential oracles."""
    rng = np.random.default_rng(100)
    B, S, W, H, hd = 1, 100, 32, 2, 16
    a = rng.uniform(0.5, 0.99, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    with pytest.raises(AssertionError):
        jax_rglru_kernel(a, b, interpret=True)
    assert _maxdiff(rglru_scan(torch.from_numpy(a), torch.from_numpy(b)),
                    jax_rglru_loop(a, b)) < 2e-3
    mk = lambda: (rng.standard_normal((B, S, H, hd)) * 0.5).astype(
        np.float32)
    r, k, v, logw = mk(), mk(), mk(), -np.exp(mk() - 1.0)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    with pytest.raises(AssertionError):
        jax_wkv6_kernel(r, k, v, logw, u, interpret=True)
    with pytest.raises(AssertionError):
        JR.rwkv_time_mix_chunked(r, k, v, logw, u, chunk=64)
    o, s = wkv6(*map(torch.from_numpy, (r, k, v, logw, u)))
    ro, rs = jax_wkv6_ref(*(x.transpose(0, 2, 1, 3) for x in (r, k, v,
                                                               logw)), u)
    assert _maxdiff(o, np.asarray(ro).transpose(0, 2, 1, 3)) < 2e-3
    assert _maxdiff(s, rs) < 2e-3


def test_wkv6_plain_version_matches_the_jax_chunked_prefill():
    """The port's prefill recurrence against the function JAX's model
    runs (rwkv_time_mix_chunked), within tests/test_models.py's 1e-3."""
    rng = np.random.default_rng(7)
    B, S, H, hd = 2, 128, 2, 16
    mk = lambda: (rng.standard_normal((B, S, H, hd)) * 0.5).astype(
        np.float32)
    r, k, v, logw = mk(), mk(), mk(), -np.exp(mk() - 1.0)
    u = (rng.standard_normal((H, hd)) * 0.3).astype(np.float32)
    o, s = wkv6(*map(torch.from_numpy, (r, k, v, logw, u)))
    jo, js = JR.rwkv_time_mix_chunked(r, k, v, logw, u, chunk=64)
    assert _maxdiff(o, jo.astype(jnp.float32)) < 1e-3
    assert _maxdiff(s, js) < 1e-3


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _unit_params(arch, name):
    jp, tp = _params(arch)
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0][name]),
            {k: v[0] for k, v in tp["blocks"][0][name].items()})


@pytest.mark.parametrize("S", [24, 2])
def test_rglru_block_matches_jax_in_prefill_and_decode(S):
    """S=2 is shorter than the conv window (the state's conv tail is
    left-padded)."""
    arch = "recurrentgemma-9b"
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    pj, pt = _unit_params(arch, "rec")
    xj, xt = _bf16_pair(np.random.default_rng(S), (2, S, jcfg.d_model))
    yj, sj = jax.jit(lambda p, x: JR.rglru_block(
        p, x, jcfg, PALLAS, None, return_state=True))(pj, xj)
    yt, st = R.rglru_block(pt, xt, cfg, None, return_state=True)
    assert yt.dtype == torch.bfloat16 and _maxdiff(yt, yj) <= BF16_TOL
    assert _maxdiff(st["h"], sj["h"]) < STATE_TOL
    assert np.array_equal(_f32(st["conv"]), _f32(sj["conv"]))
    # one decode step from the JAX state
    state = {"h": torch.from_numpy(_f32(sj["h"])), "conv": st["conv"]}
    y1j, s1j = jax.jit(lambda p, x, s: JR.rglru_block(
        p, x, jcfg, PALLAS, s))(pj, xj[:, :1], sj)
    y1t, s1t = R.rglru_block(pt, xt[:, :1], cfg, state)
    assert _maxdiff(y1t, y1j) <= BF16_TOL
    assert _maxdiff(s1t["h"], s1j["h"]) < STATE_TOL
    assert np.array_equal(_f32(s1t["conv"]), _f32(s1j["conv"]))


def test_rwkv_mixes_match_jax_in_prefill_and_decode():
    arch = "rwkv6-1.6b"
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    pj, pt = _unit_params(arch, "mix")
    xj, xt = _bf16_pair(np.random.default_rng(3), (2, 64, jcfg.d_model))
    yj, sj = jax.jit(lambda p, x: JR.rwkv_time_mix(
        p, x, jcfg, PALLAS, None, return_state=True))(pj, xj)
    yt, st = R.rwkv_time_mix(pt, xt, cfg, None, return_state=True)
    assert _maxdiff(yt, yj) <= BF16_TOL
    assert _maxdiff(st["s"], sj["s"]) < STATE_TOL
    assert np.array_equal(_f32(st["tm_prev"]), _f32(sj["tm_prev"]))
    cj, cmj = jax.jit(lambda p, x: JR.rwkv_channel_mix(
        p, x, jcfg, PALLAS, None, return_state=True))(pj, xj)
    ct, cmt = R.rwkv_channel_mix(pt, xt, cfg, None, return_state=True)
    assert _maxdiff(ct, cj) <= BF16_TOL
    assert np.array_equal(_f32(cmt), _f32(cmj))
    state_j = {"s": sj["s"], "tm_prev": sj["tm_prev"], "cm_prev": cmj}
    state_t = {"s": torch.from_numpy(_f32(sj["s"])), "tm_prev": st["tm_prev"],
               "cm_prev": cmt}
    x1j, x1t = _bf16_pair(np.random.default_rng(4), (2, 1, jcfg.d_model))
    y1j, n1j = jax.jit(lambda p, x, s: JR.rwkv_time_mix(
        p, x, jcfg, PALLAS, s))(pj, x1j, state_j)
    y1t, n1t = R.rwkv_time_mix(pt, x1t, cfg, state_t)
    assert _maxdiff(y1t, y1j) <= BF16_TOL
    assert _maxdiff(n1t["s"], n1j["s"]) < STATE_TOL
    c1j, _ = jax.jit(lambda p, x, s: JR.rwkv_channel_mix(
        p, x, jcfg, PALLAS, s))(pj, x1j, state_j)
    c1t, _ = R.rwkv_channel_mix(pt, x1t, cfg, state_t)
    assert _maxdiff(c1t, c1j) <= BF16_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)).astype(x.dtype), tree)


def _to_torch(tree):
    return bridge.to_torch(jax.tree.map(np.array, tree), "cpu")


def _leaf_pairs(jtree, ttree):
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = jax.tree.leaves(ttree)
    assert len(jl) == len(tl)
    return [(jax.tree_util.keystr(p), a, b) for (p, a), b in zip(jl, tl)]


# (arch, S, logit tolerance, f32 state tolerance)
PREFILLS = [("recurrentgemma-9b", 24, LOGIT_TOL, STATE_TOL),
            ("recurrentgemma-9b", 8, LOGIT_TOL, STATE_TOL),
            ("rwkv6-1.6b", 24, LOGIT_TOL, STATE_TOL),
            # 256 steps: the sequential scans and JAX's associative scan
            # round apart in the last f32 bits; over 256 positions a few
            # bf16 roundings of block outputs land the other way, and the
            # recurrences carry each such step to every later position
            # (the first 48 positions are bit-equal; JAX's own naive and
            # pallas plans differ by 4.7e-2 in these logits)
            ("recurrentgemma-9b", 256, 1 / 16, 2e-2)]


def _rglru_gates_f64_transcendentals(p, u):
    """R._rglru_gates with each exp and log1p taken in f64 and rounded
    once to f32 (products, sums and sqrt as in the port)."""
    ex = lambda x: torch.exp(x.double()).float()
    sig = lambda z: 1 / (1 + ex(-z))
    r = sig(R._block_diag_matmul(u, p["w_rgate"].float()))
    i = sig(R._block_diag_matmul(u, p["w_igate"].float()))
    lam = p["lam"]
    softplus = torch.clamp_min(lam, 0.0) + torch.log1p(
        torch.exp(-lam.abs().double())).float()
    log_a = -R._RGLRU_C * softplus * r
    mult = torch.sqrt(torch.clamp_min(1.0 - ex(2.0 * log_a), 1e-12))
    return ex(log_a), mult * (i * u)


@pytest.mark.parametrize("arch,S,tol,state_tol", PREFILLS,
                         ids=["rg-24", "rg-8", "rwkv-24", "rg-256-flash"])
def test_prefill_logits_and_caches_match_jax(arch, S, tol, state_tol,
                                             monkeypatch):
    """S=24 rolls the 16-token window ring, S=8 keeps a short ring, S=256
    takes the flash branch (JAX's Pallas kernel in interpret mode, with
    the window).

    The f32 state leaves are held to max(state_tol, twice a spread
    measured here): the port's own states with the RG-LRU gates' exp and
    log1p taken in f64 and rounded once, against the port as it stands.
    PyTorch's vectorised f32 exp is not correctly rounded on every CPU
    (on AVX-512, exp(-0.11358591) gives 0.89262754 where XLA and the f64
    value round to 0.8926275), and 1 - exp(2 log_a) in the gates turns a
    last-bit difference into a few ulps of b. At S=8 that moves one bf16
    rounding of gate * h in the tail's first block, and the last block's
    state by 3.158e-4 against JAX's; the f64 gates move it by the same
    3.158e-4 (so the tolerance reads 6.3e-4) and land within 1.5e-7 of
    JAX's. On a CPU where the two exps agree the spread is ~5e-7 and
    state_tol holds."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp, tp = _params(arch)
    B = 1 if S > 128 else 2
    tok = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S))
    tok = tok.astype(np.int32)
    jl, jc, _ = jax.jit(lambda p, t: JMo.forward(
        p, t, jcfg, PALLAS, mode="prefill"))(jp, tok)
    tl, tc = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(),
                        mode="prefill")
    with monkeypatch.context() as m:
        m.setattr(R, "_rglru_gates", _rglru_gates_f64_transcendentals)
        _, tc64 = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(),
                             mode="prefill")
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    assert _maxdiff(tl, jl) < tol
    for (path, a, b), b64 in zip(_leaf_pairs(jc, tc), jax.tree.leaves(tc64)):
        assert tuple(b.shape) == a.shape, path
        if b.dtype == torch.float32:
            leaf_tol = max(state_tol, 2 * _maxdiff(b64, b))
        else:
            leaf_tol = BF16_TOL
        assert _maxdiff(b, a) <= leaf_tol, path
    last, _ = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(),
                         mode="prefill", last_only=True)
    assert torch.equal(last, tl[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_logits_and_caches_match_jax(arch):
    """One decode step over a paged pool with random K/V and states:
    depths 0, 9 and 40 (the last wraps the 16-token window ring)."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp, tp = _params(arch)
    B, NB, bs, MB = 3, 12, 8, 2
    pool = _random_like(JMo.init_paged_cache(jcfg, PALLAS, B, NB, bs), 3)
    rng = np.random.default_rng(5)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    tables = tables.astype(np.int32)
    cl = np.asarray([0, 9, 40], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    bt = {"global": tables, "local": tables}
    jl, jc, _ = jax.jit(lambda p, c, t, l, b: JMo.forward(
        p, t, jcfg, PALLAS, mode="decode", caches=c, cur_len=l,
        block_tables=b))(jp, pool, tok, cl, bt)
    tpool = _to_torch(pool)
    tl, tc = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(), caches=tpool,
                        cur_len=torch.from_numpy(cl),
                        block_tables={k: torch.from_numpy(v)
                                      for k, v in bt.items()})
    assert tl.shape == (B, 1, jcfg.vocab_size)
    assert _maxdiff(tl, jl) < LOGIT_TOL
    for path, a, b in _leaf_pairs(jc, tc):
        tol = STATE_TOL if b.dtype == torch.float32 else BF16_TOL
        assert _maxdiff(b, a) <= tol, path


def test_contiguous_decode_matches_jax_on_rwkv():
    """rwkv has no attention, so the contiguous decode computes what
    JAX's does (a local unit's contiguous decode would differ: JAX's
    attention_decode rounds probabilities to bf16, see ROADMAP queue 3)."""
    arch = "rwkv6-1.6b"
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp, tp = _params(arch)
    cache = _random_like(JMo.init_cache(jcfg, PALLAS, 3, 20), 1)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 1))
    tok = tok.astype(np.int32)
    cl = np.asarray([0, 7, 19], np.int32)
    jl, jc, _ = jax.jit(lambda p, c, t, l: JMo.forward(
        p, t, jcfg, PALLAS, mode="decode", caches=c, cur_len=l))(
            jp, cache, tok, cl)
    tl, tc = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(),
                        caches=_to_torch(cache), cur_len=torch.from_numpy(cl))
    assert _maxdiff(tl, jl) < LOGIT_TOL
    for path, a, b in _leaf_pairs(jc, tc):
        tol = STATE_TOL if b.dtype == torch.float32 else BF16_TOL
        assert _maxdiff(b, a) <= tol, path


def test_decode_rows_past_the_batch_leave_the_state_alone():
    """A decode step pads its rows to a whole row tile: the padding rows
    read zeros and write no state row, and a row's logits and state do
    not depend on the rows beside it."""
    arch = "recurrentgemma-9b"
    cfg = torch_smoke(arch)
    _, tp = _params(arch)
    B, bs, NB = 3, 8, 8
    pool = _to_torch(_random_like(JMo.init_paged_cache(
        get_smoke(arch), PALLAS, B, NB, bs), 9))
    tables = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    bt = {"global": tables, "local": tables}
    tok = torch.tensor([[5], [7], [11]])
    cl = torch.tensor([3, 12, 30])
    before = jax.tree.map(lambda t: t.clone(), pool)
    full, after = Mo.forward(tp, tok, cfg, Env(), caches=pool, cur_len=cl,
                             block_tables=bt)
    for x, y in zip(jax.tree.leaves(before["blocks"][0]),
                    jax.tree.leaves(after["blocks"][0])):
        assert x.shape == y.shape  # the state rows stay B rows
    one = jax.tree.map(lambda t: t.clone(), before)
    one = {"blocks": tuple({n: x[:, 1:2].clone() if n in ("h", "conv")
                            else x for n, x in u.items()}
                           for u in one["blocks"]),
           "tail": tuple({n: x[1:2].clone() for n, x in u.items()}
                         for u in one["tail"])}
    alone, one = Mo.forward(tp, tok[1:2], cfg, Env(), caches=one,
                            cur_len=cl[1:2],
                            block_tables={k: v[1:2] for k, v in bt.items()})
    assert torch.equal(alone[0], full[1])
    assert torch.equal(one["tail"][0]["h"][0], after["tail"][0]["h"][1])
    with pytest.raises(ValueError, match="state rows"):
        Mo.forward(tp, tok[:2], cfg, Env(), caches=before, cur_len=cl[:2],
                   block_tables={k: v[:2] for k, v in bt.items()})


def test_rwkv_decode_row_does_not_depend_on_its_batch():
    """The WKV step runs on the real rows alone (the GEMMs on the padded
    row tile): a row decoded beside two others and alone gives the same
    logits and the same state, bit for bit."""
    arch = "rwkv6-1.6b"
    cfg = torch_smoke(arch)
    _, tp = _params(arch)
    cache = _to_torch(_random_like(JMo.init_cache(get_smoke(arch), PALLAS,
                                                  3, 20), 4))
    tok = torch.tensor([[5], [7], [11]])
    cl = torch.tensor([0, 7, 19])
    one = jax.tree.map(lambda t: t[:, 1:2].clone(), {"blocks": cache[
        "blocks"], "tail": ()})
    full, after = Mo.forward(tp, tok, cfg, Env(), caches=cache, cur_len=cl)
    alone, one = Mo.forward(tp, tok[1:2], cfg, Env(), caches=one,
                            cur_len=cl[1:2])
    assert torch.equal(alone[0], full[1])
    for x, y in zip(jax.tree.leaves(one), jax.tree.leaves(after)):
        assert x.shape[1] == 1 and y.shape[1] == 3
        assert torch.equal(x[:, 0], y[:, 1])
