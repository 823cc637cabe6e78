"""The port's four dense attention archs and two MoE archs against the
JAX package, on their smoke configs (CPU).

yi-9b, granite-3-8b (an odd vocabulary), qwen3-32b (qk-norm), qwen2-1.5b
(qkv bias, three query heads), grok-1-314b (8 experts top-2) and
llama4-scout-17b-a16e (16 experts top-1; smoke: 4 experts). Weights are
the JAX package's (`Mo.init_params(PRNGKey(0), ...)`) through the numpy
bridge; inputs are made with numpy from a seed; JAX runs its pallas plan
(the paged kernel in interpret mode), as its own tests run it.

Tolerances: logits within 3e-2 (bf16 logits, sums in another order, as
tests/test_torch_model.py); the MoE layer's routing (experts, ranks, kept
set, drop count) exactly, its gates within 1e-6 (f32 softmax of the same
f32 logits) and its bf16 output within 1/32 (a few bf16 roundings of
values of order one). The served-token parity with JAX's engine lives in
tests/test_torch_zoo_serving.py.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.kernels.paged_decode.ops import paged_flash_decode as jax_paged
from repro.launch import serve as jax_cli
from repro.models import model as JMo
from repro.models import moe as JM
from repro.models.env import Env as JEnv
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.kernels.paged_decode.ops import GROUPS, paged_flash_decode
from repro_torch.launch import serve as torch_cli
from repro_torch.models import layers as L
from repro_torch.models import model as Mo
from repro_torch.models import moe as M
from repro_torch.models.env import Env, vocab_pad

DENSE = ("yi-9b", "granite-3-8b", "qwen3-32b", "qwen2-1.5b")
MOE = ("grok-1-314b", "llama4-scout-17b-a16e")
ARCHS = DENSE + MOE
PALLAS = JEnv(mesh=None, plan=ParallelPlan(fsdp=False, remat="full",
                                           attn_impl="pallas",
                                           kv_cache="replicated"))
LOGIT_TOL = 3e-2
BF16_TOL = 1 / 32
GATE_TOL = 1e-6
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


def _bf16_pair(x):
    """The same bf16 values for both packages, from f32 numpy x."""
    j = jnp.asarray(x.astype(np.float32)).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(_f32(j))).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_equal_the_jax_configs(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (torch_smoke(arch), get_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_blocks == ref.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_jax_tree_shapes_and_dtypes(arch):
    """qk-norm's f32 [hd] scales, the qkv biases and the MoE leaves (f32
    router, bf16 experts stacked on a layer axis) included."""
    jp, tp = _params(arch)
    own = Mo.init_params(torch_smoke(arch), Env(), seed=0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) == len(jax.tree.leaves(own))
    for (path, jl), tl, ol in zip(jleaves, jax.tree.leaves(tp),
                                  jax.tree.leaves(own)):
        assert tuple(ol.shape) == tuple(tl.shape) == tuple(jl.shape), path
        assert ol.dtype == tl.dtype, path
    if get_smoke(arch).qk_norm:
        assert own["blocks"][0]["attn"]["q_norm"].dtype == torch.float32


def _init_params_by_stacking(cfg, seed):
    """init_params as it was built before its stacked leaves were filled
    in place: every layer's tree drawn, then torch.stack-ed."""
    env = Env()
    gen = torch.Generator().manual_seed(seed)
    d, vp = cfg.d_model, vocab_pad(cfg, env)
    return {
        "embed": L.dense_init(gen, vp, d),
        "blocks": tuple(Mo._stack([Mo._init_block(kind, gen, cfg, env)
                                   for _ in range(cfg.num_blocks)])
                        for kind in cfg.block_pattern),
        "tail": tuple(Mo._init_block(kind, gen, cfg, env)
                      for kind in cfg.pattern_tail),
        "final_norm": torch.zeros((d,), dtype=torch.float32),
        "unembed": L.dense_init(gen, d, vp),
    }


@pytest.mark.parametrize("arch", ["paper-demo", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "grok-1-314b"])
def test_init_params_filled_in_place_keeps_every_value(arch):
    """Filling preallocated stacks layer by layer draws the generator in
    the same order: the same seed gives the same tensors, bit for bit."""
    cfg = torch_smoke(arch)
    got = Mo.init_params(cfg, Env(), seed=3, device="cpu")
    want = _init_params_by_stacking(cfg, 3)
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_check_supported_refuses_only_mrope_vision_and_encoders():
    """Every arch of the JAX package's zoo is the port's since the
    modality slice (M-RoPE, vision and encoder-decoder included): the
    registry holds them all and check_supported passes each; a block kind
    the port has no layer for is refused."""
    for arch in ARCH_IDS:
        Mo.check_supported(get_config(arch))
    for arch in ("qwen2-vl-7b", "whisper-small"):
        ref = jax_config(arch)
        Mo.check_supported(ModelConfig(**{f.name: getattr(ref, f.name)
                                          for f in dataclasses.fields(ref)}))
    with pytest.raises(NotImplementedError):
        Mo.check_supported(dataclasses.replace(get_config("paper-demo"),
                                               block_pattern=("enc",)))
    assert set(ARCH_IDS) == set(DENSE + MOE) | {
        "paper-demo", "recurrentgemma-9b", "rwkv6-1.6b", "qwen2-vl-7b",
        "whisper-small"}


# ---------------------------------------------------------------------------
# the model: prefill and one decode step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_jax(arch):
    """B=2, S=20: every position's logits; qk-norm and the MoE dispatch
    over the b * S + s tokens (not the port's row padding)."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp, tp = _params(arch)
    tok = np.random.default_rng(7).integers(0, jcfg.vocab_size, (2, 20))
    tok = tok.astype(np.int32)
    jl, _, _ = jax.jit(lambda p, t: JMo.forward(
        p, t, jcfg, PALLAS, mode="prefill"))(jp, tok)
    tl, _ = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(),
                       mode="prefill")
    assert tl.shape == jl.shape and tl.dtype == torch.bfloat16
    assert _maxdiff(tl, jl) < LOGIT_TOL


def test_qk_norm_reads_the_bf16_projection_with_nonzero_scales():
    """qwen3-32b's qk-norm with random q_norm / k_norm scales (the init's
    zeros leave `1 + scale` at one): q and k per head against the JAX
    package's _project_qkv, within one bf16 rounding step of values up to
    8 (both normalise in f32 and round once, so they agree bit for bit
    unless an f32 rsqrt differs in its last bit); v bit for bit."""
    from repro.models import layers as JL
    jcfg, cfg = get_smoke("qwen3-32b"), torch_smoke("qwen3-32b")
    jp, tp = _params("qwen3-32b")
    rng = np.random.default_rng(11)
    hd = cfg.head_dim
    scales = {n: rng.standard_normal(hd).astype(np.float32)
              for n in ("q_norm", "k_norm")}
    pj = {**jax.tree.map(lambda a: a[0], jp["blocks"][0]["attn"]),
          **{n: jnp.asarray(v) for n, v in scales.items()}}
    pt = {**{n: v[0] for n, v in tp["blocks"][0]["attn"].items()},
          **{n: torch.from_numpy(v) for n, v in scales.items()}}
    xj, xt = _bf16_pair(rng.standard_normal((2, 9, cfg.d_model)))
    qj, kj, vj = jax.jit(lambda p, x: JL._project_qkv(
        p, x, x, jcfg, PALLAS))(pj, xj)
    qt, kt, vt = L._project_qkv(pt, xt, cfg)
    assert qt.dtype == kt.dtype == torch.bfloat16
    assert qt.shape == (2, 9, cfg.n_heads, hd)
    assert _maxdiff(qt, qj) <= 2.0 ** -6 and _maxdiff(kt, kj) <= 2.0 ** -6
    assert np.array_equal(_f32(vt), _f32(vj))


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)).astype(x.dtype), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_step_logits_and_cache_match_jax(arch):
    """Five rows over a paged pool of random K/V at depths 0..31, one of
    them masked (null table, depth 0), as the engine's steps carry them."""
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    jp, tp = _params(arch)
    B, NB, bs, MB = 5, 12, 16, 2
    pool = _random_like(JMo.init_paged_cache(jcfg, PALLAS, B, NB, bs), 2)
    rng = np.random.default_rng(4)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(B, MB)
    tables = tables.astype(np.int32)
    tables[4] = 0
    cl = np.asarray([0, 5, 17, 31, 0], np.int32)
    tok = rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    tok[4] = 0
    jl, jc, _ = jax.jit(lambda p, c, t, l, b: JMo.forward(
        p, t, jcfg, PALLAS, mode="decode", caches=c, cur_len=l,
        block_tables={"global": b}))(jp, pool, tok, cl, tables)
    tc = bridge.to_torch(jax.tree.map(np.array, pool), "cpu")
    tl, tc = Mo.forward(tp, torch.from_numpy(tok), cfg, Env(), caches=tc,
                        cur_len=torch.from_numpy(cl),
                        block_tables={"global": torch.from_numpy(tables)})
    assert tl.shape == (B, 1, vocab_pad(cfg, Env()))
    assert _maxdiff(tl, jl) < LOGIT_TOL
    for name in ("k", "v"):
        assert _maxdiff(tc["blocks"][0][name],
                        jc["blocks"][0][name]) < BF16_TOL


def test_paged_decode_op_takes_llama4_scout_group():
    """GQA 5 (llama4-scout-17b-a16e's 40 / 8 heads) at hd 128 is one of
    the kernels' groups; the op's plain version against the JAX package's
    kernel in interpret mode (tests/test_torch_paged_decode.py's bf16
    tolerance)."""
    assert 5 in GROUPS
    rng = np.random.default_rng(5)
    B, Hq, Hkv, hd, bs, MB = 3, 10, 2, 128, 16, 2
    NB = 1 + B * MB
    q, kp, vp = (_bf16_pair(rng.standard_normal(s))
                 for s in ((B, Hq, hd), (NB, Hkv, bs, hd), (NB, Hkv, bs, hd)))
    tables = (1 + rng.permutation(NB - 1)).reshape(B, MB).astype(np.int32)
    lengths = np.asarray([0, 17, 31], np.int32)
    got = paged_flash_decode(q[1], kp[1], vp[1], torch.from_numpy(tables),
                             torch.from_numpy(lengths))
    want = jax_paged(q[0], kp[0], vp[0], tables, lengths, interpret=True)
    assert _maxdiff(got, want) < LOGIT_TOL


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def _moe_inputs(arch, n, seed, skew):
    """bf16 tokens [1, n, d] for both packages: unit normal plus `skew`
    times one shared direction, which draws most tokens to the same
    experts (so capacity overflows)."""
    d = get_smoke(arch).d_model
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, n, d)) + skew * rng.standard_normal(d)
    return _bf16_pair(x)


def _moe_unit(arch):
    jp, tp = _params(arch)
    return (jax.tree.map(lambda a: a[0], jp["blocks"][0]["moe"]),
            {k: v[0] for k, v in tp["blocks"][0]["moe"].items()})


@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_drops_exactly_the_tokens_jax_drops(arch):
    cfg = torch_smoke(arch)
    E, k, cf = cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.capacity_factor
    pj, pt = _moe_unit(arch)
    xj, xt = _moe_inputs(arch, 40, 1, skew=3.0)
    n = xt.shape[1]
    cap = M._capacity(n, E, k, cf)
    assert cap == JM._capacity(n, E, k, cf)
    je, jt, jg, jr, jaux = JM._route(xj[0], pj["router"], E, k)
    te, tt, tg, tr, _, taux = M._route(xt[0], pt["router"], E, k)
    assert np.array_equal(te.numpy(), np.asarray(je))
    assert np.array_equal(tt.numpy(), np.asarray(jt))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert _maxdiff(tg, jg) < GATE_TOL
    assert abs(float(taux) - float(jaux)) < GATE_TOL
    _, (_, _, jdest, jkeep), _ = JM._dispatch(xj[0], pj["router"], E, k, cap)
    _, (_, _, tdest, tkeep, _), _ = M._dispatch(xt[0], pt["router"], E, k,
                                                cap)
    assert np.array_equal(tkeep.numpy(), np.asarray(jkeep))
    assert np.array_equal(tdest.numpy(), np.asarray(jdest))
    dropped = int((~tkeep).sum())
    assert dropped > 0  # the input overflows capacity
    yj, _ = JM.moe_layer(pj, xj, get_smoke(arch), PALLAS)
    with M.dispatch_stats() as stats:
        yt, _ = M.moe_layer(pt, xt, cfg)
    assert stats == [{"tokens": n, "capacity": cap, "dropped": dropped}]
    assert yt.dtype == torch.bfloat16 and _maxdiff(yt, yj) < BF16_TOL


@pytest.mark.parametrize("arch", MOE)
def test_moe_dispatch_at_decode_scale_is_dropless(arch):
    """n * k <= E: the capacity is n * k, no alignment padding, so every
    token is kept however the router skews."""
    cfg = torch_smoke(arch)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    n = E // k
    pj, pt = _moe_unit(arch)
    xj, xt = _moe_inputs(arch, n, 2, skew=6.0)
    assert M._capacity(n, E, k, cfg.moe.capacity_factor) == n * k
    yj, _ = JM.moe_layer(pj, xj, get_smoke(arch), PALLAS)
    with M.dispatch_stats() as stats:
        yt, _ = M.moe_layer(pt, xt, cfg)
    assert stats == [{"tokens": n, "capacity": n * k, "dropped": 0}]
    assert _maxdiff(yt, yj) < BF16_TOL


def test_top_k_breaks_ties_as_lax_top_k():
    """Tied gates keep the lower expert first, as lax.top_k orders them:
    planted ties across and inside the top k, a row of all-equal gates."""
    rng = np.random.default_rng(0)
    g = rng.random((64, 16)).astype(np.float32)
    g[:, 5] = g[:, 2]
    g[::2, 9] = g[::2, 2]
    g[::3, 0] = g[::3].max(1)
    g[7] = 0.0625
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(g), k)
        tv, ti = M._top_k(torch.from_numpy(g), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
    # all-equal router logits through the whole route
    cfg = torch_smoke("grok-1-314b")
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    zj, zt = _bf16_pair(np.zeros((6, cfg.d_model)))
    je = JM._route(zj, jnp.zeros((cfg.d_model, E)), E, k)[0]
    te = M._route(zt, torch.zeros((cfg.d_model, E)), E, k)[0]
    assert np.array_equal(te.numpy(), np.asarray(je))


# ---------------------------------------------------------------------------
# the CLI's --verify on the MoE archs
# ---------------------------------------------------------------------------


def test_jax_verify_mismatches_on_grok_smoke_and_the_port_prints_the_same(
        monkeypatch, capsys):
    """The JAX package's own CLI (`python -m repro.launch.serve --arch
    grok-1-314b --smoke --requests 8 --verify`) prints MISMATCH: MoE
    capacity depends on the tokens one dispatch holds, and an engine step
    and the one-shot baseline group tokens differently. The port's CLI on
    the same arguments prints the same verdict."""
    argv = ["serve", "--arch", "grok-1-314b", "--smoke", "--requests", "8",
            "--verify"]
    monkeypatch.setattr(sys, "argv", argv)
    assert jax_cli.main() == 1
    jax_out = capsys.readouterr().out
    assert "verify vs streamed-prefill one-shot baseline: MISMATCH" in jax_out
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    assert torch_cli.main() == 1
    out = capsys.readouterr().out
    assert "verify vs streamed-prefill one-shot baseline: MISMATCH" in out
