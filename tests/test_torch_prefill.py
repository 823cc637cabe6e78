"""The port's full-sequence prefill against the JAX package (CPU).

forward(mode="prefill") on the smoke config, with the JAX package's
weights through the bridge: logits and the emitted K/V against
Mo.forward under the pallas plan, at a 16-token prompt (both take
attention_naive) and a 256-token prompt (the flash branch: JAX's Pallas
kernel in interpret mode, the port's plain version), within 3e-2 (bf16
logits, as tests/test_torch_model.py holds decode). Inside the port: a
prompt's rows do not depend on the batch around it (B=1 and B=3 prefills
are bit-identical), the flash/naive dispatch reads the real prompt length,
and the slot-pool cache ops match the JAX package's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env

JCFG = get_smoke("paper-demo")
CFG = torch_smoke("paper-demo")
PALLAS = JEnv(mesh=None, plan=ParallelPlan(fsdp=False, remat="full",
                                           attn_impl="pallas",
                                           kv_cache="replicated"))
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), JCFG, PALLAS)
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
TOL = 3e-2


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _port_prefill(tok):
    return Mo.forward(PARAMS, torch.from_numpy(tok), CFG, Env(),
                      mode="prefill")


@pytest.mark.parametrize("S", [16, 256])
def test_prefill_logits_and_kv_match_jax_pallas_plan(S):
    tok = _tokens(2, S, seed=S)
    jl, jc, _ = jax.jit(lambda p, t: JMo.forward(
        p, t, JCFG, PALLAS, mode="prefill"))(JPARAMS, tok)
    tl, tc = _port_prefill(tok)
    assert tl.shape == (2, S, JCFG.vocab_size) and tl.dtype == torch.bfloat16
    assert np.abs(_f32(tl) - _f32(jl)).max() < TOL
    for name in ("k", "v"):
        got, want = tc["blocks"][0][name], jc["blocks"][0][name]
        assert tuple(got.shape) == want.shape  # [L,B,Hkv,S,hd]
        assert np.abs(_f32(got) - _f32(want)).max() < TOL
    assert tc["tail"] == ()


@pytest.mark.parametrize("S", [16, 200])
def test_prefill_rows_do_not_depend_on_the_batch(S):
    """Each prompt is padded to whole 128-row tiles, so a prompt prefilled
    alone and inside a batch of three gives the same bits (both branches:
    16 tokens naive, 200 tokens flash with a ragged tile)."""
    tok = _tokens(3, S, seed=1)
    l3, c3 = _port_prefill(tok)
    l1, c1 = _port_prefill(tok[1:2])
    assert torch.equal(l1[0], l3[1])
    for name in ("k", "v"):
        assert torch.equal(c1["blocks"][0][name][:, 0],
                           c3["blocks"][0][name][:, 1])


@pytest.mark.parametrize("S,flash", [(128, False), (129, True)])
def test_flash_dispatch_reads_the_real_prompt_length(S, flash, monkeypatch):
    """The reference's pallas plan: Sq > 128 takes the kernel. The port
    pads a 129-token prompt to 256 rows; the decision reads 129."""
    calls = []
    real = fa_ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    _port_prefill(_tokens(1, S))
    if flash:
        assert calls == [(1, S, CFG.n_heads, CFG.head_dim)] * CFG.num_blocks
    else:
        assert calls == []


def test_prefill_step_takes_the_last_real_position_and_grows_caches():
    """make_prefill_step's logits are position S-1's (not the padded
    tile's last row); grow_caches appends zero positions as JAX's does."""
    S, extra = 20, 5
    tok = _tokens(2, S, seed=2)
    full, _ = _port_prefill(tok)
    last, caches = St.make_prefill_step(CFG, Env())(
        PARAMS, {"tokens": torch.from_numpy(tok)})
    assert torch.equal(last, full[:, S - 1])
    grown = Mo.grow_caches(caches, extra, CFG)
    jc = {"blocks": ({n: jnp.asarray(_f32(caches["blocks"][0][n])).astype(
        jnp.bfloat16) for n in ("k", "v")},), "tail": ()}
    jg = JMo.grow_caches(jc, extra, JCFG)
    for n in ("k", "v"):
        assert grown["blocks"][0][n].shape[-2] == S + extra
        assert np.array_equal(_f32(grown["blocks"][0][n]),
                              _f32(jg["blocks"][0][n]))
    # the JAX step agrees with the port's on the last position
    jl, _ = jax.jit(JSt.make_prefill_step(JCFG, PALLAS))(
        JPARAMS, {"tokens": tok})
    assert np.abs(_f32(last) - _f32(jl)).max() < TOL


def test_slot_cache_ops_match_jax():
    """cache_insert_slot / cache_read_slot / cache_evict_slot on a pooled
    cache, against the JAX package's on the same numbers."""
    rng = np.random.default_rng(3)
    N, Smax, S = 3, 24, 16
    jpool = JMo.init_cache(JCFG, PALLAS, N, Smax)
    jpool = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)).astype(x.dtype), jpool)
    tok = _tokens(1, S, seed=4)
    _, req = _port_prefill(tok)
    req = Mo.grow_caches(req, Smax - S, CFG)
    jreq = {"blocks": ({n: jnp.asarray(_f32(req["blocks"][0][n])).astype(
        jnp.bfloat16) for n in ("k", "v")},), "tail": ()}
    pool = bridge.to_torch(jax.tree.map(np.asarray, jpool), "cpu")
    pool = Mo.cache_insert_slot(pool, req, 1)
    jpool = JMo.cache_insert_slot(jpool, jreq, 1)
    for n in ("k", "v"):
        assert np.array_equal(_f32(pool["blocks"][0][n]),
                              _f32(jpool["blocks"][0][n]))
    back = Mo.cache_read_slot(pool, 1)
    for n in ("k", "v"):
        assert torch.equal(back["blocks"][0][n], req["blocks"][0][n])
    pool = Mo.cache_evict_slot(pool, 1)
    jpool = JMo.cache_evict_slot(jpool, 1)
    for n in ("k", "v"):
        assert np.array_equal(_f32(pool["blocks"][0][n]),
                              _f32(jpool["blocks"][0][n]))
        assert float(pool["blocks"][0][n][:, 1].abs().max()) == 0.0


def test_train_mode_waits_for_the_training_slice():
    """The training slice has landed (tests/test_torch_train.py holds it
    to the JAX package): under the serving plan train mode gives
    prefill's logits at 8 tokens, and past 128 it refuses, since the
    flash kernel has no backward."""
    tok = torch.from_numpy(_tokens(1, 8))
    logits, aux = Mo.forward(PARAMS, tok, CFG, Env(), mode="train")
    assert torch.equal(logits,
                       Mo.forward(PARAMS, tok, CFG, Env(), mode="prefill")[0])
    assert float(aux) == 0.0
    with pytest.raises(NotImplementedError, match="no backward"):
        Mo.forward(PARAMS, torch.from_numpy(_tokens(1, 129)), CFG, Env(),
                   mode="train")
