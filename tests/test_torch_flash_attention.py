"""The port's flash-attention op and prefill attention against the JAX
package (CPU).

The op's plain version (what a CPU tensor runs) is held to JAX's
attention_ref and to JAX's Pallas kernel in interpret mode on the JAX
package's own sweep (tests/test_kernels.py), at its tolerances: 2e-2 on
bf16 outputs, 2e-3 on f32. A ragged prompt (S = 200) is held to
attention_ref only: the JAX kernel asserts Sq % 128 == 0 and refuses it,
which the CUDA kernel does not (it masks the ragged tile). The model's
short-prompt branch, attention_naive, keeps the JAX package's rounding
(bf16 scores and probabilities); it is bit-equal to JAX's in nearly
every entry and one bf16 rounding step apart in the rest, where XLA's CPU
exp and dot round the last f32 bit otherwise than PyTorch's (ROADMAP.md,
queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_no_kernel_device import NoKernelTensor
from repro.configs import get_smoke
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L

JCFG = get_smoke("paper-demo")
CFG = torch_smoke("paper-demo")

# tests/test_kernels.py test_flash_attention_sweep's shapes
SWEEP = [
    (1, 128, 4, 4, 32, True, 0, 64, 64),
    (2, 256, 4, 2, 64, True, 0, 128, 128),
    (1, 256, 8, 1, 64, True, 64, 64, 64),  # MQA + sliding window
    (2, 128, 4, 4, 128, False, 0, 128, 128),  # bidirectional
    (1, 192, 6, 2, 32, True, 0, 64, 64),  # non-pow2 seq
]


def _qkv(seed, B, S, Hq, Hkv, hd, dtype):
    """The same numbers as jax arrays (model layout) and torch tensors."""
    rng = np.random.default_rng(seed)
    mk = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32)
                                ).astype(dtype)
    jq, jk, jv = mk(B, S, Hq, hd), mk(B, S, Hkv, hd), mk(B, S, Hkv, hd)
    to = lambda a: bridge.to_torch(np.asarray(a), "cpu")
    return (jq, jk, jv), (to(jq), to(jk), to(jv))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_ref(jq, jk, jv, causal, window):
    B, S, Hq, hd = jq.shape
    t = lambda a: a.transpose(0, 2, 1, 3)
    r = jax_ref(t(jq), t(jk), t(jv), causal=causal, window=window)
    return t(r).reshape(B, S, Hq * hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal,window,bq,bk", SWEEP)
def test_plain_matches_jax_oracle_and_pallas_kernel(dtype, B, S, Hq, Hkv, hd,
                                                    causal, window, bq, bk):
    jdt = getattr(jnp, dtype)
    (jq, jk, jv), (q, k, v) = _qkv(S + hd + Hkv, B, S, Hq, Hkv, hd, jdt)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          n_kv_heads=Hkv)
    assert got.shape == (B, S, Hq * hd) and got.dtype == q.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    ref = _jax_ref(jq, jk, jv, causal, window)
    assert np.abs(_f32(got) - _f32(ref)).max() < tol
    kern = jax_flash(jq, jk, jv, causal=causal, window=window,
                     n_kv_heads=Hkv, block_q=bq, block_k=bk, interpret=True)
    assert np.abs(_f32(got) - _f32(kern)).max() < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_ragged_prompt_matches_jax_oracle(dtype, causal, window):
    """S = 200 is no multiple of 128: the plain version takes it (as the
    CUDA kernel does, masking its ragged last tile); JAX's kernel refuses
    it, so the oracle is attention_ref alone."""
    jdt = getattr(jnp, dtype)
    B, S, Hq, Hkv, hd = 2, 200, 12, 4, 16
    (jq, jk, jv), (q, k, v) = _qkv(7, B, S, Hq, Hkv, hd, jdt)
    got = flash_attention(q, k, v, causal=causal, window=window,
                          n_kv_heads=Hkv)
    tol = 2e-2 if dtype == "bfloat16" else 2e-3
    assert np.abs(_f32(got) - _f32(_jax_ref(jq, jk, jv, causal, window))
                  ).max() < tol
    with pytest.raises(AssertionError):
        jax_flash(jq, jk, jv, causal=causal, window=window, n_kv_heads=Hkv,
                  interpret=True)


def test_plain_ref_is_exact_attention_in_f32():
    """attention_ref on its own layout: GQA head h reads KV head h // g,
    a fully visible row is the softmax average, the output keeps q's
    dtype."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 4, 5, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
    o = attention_ref(q, k, v, causal=True)
    assert torch.allclose(o[0, 3, 0], v[0, 1, 0])  # row 0 sees key 0 only
    s = (q[0, 1] @ k[0, 0].T) / np.sqrt(8)
    full = torch.softmax(s, -1) @ v[0, 0]
    assert torch.allclose(attention_ref(q, k, v, causal=False)[0, 1], full,
                          atol=1e-6)
    assert attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16()).dtype \
        == torch.bfloat16


def test_cpu_tensors_run_the_plain_version_and_other_devices_raise():
    (_, _, _), (q, k, v) = _qkv(1, 1, 16, 4, 2, 16, jnp.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, n_kv_heads=2)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2)).transpose(1, 2).reshape(1, 16, 64)
    assert torch.equal(got, want)
    assert flash_attention.launches == before  # launches count the kernel
    with pytest.raises(ValueError, match="n_kv_heads"):
        flash_attention(q, k, v, n_kv_heads=4)
    # a meta tensor (the dry run) gives the plain version's shape and
    # dtype with no launch; a device with no kernel raises
    meta = flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert (meta.device.type, meta.shape, meta.dtype) == (
        "meta", want.shape, want.dtype)
    assert flash_attention.launches == before
    other = NoKernelTensor((1, 16, 4, 16))
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(other, other, other)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("S", [16, 32, 100, 128])
def test_attention_naive_matches_jax_to_one_bf16_rounding(S, seed):
    """Prompt lengths up to the flash threshold (heads 4/2, hd 16): bf16
    scores before the scale, bf16 probabilities, bf16 P·V, as the
    reference rounds. Nearly every entry is bit-equal; XLA's CPU exp (and,
    at 100-128 keys, its dot's summation order) differ from PyTorch's in
    the last f32 bit now and then, which moves a probability or an output
    by one bf16 rounding step in a few entries (ROADMAP.md, queue 3): a
    probability step is at most 2^-8 of it, so such an entry moves by less
    than 2e-2 (|v| < 5 here), the JAX package's bf16 kernel bound."""
    (jq, jk, jv), (q, k, v) = _qkv(100 * S + seed, 3, S, 4, 2, 16,
                                   jnp.bfloat16)
    want = _f32(jax.jit(lambda a, b, c: JL.attention_naive(
        a, b, c, JCFG, causal=True))(jq, jk, jv))
    got_t = L.attention_naive(q, k, v, CFG, causal=True)
    assert got_t.dtype == torch.bfloat16
    got = _f32(got_t)
    diff = np.abs(got - want)
    assert (diff > 0).mean() < 1e-2
    assert diff.max() < 2e-2


def test_attention_naive_masks_as_the_reference():
    """The sliding-window and bidirectional masks of attention_naive are
    the reference's (the classic path runs causal, window 0)."""
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 24, 4, 2, 16, jnp.bfloat16)
    for causal, window in ((True, 8), (False, 0)):
        want = JL.attention_naive(jq, jk, jv, JCFG, causal=causal,
                                  window=window)
        got = L.attention_naive(q, k, v, CFG, causal=causal, window=window)
        assert np.array_equal(_f32(got), _f32(want))
