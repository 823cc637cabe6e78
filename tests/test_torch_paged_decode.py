"""Paged decode attention in the PyTorch port against the JAX package.

The port's op runs its plain version on CPU tensors (the CUDA kernel
only exists on the card); it is held to the JAX oracle (paged_decode_ref)
and to the Pallas kernel in interpret mode on the same numpy inputs, at the
JAX kernel tests' sweep shapes and tolerances (2e-3 f32, 3e-2 bf16). The
CUDA kernel is held to the plain version on the card in test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_no_kernel_device import NoKernelTensor
from repro.kernels.flash_decode.ref import decode_ref
from repro.kernels.paged_decode.ops import paged_flash_decode as jax_paged
from repro.kernels.paged_decode.ref import paged_decode_ref as jax_ref
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.kernels.paged_decode.ops import paged_flash_decode

SWEEP = [(2, 4, 2, 32, 16, 4),
         (3, 8, 8, 64, 8, 3),    # MHA
         (1, 4, 1, 128, 32, 2)]  # MQA, wide blocks


def _setup(seed, B, Hq, Hkv, hd, bs, MB, extra_blocks=3):
    """Random pool + per-row tables drawing disjoint, shuffled physical
    blocks (block 0 reserved as the null block, like serve/blocks.py)."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * MB + extra_blocks
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((NB, Hkv, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((NB, Hkv, bs, hd)).astype(np.float32)
    ids = rng.permutation(np.arange(1, NB))
    tables = ids[:B * MB].reshape(B, MB).astype(np.int32)
    return q, kp, vp, tables


def _both(arrays, dtype):
    """The same numpy arrays as jax and torch inputs, rounded to `dtype`
    once so both packages see identical values."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ja = [jnp.asarray(a).astype(jd) for a in arrays]
    ta = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in ja]
    if dtype == "bf16":
        ta = [t.to(torch.bfloat16) for t in ta]
    return ja, ta


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,hd,bs,MB", SWEEP)
def test_plain_matches_jax_oracle_and_pallas_kernel(B, Hq, Hkv, hd, bs, MB,
                                                    dtype):
    q, kp, vp, tables = _setup(B * 31 + hd, B, Hq, Hkv, hd, bs, MB)
    lengths = np.asarray([(i * 7) % (MB * bs) for i in range(B)], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp), dtype)
    got = paged_flash_decode(tq, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(lengths)).numpy()
    tol = 3e-2 if dtype == "bf16" else 2e-3
    want = np.asarray(jax_ref(jq, jk, jv, tables, lengths))
    kern = np.asarray(jax_paged(jq, jk, jv, tables, lengths, interpret=True))
    assert got.dtype == np.float32 and got.shape == (B, Hq, hd)
    assert np.abs(got - want).max() < tol
    assert np.abs(got - kern).max() < tol


def test_masked_depth_zero_and_full_rows():
    """lengths -1 (zero row), 0 (one key) and full (every table entry)."""
    B, Hq, Hkv, hd, bs, MB = 3, 4, 2, 32, 16, 3
    q, kp, vp, tables = _setup(5, B, Hq, Hkv, hd, bs, MB)
    lengths = np.asarray([-1, 0, MB * bs - 1], np.int32)
    (jq, jk, jv), (tq, tk, tv) = _both((q, kp, vp), "f32")
    got = paged_flash_decode(tq, tk, tv, torch.from_numpy(tables),
                             torch.from_numpy(lengths)).numpy()
    assert np.abs(got[0]).max() == 0.0, "masked row must be zero"
    kern = np.asarray(jax_paged(jq, jk, jv, tables, lengths, interpret=True))
    assert np.abs(got - kern).max() < 2e-3


def test_paging_a_contiguous_cache_leaves_the_output_unchanged():
    """Scatter a contiguous cache into shuffled physical blocks: attention
    through the tables equals attention over the cache read as one block
    per row (the layout the one-shot baseline uses), bit for bit, and the
    JAX contiguous-decode oracle within 2e-3."""
    rng = np.random.default_rng(0)
    B, Hq, Hkv, hd, bs, MB = 2, 8, 2, 64, 16, 4
    S = MB * bs
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, hd)).astype(np.float32)
    NB = 1 + B * MB
    tables = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    kp = np.zeros((NB, Hkv, bs, hd), np.float32)
    vp = np.zeros((NB, Hkv, bs, hd), np.float32)
    for b in range(B):
        for j in range(MB):
            kp[tables[b, j]] = k[b, :, j * bs:(j + 1) * bs]
            vp[tables[b, j]] = v[b, :, j * bs:(j + 1) * bs]
    cur = 37
    lengths = torch.full((B,), cur, dtype=torch.int32)
    paged = paged_flash_decode(torch.from_numpy(q), torch.from_numpy(kp),
                               torch.from_numpy(vp), torch.from_numpy(tables),
                               lengths)
    ident = torch.arange(B, dtype=torch.int32)[:, None]
    contig = paged_flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), ident, lengths)
    assert torch.equal(paged, contig)
    want = np.asarray(decode_ref(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), cur))
    assert np.abs(paged.numpy() - want).max() < 2e-3


def test_block_placement_never_leaks_into_the_output():
    """Truncate-and-regrow rewrites a row's table suffix onto other
    physical blocks: same logical KV -> bit-identical output, even with the
    freed blocks poisoned."""
    rng = np.random.default_rng(1)
    Hq, Hkv, hd, bs, MB = 4, 2, 32, 8, 4
    q = torch.from_numpy(rng.standard_normal((1, Hq, hd)).astype(np.float32))
    kv = rng.standard_normal((2, Hkv, MB * bs, hd)).astype(np.float32)
    pools = [np.zeros((1 + 2 * MB, Hkv, bs, hd), np.float32) for _ in range(2)]
    first = np.arange(1, MB + 1)
    regrown = np.concatenate([first[:2], np.arange(MB + 1, MB + 3)])
    for ids, poison in ((first, False), (regrown, True)):
        for j, bid in enumerate(ids):
            for p, src in zip(pools, kv):
                p[bid] = src[:, j * bs:(j + 1) * bs]
        if poison:
            for p, val in zip(pools, (1e6, -1e6)):
                p[first[2:]] = val
        tables = torch.from_numpy(ids[None].astype(np.int32))
        out = paged_flash_decode(q, torch.from_numpy(pools[0]),
                                 torch.from_numpy(pools[1]), tables,
                                 torch.tensor([MB * bs - 1], dtype=torch.int32))
        if poison:
            assert torch.equal(out, ref_out)
        ref_out = out


def test_no_silent_fallback_on_other_devices():
    """Only CPU tensors take the plain version (meta tensors, the dry
    run's, its shape alone); any other device must launch a kernel or
    raise."""
    q = NoKernelTensor((1, 4, 32))
    kp = NoKernelTensor((2, 2, 16, 32))
    t = NoKernelTensor((1, 1), torch.int32)
    n = NoKernelTensor((1,), torch.int32)
    with pytest.raises(ValueError, match="no kernel"):
        paged_flash_decode(q, kp, kp, t, n)


@pytest.mark.parametrize("hd,group", [(64, 3), (256, 16), (128, 6),
                                      (128, 8), (256, 2), (16, 1)])
def test_span_plan_follows_head_dim_group_and_width_alone(hd, group):
    """The kernel's span plan (csrc/paged_decode.cuh): the span, the number
    of spans and the workspace of a (row, KV head) follow hd, the group
    and the table's logical width alone. The same width at bs 8, 16 and
    as one block (the one-shot baseline's layout) gives the same plan at
    B 1 and 5, the workspace scales with B x Hkv only, and its spans
    cover every token of the table."""
    Hkv = 2
    Hq = group * Hkv
    full = pd_ops.SPAN_GQA16 if group == 16 else pd_ops.SPAN
    for S in (96, 288, 640, 2048):
        span, n_spans, floats = pd_ops.span_plan(hd, group, S)
        assert span == min(full, S)
        assert (n_spans - 1) * span < S <= n_spans * span
        assert floats == (0 if n_spans == 1 else group * n_spans * (hd + 2))
        for B in (1, 5):
            for bs in (8, 16, S):
                q = torch.empty((B, Hq, hd), dtype=torch.bfloat16)
                kp = torch.empty((1, Hkv, bs, hd), dtype=torch.bfloat16)
                tables = torch.zeros((B, S // bs), dtype=torch.int32)
                got, work = pd_ops._workspace(q, kp, tables)
                assert got == span
                assert (0 if work is None else work.numel()) == \
                    B * Hkv * floats


def test_every_row_of_the_serving_tables_is_one_span():
    """The serving path's paged decode (paper-demo-110m: hd 64, GQA 3) and
    its int8 pool never split a row: chunked admission's 96-token tables
    (6 blocks of 16), classic admission's and the slot pool's 288-token
    tables at prompt 256, gen 32 (18 blocks of 16) and their one-shot
    baseline's contiguous cache (one block of 288) each take one launch
    and no workspace. recurrentgemma-9b's 2048-token rings (GQA 16, hd
    256) split over SPAN_GQA16-token spans."""
    for width in (6 * 16, 18 * 16, 288):
        assert pd_ops.span_plan(64, 3, width)[1:] == (1, 0)
    span, n_spans, _ = pd_ops.span_plan(256, 16, 128 * 16)
    assert span == pd_ops.SPAN_GQA16 and n_spans == -(-2048 // span)
