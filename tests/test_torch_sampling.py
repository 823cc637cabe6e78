"""Seeded sampling in the PyTorch port against the JAX package.

* the top-k/top-p mask (plain version on the CPU) yields the JAX oracle's
  keep-set with kept logits bit-equal, on the JAX kernel tests' cases and
  at the edges of its semantics (top_p 0, an exact prefix mass, an
  all-equal row, top_k >= V, rows of one nonzero probability);
* the counter-based generator (repro_torch/random.py) reproduces jax's
  threefry2x32 keys and bits bit for bit (jax_threefry_partitionable, the
  default of this tree's jax), its uniforms bit for bit, and each of the
  two logs of the Gumbel transform to 1 ulp (XLA's CPU log and torch's
  differ by 1 ulp on some inputs);
* the CUDA mask kernel is held to the plain version in test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampling.ref import topk_topp_mask_ref as jax_mask_ref
from repro_torch import random as R
from repro_torch.kernels.sampling.ops import topk_topp_mask
from repro_torch.kernels.sampling.ref import NEG_INF, topk_topp_mask_ref


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


# ---------------------------------------------------------------------------
# top-k / top-p mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,V", [(4, 128), (3, 200), (1, 512)])
def test_mask_matches_jax_oracle(T, V):
    """Same survivors, same NEG_INF drops, kept logits unchanged —
    including a vocabulary that is not a multiple of 128."""
    logits = np.random.default_rng(V).standard_normal((T, V)).astype(
        np.float32) * 3.0
    top_k = np.asarray([0, 5, 1, 40][:T], np.int32)
    top_p = np.asarray([1.0, 0.9, 0.5, 0.25][:T], np.float32)
    got = topk_topp_mask(torch.from_numpy(logits), torch.from_numpy(top_k),
                         torch.from_numpy(top_p)).numpy()
    want = np.asarray(jax_mask_ref(jnp.asarray(logits), jnp.asarray(top_k),
                                   jnp.asarray(top_p)))
    keep_g, keep_w = got > NEG_INF / 2, want > NEG_INF / 2
    assert np.array_equal(keep_g, keep_w), "keep-sets differ"
    assert np.array_equal(got[keep_w], want[keep_w]), \
        "kept logits must pass through unchanged"


def _keep(logits, k, p):
    out = topk_topp_mask_ref(torch.log(torch.tensor([logits])),
                             torch.tensor([k], dtype=torch.int32),
                             torch.tensor([p]))
    return [bool(b) for b in (out[0] > NEG_INF / 2)]


def test_mask_semantics():
    """Unit semantics on a hand-checkable distribution."""
    dist = [0.4, 0.3, 0.2, 0.05, 0.05]
    assert _keep(dist, 2, 1.0) == [True, True, False, False, False]
    # 0.65 sits safely between 0.4 and 0.7 so fp roundoff can't flip it
    assert _keep(dist, 0, 0.65) == [True, True, False, False, False]
    assert all(_keep(dist, 0, 1.0))
    # the argmax always survives even the harshest settings
    assert _keep(dist, 1, 1e-3) == [True, False, False, False, False]


def test_mask_keeps_value_ties_at_the_top_k_edge():
    logits = torch.tensor([[1.0, 2.0, 2.0, 0.0, -1.0] + [-9.0] * 123])
    out = topk_topp_mask(logits, torch.tensor([2], dtype=torch.int32),
                         torch.tensor([1.0]))
    assert [bool(b) for b in (out[0, :5] > NEG_INF / 2)] == \
        [False, True, True, False, False]


def _edge_rows(case):
    """Four rows of 300 logits, top_k, top_p at one edge of the semantics
    (the CUDA kernel is held to the same edges in test_torch_cuda.py)."""
    x = (np.random.default_rng(7).standard_normal((4, 300)) * 3.0).astype(
        np.float32)
    if case == "p_zero":  # the max alone survives, with its ties
        x[1, :3] = x[1].max() + 1.0
        k, p = [0, 0, 5, 50], [0.0, 0.0, 0.0, -1.0]
    elif case == "exact_prefix_mass":  # probs 0.5, 0.25, 0.25, then 0s
        x[:, :3] = np.log(np.float32([0.5, 0.25, 0.25]))
        x[:, 3:] = -1e4
        k, p = [0, 0, 0, 2], [0.5, 0.75, 0.25, 0.75]
    elif case == "all_equal":
        x[:] = 0.5
        k, p = [5, 5, 0, 1], [1.0, 0.9, 0.5, 0.0]
    elif case == "k_at_least_v":
        k, p = [299, 300, 307, 2**31 - 1], [1.0, 1.0, 0.9, 0.5]
    else:  # greedy rows, scaled by 1/1e-6: every prob but the max's is 0
        x = x / np.float32(1e-6)
        k, p = [0, 50, 0, 1], [0.9, 0.9, 0.9999999, 1.0]
    return x, np.asarray(k, np.int32), np.asarray(p, np.float32)


@pytest.mark.parametrize("case", ["p_zero", "exact_prefix_mass", "all_equal",
                                  "k_at_least_v", "greedy_scaled"])
def test_mask_edges_match_jax_oracle(case):
    """The plain version (the kernel's oracle) against JAX's at the edges
    of the semantics: top_p 0 and below, top_p equal to a prefix mass
    (the first prefix that reaches it ends the nucleus), an all-equal row,
    top_k >= V, rows whose probabilities all but one underflow."""
    x, k, p = _edge_rows(case)
    got = topk_topp_mask(torch.from_numpy(x), torch.from_numpy(k),
                         torch.from_numpy(p)).numpy()
    want = np.asarray(jax_mask_ref(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(p)))
    assert np.array_equal(got, want)
    keep = got > NEG_INF / 2
    if case == "exact_prefix_mass":
        assert keep[:, :3].tolist() == [[True, False, False],
                                        [True, True, True],
                                        [True, False, False],
                                        [True, True, True]]
        assert not keep[:, 3:].any()
    elif case == "p_zero":
        assert keep.sum(1).tolist() == [1, 3, 1, 1]
    elif case == "all_equal":
        assert keep.all()
    elif case == "greedy_scaled":
        assert keep.sum(1).tolist()[::2] == [1, 1]


# ---------------------------------------------------------------------------
# threefry2x32 and the Gumbel noise of make_sample_fn
# ---------------------------------------------------------------------------


def _seeds_and_positions(n=1000):
    rng = np.random.default_rng(0)
    seeds = np.concatenate([rng.integers(-2**31, 2**31, n - 4),
                            [0, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    pos = rng.integers(0, 2**31, n).astype(np.int32)
    pos[:8] = np.arange(8)  # the first positions of a request, too
    return seeds, pos


def _jax_rows(seeds, pos, V):
    def row(s, p):
        key = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return (jax.random.key_data(key),
                jax.random.bits(key, (V,), jnp.uint32),
                jax.random.uniform(key, (V,), jnp.float32,
                                   minval=jnp.finfo(jnp.float32).tiny),
                jax.random.gumbel(key, (V,), jnp.float32))
    return [np.array(a) for a in jax.vmap(row)(jnp.asarray(seeds),
                                                 jnp.asarray(pos))]


def test_threefry_keys_and_bits_equal_jax():
    seeds, pos = _seeds_and_positions()
    V = 48
    jkey, jbits, _, _ = _jax_rows(seeds, pos, V)
    key = R.fold_in(R.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    tkey = np.stack([k.numpy() for k in key], -1).astype(np.uint32)
    assert np.array_equal(tkey, jkey)
    assert np.array_equal(R.random_bits(key, V).numpy().astype(np.uint32),
                          jbits)


def test_gumbel_noise_matches_jax_within_one_ulp_per_log():
    seeds, pos = _seeds_and_positions()
    V = 48
    _, _, juni, jg = _jax_rows(seeds, pos, V)
    key = R.fold_in(R.PRNGKey(torch.from_numpy(seeds)), torch.from_numpy(pos))
    tuni = R.uniform(key, V).numpy()
    assert np.array_equal(tuni, juni), "uniforms are bit-exact"
    # g = -log(w), w = -log(u): each log is held to 1 ulp of jax's on the
    # same argument; near g = 0 an ulp of w shows up as an absolute error
    # of about 2^-23, so the end-to-end noise is held to 2 ulps of
    # max(|g|, 1)
    w_j = np.array(-jnp.log(jnp.asarray(juni)))
    w_t = (-torch.log(torch.from_numpy(juni))).numpy()
    assert _ulps(w_t, w_j).max() <= 1
    g_j = np.array(-jnp.log(jnp.asarray(w_j)))
    g_t = (-torch.log(torch.from_numpy(w_j))).numpy()
    assert _ulps(g_t, g_j).max() <= 1
    tg = R.gumbel(key, V).numpy()
    scale = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert (np.abs(tg - jg) <= 2 * scale).all()


def test_sample_keys_depend_only_on_seed_and_position():
    """A row's noise is a pure function of (seed, position): the same pair
    draws the same noise in any batch, at any row."""
    seeds = torch.tensor([5, 9, 5, -3], dtype=torch.int32)
    pos = torch.tensor([2, 2, 2, 7], dtype=torch.int32)
    g = R.gumbel(R.fold_in(R.PRNGKey(seeds), pos), 64)
    assert torch.equal(g[0], g[2]) and not torch.equal(g[0], g[1])
    alone = R.gumbel(R.fold_in(R.PRNGKey(seeds[3:]), pos[3:]), 64)
    assert torch.equal(alone[0], g[3])
