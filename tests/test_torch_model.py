"""The PyTorch port's model against the JAX package on the smoke config.

Weights come from the JAX package (`Mo.init_params(PRNGKey(0), ...)`)
through the numpy weight bridge; caches and tokens are made with numpy and
handed to both. Decode logits are held to `Mo.forward` within 3e-2 (bf16
logits), over a paged pool (JAX's pallas plan, the kernel in interpret
mode) and over a contiguous cache (JAX's naive plan, whose
attention_decode rounds probabilities to bf16 where the port keeps f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.models import model as Mo
from repro_torch.models.env import Env

JCFG = get_smoke("paper-demo")
CFG = torch_smoke("paper-demo")
PALLAS = JEnv(mesh=None, plan=ParallelPlan(fsdp=False, remat="full",
                                           attn_impl="pallas",
                                           kv_cache="replicated"))
NAIVE = JEnv(mesh=None, plan=ParallelPlan(fsdp=False, remat="full",
                                          attn_impl="naive",
                                          kv_cache="replicated"))
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), JCFG, PALLAS)
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
TOL = 3e-2


def _to_np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)).astype(x.dtype), tree)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def test_configs_and_bridge_keep_the_jax_layout():
    """The port's copied config describes the same model; bridged weights
    keep bf16 bits, the stacked layer axis and the padded vocabulary, and
    the port's own seeded init has the same tree, shapes and dtypes."""
    assert CFG == type(CFG)(**{f: getattr(JCFG, f)
                               for f in JCFG.__dataclass_fields__})
    own = Mo.init_params(CFG, Env(), seed=0, device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(JPARAMS)
    for (path, jl), tl, ol in zip(jleaves, jax.tree.leaves(PARAMS),
                                  jax.tree.leaves(own)):
        assert tuple(tl.shape) == tuple(jl.shape) == tuple(ol.shape), path
        assert tl.dtype == ol.dtype, path
        assert str(tl.dtype).endswith(str(jl.dtype)), path
        assert np.array_equal(_f32(tl), _f32(jl)), path
    assert len(jleaves) == len(jax.tree.leaves(own))
    assert PARAMS["blocks"][0]["attn"]["wq"].shape[0] == CFG.n_layers


def _paged_inputs(seed=0):
    rng = np.random.default_rng(seed)
    B, NB, bs, MB = 5, 12, 16, 2
    pool = _random_like(JMo.init_paged_cache(JCFG, PALLAS, B, NB, bs), seed)
    tables = rng.permutation(np.arange(1, NB))[:B * MB].reshape(
        B, MB).astype(np.int32)
    cl = np.asarray([0, 5, 17, 31, 16], np.int32)
    tok = rng.integers(0, JCFG.vocab_size, (B, 1)).astype(np.int32)
    return pool, tables, cl, tok


def _port_forward(pool, tables, cl, tok):
    caches = bridge.to_torch(_to_np(pool), "cpu")
    bt = None if tables is None else {"global": torch.from_numpy(tables)}
    logits, caches = Mo.forward(PARAMS, torch.from_numpy(tok), CFG, Env(),
                                caches=caches, cur_len=torch.from_numpy(cl),
                                block_tables=bt)
    return logits, caches


def test_paged_decode_logits_and_cache_match_jax():
    pool, tables, cl, tok = _paged_inputs()
    jl, jc, _ = jax.jit(lambda p, c, t, l, tb: JMo.forward(
        p, t, JCFG, PALLAS, mode="decode", caches=c, cur_len=l,
        block_tables={"global": tb}))(JPARAMS, pool, tok, cl, tables)
    tl, tc = _port_forward(pool, tables, cl, tok)
    assert tl.shape == (5, 1, JCFG.vocab_size) and tl.dtype == torch.bfloat16
    assert np.abs(_f32(tl) - _f32(jl)).max() < TOL
    # the written K/V rows (every layer) land where JAX writes them
    for name in ("k", "v"):
        assert np.abs(_f32(tc["blocks"][0][name])
                      - _f32(jc["blocks"][0][name])).max() < TOL


def test_contiguous_decode_logits_match_jax():
    """The port's contiguous-cache decode against Mo.forward on the same
    KV: within 3e-2 of the pallas plan (the same KV as one block per row,
    f32 probabilities, the semantics the port implements), and within 1e-1
    of the naive plan, whose attention_decode rounds each probability to
    bf16 (relative error up to 2^-9) before P·V — that alone moves these
    logits by up to 0.07."""
    rng = np.random.default_rng(3)
    B, S = 4, 24
    cache = _random_like(JMo.init_cache(JCFG, NAIVE, B, S), 3)
    cl = np.asarray([0, 7, 12, 23], np.int32)
    tok = rng.integers(0, JCFG.vocab_size, (B, 1)).astype(np.int32)
    tl, _ = _port_forward(cache, None, cl, tok)
    # [L,B,H,S,hd] is a pool of B blocks of S tokens; row b reads block b
    ident = np.arange(B, dtype=np.int32)[:, None]
    jl, _, _ = jax.jit(lambda p, c, t, l: JMo.forward(
        p, t, JCFG, PALLAS, mode="decode", caches=c, cur_len=l,
        block_tables={"global": ident}))(JPARAMS, cache, tok, cl)
    assert np.abs(_f32(tl) - _f32(jl)).max() < TOL
    jn, _, _ = jax.jit(lambda p, c, t, l: JMo.forward(
        p, t, JCFG, NAIVE, mode="decode", caches=c, cur_len=l))(
            JPARAMS, cache, tok, cl)
    assert np.abs(_f32(tl) - _f32(jn)).max() < 1e-1


def test_paging_a_contiguous_cache_leaves_the_logits_unchanged():
    """The same KV, contiguous or scattered into shuffled blocks, decodes
    to the same logits bit for bit (table order == logical order)."""
    rng = np.random.default_rng(4)
    B, bs, MB = 3, 8, 4
    S = bs * MB
    cache = _to_np(_random_like(JMo.init_cache(JCFG, NAIVE, B, S), 4))
    NB = 1 + B * MB
    tables = rng.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    pool = {"blocks": ({}, ), "tail": ()}
    for name, leaf in cache["blocks"][0].items():  # [L,B,H,S,hd]
        L_, _, H, _, hd = leaf.shape
        p = np.zeros((L_, NB, H, bs, hd), leaf.dtype)
        for b in range(B):
            for j in range(MB):
                p[:, tables[b, j]] = leaf[:, b, :, j * bs:(j + 1) * bs]
        pool["blocks"][0][name] = p
    cl = np.asarray([3, 20, 31], np.int32)
    tok = rng.integers(0, JCFG.vocab_size, (B, 1)).astype(np.int32)
    contig, _ = _port_forward(cache, None, cl, tok)
    paged, _ = _port_forward(pool, tables, cl, tok)
    assert torch.equal(contig, paged)


def test_a_rows_logits_do_not_depend_on_its_batch():
    """Batch invariance: the same (token, depth, table) row decodes to the
    same logits bit for bit alone, at another row, and in a batch padded
    past one row tile."""
    pool, tables, cl, tok = _paged_inputs(seed=5)
    full, _ = _port_forward(pool, tables, cl, tok)
    alone, _ = _port_forward(pool, tables[3:4], cl[3:4], tok[3:4])
    assert torch.equal(alone[0], full[3])
    big = 130  # two row tiles; row 3 repeated at the end
    idx = np.concatenate([np.arange(5), np.full(big - 5, 3)])
    wide, _ = _port_forward(pool, tables[idx], cl[idx], tok[idx])
    assert torch.equal(wide[-1], full[3]) and torch.equal(wide[:5], full)


def test_paged_pool_helpers_round_trip():
    """insert -> read returns the request's KV; copy duplicates a block
    (copy-on-write); evict zeroes exactly the named blocks."""
    rng = np.random.default_rng(6)
    bs, NB = 4, 9
    pool = Mo.init_paged_cache(CFG, Env(), NB, bs, device="cpu")
    S = 10  # pads to 3 blocks
    req = Mo.init_cache(CFG, Env(), 1, S, device="cpu")
    for leaf in req["blocks"][0].values():
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            leaf.shape).astype(np.float32)))
    table = torch.tensor([5, 2, 7, 0], dtype=torch.int32)
    Mo.make_paged_insert(CFG, bs)(pool, req, table)
    valid = torch.tensor([True, True, True, False])
    back = Mo.make_paged_read(CFG)(pool, table, valid)
    for name in ("k", "v"):
        got = back["blocks"][0][name]
        assert torch.equal(got[..., :S, :], req["blocks"][0][name])
        assert float(got[..., 3 * bs:, :].abs().max()) == 0.0
    Mo.make_paged_copy(CFG)(pool, 2, 4)
    k = pool["blocks"][0]["k"]
    assert torch.equal(k[:, 4], k[:, 2])
    Mo.make_paged_evict(CFG)(pool, torch.tensor([2, 5]))
    assert float(k[:, [2, 5]].abs().max()) == 0.0
    assert float(k[:, 7].abs().max()) > 0.0 and torch.equal(k[:, 4], k[:, 4])


def test_unsupported_architectures_are_refused():
    """qk-norm is served since the zoo slice, M-RoPE and the VLM and
    encoder-decoder families since the modality slice; an "enc" block in
    the decoder's pattern is still refused (it builds the encoder stack,
    never a decoder block)."""
    import dataclasses
    for change in ({"qk_norm": True}, {"mrope": True}, {"family": "vlm"},
                   {"block_pattern": ("dec",), "encoder_layers": 1}):
        Mo.init_params(dataclasses.replace(CFG, **change), Env(),
                       device="cpu")
    for kinds in (("enc",), ("attn", "enc")):
        with pytest.raises(NotImplementedError):
            Mo.init_params(dataclasses.replace(CFG, block_pattern=kinds),
                           Env(), device="cpu")
