"""The two modality archs of the port against the JAX package on the CPU:
qwen2-vl-7b (a VLM with M-RoPE behind a vision-embedding stub) and
whisper-small (an encoder-decoder behind a frame stub).

Weights are the JAX package's (`Mo.init_params(PRNGKey(0), ...)`)
through the numpy bridge; tokens and the stubs' vision embeddings and
frames are made with numpy from a seed (the CLI feeds zero stubs, as
JAX's does; zeros alone would leave the encoder and the vision positions
untested). JAX's engines refuse both archs, so the oracle is its model:
prefill, decode step and full forward.

Tolerances, and why:
- Prefill at S <= 128 (both packages' attention_naive): logits and caches
  within TOL = 3e-2 (bf16, as tests/test_torch_prefill.py; they read
  equal on this CPU).
- Prefill past 128 positions (the port's flash branch: its plain version
  on the CPU; JAX's Pallas kernel in interpret mode under the pallas
  plan; the whisper encoder's 256 frames non-causal): the port within
  JAX's own spread, the distance between JAX's naive and pallas plans on
  the same inputs (measured in the test: ~9e-2 relative at most, ~1e-2
  mean, on both archs), in the worst logit and on average. At a ragged
  length (JAX's kernel takes multiples of 128 only) JAX's pallas plan
  runs with its kernel replaced by its own reference, attention_ref, and
  the port is held within the same FLASH_TOL.
- A decode step: logits (and the cache rows the steps write) within
  DECODE_TOL = 2^-4. JAX's contiguous
  decode rounds its probabilities to bf16 before P.V; the port keeps them
  in f32 (kernels/paged_decode/ops.py), as its text archs do, which lie
  as far from JAX on the same harness (paper-demo and qwen2-1.5b: up to
  0.051 over six steps).
- Greedy tokens (the near-tie rule of tests/test_torch_hybrid_serving.py,
  made explicit since JAX has no engine for these archs): equal to JAX's
  one-shot up to a first difference, where JAX's own top two logits must
  lie within TIE_MARGIN = 2 x DECODE_TOL and the port's token be one
  within it; and equal to the argmax of JAX's full forward over the
  generated sequence wherever its top two lie further apart than
  TIE_MARGIN (most positions).
- Train mode: the loss within LOSS_TOL = 5e-4 and every gradient leaf
  within GRAD_TOL = 2.5e-2 relative L2 of jax.grad(Mo.lm_loss), as
  tests/test_torch_train.py holds the text archs (which also run these
  two archs' naive-plan loss and gradients with seeded stubs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.launch import serve as jax_cli
from repro.launch import steps as JSt
from repro.models import layers as JL
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import BlockManager as JaxBlockManager
from repro.serve import SlotPool as JaxSlotPool
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as cli
from repro_torch.models import layers as L
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.serve import (BlockManager, QuantBlockManager, SlotPool,
                               make_serving_engine)

VLM, AUDIO = "qwen2-vl-7b", "whisper-small"
ARCHS = (VLM, AUDIO)
TOL = 3e-2
DECODE_TOL = 2 ** -4
TIE_MARGIN = 2 * DECODE_TOL
FLASH_TOL = 0.1
LOSS_TOL = 5e-4
GRAD_TOL = 2.5e-2
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


def _jenv(impl, **kw):
    return JEnv(mesh=None, plan=JPlan(fsdp=False, remat="full",
                                      attn_impl=impl, kv_cache="replicated",
                                      **kw))


def _env(impl, **kw):
    return Env(plan=ParallelPlan(fsdp=False, remat="full", attn_impl=impl,
                                 kv_cache="replicated", **kw))


def _params(arch):
    """(JAX params, the port's bridged copy) of the smoke config."""
    if arch not in _PARAMS:
        jp = JMo.init_params(jax.random.PRNGKey(0), jax_smoke(arch),
                             _jenv("naive"))
        _PARAMS[arch] = (jp, bridge.to_torch(jax.tree.map(np.asarray, jp),
                                             "cpu"))
    return _PARAMS[arch]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(arch, B, S, seed):
    """Seeded tokens [B,S] and the arch's stubs (numpy f32): a VLM's
    vision embeddings, an encoder-decoder's S / enc_downsample frames."""
    cfg = jax_smoke(arch)
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    n = (cfg.num_vision_embeds if cfg.family == "vlm"
         else S // cfg.enc_downsample)
    name = "vision_embeds" if cfg.family == "vlm" else "frames"
    return tok, {name: rng.normal(size=(B, n, cfg.d_model)).astype(
        np.float32)}


def _jax_prefill(arch, env, tok, stubs):
    jp, _ = _params(arch)
    cfg = jax_smoke(arch)
    return jax.jit(lambda p, t, s: JMo.forward(
        p, t, cfg, env, mode="prefill", **s)[:2])(
            jp, jnp.asarray(tok), {k: jnp.asarray(v) for k, v in stubs.items()})


def _port_prefill(arch, tok, stubs):
    return Mo.forward(_params(arch)[1], torch.from_numpy(tok),
                      get_smoke(arch), Env(), mode="prefill",
                      **{k: torch.from_numpy(v) for k, v in stubs.items()})


def _rel(a, b):
    """|a - b| / max(|b|, 1) over every logit."""
    a, b = _f32(a), _f32(b)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


# ---------------------------------------------------------------------------
# configs, parameters, M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_equal_the_jax_configs(arch):
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke(arch), jax_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.num_blocks == ref.num_blocks


@pytest.mark.parametrize("arch", ARCHS)
def test_own_init_has_the_jax_tree_shapes_and_dtypes(arch):
    """whisper's encoder stack ("enc_blocks", one stacked "enc" unit, and
    "enc_norm") and its "dec" unit (attn, lnx, xattn) included, so the
    bridge lands JAX's tree on the port's structure."""
    jp, tp = _params(arch)
    own = Mo.init_params(get_smoke(arch), Env(), seed=0, device="cpu")
    assert (jax.tree.structure(jax.tree.map(lambda x: 0, tp))
            == jax.tree.structure(jax.tree.map(lambda x: 0, own)))
    for (path, jl), ol in zip(jax.tree_util.tree_leaves_with_path(jp),
                              jax.tree.leaves(own)):
        assert tuple(ol.shape) == tuple(jl.shape), path
        assert str(ol.dtype) == f"torch.{np.asarray(jl).dtype.name}", path
    if arch == AUDIO:
        cfg = get_smoke(arch)
        assert set(own["blocks"][0]) == {"ln1", "attn", "lnx", "xattn",
                                         "ln2", "mlp"}
        assert own["enc_blocks"][0]["attn"]["wq"].shape[0] == \
            cfg.encoder_layers


@pytest.mark.parametrize("S,nv", [(24, 8), (300, 256), (5, 0), (12, 9)])
def test_build_mrope_positions_matches_jax(S, nv):
    want = np.asarray(JMo.build_mrope_positions(S, nv))
    got = Mo.build_mrope_positions(S, nv).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    for cur in (nv, nv + 7, S + 3):
        want = np.asarray(JMo.build_mrope_positions(1, nv, cur_len=cur))
        got = Mo.build_mrope_positions(1, nv, cur_len=cur).numpy()
        assert np.array_equal(got, want)
    # a vector of cache positions: one row each (JAX takes a scalar)
    rows = Mo.build_mrope_positions(1, nv, cur_len=torch.tensor([S, S + 1]))
    assert rows.shape == (2, 1, 3) and int(rows[1, 0, 2]) - int(
        rows[0, 0, 2]) == 1


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_apply_mrope_matches_jax(sections, hd):
    """f32 angles per (temporal, h, w) section, the rotation in f32,
    rounded once to bf16: within one bf16 step of JAX's jitted
    apply_mrope (XLA's and PyTorch's f32 sin / cos may differ in the last
    bit), and most entries equal."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 40, 4, hd)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(_f32(jx))).to(torch.bfloat16)
    pos = JMo.build_mrope_positions(40, 16)
    want = _f32(jax.jit(lambda a, p: JL.apply_mrope(
        a, p, 1e6, sections))(jx, pos))
    got = _f32(L.apply_mrope(tx, torch.from_numpy(np.asarray(pos)), 1e6,
                             sections))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= step).all()
    assert (got == want).mean() > 0.99
    with pytest.raises(ValueError, match="sections"):
        L.apply_mrope(tx, torch.from_numpy(np.asarray(pos)), 1e6, (1, 2, 3))


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_jax(arch):
    """S = 16 (qwen2-vl: 8 vision positions + 16 tokens; whisper: 8
    frames), both packages' attention_naive: logits over every position
    and the caches (self-attention k/v after M-RoPE; whisper's xk/xv over
    the encoder's output) against JAX's."""
    tok, stubs = _inputs(arch, 2, 16, seed=1)
    jl, jc = _jax_prefill(arch, _jenv("pallas"), tok, stubs)
    tl, tc = _port_prefill(arch, tok, stubs)
    assert tl.shape == jl.shape
    assert float(np.abs(_f32(tl) - _f32(jl)).max()) < TOL
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    assert len(jleaves) == len(jax.tree.leaves(tc))
    for (path, want), got in zip(jleaves, jax.tree.leaves(tc)):
        assert tuple(got.shape) == tuple(want.shape), path
        assert float(np.abs(_f32(got) - _f32(want)).max()) < TOL, path


@pytest.mark.parametrize("arch,S", [(VLM, 248), (AUDIO, 512)])
def test_prefill_at_a_flash_length_within_jaxs_own_plan_spread(
        arch, S, monkeypatch):
    """qwen2-vl at 8 + 248 = 256 positions, whisper at 512 tokens over
    256 frames: the port's flash branch (its encoder's non-causal) against
    JAX's pallas plan, within JAX's naive-vs-pallas spread."""
    tok, stubs = _inputs(arch, 1, S, seed=2)
    pallas = _f32(_jax_prefill(arch, _jenv("pallas"), tok, stubs)[0])
    naive = _f32(_jax_prefill(arch, _jenv("naive"), tok, stubs)[0])
    calls = []
    flash = fa_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[1], kw["causal"]))
        return flash(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    mine = _port_prefill(arch, tok, stubs)[0]
    cfg = get_smoke(arch)
    if arch == AUDIO:  # every encoder layer non-causal, then the decoder
        assert calls == ([(S // 2, False)] * cfg.encoder_layers
                         + [(S, True)] * cfg.n_layers)
    else:
        assert calls == [(cfg.num_vision_embeds + S, True)] * cfg.n_layers
    err, spread = _rel(mine, pallas), _rel(naive, pallas)
    assert 0 < spread.max() < FLASH_TOL
    assert err.max() <= spread.max() and err.mean() <= spread.mean()


def test_prefill_at_a_ragged_flash_length_against_attention_ref(monkeypatch):
    """qwen2-vl at 8 + 150 = 158 positions, past 128 but no multiple of
    it: JAX's pallas plan with its kernel replaced by its reference."""
    def ref(q, k, v, *, causal=True, window=0, n_kv_heads=None, **kw):
        B, Sq, Hq, hd = q.shape
        o = jax_attn_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                         v.transpose(0, 2, 1, 3), causal=causal,
                         window=window)
        return o.transpose(0, 2, 1, 3).reshape(B, Sq, Hq * hd).astype(
            q.dtype)

    monkeypatch.setattr(jfa_ops, "flash_attention", ref)
    tok, stubs = _inputs(VLM, 1, 150, seed=3)
    want = _jax_prefill(VLM, _jenv("pallas"), tok, stubs)[0]
    err = _rel(_port_prefill(VLM, tok, stubs)[0], want)
    assert err.max() < FLASH_TOL


# ---------------------------------------------------------------------------
# decode and the one-shot
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax_on_the_same_cache(arch):
    """JAX's prefill caches (grown by 6) bridged to the port, then six
    decode steps of the same tokens on each side: qwen2-vl at M-RoPE
    positions past its vision embeddings, whisper reading its cross
    caches (all frames) and writing its self-attention cache."""
    cfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jp, tp = _params(arch)
    env = _jenv("naive")
    S, G, B = 16, 6, 3
    tok, stubs = _inputs(arch, B, S, seed=4)
    _, jc = _jax_prefill(arch, env, tok, stubs)
    jc = JMo.grow_caches(jc, G, cfg)
    tc = bridge.to_torch(jax.tree.map(np.asarray, jc), "cpu")
    off = cfg.num_vision_embeds if cfg.family == "vlm" else 0
    step = jax.jit(JSt.make_decode_step(cfg, env))
    rng = np.random.default_rng(5)
    for i in range(G):
        nt = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = step(jp, jc, jnp.asarray(nt),
                      jnp.asarray(S + off + i, jnp.int32))
        tl, tc = Mo.forward(tp, torch.from_numpy(nt), tcfg, Env(),
                            mode="decode", caches=tc, cur_len=S + off + i)
        assert float(np.abs(_f32(tl[:, 0]) - _f32(jl)).max()) < DECODE_TOL
    # the rows written past the first layer carry the step's difference
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jc),
                                 jax.tree.leaves(tc)):
        assert float(np.abs(_f32(got) - _f32(want)).max()) < DECODE_TOL, \
            path


def _jax_oneshot(arch, tok, stubs, gen):
    """JAX's serve_batch with the given stubs: (tokens [B,gen], the logits
    each token is the argmax of, [B,gen,V] f32)."""
    cfg = jax_smoke(arch)
    jp, _ = _params(arch)
    env = _jenv("naive")
    B, S = tok.shape
    lg, c = jax.jit(JSt.make_prefill_step(cfg, env))(
        jp, {"tokens": jnp.asarray(tok),
             **{k: jnp.asarray(v) for k, v in stubs.items()}})
    c = JMo.grow_caches(c, gen, cfg)
    step = jax.jit(JSt.make_decode_step(cfg, env))
    off = cfg.num_vision_embeds if cfg.family == "vlm" else 0
    V = cfg.vocab_size
    toks, lgs = [], []
    for i in range(gen):
        if i:
            lg, c = step(jp, c, toks[-1][:, None],
                         jnp.asarray(S + off + i - 1, jnp.int32))
        lgs.append(_f32(lg[:, :V]))
        toks.append(jnp.argmax(lg[:, :V], -1).astype(jnp.int32))
    return np.stack([np.asarray(t) for t in toks], 1), np.stack(lgs, 1)


def _hold_to_the_oracle(arch, tok, stubs, mine):
    """The module docstring's token rule: mine against JAX's one-shot
    (first differences at near-ties) and against the argmax of JAX's
    full forward over the prompt and mine (wherever it is clear)."""
    cfg = jax_smoke(arch)
    B, S = tok.shape
    gen = mine.shape[1]
    ref, lgs = _jax_oneshot(arch, tok, stubs, gen)
    for b in range(B):
        d = np.flatnonzero(mine[b] != ref[b])
        if len(d):
            row = lgs[b, d[0]]
            top = np.sort(row)[::-1]
            assert top[0] - top[1] <= TIE_MARGIN, (b, d[0], top[:2])
            assert row[mine[b, d[0]]] >= top[0] - TIE_MARGIN
    seq = np.concatenate([tok, mine[:, :-1]], 1)
    full = _f32(_jax_prefill(arch, _jenv("naive"), seq, stubs)[0])
    off = cfg.num_vision_embeds if cfg.family == "vlm" else 0
    full = full[:, off + S - 1:, :cfg.vocab_size]
    top2 = np.sort(full, -1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > TIE_MARGIN
    assert clear.mean() > 0.5
    assert np.array_equal(full.argmax(-1)[clear], mine[clear])
    return ref


@pytest.mark.parametrize("arch", ARCHS)
def test_oneshot_tokens_hold_to_jaxs_model(arch):
    """serve_batch's full prefill with seeded stubs, 4 prompts of 16
    tokens, 12 greedy tokens each."""
    tok, stubs = _inputs(arch, 4, 16, seed=6)
    mine = cli.serve_batch(get_smoke(arch), _params(arch)[1], tok, 12,
                           streamed_prefill=False, device="cpu",
                           stubs={k: torch.from_numpy(v)
                                  for k, v in stubs.items()})
    assert mine.shape == (4, 12) and mine.dtype == np.int32
    _hold_to_the_oracle(arch, tok, stubs, mine)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_oneshot_runs_with_jaxs_zero_stubs(arch, capsys):
    """--trace oneshot with zero stubs (JAX's serve_batch's): the
    tokens hold to JAX's own serve_batch on the same prompts under the
    token rule; a streamed one-shot, which would carry no modality, is
    refused."""
    args = cli.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                           "--trace", "oneshot", "--requests", "3",
                           "--gen", "8"])
    run = cli.run_oneshot(args, get_smoke(arch), _params(arch)[1])
    assert run["rc"] == 0 and run["tokens"].shape == (3, 8)
    assert "generated 24 tokens" in capsys.readouterr().out
    cfg = jax_smoke(arch)
    stubs = {k: v.numpy() for k, v in cli.modality_stubs(
        get_smoke(arch), 3, 16, "cpu").items()}
    want = np.asarray(jax_cli.serve_batch(
        None, cfg, _params(arch)[0], jnp.asarray(run["prompts"]), 8,
        _jenv("naive").plan))
    ref = _hold_to_the_oracle(arch, run["prompts"], stubs, run["tokens"])
    assert np.array_equal(ref, want)  # the oracle's one-shot is JAX's own
    with pytest.raises(ValueError, match="streamed"):
        cli.serve_batch(get_smoke(arch), _params(arch)[1], run["prompts"],
                        4, streamed_prefill=True, device="cpu")


def test_whisper_encoder_takes_the_flash_branch_in_the_oneshot(monkeypatch):
    """At prompt 512 the one-shot's encoder (256 frames) reaches the flash
    op non-causal in its prefill (on the card, kernel #4), as JAX's
    encoder does under its pallas plan, though the reference runs its
    encoder in train mode."""
    calls = []
    flash = fa_ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw["causal"])
        return flash(q, k, v, **kw)

    monkeypatch.setattr(fa_ops, "flash_attention", spy)
    cfg = get_smoke(AUDIO)
    tok = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 512))
    out = cli.serve_batch(cfg, _params(AUDIO)[1], tok, 3,
                          streamed_prefill=False, device="cpu")
    assert out.shape == (2, 3)
    assert calls == [False] * cfg.encoder_layers + [True] * cfg.n_layers


# ---------------------------------------------------------------------------
# the engines' refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_paths_raise_jaxs_value_error(arch):
    """The block pools and the slot pool refuse a VLM and an
    encoder-decoder with JAX's ValueError and words, before anything
    else, so the serving CLI fails as JAX's does."""
    jcfg, cfg = jax_smoke(arch), get_smoke(arch)
    kw = dict(num_slots=2, prompt_len=16, max_gen=4)
    with pytest.raises(ValueError) as want:
        JaxBlockManager(jcfg, _jenv("naive"), **kw)
    with pytest.raises(ValueError) as want_slot:
        JaxSlotPool(jcfg, _jenv("naive"), **kw)
    for cls in (BlockManager, QuantBlockManager):
        with pytest.raises(ValueError) as got:
            cls(cfg, Env(), device="cpu", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        SlotPool(cfg, Env(), device="cpu", **kw)
    assert str(got.value) == str(want_slot.value)
    for kv in ("paged", "quant", "slot"):
        with pytest.raises(ValueError, match="decoder-only"):
            make_serving_engine(cfg, _params(arch)[1], kv=kv, device="cpu",
                                prefill_chunk=0, **kw)
    if cfg.is_encdec:  # the cross caches have no block layout
        with pytest.raises(ValueError, match="paged-cache layout"):
            Mo.init_paged_cache(cfg, Env(), 4, 8, device="cpu")


# ---------------------------------------------------------------------------
# train mode
# ---------------------------------------------------------------------------


def _loss_grads(arch, jenv, env, S, seed):
    """(JAX loss, JAX gradient leaves, port loss, port gradient leaves)
    of lm_loss on a seeded batch with seeded stubs."""
    cfg, tcfg = jax_smoke(arch), get_smoke(arch)
    jp, tp = _params(arch)
    tok, stubs = _inputs(arch, 2, S, seed)
    labels = np.roll(tok, -1, axis=1)
    batch = {"tokens": tok, "labels": labels, **stubs}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JMo.lm_loss(p, batch, cfg, jenv), has_aux=True))(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (tl, _), tg = A.value_and_grad(lambda p: Mo.lm_loss(p, tb, tcfg, env),
                                   tp)
    return (float(jl), [np.asarray(x, np.float32) for x in jax.tree.leaves(jg)],
            float(tl), [x.float().numpy() for x in A.tree_leaves(tg)])


def _grel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_encoder_train_under_xla_chunked_matches_jax():
    """whisper at S = 32 (16 frames) with attention chunks of 8: its
    encoder's non-causal attention_chunked and its decoder's causal one,
    loss and every gradient leaf against jax.grad."""
    kw = dict(attn_q_chunk=8, attn_kv_chunk=8)
    jl, jg, tl, tg = _loss_grads(AUDIO, _jenv("xla_chunked", **kw),
                                 _env("xla_chunked", **kw), 32, seed=9)
    assert abs(tl - jl) <= LOSS_TOL
    assert len(tg) == len(jg)
    assert max(_grel(t, j) for t, j in zip(tg, jg)) <= GRAD_TOL


def test_vlm_loss_reads_the_text_positions_only():
    """qwen2-vl's lm_loss scores the S text positions after its vision
    embeddings (JAX's slice): loss and gradients against jax.grad, and a
    change of the logits at the vision positions alone moves nothing."""
    jl, jg, tl, tg = _loss_grads(VLM, _jenv("naive"), _env("naive"), 16,
                                 seed=10)
    assert abs(tl - jl) <= LOSS_TOL
    assert max(_grel(t, j) for t, j in zip(tg, jg)) <= GRAD_TOL
    cfg = get_smoke(VLM)
    tok, stubs = _inputs(VLM, 2, 16, seed=10)
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, axis=1)),
             **{k: torch.from_numpy(v) for k, v in stubs.items()}}
    with torch.no_grad():
        base, _ = Mo.lm_loss(_params(VLM)[1], batch, cfg, _env("naive"))
        lg, _ = Mo.forward(_params(VLM)[1], batch["tokens"], cfg,
                           _env("naive"), mode="train",
                           vision_embeds=batch["vision_embeds"])
    assert lg.shape[1] == cfg.num_vision_embeds + 16
    nv = cfg.num_vision_embeds
    logz, ll = Mo.token_logprobs(lg[:, nv:], batch["labels"], cfg)
    assert torch.equal(torch.mean(logz - ll), base)


def test_encoder_train_past_128_frames_under_the_pallas_plan_raises():
    """Train mode needs a gradient, and the flash kernel has none (nor
    has JAX's): whisper's encoder at 160 frames raises under the pallas
    plan, where a prefill of the same input runs (the flash branch)."""
    cfg = get_smoke(AUDIO)
    tok, stubs = _inputs(AUDIO, 1, 320, seed=11)
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok),
          "frames": torch.from_numpy(stubs["frames"])}
    with pytest.raises(NotImplementedError, match="no backward"):
        Mo.lm_loss(_params(AUDIO)[1], tb, cfg, Env())
    lg, caches = _port_prefill(AUDIO, tok, stubs)
    assert lg.shape[1] == 320 and caches["blocks"][0]["xk"].shape[-2] == 160
