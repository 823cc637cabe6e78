"""The port's train mode, AdamW and train step against the JAX package.

Weights are the port's seeded init (`Mo.init_params(cfg, Env(), seed=0)`,
the JAX package's tree, shapes and dtypes) handed to the JAX package as
arrays of the same bits: its own eager init of the recurrent smoke
configs takes seconds per arch, which this file cannot spend. Tokens,
labels and cotangents are made with numpy and handed to both packages;
the port runs on the CPU.

Tolerances, and why:
- Loss within LOSS_TOL = 5e-4 and every gradient leaf within GRAD_TOL =
  2.5e-2 relative L2 error of `jax.grad(Mo.lm_loss)` (naive plan, B=2,
  S=16). Gradients of a bf16 model round at every product, and a single
  logit on the other side of a bf16 rounding sends a different value back
  through every layer. JAX's own naive and xla_chunked plans, which
  compute the same function in another order, lie up to 2.0e-2 apart per
  leaf and up to 4.9e-3 apart in the loss on these configs (attention
  chunks of 8); the port lies within 1.9e-2 and 2.2e-4 of the naive plan.
  test_xla_chunked_plan_matches_jax measures JAX's spread again and holds
  GRAD_TOL above it.
- The chunked attentions, the associative RG-LRU scan and the MoE layer's
  forward are bit-equal to JAX's (eager; jit fuses the scan's multiply-add
  and moves it by at most a few ulps), and so are their vector-Jacobian
  products except the MoE's (bf16 SiLU gradients round apart, within
  1e-2).
- AdamW: bit-equal to JAX's eager update when clipping is off. With it on,
  the global norm sums its squares in another order (a few ulps), which
  moves the clip factor and with it every moment and update by about 1e-6
  relative; an int8 moment may then round to its neighbour.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.launch import steps as JSt
from repro.models import layers as JL
from repro.models import model as JMo
from repro.models import moe as JM
from repro.models import recurrent as JR
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.paged_decode import ops as pd_ops
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.kernels.sampling import ops as mask_ops
from repro_torch.launch import steps as St
from repro_torch.models import layers as L
from repro_torch.models import model as Mo
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A

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


LOSS_TOL = 5e-4
GRAD_TOL = 2.5e-2
B, S = 2, 16


def _jplan(impl, **kw):
    return JEnv(mesh=None, plan=JPlan(fsdp=False, remat="full",
                                      attn_impl=impl, kv_cache="replicated",
                                      **kw))


def _plan(impl, remat="full", **kw):
    return Env(plan=ParallelPlan(fsdp=False, remat=remat, attn_impl=impl,
                                 kv_cache="replicated", **kw))


_PARAMS = {}


def _jax(t):
    """A torch tensor as a JAX array of the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _cfgs(arch):
    """(JAX config, port config): the smoke config, or "local+attn", a
    paper-demo smoke with a window-12 local layer before its attention
    layer (both train attentions of the xla_chunked plan in one model)."""
    if arch == "local+attn":
        kw = dict(block_pattern=("local", "attn"), local_window=12)
        return (dataclasses.replace(get_smoke("paper-demo"), **kw),
                dataclasses.replace(torch_smoke("paper-demo"), **kw))
    return get_smoke(arch), torch_smoke(arch)


def _params(arch):
    """(JAX tree, port tree) of the port's seed-0 weights (made once)."""
    if arch not in _PARAMS:
        p = Mo.init_params(_cfgs(arch)[1], Env(), seed=0, device="cpu")
        _PARAMS[arch] = (A.tree_map(_jax, p), p)
    return _PARAMS[arch]


def _torch(tree):
    return bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")


def _batch(cfg, seed=3, S=S):
    """Tokens and labels, and a modality arch's seeded stubs: a VLM's
    vision embeddings, an encoder-decoder's S / enc_downsample frames."""
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    stub = lambda n: rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision_embeds"] = stub(cfg.num_vision_embeds)
    if cfg.is_encdec:
        batch["frames"] = stub(S // cfg.enc_downsample)
    return batch


def _jax_loss_grad(arch, env, batch):
    cfg = _cfgs(arch)[0]
    f = jax.jit(jax.value_and_grad(
        lambda p: JMo.lm_loss(p, batch, cfg, env), has_aux=True))
    (loss, m), g = f(_params(arch)[0])
    return float(loss), m, [np.asarray(x, np.float32)
                            for x in jax.tree.leaves(g)]


def _port_loss_grad(arch, env, batch):
    cfg = _cfgs(arch)[1]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    (loss, m), g = A.value_and_grad(
        lambda p: Mo.lm_loss(p, tb, cfg, env), _params(arch)[1])
    return float(loss), m, [x.float().numpy() for x in A.tree_leaves(g)]


def _rel(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_loss_and_every_gradient_leaf_match_jax(arch):
    batch = _batch(get_smoke(arch))
    jl, jm, jg = _jax_loss_grad(arch, _jplan("naive"), batch)
    tl, tm, tg = _port_loss_grad(arch, _plan("naive"), batch)
    assert abs(tl - jl) <= LOSS_TOL, (tl, jl)
    assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-5
    assert len(tg) == len(jg)
    rel = [_rel(t, j) for t, j in zip(tg, jg)]
    assert all(np.isfinite(t).all() for t in tg)
    assert max(rel) <= GRAD_TOL, max(rel)


def test_xla_chunked_plan_matches_jax():
    """attn_q_chunk = attn_kv_chunk = 8 at S=32 on "local+attn" (see
    _cfgs): attention_window_prefill in the local layer and
    attention_chunked in the attention layer, loss and gradients against
    JAX's; JAX's own spread between its two plans stays below GRAD_TOL."""
    arch = "local+attn"
    batch = _batch(_cfgs(arch)[0], seed=4, S=32)
    kw = dict(attn_q_chunk=8, attn_kv_chunk=8)
    jl, _, jg = _jax_loss_grad(arch, _jplan("xla_chunked", **kw), batch)
    tl, _, tg = _port_loss_grad(arch, _plan("xla_chunked", **kw), batch)
    assert abs(tl - jl) <= LOSS_TOL
    assert max(_rel(t, j) for t, j in zip(tg, jg)) <= GRAD_TOL
    _, _, ng = _jax_loss_grad(arch, _jplan("naive"), batch)
    spread = max(_rel(c, n) for c, n in zip(jg, ng))
    assert 0.0 < spread < GRAD_TOL, spread
    # the port's own forward: chunked and naive logits agree closely
    p = _params(arch)[1]
    tok = torch.as_tensor(batch["tokens"])
    tcfg = _cfgs(arch)[1]
    with torch.no_grad():
        lc, _ = Mo.forward(p, tok, tcfg, _plan("xla_chunked", **kw),
                           mode="train")
        ln, _ = Mo.forward(p, tok, tcfg, _plan("naive"), mode="train")
    assert float((lc.float() - ln.float()).abs().max()) < 0.1


@pytest.mark.parametrize("window", [0, 6])
def test_chunked_attentions_match_jax_bit_for_bit(window):
    """layers.attention_chunked (causal, with and without a window) and
    attention_window_prefill against JAX's (jitted), forward and
    vector-Jacobian product, bf16 inputs."""
    jcfg, cfg = get_smoke("paper-demo"), torch_smoke("paper-demo")
    env = _jplan("xla_chunked")
    rng = np.random.default_rng(window)
    q, k, v = (jnp.asarray(rng.standard_normal((B, 32, h, 16)), jnp.bfloat16)
               for h in (4, 2, 2))
    ct = jnp.asarray(rng.standard_normal((B, 32, 64)), jnp.bfloat16)
    cases = [(lambda *a: JL.attention_chunked(*a, jcfg, env, causal=True,
                                              window=window, q_chunk=8,
                                              kv_chunk=8),
              lambda *a: L.attention_chunked(*a, cfg, causal=True,
                                             window=window, q_chunk=8,
                                             kv_chunk=8))]
    if window:
        cases.append((lambda *a: JL.attention_window_prefill(
            *a, jcfg, env, window=window, q_chunk=8),
            lambda *a: L.attention_window_prefill(*a, cfg, window=window,
                                                  q_chunk=8)))
    for jf, tf in cases:
        oj, gj = jax.jit(lambda q, k, v, ct: (
            lambda o, vjp: (o, vjp(ct)))(*jax.vjp(jf, q, k, v)))(q, k, v, ct)
        qkv = [_torch(x).requires_grad_() for x in (q, k, v)]
        ot = tf(*qkv)
        gt = torch.autograd.grad(ot, qkv, _torch(ct))
        assert torch.equal(ot, _torch(oj))
        for a, b in zip(gt, gj):
            assert torch.equal(a, _torch(b))


def test_pallas_plan_raises_past_128_positions():
    """Under the pallas plan train mode takes attention_naive up to 128
    positions and refuses past them: the flash kernel has no backward,
    and jax.grad through the reference's fails (pinned below)."""
    cfg = torch_smoke("paper-demo")
    p = _params("paper-demo")[1]
    env = _plan("pallas")
    tok = torch.zeros((1, 129), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no backward"):
        Mo.forward(p, tok, cfg, env, mode="train")
    logits, _ = Mo.forward(p, tok[:, :128], cfg, env, mode="train")
    assert logits.shape == (1, 128, 512)
    # the reference: the flash kernel's forward runs at 256 positions in
    # interpret mode, its gradient does not
    from repro.kernels.flash_attention import ops as jfa
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 256, h, 16)), jnp.bfloat16)
               for h in (4, 2, 2))
    jfa.flash_attention(q, k, v, causal=True, n_kv_heads=2)
    with pytest.raises(AssertionError):
        jax.grad(lambda q: jnp.sum(jfa.flash_attention(
            q, k, v, causal=True, n_kv_heads=2).astype(jnp.float32)))(q)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_logits_equal_prefill_logits_in_the_port(arch):
    """Train mode is prefill's stack: its logits are prefill's, bit for
    bit, on the attention and MoE archs and the modality archs, stubs
    included (S <= 128: both take attention_naive). The recurrent archs
    close their recurrences in another order in train mode (the
    associative scan and the chunked WKV against the kernels' sequential
    plain versions), within one bf16 step of the logits."""
    cfg = torch_smoke(arch)
    p = _params(arch)[1]
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    tok = batch["tokens"]
    stubs = {k: v for k, v in batch.items()
             if k in ("vision_embeds", "frames")}
    with torch.no_grad():
        lt, _ = Mo.forward(p, tok, cfg, _plan("naive"), mode="train",
                           **stubs)
        lp, _ = Mo.forward(p, tok, cfg, Env(), mode="prefill", **stubs)
    if (set(cfg.block_pattern) | set(cfg.pattern_tail)
            <= {"attn", "moe", "dec"}):
        assert torch.equal(lt, lp)
    else:
        assert float((lt.float() - lp.float()).abs().max()) <= 2 ** -5


def test_remat_recomputes_the_same_values():
    """plan.remat "nothing" wraps each pattern unit (here local + attn)
    in torch.utils.checkpoint: loss and every gradient equal to no
    remat."""
    arch = "local+attn"
    batch = _batch(_cfgs(arch)[0])
    full = _port_loss_grad(arch, _plan("naive", remat="full"), batch)
    remat = _port_loss_grad(arch, _plan("naive", remat="nothing"), batch)
    assert full[0] == remat[0]
    assert all(np.array_equal(a, b) for a, b in zip(full[2], remat[2]))


def test_train_mode_calls_no_kernel(monkeypatch):
    """Train mode runs none of the seven kernels' ops, on any arch kind
    (paper-demo at 129 positions, where prefill takes the flash
    kernel)."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel op ran in train mode")

    for mod, name in ((fa_ops, "flash_attention"), (R, "rglru_scan"),
                      (R, "wkv6"), (pd_ops, "paged_flash_decode"),
                      (pd_ops, "paged_flash_decode_quant"),
                      (mask_ops, "topk_topp_mask"), (rg_ops, "rglru_scan"),
                      (wkv_ops, "wkv6")):
        monkeypatch.setattr(mod, name, refuse)
    for arch, n in (("paper-demo", 129), ("recurrentgemma-9b", 16),
                    ("rwkv6-1.6b", 16), ("grok-1-314b", 16)):
        cfg = torch_smoke(arch)
        tok = torch.zeros((1, n), dtype=torch.int32)
        (loss, _), g = A.value_and_grad(
            lambda p: Mo.lm_loss(p, {"tokens": tok, "labels": tok}, cfg,
                                 _plan("naive")), _params(arch)[1])
        assert math.isfinite(float(loss))


@pytest.mark.parametrize("S", [1, 7, 24])
def test_rglru_associative_scan_matches_jax(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (2, S, 32)).astype(np.float32)
    b = rng.standard_normal((2, S, 32)).astype(np.float32)
    ct = rng.standard_normal((2, S, 32)).astype(np.float32)
    hj, vjp = jax.vjp(JR.rglru_scan, jnp.asarray(a), jnp.asarray(b))
    at, bt = (torch.as_tensor(x).requires_grad_() for x in (a, b))
    ht = R.rglru_scan_assoc(at, bt)
    assert np.array_equal(ht.detach().numpy(), np.asarray(hj))
    gt = torch.autograd.grad(ht, (at, bt), torch.as_tensor(ct),
                             allow_unused=True)
    for t, j in zip(gt, vjp(jnp.asarray(ct))):
        t = np.zeros_like(a) if t is None else t.numpy()
        assert np.array_equal(t, np.asarray(j))
    hjit = np.asarray(jax.jit(JR.rglru_scan)(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(hjit - np.asarray(hj)).max() <= 1e-6


@pytest.mark.parametrize("S,chunk", [(16, 8), (128, 64)])
def test_chunked_wkv6_matches_jax(S, chunk):
    """rwkv_time_mix_chunked against JAX's: the bf16 output within one
    bf16 step where the f32 sums round it to the other neighbour, the f32
    state within 1e-5 relative, and the vector-Jacobian product."""
    rng = np.random.default_rng(S)
    H, hd = 2, 8
    r, k, v = (jnp.asarray(rng.standard_normal((B, S, H, hd)), jnp.bfloat16)
               for _ in range(3))
    logw = jnp.asarray(-np.exp(rng.uniform(-4, 1, (B, S, H, hd))),
                       jnp.float32)
    u = jnp.asarray(rng.standard_normal((H, hd)) * 0.3, jnp.float32)
    co = jnp.asarray(rng.standard_normal((B, S, H, hd)), jnp.bfloat16)
    cs = jnp.asarray(rng.standard_normal((B, H, hd, hd)), jnp.float32)
    (oj, sj), vjp = jax.vjp(jax.jit(
        lambda *a: JR.rwkv_time_mix_chunked(*a, chunk=chunk)),
        r, k, v, logw, u)
    ins = [_torch(x).requires_grad_() for x in (r, k, v, logw, u)]
    ot, st = R.rwkv_time_mix_chunked(*ins, chunk=chunk)
    d = (ot.float() - _torch(oj).float()).abs()
    assert float(d.max()) <= 2 ** -6 and float((d > 0).float().mean()) < 1e-2
    assert _rel(st.detach().numpy(), np.asarray(sj)) < 1e-5
    gt = torch.autograd.grad((ot, st), ins, (_torch(co), _torch(cs)))
    for t, j in zip(gt, vjp((co, cs))):
        assert _rel(t.float().numpy(), np.asarray(j, np.float32)) < 1e-2


@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-scout-17b-a16e"])
def test_moe_layer_aux_loss_and_gradients_match_jax(arch):
    cfg = get_smoke(arch)
    env = _jplan("naive")
    p = JM.init_moe(jax.random.PRNGKey(0), cfg, env)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)), jnp.bfloat16)
    ct = jnp.asarray(rng.standard_normal(x.shape), jnp.bfloat16)
    def f(p, x, ct):
        out, vjp = jax.vjp(lambda p, x: JM.moe_layer(p, x, cfg, env), p, x)
        return out, vjp((ct, jnp.ones((), jnp.float32)))

    (yj, auxj), (gpj, gxj) = jax.jit(f)(p, x, ct)
    pt = {n: t.requires_grad_() for n, t in _torch(p).items()}
    xt = _torch(x).requires_grad_()
    yt, auxt = M.moe_layer(pt, xt, torch_smoke(arch))
    assert torch.equal(yt, _torch(yj))
    # jit sums the aux loss in another order (eager: bit-equal)
    assert abs(float(auxt) - float(auxj)) <= 2e-7 * abs(float(auxj))
    names = sorted(pt)
    gt = torch.autograd.grad((yt, auxt), [xt] + [pt[n] for n in names],
                             (_torch(ct), torch.ones(())))
    want = [gxj] + [gpj[n] for n in names]
    for t, j in zip(gt, want):
        assert _rel(t.float().numpy(), np.asarray(j, np.float32)) < 1e-2


def _opt_tree(rng):
    return {"w": jnp.asarray(rng.standard_normal((4, 33, 16)), jnp.bfloat16),
            "b": jnp.asarray(rng.standard_normal((64,)), jnp.float32),
            "t": (jnp.asarray(rng.standard_normal((8, 5)), jnp.bfloat16),)}


def _jl(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _tl(tree):
    return [x.float().numpy() for x in A.tree_leaves(tree)]


@pytest.mark.parametrize("state_dtype", ["fp32", "int8"])
def test_adamw_update_matches_jax(state_dtype):
    """Four steps from one bridged state: without clipping bit-equal to
    JAX's eager update (params, master, moments). With clipping active the
    clip factor lies within 4e-6 relative of JAX's; the fp32 moments and
    master weights within 1e-5 of each leaf's largest magnitude; int8
    moments at most one quantum apart in under 2% of their entries, which
    may move an update by up to lr, so their master weights are held to
    4 lr (four steps)."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    for clip in (1e9, 1.0):
        kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
                  state_dtype=state_dtype)
        jcfg, tcfg = JA.AdamWConfig(**kw), A.AdamWConfig(**kw)
        js = JA.adamw_init(params, jcfg)
        ts = _torch(js)  # the JAX state, bridged
        for _ in range(4):
            g = jax.tree.map(lambda p: jnp.asarray(
                rng.standard_normal(p.shape), p.dtype), params)
            gt = _torch(g)
            jp, js = JA.adamw_update(g, js, jcfg)
            tp, ts = A.adamw_update(gt, ts, tcfg)
            assert int(ts["step"]) == int(js["step"])
            if clip > 1e6:
                for part in ("params", "master", "m", "v"):
                    t = tp if part == "params" else ts[part]
                    j = jp if part == "params" else js[part]
                    for a, b in zip(_tl(t), _jl(j)):
                        assert np.array_equal(a, b), part
                continue
            jclip = min(1.0, clip / float(JA.global_norm(g)))
            tclip = min(1.0, clip / float(A.global_norm(gt)))
            assert abs(tclip - jclip) <= 4e-6 * jclip
            mtol = 4 * kw["lr"] if state_dtype == "int8" else None
            for a, b in zip(_tl(ts["master"]), _jl(js["master"])):
                d = np.abs(a - b).max()
                assert d <= (mtol or 1e-5 * np.abs(b).max()), d
            for part in ("m", "v"):
                for a, b in zip(A.tree_leaves(ts[part]),
                                jax.tree.leaves(js[part])):
                    b = np.asarray(b)
                    if a.dtype == torch.int8:  # one quantum at most
                        d = np.abs(a.numpy().astype(np.int32)
                                   - b.astype(np.int32))
                        assert d.max() <= 1 and (d > 0).mean() < 2e-2
                    elif state_dtype == "fp32" or b.ndim == 1:
                        d = np.abs(a.numpy() - b).max()
                        assert d <= 1e-5 * np.abs(b).max(), (part, d)


def test_cosine_lr_matches_jax():
    """Within 4 f32 ulps of JAX's at every step, and equal through the
    warmup: XLA's and PyTorch's f32 cos round an ulp apart now and then,
    and 1 + cos near cos = -1 magnifies that (at step 10 of the first
    schedule the learning rates are 2 ulps apart)."""
    for cfg in (dict(warmup_steps=3, total_steps=12),
                dict(warmup_steps=0, total_steps=7, min_lr_frac=0.0)):
        jcfg, tcfg = JA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
        for step in range(15):
            t = np.float32(A.cosine_lr(tcfg, torch.tensor(step)))
            j = np.float32(JA.cosine_lr(jcfg, jnp.asarray(step)))
            assert abs(int(t.view(np.int32)) - int(j.view(np.int32))) <= 4
            if step <= cfg["warmup_steps"]:
                assert t == j


def test_train_step_tracks_jax_and_the_loss_falls():
    """Five make_train_step steps on the paper-demo smoke config (one
    fixed batch, lr 1e-3, clipping active) from one state: the first loss
    within LOSS_TOL of JAX's, every later one within 1e-2, and falling.
    Each step rounds the new weights to bf16 and the next gradients move
    apart from there: JAX's own naive and xla_chunked plans (chunks of 8)
    part by up to 2.5e-3 over the same five steps; the port and JAX's
    naive plan by up to 3.5e-3 (CPU)."""
    arch = "paper-demo"
    jcfg, cfg = get_smoke(arch), torch_smoke(arch)
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=10, weight_decay=0.0)
    batch = _batch(jcfg, seed=5)
    jstep = jax.jit(JSt.make_train_step(jcfg, _jplan("naive"),
                                        JA.AdamWConfig(**opt)))
    tstep = St.make_train_step(cfg, _plan("naive"), A.AdamWConfig(**opt))
    js = JA.make_train_state(_params(arch)[0], JA.AdamWConfig(**opt))
    ts = {"params": _torch(js["params"]), "opt": _torch(js["opt"])}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jl, tl = [], []
    for _ in range(5):
        js, jm = jstep(js, batch)
        ts, tm = tstep(ts, tb)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert abs(tl[0] - jl[0]) <= LOSS_TOL
    assert all(abs(a - b) <= 1e-2 for a, b in zip(tl, jl)), (tl, jl)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    assert all(p.grad is None and not p.requires_grad
               for p in A.tree_leaves(ts["params"]))
