"""The port's CUDA kernels and serving path on the card.

Every test here needs an NVIDIA GPU (marker `gpu`) and skips without one.
The file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed; tests/conftest.py imports jax, hence:

  PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_cuda.py

Each kernel is held to its plain version on the same inputs: paged decode
over the bf16 and the int8 pool within 1e-5 (both sides compute in f32
from the same bf16 or int8-and-scale inputs; sound runs read below 1e-6,
a kernel rounding its probabilities to bf16 reads above 1e-3; a row's
output bit-equal across batch composition and block size), the
top-k/top-p mask exactly (torch.equal, at the edges of its semantics
and on rows wider than shared memory; two calls bit-equal, a row alone
equal to the same row in a batch), flash-decoding's partials within 1e-5 in f32 and
bf16 (l relative: a sum of up to S terms), flash
attention within 2e-2 on its bf16 output (the JAX package's bound for its
kernel, tests/test_kernels.py: one bf16 rounding of values of a few units
is up to 1.6e-2), the RG-LRU scan bit for bit (the kernel rounds each
product and sum as the plain version does) and the WKV6 recurrence within
2e-3 on its f32 outputs (the JAX package's bound, tests/test_kernels.py).
On the serving path: the host swap tier restores a bf16 and an int8 pool
byte for byte, and speculative verify rows on the paged, int8 and slot
pools emit the non-speculative tokens bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_partials,
                                                  merge_partials_stacked)
from repro_torch.kernels.flash_decode.ref import flash_decode_partials_ref
from repro_torch.kernels.paged_decode.ops import (SPAN, paged_flash_decode,
                                                  paged_flash_decode_quant,
                                                  quantize_kv)
from repro_torch.kernels.paged_decode.ref import (paged_decode_quant_ref,
                                                  paged_decode_ref)
from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_ref_loop
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.kernels.sampling.ops import (CLUSTER, MAX_SHARE,
                                              MAX_VOCAB, topk_topp_mask)
from repro_torch.kernels.sampling.ref import topk_topp_mask_ref
from repro_torch.launch.serve import modality_stubs, serve_batch
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import tree_map
from repro_torch.serve import (BlockManager, EDFPolicy, Request,
                               SamplingParams, ServingEngine,
                               make_kv_backend, make_serving_engine,
                               poisson_trace, repetitive_trace,
                               run_to_completion)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("B,Hq,Hkv,hd,bs,MB", [
    (2, 4, 2, 32, 16, 4), (3, 8, 8, 64, 8, 3), (1, 4, 1, 128, 32, 2),
    (9, 12, 4, 64, 16, 6), (5, 16, 1, 256, 16, 9), (3, 32, 2, 256, 8, 4),
    (4, 12, 2, 128, 16, 5), (4, 16, 2, 128, 8, 9)])
def test_paged_decode_kernel_matches_plain(B, Hq, Hkv, hd, bs, MB, cuda):
    rng = np.random.default_rng(B + hd)
    NB = 1 + B * MB + 3
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    q, kp, vp = mk(B, Hq, hd), mk(NB, Hkv, bs, hd), mk(NB, Hkv, bs, hd)
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:B * MB]
                              .reshape(B, MB).astype(np.int32)).to(cuda)
    lengths = torch.tensor([(i * 7) % (MB * bs) for i in range(B)],
                           dtype=torch.int32, device=cuda)
    lengths[0] = -1
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert float((got - paged_decode_ref(q, kp, vp, tables, lengths))
                 .abs().max()) < 1e-5
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("B,Hq,Hkv,hd,bs,MB", [
    (2, 4, 2, 32, 16, 4), (3, 8, 8, 64, 8, 3), (1, 4, 1, 128, 32, 2),
    (9, 12, 4, 64, 16, 6), (4, 16, 1, 256, 16, 5), (4, 12, 2, 128, 16, 5),
    (4, 16, 2, 128, 8, 9)])
def test_quant_paged_decode_kernel_matches_plain(B, Hq, Hkv, hd, bs, MB,
                                                 cuda):
    """The sweep shapes cover hd 32 to 256, the heads on the MMA's N
    (groups 1, 2, 3, 6 and 8; 6 and 8 at hd 128, the widest int8 forms
    below hd 256) and on its M (16); rows 0-2 are the masks: fully
    masked, depth 0, the whole table."""
    rng = np.random.default_rng(B + hd + 1)
    NB = 1 + B * MB + 3
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    q = mk(B + 3, Hq, hd).to(torch.bfloat16)
    kq, ks = quantize_kv(mk(NB, Hkv, bs, hd))
    vq, vs = quantize_kv(mk(NB, Hkv, bs, hd))
    ids = rng.permutation(np.arange(1, NB))
    rows = [ids[(i % B) * MB:(i % B + 1) * MB] for i in range(B + 3)]
    tables = torch.from_numpy(np.stack(rows).astype(np.int32)).to(cuda)
    lengths = torch.tensor([-1, 0, MB * bs - 1]
                           + [(i * 7) % (MB * bs) for i in range(B)],
                           dtype=torch.int32, device=cuda)
    before = paged_flash_decode_quant.launches
    got = paged_flash_decode_quant(q, kq, vq, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    assert paged_flash_decode_quant.launches == before + 1
    want = paged_decode_quant_ref(q, kq, vq, ks, vs, tables, lengths)
    assert float((got - want).abs().max()) < 1e-5
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.parametrize("quant", [False, True])
def test_split_paged_decode_over_long_rings_matches_plain(quant, cuda):
    """GQA 16, hd 256 over recurrentgemma-9b's window rings: full rings
    (2047), lengths at and around the 64-token span edges, depth 0 and a
    masked row, so rows end in every part of a span and use from one to
    all 32 spans (merged by the second launch past one)."""
    rng = np.random.default_rng(31 + quant)
    Hq, Hkv, hd, bs, MB = 16, 1, 256, 16, 128
    lens = [2047, 1500, 64, 63, 65, 127, 128, 0, -1]
    B, NB = len(lens), 1 + 3 * MB
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    q = mk(B, Hq, hd).to(torch.bfloat16)
    ids = rng.permutation(np.arange(1, NB))
    tables = torch.from_numpy(np.stack([ids[(i % 3) * MB:(i % 3 + 1) * MB]
                                        for i in range(B)]).astype(
        np.int32)).to(cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    if quant:
        kq, ks = quantize_kv(mk(NB, Hkv, bs, hd))
        vq, vs = quantize_kv(mk(NB, Hkv, bs, hd))
        args = (q, kq, vq, ks, vs, tables, lengths)
        op, ref = paged_flash_decode_quant, paged_decode_quant_ref
    else:
        args = (q, mk(NB, Hkv, bs, hd).to(torch.bfloat16),
                mk(NB, Hkv, bs, hd).to(torch.bfloat16), tables, lengths)
        op, ref = paged_flash_decode, paged_decode_ref
    before = op.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert op.launches == before + 1
    assert float((got - ref(*args)).abs().max()) < 1e-5
    assert float(got[-1].abs().max()) == 0.0


def _paged_copies(k, v, ks, vs, bs, rng, cuda):
    """The contiguous per-row K/V [B,Hkv,S,hd] (and int8 scales [B,Hkv,S])
    paged into a pool of blocks of bs tokens at shuffled physical ids,
    with tables [B,S/bs]; bs = S is the one-shot baseline's layout."""
    B, Hkv, S, hd = k.shape
    MB = S // bs
    NB = 1 + B * MB
    ids = torch.from_numpy(rng.permutation(np.arange(1, NB)).reshape(
        B, MB).astype(np.int32)).to(cuda)
    pools = []
    for x in (k, v, ks, vs):
        if x is None:
            pools.append(None)
            continue
        pool = torch.zeros((NB, Hkv, bs) + x.shape[3:], dtype=x.dtype,
                           device=cuda)
        pool[ids.long().reshape(-1)] = x.reshape(
            (B, Hkv, MB, bs) + x.shape[3:]).transpose(1, 2).reshape(
            (B * MB, Hkv, bs) + x.shape[3:])
        pools.append(pool)
    return pools, ids


# (G, hd, Hkv, S, lengths): rows over several spans (span_plan: SPAN at
# G 3, SPAN_GQA16 at G 16), one span, depth 0 and masked; the serving
# path's 288-token tables, one span narrower than SPAN
EQUAL_CASES = [(3, 64, 2, 1152, [1151, 600, 512, 511, 300, 17, 0, -1]),
               (16, 256, 1, 320, [319, 200, 128, 64, 63, 0, -1]),
               (3, 64, 2, 288, [287, 256, 255, 100, 0, -1])]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G,hd,Hkv,S,lens", EQUAL_CASES)
def test_paged_decode_rows_are_bit_equal_across_batch_and_block_size(
        G, hd, Hkv, S, lens, quant, cuda):
    """A row's output depends only on its q, its tokens' K and V in logical
    order and its length: torch.equal for the row alone, among the others
    in shuffled order, with the same logical K/V paged at bs 8 and 16 and
    as one contiguous block of S tokens (the baseline's layout), and in
    tables SPAN tokens wider (null blocks past every row)."""
    rng = np.random.default_rng(G * 1000 + hd + quant)
    B = len(lens)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    q = mk(B, G * Hkv, hd).to(torch.bfloat16)
    k, v = mk(B, Hkv, S, hd), mk(B, Hkv, S, hd)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        op, ref = paged_flash_decode_quant, paged_decode_quant_ref
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
        op, ref = paged_flash_decode, paged_decode_ref
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    order = rng.permutation(B)
    outs = []
    for bs in (8, 16, S):
        (kp, vp, ksp, vsp), tables = _paged_copies(k, v, ks, vs, bs, rng,
                                                   cuda)
        pools = (kp, vp, ksp, vsp) if quant else (kp, vp)
        before = op.launches
        full = op(q, *pools, tables, lengths)
        shuffled = op(q[order].contiguous(), *pools,
                      tables[order].contiguous(), lengths[order].contiguous())
        alone = [op(q[b:b + 1].contiguous(), *pools,
                    tables[b:b + 1].contiguous(),
                    lengths[b:b + 1].contiguous()) for b in range(B)]
        torch.cuda.synchronize()
        assert op.launches == before + 2 + B
        assert float((full - ref(q, *pools, tables, lengths)).abs().max()) \
            < 1e-5
        assert torch.equal(shuffled, full[order])
        for b in range(B):
            assert torch.equal(alone[b][0], full[b]), (bs, b)
        assert float(full[-1].abs().max()) == 0.0
        if bs < S:
            wide = torch.cat([tables, torch.zeros(
                (B, -(-SPAN // bs)), dtype=torch.int32, device=cuda)], 1)
            assert torch.equal(op(q, *pools, wide, lengths), full), bs
        outs.append(full)
    for bs, got in zip((16, S), outs[1:]):
        assert torch.equal(got, outs[0]), bs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("G,hd,Hkv", [(3, 64, 2), (16, 256, 1)])
def test_paged_decode_takes_q_at_an_odd_storage_offset(G, hd, Hkv, quant,
                                                       cuda):
    """A contiguous q view one element into its storage is copied to an
    aligned allocation first: the output is torch.equal to the aligned
    call's, with the heads on the MMA's N (G 3) and on its M (G 16). A
    pool view that does not start on 16 bytes is refused before any
    launch."""
    rng = np.random.default_rng(G + hd + quant)
    B, bs, MB = 3, 16, 5
    NB = 1 + B * MB
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    q = mk(B, G * Hkv, hd).to(torch.bfloat16)
    q_odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(
        q.shape)
    q_odd.copy_(q)
    if quant:
        (kp, ks), (vp, vs) = (quantize_kv(mk(NB, Hkv, bs, hd))
                              for _ in range(2))
        op, scales = paged_flash_decode_quant, (ks, vs)
    else:
        kp, vp = (mk(NB, Hkv, bs, hd).to(torch.bfloat16) for _ in range(2))
        op, scales = paged_flash_decode, ()
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB)).reshape(
        B, MB).astype(np.int32)).to(cuda)
    lengths = torch.tensor([MB * bs - 1, 40, -1], dtype=torch.int32,
                           device=cuda)
    assert q_odd.data_ptr() % 16 and q_odd.is_contiguous()
    assert torch.equal(op(q_odd, kp, vp, *scales, tables, lengths),
                       op(q, kp, vp, *scales, tables, lengths))
    k_odd = torch.empty(kp.numel() + 1, dtype=kp.dtype, device=cuda)[1:].view(
        kp.shape)
    k_odd.copy_(kp)
    before = op.launches
    with pytest.raises(ValueError, match="16 bytes"):
        op(q, k_odd, vp, *scales, tables, lengths)
    assert op.launches == before


def _mask_rows(case, T, V, gen, dev):
    """logits [T, V], top_k [T], top_p [T] of one case of the mask tests;
    settings cycle over the rows."""
    logits = torch.randn((T, V), generator=gen, device=dev) * 3.0
    if case == "mix":
        ks, ps = [0, 5, 1, 40], [1.0, 0.9, 0.5, 0.25]
    elif case == "mix_wide":  # tied values and a nucleus near 1
        logits[2, :8] = logits[2].max() + 1.0  # 8 tied values, top_k 5
        ks, ps = [0, 50, 5, 1, V, 0], [0.9, 1.0, 0.95, 0.5, 0.999, 1e-3]
    elif case == "serve":  # the seeded serves' settings, and top-p alone
        ks, ps = [50, 0], [0.9, 0.9]
    elif case == "p_zero":  # the max alone, with its ties
        logits[1, :3] = logits[1].max() + 1.0
        ks, ps = [0, 0, 50, 5], [0.0, 0.0, 0.0, -1.0]
    elif case == "p_near_one":  # the nucleus ends deep in the tail
        ks, ps = [0, 50, 1, 40000], [0.9999999] * 4
    elif case == "exact_prefix":  # probs 0.5, 0.25, 0.25, then 0s
        logits[:, :3] = torch.tensor([0.5, 0.25, 0.25], device=dev).log()
        logits[:, 3:] = -1e4
        ks, ps = [0, 0, 0, 2], [0.5, 0.75, 0.25, 0.75]
    elif case == "all_equal":
        logits.fill_(0.5)
        ks, ps = [5, 5, 5, 0], [1.0, 0.9, 0.0, 0.5]
    elif case == "ties_past_list":  # more ties at the k-th value than the
        logits[:, :3000] = logits.max() + 1.0  # kernel lists (1024)
        ks, ps = [5, 2999, 3001, 0, 5], [0.9, 1.0, 0.5, 0.9, 0.9999999]
    elif case == "k_edges":
        ks, ps = [V - 1, V, V + 7, V - 1, V], [1.0, 1.0, 0.5, 0.9, 0.9]
    elif case == "greedy":  # scaled by 1/1e-6: all probs but one are 0
        logits = logits / 1e-6
        ks, ps = [0, 50, 0, 1], [0.9, 0.9, 0.9999999, 1.0]
    elif case == "copy":  # nothing to mask
        ks, ps = [0, -3, V, V + 1], [1.0, 1.5, 1.0, 2.0]
    else:  # "edges": one row of each kind above
        logits[4, :3000] = logits[4].max() + 1.0
        logits[3] = logits[3] / 1e-6
        logits[7].fill_(0.5)
        ks, ps = ([0, 0, 50, 0, 5, V - 1, V, 5, 0, 50],
                  [0.0, 0.9999999, 0.9999999, 0.9, 0.9, 1.0, 0.9, 0.9, 1.0,
                   0.9])
    ks = torch.tensor([ks[i % len(ks)] for i in range(T)],
                      dtype=torch.int32, device=dev)
    ps = torch.tensor([ps[i % len(ps)] for i in range(T)], device=dev)
    return logits.contiguous(), ks, ps


def _mask_checked(logits, top_k, top_p):
    """One launch of the kernel, equal to the plain version."""
    before = topk_topp_mask.launches
    got = topk_topp_mask(logits, top_k, top_p)
    torch.cuda.synchronize()
    assert topk_topp_mask.launches == before + 1
    assert torch.equal(got, topk_topp_mask_ref(logits, top_k, top_p))
    return got


@pytest.mark.parametrize("T,V,case", [
    (4, 128, "mix"), (3, 200, "mix"), (72, 32000, "mix"),
    (2, MAX_VOCAB, "mix"), (72, 32000, "serve"), (8, 32000, "p_zero"),
    (8, 32000, "p_near_one"), (4, 3, "exact_prefix"),
    (4, 128, "exact_prefix"), (6, 1000, "all_equal"),
    (5, 32000, "ties_past_list"), (5, MAX_VOCAB, "ties_past_list"),
    (6, 32000, "k_edges"), (8, 32000, "greedy"), (3, 1, "mix"),
    (3, 3, "mix"), (6, 32001, "mix"), (10, 32001, "edges"),
    (8, 32000, "copy"), (10, 32000, "edges"), (6, 32000, "mix_wide")])
def test_mask_kernel_matches_plain(T, V, case, cuda):
    """One block a row: the kernel's output equals the plain version's
    (torch.equal) at the mix of settings, at the serves' settings, and at
    the edges: top_p 0 and 0.9999999, a top_p equal to a prefix mass, an
    all-equal row, more ties at the k-th value than the kernel lists,
    top_k V - 1, V and past V, greedy rows (logits / 1e-6), 1, 3 and an
    odd number of logits (rows off 16 bytes), rows with nothing to mask,
    top_p 0.999 alone (more candidates than shared memory lists)."""
    gen = torch.Generator(device=cuda).manual_seed(T * V)
    _mask_checked(*_mask_rows(case, T, V, gen, cuda))


@pytest.mark.parametrize("case", ["mix_wide", "serve", "edges"])
@pytest.mark.parametrize("V", [MAX_VOCAB + 1, 57857, 65536, 256000,
                               CLUSTER * MAX_SHARE, CLUSTER * MAX_SHARE + 1,
                               CLUSTER * MAX_VOCAB + 1])
def test_mask_kernel_takes_rows_wider_than_shared_memory(V, case, cuda):
    """Rows past MAX_VOCAB (rwkv6-1.6b's 65536, recurrentgemma-9b's 256000
    logits) split over a cluster of 2-8 blocks, each holding at most
    MAX_SHARE; past CLUSTER * MAX_SHARE a cluster of CLUSTER blocks reads
    its shares from device memory on every pass. Equal to the plain
    version at every case."""
    gen = torch.Generator(device=cuda).manual_seed(V)
    _mask_checked(*_mask_rows(case, 10, V, gen, cuda))


@pytest.mark.parametrize("V", [32000, 32001, 65536])
def test_mask_kernel_is_deterministic_and_row_independent(V, cuda):
    """Two calls give the same bits; each row of a 72-row call equals a
    call on that row alone; a logits view that starts 4 bytes past 16 is
    taken (4-byte copies) with the same result and one launch."""
    gen = torch.Generator(device=cuda).manual_seed(V + 1)
    logits, ks, ps = _mask_rows("edges", 72, V, gen, cuda)
    got = _mask_checked(logits, ks, ps)
    assert torch.equal(topk_topp_mask(logits, ks, ps), got)
    for t in range(72):
        assert torch.equal(topk_topp_mask(logits[t:t + 1], ks[t:t + 1],
                                          ps[t:t + 1])[0], got[t]), t
    odd = torch.empty(logits.numel() + 1, device=cuda)[1:].view(72, V)
    odd.copy_(logits)
    assert odd.data_ptr() % 16 == 4
    assert torch.equal(_mask_checked(odd, ks, ps), got)


def test_engine_on_the_card_is_exact_and_lane_invariant(cuda):
    """Smoke config on the card: greedy tokens equal the streamed one-shot
    baseline; seeded tokens are identical at two slot counts."""
    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    mk = lambda sampling: poisson_trace(8, 16.0, prompt_len=16,
                                        vocab_size=cfg.vocab_size, gen_len=8,
                                        sampling=sampling, seed=0)
    run = lambda n, sampling: run_to_completion(ServingEngine(
        cfg, params, num_slots=n, prompt_len=16, max_gen=8,
        clock=ManualClock(), device=cuda), mk(sampling), dt=0.05)
    out = run(4, None)
    base = serve_batch(cfg, params, np.stack([r.prompt for r in mk(None)]), 8,
                       device=cuda)
    assert all(out[i] == list(base[i]) for i in range(8))
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=3)
    assert run(4, sp) == run(2, sp)


def test_quant_fleet_on_the_card_is_lane_and_fleet_invariant(cuda):
    """Smoke config on the card, int8 KV: the same tokens at two slot
    counts, and a 2-replica fleet equal to one engine; every attention
    read goes through the quant kernel."""
    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    mk = lambda: poisson_trace(8, 16.0, prompt_len=16,
                               vocab_size=cfg.vocab_size, gen_len=8, seed=0)
    run = lambda **kw: run_to_completion(make_serving_engine(
        cfg, params, prompt_len=16, max_gen=8, kv="quant",
        clock=ManualClock(), device=cuda, **kw), mk(), dt=0.05)
    before = paged_flash_decode.launches
    quant_before = paged_flash_decode_quant.launches
    out = run(num_slots=4)
    assert paged_flash_decode_quant.launches > quant_before
    assert paged_flash_decode.launches == before
    assert run(num_slots=2) == out
    assert run(num_slots=2, replicas=2) == out


@pytest.mark.parametrize("kv", ["paged", "quant"])
def test_swap_round_trip_on_the_card_is_byte_equal(kv, cuda):
    """The host swap tier on the card: swap_out copies a slot's blocks
    (int8 values and f32 scales in the quant pool) into pinned host
    tensors; swap_in scatters them into fresh blocks of another slot,
    which read back byte-equal. An EDF-preempted victim then resumes
    from the host tier with the tokens of an unpreempted run and nothing
    recomputed."""
    cfg = get_smoke("paper-demo")
    pool = make_kv_backend(kv, cfg, Env(), num_slots=3, prompt_len=16,
                           max_gen=8, block_size=4, swap=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for leaf in pool.caches["blocks"][0].values():
        leaf.copy_((torch.randn(leaf.shape, generator=gen, device=cuda)
                    * 20).to(leaf.dtype))
    a, b = pool.admit(0, 8), pool.admit(1, 8)
    for pos in range(19):
        pool.ensure(a, pos)
    before = BlockManager.read_slot(pool, a)
    assert pool.swap_out(a)
    payload = pool.swap_pool.peek(0).payload
    assert all(x.device.type == "cpu" and x.is_pinned()
               for x in payload["blocks"][0].values())
    new = pool.swap_in(0)
    assert new not in (a, b)
    after = BlockManager.read_slot(pool, new)
    for n, x in before["blocks"][0].items():
        assert torch.equal(x.view(torch.uint8),
                           after["blocks"][0][n].view(torch.uint8)), n
    pool.evict(new)
    pool.evict(b)
    pool.release()
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (16,), dtype=np.int32)
               for _ in range(2)]
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=7)
    reqs = lambda: [Request(rid=0, prompt=prompts[0], gen_len=8,
                            sampling=sp),
                    Request(rid=1, prompt=prompts[1], gen_len=2,
                            arrival_t=0.12, deadline_s=0.4)]
    eng = lambda **kw: ServingEngine(cfg, params, num_slots=1, prompt_len=16,
                                     max_gen=8, kv=kv, block_size=4,
                                     clock=ManualClock(), device=cuda, **kw)
    solo = run_to_completion(eng(), reqs()[:1], dt=0.05)
    swp = eng(swap=True, policy=EDFPolicy(preemptive=True, min_slack_s=1.0))
    out = run_to_completion(swp, reqs(), dt=0.05)
    assert out[0] == solo[0] and swp.metrics.preemptions >= 1
    assert swp.metrics.recomputed_tokens == 0
    m = swp.pool.metrics()
    assert m["swap_out_bytes"] == m["swap_in_bytes"] > 0


@pytest.mark.parametrize("kv", ["paged", "quant", "slot"])
def test_verify_rows_on_the_card_equal_the_non_spec_step(kv, cuda):
    """Speculative verify rows on the card (n-gram drafts on a repetitive
    trace, k 4 and 8): the tokens of serving with --spec off, bit for
    bit, greedy and seeded; the rows go through the paged-decode kernels
    (the slot pool's through one-entry row -> slot tables) and the seeded
    ones through the mask kernel."""
    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    kernel = paged_flash_decode_quant if kv == "quant" else \
        paged_flash_decode
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=7)
    for sampling in (None, sp):
        mk = lambda: repetitive_trace(8, 48.0, prompt_len=16,
                                      vocab_size=cfg.vocab_size, gen_len=8,
                                      motif_len=2, sampling=sampling,
                                      seed=0)
        run = lambda **kw: run_to_completion(ServingEngine(
            cfg, params, num_slots=3, prompt_len=16, max_gen=8, kv=kv,
            block_size=4, clock=ManualClock(), device=cuda, **kw), mk(),
            dt=0.05)
        base = run()
        for k in (4, 8):
            n_dec, n_mask = kernel.launches, topk_topp_mask.launches
            assert run(spec="ngram", spec_k=k) == base
            assert kernel.launches > n_dec
            assert (topk_topp_mask.launches > n_mask) == (sampling
                                                          is not None)


# the phase-2 shapes of chip_smoke.py: paper-demo's heads causal at B=1,
# a ragged last tile (S=200), a sliding window, bidirectional, MQA, hd 16
FLASH_SHAPES = [
    dict(B=1, S=256, Hq=12, Hkv=4, hd=64, causal=True, window=0),
    dict(B=2, S=200, Hq=12, Hkv=4, hd=64, causal=True, window=0),
    dict(B=1, S=256, Hq=12, Hkv=4, hd=64, causal=True, window=64),
    dict(B=1, S=256, Hq=12, Hkv=4, hd=64, causal=False, window=0),
    dict(B=1, S=256, Hq=12, Hkv=1, hd=64, causal=True, window=0),
    dict(B=2, S=130, Hq=4, Hkv=2, hd=16, causal=True, window=0),
    # recurrentgemma-9b's local attention: MQA 16:1 at hd 256, window
    dict(B=1, S=300, Hq=16, Hkv=1, hd=256, causal=True, window=256),
    dict(B=2, S=200, Hq=16, Hkv=1, hd=256, causal=True, window=0),
] + [
    # one short of, at and one past the 64-row tile
    dict(B=2, S=S, Hq=12, Hkv=4, hd=64, causal=True, window=0)
    for S in (63, 64, 65)
] + [
    # every instantiation (HEAD_DIMS), causal, windowed and bidirectional
    dict(B=2, S=150, Hq=8, Hkv=2, hd=hd, causal=causal, window=window)
    for hd in (16, 32, 64, 128, 256)
    for causal, window in ((True, 0), (True, 48), (False, 0))
]


def _flash_case(rng, B, Sq, Sk, Hq, Hkv, hd, device):
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(device).to(torch.bfloat16)
    return mk(B, Sq, Hq, hd), mk(B, Sk, Hkv, hd), mk(B, Sk, Hkv, hd)


def _flash_vs_plain(q, k, v, causal, window):
    B, Sq, Hq, hd = q.shape
    got = flash_attention(q, k, v, causal=causal, window=window,
                          n_kv_heads=k.shape[2])
    torch.cuda.synchronize()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window)
    want = want.transpose(1, 2).reshape(B, Sq, Hq * hd)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    return float((got.float() - want.float()).abs().max())


@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=lambda d: "-".join(f"{k}{v}" for k, v in
                                                d.items()))
def test_flash_attention_kernel_matches_plain(shape, cuda):
    B, S, Hq, Hkv, hd = (shape[k] for k in ("B", "S", "Hq", "Hkv", "hd"))
    rng = np.random.default_rng(S + hd + Hkv)
    q, k, v = _flash_case(rng, B, S, S, Hq, Hkv, hd, cuda)
    before = flash_attention.launches
    err = _flash_vs_plain(q, k, v, shape["causal"], shape["window"])
    assert flash_attention.launches == before + 1
    assert err < 2e-2


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", [
    (16, 256, 12, 4, 64, 0), (8, 2304, 16, 1, 256, 2048)])
def test_flash_attention_rows_are_batch_independent(B, S, Hq, Hkv, hd,
                                                    window, cuda):
    """Each row of a batched call equals, bit for bit, the same row
    computed alone: a row's arithmetic depends on its query tile, head
    and row only (no split over keys, no atomics). Classic admission
    relies on it: a batch-1 prefill must emit what the one-shot batch's
    prefill emits, token for token."""
    rng = np.random.default_rng(B * S + hd)
    q, k, v = _flash_case(rng, B, S, S, Hq, Hkv, hd, cuda)
    whole = flash_attention(q, k, v, causal=True, window=window,
                            n_kv_heads=Hkv)
    for b in range(B):
        alone = flash_attention(q[b:b + 1].contiguous(),
                                k[b:b + 1].contiguous(),
                                v[b:b + 1].contiguous(), causal=True,
                                window=window, n_kv_heads=Hkv)
        assert torch.equal(whole[b:b + 1], alone), f"row {b}"


@pytest.mark.parametrize("Sq,Sk,causal,window", [
    (65, 200, False, 0), (200, 63, True, 0), (64, 200, False, 65),
    (65, 200, True, 64)])
def test_flash_attention_takes_unequal_query_and_key_counts(
        Sq, Sk, causal, window, cuda):
    """Sq != Sk, each ragged against the 64-row tile: missing rows staged
    as zeros, their keys masked, their queries never stored; within the
    bf16 output's 2e-2."""
    rng = np.random.default_rng(Sq * 1000 + Sk)
    q, k, v = _flash_case(rng, 2, Sq, Sk, 12, 4, 64, cuda)
    assert _flash_vs_plain(q, k, v, causal, window) < 2e-2


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 8, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)
    qb = torch.zeros((1, 8, 4, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        flash_attention(qb, qb, qb)


def test_classic_engine_on_the_card_matches_the_full_prefill_baseline(cuda):
    """Smoke config on the card, prompts of 160 tokens (the flash branch):
    classic admission on the paged pool and on the slot pool emits, token
    for token, what the full-prefill one-shot batch emits."""
    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    P = 160
    mk = lambda: poisson_trace(6, 16.0, prompt_len=P,
                               vocab_size=cfg.vocab_size, gen_len=8, seed=0)
    run = lambda **kw: run_to_completion(make_serving_engine(
        cfg, params, num_slots=4, prompt_len=P, max_gen=8,
        clock=ManualClock(), device=cuda, **kw), mk(), dt=0.05)
    before = flash_attention.launches
    out = run(prefill_chunk=0)
    assert flash_attention.launches == before + 6 * cfg.num_blocks
    base = serve_batch(cfg, params, np.stack([r.prompt for r in mk()]), 8,
                       streamed_prefill=False, device=cuda)
    assert all(out[i] == list(base[i]) for i in range(6))
    assert run(kv="slot") == out


@pytest.mark.parametrize("B,S,W,with_h0", [
    (1, 2304, 512, False), (2, 200, 4096, True), (3, 1, 96, True),
    (2, 37, 130, False), (3, 101, 4100, True), (2, 77, 1001, True)])
def test_rglru_scan_kernel_matches_plain(B, S, W, with_h0, cuda):
    """Ragged S and W (a last channel group of 4, 2 or 9 lanes; W % 4 != 0
    takes 4-byte copies), a one-step scan, a carried h0: bit-equal to the
    plain version (same product, same sum, each rounded once)."""
    rng = np.random.default_rng(S + W)
    a = torch.from_numpy(rng.uniform(0.05, 0.999, (B, S, W)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(
        np.float32)).to(cuda)
    h0 = (torch.from_numpy(rng.standard_normal((B, W)).astype(np.float32))
          .to(cuda) if with_h0 else None)
    before = rglru_scan.launches
    got = rglru_scan(a, b, h0)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    assert torch.equal(got, rglru_ref_loop(a, b, h0))


@pytest.mark.parametrize("B,S,H,hd", [
    (1, 256, 32, 64), (3, 100, 4, 64), (2, 70, 3, 16), (1, 33, 2, 32)])
def test_wkv6_kernel_matches_plain(B, S, H, hd, cuda):
    """rwkv6-1.6b's heads, ragged S, narrow heads: output and final state
    within 2e-3 of the plain version."""
    rng = np.random.default_rng(S + hd)
    mk = lambda: torch.from_numpy((rng.standard_normal(
        (B, S, H, hd)) * 0.5).astype(np.float32)).to(cuda)
    r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(mk() - 1.0)
    u = torch.from_numpy((rng.standard_normal((H, hd)) * 0.3).astype(
        np.float32)).to(cuda)
    before = wkv6.launches
    o, s_fin = wkv6(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert wkv6.launches == before + 1
    o_ref, s_ref = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)),
                            u)
    assert o.shape == (B, S, H, hd) and s_fin.shape == (B, H, hd, hd)
    assert float((o - o_ref.transpose(1, 2)).abs().max()) < 2e-3
    assert float((s_fin - s_ref).abs().max()) < 2e-3


@pytest.mark.parametrize("B,S,H,hd", [
    (1, 256, 32, 64), (2, 77, 4, 32), (3, 45, 2, 16)])
def test_wkv6_kernel_across_the_decay_range(B, S, H, hd, cuda):
    """Strong and weak decays mixed: logw = -exp(x), x per (head, channel)
    uniform in [-20, 8] (the model's rwkv_decay clamp: w from exp(-2981) =
    0 to 1 - 2e-9) plus a per-step jitter. Finite, and within 2e-3 of the
    plain version."""
    rng = np.random.default_rng(7 * S + hd)
    mk = lambda: torch.from_numpy((rng.standard_normal(
        (B, S, H, hd)) * 0.5).astype(np.float32)).to(cuda)
    r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
    x = torch.from_numpy(rng.uniform(-20.0, 8.0, (H, hd)).astype(
        np.float32)).to(cuda) + mk()
    logw = -torch.exp(x.clamp(-20.0, 8.0))
    u = torch.from_numpy((rng.standard_normal((H, hd)) * 0.3).astype(
        np.float32)).to(cuda)
    o, s_fin = wkv6(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s_fin).all())
    o_ref, s_ref = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)),
                            u)
    assert float((o - o_ref.transpose(1, 2)).abs().max()) < 2e-3
    assert float((s_fin - s_ref).abs().max()) < 2e-3


def test_recurrent_kernel_rows_do_not_depend_on_the_batch(cuda):
    """One B=16 call against sixteen B=1 calls at the same S, bit for
    bit: a row's arithmetic depends on its own inputs alone (the engine's
    batch-1 prefill is held to the one-shot baseline's B=16 token for
    token)."""
    rng = np.random.default_rng(16)
    B, S, W = 16, 230, 4096
    a = torch.from_numpy(rng.uniform(0.05, 0.999, (B, S, W)).astype(
        np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(
        np.float32)).to(cuda)
    h0 = torch.from_numpy(rng.standard_normal((B, W)).astype(
        np.float32)).to(cuda)
    whole = rglru_scan(a, b, h0)
    for i in range(B):
        assert torch.equal(whole[i:i + 1], rglru_scan(
            a[i:i + 1], b[i:i + 1], h0[i:i + 1])), i
    S, H, hd = 256, 32, 64
    mk = lambda: torch.from_numpy((rng.standard_normal(
        (B, S, H, hd)) * 0.5).astype(np.float32)).to(cuda)
    r, k, v = (mk().to(torch.bfloat16) for _ in range(3))
    logw = -torch.exp(mk() - 1.0)
    u = torch.from_numpy((rng.standard_normal((H, hd)) * 0.3).astype(
        np.float32)).to(cuda)
    o, s_fin = wkv6(r, k, v, logw, u)
    for i in range(B):
        oi, si = wkv6(*(t[i:i + 1] for t in (r, k, v, logw)), u)
        assert torch.equal(o[i:i + 1], oi) and torch.equal(
            s_fin[i:i + 1], si), i


def test_recurrent_kernels_take_inputs_at_an_odd_storage_offset(cuda):
    """Contiguous views 4 bytes into their storage: the RG-LRU scan takes
    4-byte copies (still bit-equal), the WKV6 op copies such an input to
    an aligned allocation."""
    rng = np.random.default_rng(3)
    B, S, W = 2, 70, 256
    n = B * S * W
    a = torch.from_numpy(rng.uniform(0.05, 0.999, n + 1).astype(
        np.float32)).to(cuda)[1:].view(B, S, W)
    b = torch.from_numpy(rng.standard_normal(n + 1).astype(
        np.float32)).to(cuda)[1:].view(B, S, W)
    assert a.data_ptr() % 16 and a.is_contiguous()
    assert torch.equal(rglru_scan(a, b), rglru_ref_loop(a, b))
    B, S, H, hd = 1, 40, 4, 32
    n = B * S * H * hd
    mk = lambda: torch.from_numpy((rng.standard_normal(n + 2) * 0.5).astype(
        np.float32)).to(cuda)
    r, k, v = (mk().to(torch.bfloat16)[2:].view(B, S, H, hd)
               for _ in range(3))
    logw = -torch.exp(mk()[1:n + 1].view(B, S, H, hd) - 1.0)
    lw_odd = torch.empty(n + 1, device=cuda)[1:].view(B, S, H, hd)
    lw_odd.copy_(logw)
    u = torch.zeros((H, hd), device=cuda)
    o, s_fin = wkv6(r, k, v, lw_odd, u)
    o_ref, s_ref = wkv6_ref(*(t.transpose(1, 2) for t in (r, k, v, logw)),
                            u)
    assert float((o - o_ref.transpose(1, 2)).abs().max()) < 2e-3
    assert float((s_fin - s_ref).abs().max()) < 2e-3


def test_recurrent_kernels_refuse_what_they_do_not_take(cuda):
    a = torch.zeros((1, 4, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        rglru_scan(a, a)
    r = torch.zeros((1, 4, 2, 48), dtype=torch.bfloat16, device=cuda)
    lw = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        wkv6(r, r, r, lw, torch.zeros((2, 48), device=cuda))
    with pytest.raises(ValueError, match="bf16"):
        wkv6(lw, lw, lw, lw, torch.zeros((2, 48), device=cuda))


@pytest.mark.parametrize("arch,P", [("recurrentgemma-9b", 160),
                                    ("recurrentgemma-9b", 24),
                                    ("rwkv6-1.6b", 40)])
def test_recurrent_engines_on_the_card_match_the_full_prefill_baseline(
        arch, P, cuda):
    """Smoke configs on the card, classic admission (the only way in for
    these archs): every token equals the full-prefill one-shot batch's,
    and the prefills went through the recurrence kernels."""
    cfg = get_smoke(arch)
    params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    mk = lambda: poisson_trace(5, 16.0, prompt_len=P,
                               vocab_size=cfg.vocab_size, gen_len=8, seed=1)
    kinds = cfg.block_pattern * cfg.num_blocks + cfg.pattern_tail
    before = (rglru_scan.launches, wkv6.launches)
    out = run_to_completion(make_serving_engine(
        cfg, params, num_slots=2, prompt_len=P, max_gen=8,
        clock=ManualClock(), device=cuda), mk(), dt=0.05)
    assert (rglru_scan.launches - before[0], wkv6.launches - before[1]) == (
        5 * kinds.count("rglru"), 5 * kinds.count("rwkv"))
    base = serve_batch(cfg, params, np.stack([r.prompt for r in mk()]), 8,
                       streamed_prefill=False, device=cuda)
    assert all(out[i] == list(base[i]) for i in range(5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,curs", [
    (2, 8, 2, 512, 64, (-1, 0, 17, 255, 511)),
    (8, 12, 4, 4096, 64, (0, 1000, 4095, 9999)),
    (4, 16, 1, 2048, 256, (-1, 63, 2047)),
    (3, 4, 4, 700, 32, (0, 650, 699))] + [
    # GQA groups of 1-17 (17 takes two 16-row tensor-core tiles in bf16)
    # at head_dims not a multiple of 16 (zero-padded to the next k-step);
    # S = 3 x 64 + 5, cur_len at -1, 0, either side of the 64-token tile
    # and S - 1
    (2, 2 * G, 2, 197, hd, (-1, 0, 63, 64, 196))
    for G in (1, 3, 5, 8, 16, 17) for hd in (8, 24, 64, 256)])
def test_flash_decode_kernel_matches_plain(B, Hq, Hkv, S, hd, curs, dtype,
                                           cuda):
    """The partials (o, m, l) against the plain version: o and m within
    1e-5, l within 1e-5 of itself (a sum of up to S terms; both sides
    compute in f32 from the same inputs, in another order); an
    all-masked slice exactly (m = -1e30, l = 0, o = 0). cur_len as a
    device tensor and past S. Eight slices merged equal the whole."""
    rng = np.random.default_rng(S + hd)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda).to(dtype)
    q, k, v = mk(B, Hq, hd), mk(B, Hkv, S, hd), mk(B, Hkv, S, hd)
    for cur in curs:
        cur_t = torch.tensor([cur], dtype=torch.int32, device=cuda)
        before = flash_decode_partials.launches
        o, m, l = flash_decode_partials(q, k, v, cur_t)
        torch.cuda.synchronize()
        assert flash_decode_partials.launches == before + 1
        ro, rm, rl = flash_decode_partials_ref(q, k, v, cur_t)
        if cur < 0:
            assert not bool(o.any()) and not bool(l.any())
            assert bool((m == np.float32(-1e30)).all())
            continue
        assert float((o - ro).abs().max()) < 1e-5
        assert float((m - rm).abs().max()) < 1e-5
        assert float(((l - rl).abs() / rl).max()) < 1e-5
        assert flash_decode(q, k, v, cur).dtype == dtype
    n = 8
    if S % n == 0:
        cur = curs[-1]
        s = S // n
        parts = [flash_decode_partials(
            q, k[:, :, i * s:(i + 1) * s].contiguous(),
            v[:, :, i * s:(i + 1) * s].contiguous(),
            min(max(cur - i * s, -1), s - 1)) for i in range(n)]
        merged = merge_partials_stacked(*(torch.stack(x) for x in
                                          zip(*parts)))
        whole = flash_decode_partials(q, k, v, cur)[0]
        assert float((merged - whole).abs().max()) < 1e-3


def test_flash_decode_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((1, 2, 32, 64), device=cuda)
    with pytest.raises(ValueError, match="all f32 or all bf16"):
        flash_decode_partials(q, kv, kv, 3)
    q12 = torch.zeros((1, 4, 12), device=cuda)
    kv12 = torch.zeros((1, 2, 32, 12), device=cuda)
    with pytest.raises(ValueError, match="unsupported"):
        flash_decode_partials(q12, kv12, kv12, 3)
    with pytest.raises(ValueError, match="one scalar"):
        flash_decode_partials(q.float(), kv, kv,
                              torch.zeros((2,), dtype=torch.int32,
                                          device=cuda))


# ---------------------------------------------------------------------------
# the zoo slice: GQA 5, qk-norm, the MoE layer
# ---------------------------------------------------------------------------


def _serving_row_mix(rng, Hq, Hkv, hd, bs=16, MB=6):
    """chip_smoke's phase-2 row mix at other heads: 8 decode rows at
    depths 64..95, a 64-row prefill lane at 0..63 over one table, a
    masked row (null table), a depth-0 row and a full-table row."""
    B_dec, lane = 8, 64
    B = B_dec + lane + 3
    NB = 1 + 8 * MB
    ids = 1 + rng.permutation(NB - 1)
    tables = np.zeros((B, MB), np.int32)
    lengths = np.zeros((B,), np.int32)
    for b in range(B_dec):
        tables[b] = ids[b * MB:(b + 1) * MB]
        lengths[b] = 64 + (b * 5) % 32
    tables[B_dec:B_dec + lane] = ids[:MB]
    lengths[B_dec:B_dec + lane] = np.arange(lane)
    lengths[B - 3] = -1
    tables[B - 2], lengths[B - 2] = ids[MB:2 * MB], 0
    tables[B - 1], lengths[B - 1] = ids[2 * MB:3 * MB], MB * bs - 1
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    return (mk(B, Hq, hd), mk(NB, Hkv, bs, hd), mk(NB, Hkv, bs, hd),
            torch.from_numpy(tables), torch.from_numpy(lengths))


def test_paged_decode_kernels_at_gqa_5_match_plain(cuda):
    """llama4-scout-17b-a16e's group: 40 query heads over 8 KV heads at hd
    128, the bf16 and the int8 kernel against their plain versions at the
    serving row mix, within 1e-5 (both compute in f32 from the same
    inputs); the masked row is zero."""
    q, kp, vp, tables, lengths = (t.to(cuda) for t in _serving_row_mix(
        np.random.default_rng(40), 40, 8, 128))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    tables, lengths = tables.to(cuda), lengths.to(cuda)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, kp, vp, tables, lengths)
    torch.cuda.synchronize()
    assert paged_flash_decode.launches == before + 1
    assert float((got - paged_decode_ref(q, kp, vp, tables, lengths))
                 .abs().max()) < 1e-5
    assert float(got[-3].abs().max()) == 0.0
    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    before = paged_flash_decode_quant.launches
    got = paged_flash_decode_quant(q, kq, vq, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    assert paged_flash_decode_quant.launches == before + 1
    want = paged_decode_quant_ref(q, kq, vq, ks, vs, tables, lengths)
    assert float((got - want).abs().max()) < 1e-5
    assert float(got[-3].abs().max()) == 0.0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def test_qk_norm_decode_step_on_the_card_matches_the_cpu(cuda):
    """qwen3-32b's smoke config with random q_norm / k_norm scales: one
    paged decode step (5 rows, one masked) on the card against the CPU
    path on the same weights and pool, |diff| / max(|logit|, 1) within
    3e-2 (chip_smoke's LOGIT_TOL: bf16 logits, sums in another order)."""
    cfg = get_smoke("qwen3-32b")
    params = Mo.init_params(cfg, Env(), seed=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    attn = params["blocks"][0]["attn"]
    for n in ("q_norm", "k_norm"):
        attn[n].copy_(torch.randn(attn[n].shape, generator=gen))
    B, NB, bs = 5, 12, 16
    pool = Mo.init_paged_cache(cfg, Env(), NB, bs, device="cpu")
    for leaf in pool["blocks"][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen).to(leaf.dtype))
    tables = torch.randperm(NB - 1, generator=gen)[:B * 2].reshape(B, 2) + 1
    tables = tables.int()
    tables[4] = 0
    cur = torch.tensor([0, 5, 17, 31, 0], dtype=torch.int32)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen)
    step = lambda p, c, t, l, tb: Mo.forward(
        p, t, cfg, Env(), caches=c, cur_len=l,
        block_tables={"global": tb})[0]
    ref = step(params, _to(pool, "cpu"), tok, cur, tables).float()
    got = step(_to(params, cuda), _to(pool, cuda), tok.to(cuda),
               cur.to(cuda), tables.to(cuda)).float().cpu()
    err = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
    assert err < 3e-2


def test_moe_layer_on_the_card_matches_the_plain_path(cuda):
    """grok-1-314b's smoke MoE layer on one 72-row input (a served step's
    rows: 8 slots and a 64-row lane), card against the CPU path on the
    same input and weights: the same experts, ranks and kept set (no
    router near-tie within 1e-4 on this input), outputs within 1e-2
    relative RMS (bf16 products rounded apart now and then); a second
    call on the card bit-equal to the first."""
    from repro_torch.models import moe as M
    cfg = get_smoke("grok-1-314b")
    p = {n: w[0] for n, w in Mo.init_params(
        cfg, Env(), seed=4, device="cpu")["blocks"][0]["moe"].items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((72, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    gates = torch.softmax(x.reshape(72, -1).float() @ p["router"], -1)
    top = torch.sort(gates, -1, descending=True).values
    assert float((top[:, k - 1] - top[:, k]).min()) > 1e-4
    pc = _to(p, cuda)
    r_cpu = M._route(x.reshape(72, -1), p["router"], E, k)
    r_gpu = M._route(x.reshape(72, -1).to(cuda), pc["router"], E, k)
    for i in (0, 1, 3):  # experts, tokens, ranks (sorted order)
        assert torch.equal(r_gpu[i].cpu(), r_cpu[i])
    y = M.moe_layer(pc, x.to(cuda), cfg)[0]
    assert torch.equal(M.moe_layer(pc, x.to(cuda), cfg)[0], y)
    yc = M.moe_layer(p, x, cfg)[0]
    rms = float((y.float().cpu() - yc.float()).norm() / yc.float().norm())
    assert rms < 1e-2


# ---------------------------------------------------------------------------
# train mode, the train step and set_params on the card
# ---------------------------------------------------------------------------

_SEVEN = (paged_flash_decode, paged_flash_decode_quant, topk_topp_mask,
          flash_attention, flash_decode_partials, rglru_scan, wkv6)


def _launches():
    return {op.__name__: op.launches for op in _SEVEN}


def _train_plan():
    from repro_torch.configs.base import ParallelPlan
    return Env(plan=ParallelPlan(fsdp=False, remat="nothing",
                                 attn_impl="xla_chunked",
                                 kv_cache="replicated"))


@pytest.mark.parametrize("arch", ["paper-demo", "recurrentgemma-9b",
                                  "rwkv6-1.6b", "grok-1-314b"])
def test_train_step_on_the_card_tracks_the_cpu_and_launches_no_kernel(
        arch, cuda):
    """Three make_train_step steps at smoke size on the card and on the
    CPU from the same weights (drawn on the CPU) and batch: the first
    loss within 2e-3 of the CPU's (the card's bf16 GEMMs accumulate in
    another order; the CPU tests hold the CPU to the JAX package), the
    later ones within 5e-2 (each update compounds that, and an MoE token
    routed otherwise at a near-tie moves its output by O(1): grok's third
    loss sat 2.0e-2 from the CPU's on an H100), the loss falling, and
    none of the seven kernels launched."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import (AdamWConfig, make_train_state,
                                         tree_map)
    cfg = get_smoke(arch)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, weight_decay=0.0)
    tok = torch.randint(0, cfg.vocab_size, (2, 64),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    step = make_train_step(cfg, _train_plan(), opt)
    losses = {}
    weights = Mo.init_params(cfg, Env(), seed=0, device="cpu")
    for dev in ("cpu", cuda):
        params = tree_map(lambda x: x.to(dev), weights)
        state = make_train_state(params, opt)
        b = {k: v.to(dev) for k, v in batch.items()}
        before = _launches()
        out = []
        for _ in range(3):
            state, m = step(state, b)
            out.append(float(m["loss"]))
        assert _launches() == before
        losses[str(dev)] = out
    cpu, card = losses["cpu"], losses[str(cuda)]
    assert abs(card[0] - cpu[0]) <= 2e-3, (card, cpu)
    assert all(abs(a - b) <= 5e-2 for a, b in zip(card, cpu)), (card, cpu)
    assert card[-1] < card[0]


def test_set_params_on_a_card_engine_serves_the_new_weights(cuda):
    """A fleet of two replicas on the card serves a seeded trace, takes
    new weights through set_params, and serves the trace again through
    the paged-decode and mask kernels: the tokens equal a fresh engine's
    on the new weights, not the first run's."""
    cfg = get_smoke("paper-demo")
    a = Mo.init_params(cfg, Env(), seed=0, device=cuda)
    b = Mo.init_params(cfg, Env(), seed=1, device=cuda)
    sp = SamplingParams(temperature=0.7, top_k=50, top_p=0.9, seed=3)
    trace = lambda: poisson_trace(8, 16.0, prompt_len=16,
                                  vocab_size=cfg.vocab_size, gen_len=8,
                                  sampling=sp, seed=2)
    mk = lambda p: make_serving_engine(cfg, p, replicas=2, num_slots=4,
                                       prompt_len=16, max_gen=8,
                                       block_size=4, clock=ManualClock(),
                                       device=cuda)
    eng = mk(a)
    first = run_to_completion(eng, trace())
    eng.set_params(b)
    paged_flash_decode.launches = topk_topp_mask.launches = 0
    again = run_to_completion(eng, trace())
    assert paged_flash_decode.launches > 0 and topk_topp_mask.launches > 0
    assert again == run_to_completion(mk(b), trace())
    assert again != first


# ---------------------------------------------------------------------------
# the int8 pool of the recurrent archs; the modality archs
# ---------------------------------------------------------------------------


def test_paged_decode_kernels_at_gqa_7_match_plain(cuda):
    """qwen2-vl-7b's group: 28 query heads over 4 KV heads at hd 128 (the
    N of the kernel's MMAs padded from 7 heads to 8), the bf16 and the
    int8 kernel at the serving row mix, and the bf16 kernel over the
    one-shot's contiguous cache (vision 256 + prompt 128 + gen 32
    positions, one block a row, rows at every depth); within 1e-5."""
    q, kp, vp, tables, lengths = (t.to(cuda) for t in _serving_row_mix(
        np.random.default_rng(28), 28, 4, 128))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    got = paged_flash_decode(q, kp, vp, tables, lengths)
    assert float((got - paged_decode_ref(q, kp, vp, tables, lengths))
                 .abs().max()) < 1e-5
    assert float(got[-3].abs().max()) == 0.0
    kq, ks = quantize_kv(kp.float())
    vq, vs = quantize_kv(vp.float())
    got = paged_flash_decode_quant(q, kq, vq, ks, vs, tables, lengths)
    want = paged_decode_quant_ref(q, kq, vq, ks, vs, tables, lengths)
    assert float((got - want).abs().max()) < 1e-5
    rng = np.random.default_rng(29)
    B, S = 4, 256 + 128 + 32
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    q, kc, vc = mk(B, 28, 128), mk(B, 4, S, 128), mk(B, 4, S, 128)
    ident = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    depth = torch.tensor([383, 384, 400, S - 2], dtype=torch.int32,
                         device=cuda)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, kc, vc, ident, depth)
    assert paged_flash_decode.launches == before + 1
    assert float((got - paged_decode_ref(q, kc, vc, ident, depth))
                 .abs().max()) < 1e-5


def test_paged_decode_kernel_over_cross_caches_matches_plain(cuda):
    """whisper-small's cross-attention read: 12 heads (MHA) at hd 64 over
    each row's encoder cache of 256 frames (prompt 512, downsampled 2),
    every frame attended (depth 255), through the identity table."""
    rng = np.random.default_rng(12)
    B, Se = 8, 256
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    q, xk, xv = mk(B, 12, 64), mk(B, 12, Se, 64), mk(B, 12, Se, 64)
    ident = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    depth = torch.full((B,), Se - 1, dtype=torch.int32, device=cuda)
    before = paged_flash_decode.launches
    got = paged_flash_decode(q, xk, xv, ident, depth)
    assert paged_flash_decode.launches == before + 1
    assert float((got - paged_decode_ref(q, xk, xv, ident, depth))
                 .abs().max()) < 1e-5


def test_quant_paged_decode_over_int8_rings_matches_plain(cuda):
    """recurrentgemma-9b's local layers on the int8 pool: 16 query heads
    over one KV head at hd 256, 2048-token window rings of 16-token
    blocks; rows short of the window, at its last position and past the
    wrap (depth min(cur_len, 2047)), and a masked row."""
    rng = np.random.default_rng(16)
    B, MB, bs = 9, 2048 // 16, 16
    NB = 1 + B * MB
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    q = mk(B, 16, 256).to(torch.bfloat16)
    kq, ks = quantize_kv(mk(NB, 1, bs, 256))
    vq, vs = quantize_kv(mk(NB, 1, bs, 256))
    tables = torch.from_numpy((1 + rng.permutation(NB - 1)).reshape(
        B, MB).astype(np.int32)).to(cuda)
    cur = np.array([0, 100, 2046, 2047, 2048, 2303, 4000, 9000, -1])
    depth = torch.tensor(np.where(cur < 0, -1, np.minimum(cur, 2047)),
                         dtype=torch.int32, device=cuda)
    before = paged_flash_decode_quant.launches
    got = paged_flash_decode_quant(q, kq, vq, ks, vs, tables, depth)
    assert paged_flash_decode_quant.launches == before + 1
    want = paged_decode_quant_ref(q, kq, vq, ks, vs, tables, depth)
    assert float((got - want).abs().max()) < 1e-5
    assert float(got[-1].abs().max()) == 0.0


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,causal", [
    (8, 256, 12, 12, 64, False), (2, 256, 12, 12, 64, True),
    (1, 384, 28, 4, 128, True), (2, 256, 28, 4, 128, False)],
    ids=["whisper-encoder", "whisper-decoder", "qwen2-vl", "gqa7-full"])
def test_flash_attention_at_the_modality_shapes_matches_plain(
        B, S, Hq, Hkv, hd, causal, cuda):
    """whisper-small's encoder (non-causal, MHA, hd 64) and decoder
    prefill, qwen2-vl-7b's prefill (GQA 7, hd 128: 256 vision positions
    and a 128-token prompt), within 2e-2 of the plain version."""
    rng = np.random.default_rng(S + Hq)
    q, k, v = _flash_case(rng, B, S, S, Hq, Hkv, hd, cuda)
    before = flash_attention.launches
    assert _flash_vs_plain(q, k, v, causal, 0) < 2e-2
    assert flash_attention.launches == before + 1


def test_recurrent_quant_engines_on_the_card_are_slot_invariant(cuda):
    """recurrentgemma-9b (its rings wrapping in decode) and rwkv6-1.6b on
    the int8 pool at the smoke size: the same tokens at 2 slots and 1,
    the quant kernel launched by the first (not the bf16 one) and by
    neither for rwkv6, which has no attention."""
    for arch, P in (("recurrentgemma-9b", 24), ("rwkv6-1.6b", 16)):
        cfg = get_smoke(arch)
        params = Mo.init_params(cfg, Env(), seed=0, device=cuda)
        trace = lambda: poisson_trace(4, 16.0, prompt_len=P,
                                      vocab_size=cfg.vocab_size, gen_len=8,
                                      seed=1)
        mk = lambda n: ServingEngine(cfg, params, num_slots=n, prompt_len=P,
                                     max_gen=8, kv="quant", block_size=8,
                                     clock=ManualClock(), device=cuda)
        paged_flash_decode.launches = paged_flash_decode_quant.launches = 0
        two = run_to_completion(mk(2), trace())
        assert paged_flash_decode.launches == 0
        assert (paged_flash_decode_quant.launches > 0) == (
            arch == "recurrentgemma-9b")
        assert two == run_to_completion(mk(1), trace())


def test_modality_oneshots_on_the_card_launch_the_kernels(cuda):
    """The one-shot of qwen2-vl-7b and whisper-small at the smoke size on
    the card: whisper at prompt 512 runs its encoder through the flash
    kernel (256 frames) and its decoder's prefill too, then reads its
    self- and cross-attention caches through the paged-decode kernel;
    qwen2-vl at prompt 248 (256 positions with its vision embeddings)
    takes the flash kernel and decodes through the paged one. The first
    token of each row equals the CPU path's wherever the CPU's top two
    logits lie 2^-4 apart or more."""
    for arch, P in (("qwen2-vl-7b", 248), ("whisper-small", 512)):
        cfg = get_smoke(arch)
        weights = Mo.init_params(cfg, Env(), seed=0, device="cpu")
        params = tree_map(lambda x: x.to(cuda), weights)
        tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, P))
        flash_attention.launches = paged_flash_decode.launches = 0
        out = serve_batch(cfg, params, tok, 4, streamed_prefill=False,
                          device=cuda)
        n_flash = cfg.n_layers + (cfg.encoder_layers if cfg.is_encdec
                                  else 0)
        assert flash_attention.launches == n_flash
        per_step = cfg.n_layers * (2 if cfg.is_encdec else 1)
        assert paged_flash_decode.launches == 3 * per_step
        assert out.shape == (2, 4)
        stubs = modality_stubs(cfg, 2, P, "cpu")
        lg, _ = Mo.forward(weights, torch.from_numpy(tok), cfg, Env(),
                           mode="prefill", last_only=True, **stubs)
        lg = lg[:, :cfg.vocab_size].float()
        top2 = torch.topk(lg, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1] >= 2 ** -4).numpy()
        assert np.array_equal(out[clear, 0], lg.argmax(-1).numpy()[clear])
