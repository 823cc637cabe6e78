"""The metric arithmetic against hand counts."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench import arith, spec

YI = json.loads((spec.BENCH_DIR / "configs" / "yi-9b.json").read_text())
QW = json.loads((spec.BENCH_DIR / "configs" / "qwen3-32b-l32.json")
                .read_text())


def test_nearest_rank_p90_with_ten_beyond():
    v = list(range(1, 101))  # 1 .. 100
    p, beyond = arith.nearest_rank(v, 90)
    assert p == 90 and beyond == 10
    p, beyond = arith.nearest_rank(list(range(1, 100)), 90)
    assert beyond < 10  # 99 values cannot carry a p90 with 10 beyond
    p, beyond = arith.nearest_rank(list(range(1, 201)), 95)
    assert p == 190 and beyond == 10


def test_matmul_params_by_hand():
    # yi-9b: 48 x (4096 x 4096 + 2 x 4096 x 512 + 4096 x 4096
    #               + 3 x 4096 x 11008) + 4096 x 64000
    layer = 4096 * 4096 * 2 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert arith.matmul_params(YI) == 48 * layer + 4096 * 64000
    layer = 5120 * 8192 * 2 + 2 * 5120 * 1024 + 3 * 5120 * 25600
    assert arith.matmul_params(QW) == 32 * layer + 5120 * 151936
    assert YI["memory"]["params"] == arith.matmul_params(YI) + \
        4096 * 64000 + 2 * 4096 * 48 + 4096


def test_span_flops_by_hand():
    P = arith.matmul_params(YI)
    att = 4 * 48 * 32 * 128
    assert arith.span_flops(YI, 0, 1) == 2 * P + att
    assert arith.span_flops(YI, 9, 10) == 2 * P + 10 * att
    assert arith.span_flops(YI, 3, 7) == pytest.approx(
        sum(2 * P + (p + 1) * att for p in range(3, 7)))
    assert arith.span_flops(YI, 5, 5) == 0.0


def _run(stamps, offsets, t_open=100.0, t_stop=None):
    items = [SimpleNamespace(offset_s=o) for o in offsets]
    r = SimpleNamespace(stamps=stamps, items=items, t_open=t_open,
                        t_stop=t_stop)
    r.due = lambda i: t_open + items[i].offset_s
    return r


def test_output_tokens_per_s_is_all_tokens_over_the_window():
    rd = spec.reader("output_tokens_per_s")
    run = _run([[101.0, 102.0], [103.0], []], [0, 0, 0], t_stop=104.0)
    assert rd.read(run) == pytest.approx(3 / 4.0)


def test_ttft_over_every_request_from_its_due_time():
    rd = spec.reader("ttft_p90_ms")
    n = 100
    # request i due at 100 + i, first token 10 ms later; one late by 5 s
    stamps = [[100.0 + i + 0.010] for i in range(n)]
    stamps[42] = [100.0 + 42 + 5.0]
    run = _run(stamps, list(range(n)))
    assert rd.read(run) == pytest.approx(10.0, abs=1e-6)
    stamps[43] = []
    assert rd.read(_run(stamps, list(range(n)))) is None  # a request unserved
    # 82 requests (the rag cell's 51-s window) leave 8 beyond; 79 leave 7
    ok = [[100.0 + i + 0.010] for i in range(82)]
    assert arith.nearest_rank([0.0] * 82, 90)[1] == 8
    assert rd.read(_run(ok, list(range(82)))) == pytest.approx(10.0,
                                                               abs=1e-6)
    assert rd.read(_run(ok[:79], list(range(79)))) is None  # 7 beyond


def test_itl_over_every_gap_of_every_request():
    rd = spec.reader("itl_p95_ms")
    stamps = [[0.0, 0.01, 0.02, 0.03] for _ in range(200)]  # gaps of 10 ms
    stamps[0] = [0.0, 1.0, 2.0, 3.0] + [3.0 + 0.01 * k for k in range(1, 4)]
    v = sorted([10.0] * 600 + [1000.0] * 3)
    run = _run(stamps, [0] * 200)
    want, _ = arith.nearest_rank(v, 95)
    assert rd.read(run) == pytest.approx(want) == pytest.approx(10.0)
    # the three long gaps all lie beyond p99.5's rank
    assert arith.nearest_rank(v, 99.9)[0] == 1000.0


def test_mfu_counts_a_shared_document_once():
    rd = spec.reader("mfu")
    cfg = YI
    items = [SimpleNamespace(prompt=[0] * 30, doc=0, doc_len=20,
                             offset_s=0.0) for _ in range(2)]
    run = SimpleNamespace(
        kind="NVIDIA H100 80GB HBM3", cfg=cfg, items=items,
        mix={"prompt": {"shared": True}}, t_open=0.0, t_stop=2.0,
        stamps=[[1.0, 1.1, 1.2], [1.5, 1.6]])
    want = (arith.span_flops(cfg, 0, 30) + arith.span_flops(cfg, 30, 32)
            + arith.span_flops(cfg, 20, 30) + arith.span_flops(cfg, 30, 31))
    assert rd.read(run) == pytest.approx(100 * want / 2.0 / 989e12)
    run.kind = "cpu"
    assert rd.read(run) is None


def test_attention_work_by_hand():
    entry = next(e for e in spec.kernel_entries() if e.ROLE == "attention")
    bs, Hkv, hd, Hq = 16, 2, 8, 4
    # row 0 at depth 20 (blocks 3, 5), row 1 at depth 3 on block 3 (the
    # same block: read once), row 2 masked
    tables = torch.tensor([[3, 5, 0], [3, 0, 0], [0, 0, 0]],
                          dtype=torch.int32)
    lengths = torch.tensor([20, 3, -1], dtype=torch.int32)
    q = torch.zeros((3, Hq, hd), dtype=torch.bfloat16)
    pool = torch.zeros((8, Hkv, bs, hd), dtype=torch.bfloat16)
    rec = entry.capture(q, pool, pool, tables, lengths)
    flops, nbytes = entry.work(rec)
    assert flops == 4 * Hq * hd * (21 + 4)
    kv = 2 * 2 * Hkv * bs * hd * 2  # blocks 3 and 5, K and V, bf16
    assert nbytes == kv + 3 * Hq * hd * 2 + 9 * 4 + 3 * 4 + 3 * Hq * hd * 4


def test_roofline_and_idle_readers():
    from bench.tracing import Capture, Timeline
    entry = next(e for e in spec.kernel_entries() if e.ROLE == "attention")
    tl = Timeline(busy_s=0.3, window_s=1.0,
                  kernel_s={"void paged_decode_kernel<8>(...)": 2e-3,
                            "paged_decode_merge_kernel": 1e-3,
                            "gemm": 0.1},
                  idle_by={}, n_device_events=5)
    cap = Capture(entry)
    tables = torch.tensor([[1]], dtype=torch.int32)
    lengths = torch.tensor([15], dtype=torch.int32)
    q = torch.zeros((1, 8, 128), dtype=torch.bfloat16)
    pool = torch.zeros((2, 1, 16, 128), dtype=torch.bfloat16)
    cap.records.append(entry.capture(q, pool, pool, tables, lengths))
    run = SimpleNamespace(timeline=tl, captures=[cap],
                          kind="NVIDIA H100 80GB HBM3")
    f, b = entry.work(cap.records[0])
    least = max(f / 989e12, b / 3.35e12)
    assert spec.reader("attn_roofline.batch").read(run) == pytest.approx(
        100 * least / 3e-3)
    assert spec.reader("device_idle.rag").read(run) == pytest.approx(70.0)
