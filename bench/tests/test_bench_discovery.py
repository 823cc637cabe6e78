"""Data-driven: a new configuration, mix, metric or kernel-work entry is
picked up by its name with new files and BENCHMARK.json entries alone;
and BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import shutil
import time

import torch

from bench import harness, spec
from bench.tests import smoke

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path
    shutil.copytree(spec.BENCH_DIR, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bm = spec.load()
    bench = root / "bench"
    cfg = json.loads((bench / "configs" / "yi-9b.json").read_text())
    cfg.update(smoke.SMOKE_MODEL, name="tiny")
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "rag-shared.json").read_text())
    smoke._merge(mix, smoke.SMOKE_MIX["rag-shared"])
    mix["prompt"]["shared"] = False
    (bench / "traffic" / "rag-unique.json").write_text(json.dumps(mix))
    (bench / "limits" / "tiny.rag-unique.json").write_text(json.dumps(
        {"gap": {"limit": 1.0}, "positions": {"limit": 10}}))
    (bench / "metrics" / "queue_wait_ms.py").write_text(
        "def read(run):\n"
        "    v = [r.t_admit - run.due(i) for i, r in enumerate(run.reqs)\n"
        "         if r.t_admit is not None]\n"
        "    return 1e3 * sum(v) / len(v) if v else None\n")
    (bench / "kernels" / "mask.py").write_text(
        "OP = 'repro_torch.kernels.sampling.ops:topk_topp_mask'\n"
        "ROLE = 'sampler'\nKERNELS = ('topk_topp_mask_kernel',)\n"
        "def capture(logits, top_k, top_p):\n"
        "    return tuple(logits.shape)\n"
        "def key(rec):\n    return rec\n"
        "def work(rec):\n    return 0.0, 8.0 * rec[0] * rec[1]\n")
    bm["configs"].append({"name": "tiny", "source": "https://example.org",
                          "file": "bench/configs/tiny.json", "reduced": [],
                          "why": "a test"})
    bm["workloads"].append({"name": "tiny.rag-unique", "config": "tiny",
                            "traffic": "rag-unique", "chips": 1,
                            "why": "a test"})
    bm["per_layer"].append({"name": "queue_wait_ms.rag", "unit": "ms",
                            "better": "lower", "source": "host_clock",
                            "layer": "engine", "moves": "ttft_p90_ms",
                            "workloads": ["tiny.rag-unique"]})
    for m in bm["end_to_end"]:
        if "workloads" in m and "qwen3-32b-l32.rag-shared" in m["workloads"]:
            m["workloads"].append("tiny.rag-unique")
    (root / "BENCHMARK.json").write_text(json.dumps(bm))

    c = spec.cell(spec.load(root), "tiny.rag-unique", root, bench)
    assert c.config["name"] == "tiny" and not c.mix["prompt"]["shared"]
    assert "queue_wait_ms.rag" in {m["name"] for m in c.per_layer}
    assert [e.ROLE for e in spec.kernel_entries(bench)].count("sampler") == 1
    out = harness.run(c, 21, 4.0, True, torch.device("cpu"),
                      time.monotonic(), bench_dir=bench)
    assert out["correct"], out["check"]
    assert "queue_wait_ms.rag" in out["metrics"]
    out = harness.run(c, 22, 1.5, False, torch.device("cpu"),
                      time.monotonic(), bench_dir=bench)
    assert {"ttft_p90_ms", "itl_p95_ms", "setup_s"} >= set(out["metrics"])
    assert "setup_s" in out["metrics"]


def test_benchmark_json_keeps_the_contract():
    bm = spec.load()
    assert set(bm) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert bm["paths"] == ["bench"] and bm["command"][1] == "bench/run.py"
    assert 1 <= bm["run_seconds"] <= 51
    names = [c["name"] for c in bm["configs"]]
    cells = [w["name"] for w in bm["workloads"]]
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    per = {m["name"]: m for m in bm["per_layer"]}
    every = names + cells + list(e2e) + list(per)
    assert len(set(every)) == len(every)
    assert all(NAME.match(n) for n in every)
    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = json.loads((spec.ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"] and f["name"] == c["name"]
        assert c["file"].startswith("bench/")
        assert any(w["config"] == c["name"] for w in bm["workloads"])
        for k in c["reduced"]:
            assert NAME.match(k)
            assert not re.search(r"(size|_dim|_rank|heads|experts)", k), k
    pairs = set()
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (spec.BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (spec.BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in list(e2e.values()) + list(per.values()):
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        spec.reader(m["name"])  # every metric has a reader
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in per.values():
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        mine = [n for n, m in e2e.items() if w in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w in m.get("workloads", cells) for m in per.values())
    layers = {}
    for m in per.values():
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_prepared_cells_have_their_files_and_readers():
    """A prepared cell (bench/prepared/) is listed by copying its entries
    into BENCHMARK.json and setting its bounds: its files and readers are
    in place, and it names nothing that BENCHMARK.json already has."""
    listed = spec.load()
    have = {m["name"] for k in ("configs", "workloads", "end_to_end",
                                "per_layer") for m in listed[k]}
    for p in sorted((spec.BENCH_DIR / "prepared").glob("*.json")):
        extra = json.loads(p.read_text())
        for k in ("configs", "workloads", "end_to_end", "per_layer"):
            assert not {m["name"] for m in extra[k]} & have, (p, k)
        for w in extra["workloads"]:
            c = spec.cell(smoke.entries(), w["name"])
            assert c.limits["gap"]["limit"] > 0 and c.mix and c.config
            assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
            for m in c.end_to_end + c.per_layer:
                assert NAME.match(m["name"]) and UNIT.match(m["unit"])
                spec.reader(m["name"])
