"""The harness end to end on the CPU at the smoke sizes of both cells:
the port served through VirtualCluster.serve, held to the plain
reference; the command-line contract without a card."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, spec
from bench.tests import smoke

CELLS = smoke.CELLS


def _names(cell, trace):
    bm = smoke.entries()
    key = "per_layer" if trace else "end_to_end"
    return {m["name"] for m in bm[key]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct_on_cpu(cell, trace):
    c = smoke.cell(cell)
    # the CPU profiler's first traced step takes over a second
    seconds = 4.0 if trace else 1.5
    out = harness.run(c, 2**31 + 17, seconds, bool(trace),
                      torch.device("cpu"), time.monotonic())
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["check"]["gap"]["value"] <= c.limits["gap"]["limit"]
    assert out["check"]["positions"]["value"] >= 10
    got = set(out["metrics"])
    assert got <= _names(cell, trace)
    if trace:
        # the CPU has no device trace and no peak: the host readers only
        assert {n.split(".")[0] for n in got} >= {"control_ms", "step_ms"}
        assert out["breakdown"]["idle_gaps"]
        assert "busy_s" in out["device"] and "window_s" in out["device"]
    else:
        assert "setup_s" in got
        assert got - {"setup_s"}, "no other end-to-end metric"
    assert list(out)[-1] == "check"
    json.dumps(out)


def test_rag_check_includes_a_document_from_the_cache():
    c = smoke.cell("qwen3-32b-l32.rag-shared")
    seen = {}

    def keep(engine):
        seen["pool"] = engine.pool
    out = harness.run(c, 5, 1.5, False, torch.device("cpu"),
                      time.monotonic(), hooks={"engine": keep})
    assert out["correct"]
    assert seen["pool"].prefix_hit_tokens > 0


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        smoke.LISTED[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_run_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        smoke.LISTED[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.gpu
def test_cell_on_the_card():
    """One short run of each cell on the card (bench/run.py itself)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for cell in smoke.LISTED:
        r = subprocess.run([sys.executable, "bench/run.py", "--workload",
                            cell, "--seed", "11", "--seconds", "5",
                            "--trace", "0"], cwd=spec.ROOT,
                           capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-4000:]
        assert json.loads(r.stdout.splitlines()[-1])["correct"]
