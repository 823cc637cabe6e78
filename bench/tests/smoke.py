"""Smoke sizes of the benchmark's cells for the CPU tests: the same
files, widths and traffic cut to what the CPU runs in seconds. The cells
prepared under bench/prepared/ (their files in place, their entries not
yet in BENCHMARK.json) are tested alongside the listed ones."""
from __future__ import annotations

import copy
import json

from bench import spec


def entries() -> dict:
    """BENCHMARK.json with the entries of every prepared cell added."""
    bm = spec.load()
    for p in sorted((spec.BENCH_DIR / "prepared").glob("*.json")):
        extra = json.loads(p.read_text())
        for k in ("configs", "workloads", "end_to_end", "per_layer"):
            bm[k] += extra.get(k, [])
    return bm


LISTED = [w["name"] for w in spec.load()["workloads"]]
CELLS = [w["name"] for w in entries()["workloads"]]

SMOKE_MODEL = {"hidden_size": 64, "num_hidden_layers": 2,
               "num_attention_heads": 4, "num_key_value_heads": 2,
               "head_dim": 16, "intermediate_size": 128, "vocab_size": 512}

SMOKE_MIX = {
    "rollout-batch": {
        "arrivals": {"kind": "backlog", "requests": 12, "fill": True},
        "prompt": {"median": 24, "min": 8, "max": 48},
        "output": {"median": 12, "min": 4, "max": 24},
        "engine": {"num_slots": 4, "prompt_len": 48, "max_gen": 24},
        "trace": {"steps": 3},
        "check": {"requests": 3}},
    "rag-shared": {
        "arrivals": {"kind": "poisson", "rate_rps": 70.0},
        "prompt": {"documents": 4, "doc_min": 24, "doc_max": 48,
                   "question": {"median": 8, "min": 4, "max": 16}},
        "output": {"median": 8, "min": 4, "max": 16},
        "engine": {"num_slots": 16, "prompt_len": 64, "max_gen": 16},
        "trace": {"steps": 3},
        "check": {"requests": 3}},
}


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def cell(name: str) -> spec.Cell:
    """The cell `name` (listed or prepared) at smoke size."""
    bm = entries()
    c = copy.deepcopy(spec.cell(bm, name))
    c.config.update(SMOKE_MODEL)
    traffic = next(w["traffic"] for w in bm["workloads"]
                   if w["name"] == name)
    _merge(c.mix, SMOKE_MIX[traffic])
    c.limits["positions"]["limit"] = 10
    return c
