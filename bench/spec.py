"""Finds what a cell is made of by the names in BENCHMARK.json: the
configuration's file, the traffic mix (bench/traffic/<traffic>.json),
the cell's limits for `correct` (bench/limits/<cell>.json), a reader per
metric (bench/metrics/<name>.py, else the reader of the quantity before
the name's first dot: `step_ms.batch` -> step_ms.py) and the
kernel-work entries (every bench/kernels/*.py). A later cell, mix,
configuration, metric or kernel entry is a new file and a new entry;
nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    run_seconds: int


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bm: dict, name: str, root: Path = ROOT,
         bench_dir: Path = BENCH_DIR) -> Cell:
    w = next((w for w in bm["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r}; known: "
                       f"{[x['name'] for x in bm['workloads']]}")
    c = next(c for c in bm["configs"] if c["name"] == w["config"])
    limits = Path(bench_dir) / "limits" / f"{name}.json"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((Path(root) / c["file"]).read_text()),
        mix=json.loads((Path(bench_dir) / "traffic"
                        / f"{w['traffic']}.json").read_text()),
        limits=json.loads(limits.read_text()),
        end_to_end=[m for m in bm["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bm["per_layer"] if _applies(m, name)],
        run_seconds=int(bm["run_seconds"]))


def _module(path: Path) -> ModuleType:
    key = "bench_file_" + re.sub(r"\W", "_", str(path))
    sp = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


_readers: Dict[Path, ModuleType] = {}


def reader(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module whose read(run) gives metric `name`."""
    d = Path(bench_dir) / "metrics"
    for stem in (name, name.split(".", 1)[0]):
        p = d / f"{stem}.py"
        if p.exists():
            if p not in _readers:
                _readers[p] = _module(p)
            return _readers[p]
    raise KeyError(f"no reader for metric {name!r} in {d}")


def kernel_entries(bench_dir: Path = BENCH_DIR) -> List[ModuleType]:
    """Every kernel-work entry: a module with OP ("module:attribute" of the
    program's op), ROLE, KERNELS (substrings of the device kernels' names),
    capture(*args) and work(record) -> (flops, bytes)."""
    return [_module(p) for p in sorted((Path(bench_dir) / "kernels")
                                       .glob("*.py"))]
