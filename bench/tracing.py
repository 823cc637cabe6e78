"""The traced run's readings: torch.profiler over single steps spread
over the window, the benchmark's own record_function spans around the
calls into each layer, and the kernel calls that bench/kernels/ names,
captured for their work without an edit to the program.

From the profiler's timeline: the device's busy time (the union of
every kernel, copy and set on the card) over the traced steps' wall
span, the device time of each kernel by name, and the idle gaps labelled
by the innermost benchmark span and host operation running at the gap's
middle.
"""
from __future__ import annotations

import bisect
import importlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SPAN = "bench."  # prefix of the benchmark's own record_function spans


def span(name: str):
    return torch.profiler.record_function(SPAN + name)


@dataclass
class Capture:
    """One kernel-work entry's calls during the traced steps."""
    entry: object
    records: List[object] = field(default_factory=list)


class KernelCapture:
    """Wraps each entry's op (module attribute) while active; restores it
    after. The wrapper keeps the entry's small record of each call."""

    def __init__(self, entries):
        self.caps = [Capture(e) for e in entries]
        self._saved = []
        self.active = False

    def install(self):
        for cap in self.caps:
            mod_name, attr = cap.entry.OP.split(":")
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)

            def wrapped(*a, __orig=orig, __cap=cap, **k):
                if self.active:
                    __cap.records.append(__cap.entry.capture(*a, **k))
                return __orig(*a, **k)

            # the op counts its launches on the module attribute's object
            wrapped.launches = getattr(orig, "launches", 0)
            setattr(mod, attr, wrapped)
            self._saved.append((mod, attr, orig, wrapped))

    def remove(self):
        for mod, attr, orig, wrapped in self._saved:
            if hasattr(orig, "launches"):
                orig.launches = wrapped.launches
            setattr(mod, attr, orig)
        self._saved = []


def _is_device(e) -> bool:
    """An operation on the card (a kernel, a copy, a set); the device-side
    ranges of the host's record_function spans are not."""
    if e.name.startswith(SPAN):
        return False
    return "CUDA" in str(getattr(e, "device_type", "")) or "cuda" in str(
        getattr(e, "device_type", ""))


@dataclass
class Timeline:
    busy_s: float
    window_s: float
    kernel_s: Dict[str, float]
    idle_by: Dict[str, float]
    n_device_events: int


def _union(iv: List[Tuple[float, float]], lo: float, hi: float) -> float:
    tot, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(iv):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                tot += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        tot += cur_b - cur_a
    return tot


def reduce(prof) -> Optional[Timeline]:
    """The timeline of a finished profile (None without a traced step)."""
    events = list(prof.events())
    steps = [e for e in events if e.name == SPAN + "step"
             and "CUDA" not in str(getattr(e, "device_type", ""))]
    if not steps:
        return None
    lo = min(e.time_range.start for e in steps)
    hi = max(e.time_range.end for e in steps)
    dev = [e for e in events if _is_device(e)]
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    kernel = defaultdict(float)
    for e in dev:
        a, b = max(e.time_range.start, lo), min(e.time_range.end, hi)
        if b > a:
            kernel[e.name] += (b - a) * 1e-6
    busy = _union(iv, lo, hi)
    # idle gaps inside [lo, hi], labelled by what the host was doing
    merged = []
    for a, b in sorted(iv):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = []
    prev = lo
    for a, b in merged:
        if a > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
        if prev >= hi:
            break
    if prev < hi:
        gaps.append((prev, hi))
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events
                  if not _is_device(e) and not e.name.startswith(SPAN))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name.startswith(SPAN)
                   and "CUDA" not in str(getattr(e, "device_type", "")))
    starts = [h[0] for h in host]
    idle_by = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        m = (a + b) / 2
        inner = [sp for sp in spans if sp[0] <= m <= sp[1]]
        label = max(inner)[2] if inner else "between the benchmark's spans"
        k = bisect.bisect_right(starts, m)
        op = next((h[2] for h in reversed(host[max(0, k - 400):k])
                   if h[1] >= m), "python")
        idle_by[f"{label} / {op}"] += (b - a) * 1e-6
    return Timeline(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                    kernel_s=dict(kernel), idle_by=dict(idle_by),
                    n_device_events=len(dev))


def merge(parts: List[Optional[Timeline]]) -> Optional[Timeline]:
    """The timelines of several traced steps as one: times summed."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    kernel, idle = defaultdict(float), defaultdict(float)
    for p in parts:
        for k, v in p.kernel_s.items():
            kernel[k] += v
        for k, v in p.idle_by.items():
            idle[k] += v
    return Timeline(busy_s=sum(p.busy_s for p in parts),
                    window_s=sum(p.window_s for p in parts),
                    kernel_s=dict(kernel), idle_by=dict(idle),
                    n_device_events=sum(p.n_device_events for p in parts))


def profiler(device: torch.device):
    """A profiler of the host and, on the card, the device; started and
    stopped by the caller around one traced step."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:200], v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:n]]
