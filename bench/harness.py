"""One run of one cell: set-up, the measured window, the check.

The window drives the system's own facade,
repro_torch.core.cluster.VirtualCluster.serve(engine, requests), on a
RealClock, over one ServingEngine: the paged bf16 KV pool, the prefix
cache on, the engine's default prefill budget (prefill_chunk =
prompt_len, chunked prefill as lane rows of the fused step), FIFO, no
autoscaling. The engine handed to serve is `Driven`, which times each
call into it: a request is due at window open + its offset, and each of
its tokens is stamped when the step that made it returns to the host.
Nothing of the engine's own clocks (t_first_token, the metrics windows)
is read.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench import arith, check, spec, tracing, traffic, weights


@dataclass
class Iteration:
    t0: float
    t1: float
    tokens: int
    prefill: int
    traced: bool

    @property
    def worked(self) -> bool:
        return self.tokens > 0 or self.prefill > 0


@dataclass
class RunRecord:
    """What the readers of bench/metrics/ read."""
    cell: str
    cfg: dict
    mix: dict
    items: list
    reqs: list
    stamps: List[List[float]]
    t_start: float
    t_open: float
    t_close: float  # the window's end (its length after t_open)
    t_stop: float  # the end of the last step the run made
    iterations: List[Iteration]
    control_s: List[tuple]  # (seconds outside engine.step, traced)
    counters: Dict[str, Dict[str, float]]
    kind: str
    timeline: Optional[tracing.Timeline] = None
    captures: list = field(default_factory=list)

    def due(self, i: int) -> float:
        return self.t_open + self.items[i].offset_s


class Tracker:
    """Stamps the tokens of each request as they reach the host."""

    def __init__(self, reqs):
        self.reqs = reqs
        self.stamps: List[List[float]] = [[] for _ in reqs]
        self.waiting = list(range(len(reqs)))
        self.active: List[int] = []

    def stamp(self, t: float) -> int:
        still = []
        for i in self.waiting:
            (self.active if self.reqs[i].t_admit is not None
             else still).append(i)
        self.waiting = still
        n, keep = 0, []
        for i in self.active:
            r, st = self.reqs[i], self.stamps[i]
            k = len(r.tokens) - len(st)
            if k > 0:
                st.extend([t] * k)
                n += k
            elif k < 0:  # a restart preemption cleared its tokens
                del st[len(r.tokens):]
            if r.t_done is None:
                keep.append(i)
        self.active = keep
        return n


class Driven:
    """The ServingEngine as VirtualCluster.serve sees it, with the
    benchmark's clocks around engine.step and its stop rule in drained."""

    def __init__(self, engine, tracker: Optional[Tracker],
                 stop: Callable[["Driven"], bool], on_work=None):
        self._e = engine
        self.clock = engine.clock
        self.tracker = tracker
        self.stop = stop
        self.on_work = on_work  # called with the work-step index
        self.iterations: List[Iteration] = []
        self.control_s: List[tuple] = []
        self._prev_end: Optional[float] = None
        self.traced = False
        self.works = 0

    def __getattr__(self, k):
        return getattr(self._e, k)

    def drained(self) -> bool:
        return self.stop(self)

    def step(self):
        now = self.clock.now
        t0 = now()
        if self._prev_end is not None:
            self.control_s.append((t0 - self._prev_end, self.traced))
        pre = self._e.metrics.prefill_tokens
        with tracing.span("step"):
            snap = self._e.step()
        t1 = now()
        n = self.tracker.stamp(t1) if self.tracker is not None else 0
        it = Iteration(t0, t1, n, self._e.metrics.prefill_tokens - pre,
                       self.traced)
        self.iterations.append(it)
        if it.worked and self.on_work is not None:
            self.on_work(self)
            self.works += 1
        # the benchmark's own bookkeeping is not the control plane's time
        self._prev_end = now()
        return snap


def model_config(cfg: dict):
    """The program's ModelConfig of a configuration file (published keys)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=arith.head_dim(cfg),
        qk_norm=bool(cfg.get("qk_norm",
                             cfg.get("derived", {}).get("qk_norm", False))),
        qkv_bias=bool(cfg.get("attention_bias", False)),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg.get("rms_norm_eps")
                       or cfg["assumed"]["rms_norm_eps"]),
        tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
        block_pattern=("attn",), source=cfg["source"])


def requests_of(items, t_open: float):
    from repro_torch.serve.request import Request
    from repro_torch.serve.sampling import SamplingParams
    return [Request(rid=it.rid, prompt=it.prompt, gen_len=it.gen_len,
                    arrival_t=t_open + it.offset_s,
                    sampling=SamplingParams(temperature=it.temperature,
                                            top_k=it.top_k, top_p=it.top_p,
                                            seed=it.sample_seed))
            for it in items]


def _counters(engine) -> Dict[str, float]:
    pool = engine.pool
    return {"prefix_hit_tokens": float(getattr(pool, "prefix_hit_tokens", 0)),
            "prefix_lookup_tokens": float(getattr(pool,
                                                  "prefix_lookup_tokens", 0)),
            "prefill_tokens": float(engine.metrics.prefill_tokens)}


def _spans(engine, cluster):
    """record_function spans around the calls into each layer, on this
    run's objects (instance attributes; the program's code is untouched)."""
    def wrap(obj, attr, name):
        f = getattr(obj, attr)

        def g(*a, **k):
            with tracing.span(name):
                return f(*a, **k)
        setattr(obj, attr, g)

    wrap(engine, "_admit_ready", "admit")
    wrap(engine.replica, "step_decode", "step_decode")
    wrap(engine.pool, "decode", "model_step")
    wrap(cluster, "pump", "control.pump")
    agent = cluster.sim.nodes[cluster.head_id].agent
    wrap(agent, "report_serving", "control.publish")


@dataclass
class Setup:
    tree: dict
    cluster: object
    engine: object
    clock: object
    device: torch.device


def setup(cell: spec.Cell, seed: int, device: torch.device) -> Setup:
    """The weights from the seed, the cluster and the engine, and the
    warm-up: the window's two step shapes and its sampler, once."""
    from repro_torch.core.clock import RealClock
    from repro_torch.core.cluster import VirtualCluster
    from repro_torch.serve.policy import FIFOPolicy
    from repro_torch.serve.scheduler import ServingEngine

    cfg, mix = cell.config, cell.mix
    if device.type == "cuda":
        from repro_torch import kernels
        kernels.library()  # built once into build/ in the checkout
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
    tree = weights.make(cfg, seed, device)
    clock = RealClock()
    cluster = VirtualCluster(n_compute=1, clock=clock, device=device)
    e = mix["engine"]
    engine = ServingEngine(
        model_config(cfg), tree, num_slots=e["num_slots"],
        prompt_len=e["prompt_len"], max_gen=e["max_gen"], kv="paged",
        block_size=e.get("block_size", 16), prefix_cache=True,
        policy=FIFOPolicy(), clock=clock, device=device)
    warm = traffic.warmup(mix, cfg["vocab_size"], seed)
    cluster.serve(Driven(engine, None, lambda d: d._e.drained()),
                  requests_of(warm, clock.now()), dt=0.0, autoscale=False)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Setup(tree, cluster, engine, clock, device)


def window(st: Setup, cell: spec.Cell, items, seconds: float, trace: bool,
           t_start: float, bench_dir: Path = spec.BENCH_DIR) -> RunRecord:
    """Serve `items` through VirtualCluster.serve and time them.

    A mix with arrivals "fill" first serves its backlog until every slot
    holds a request that has its first token (the set-up a decode-heavy
    batch needs), then opens the window; otherwise the window opens at
    once and the requests fall due from its open."""
    mix, engine, cluster, clock = cell.mix, st.engine, st.cluster, st.clock
    cuda = st.device.type == "cuda"
    fill = bool(mix["arrivals"].get("fill"))
    reqs = requests_of(items, clock.now())
    tracker = Tracker(reqs)
    if fill:
        want = min(mix["engine"]["num_slots"], len(reqs))
        cluster.serve(Driven(engine, tracker, lambda d: sum(
            1 for s in tracker.stamps if s) >= want), reqs, dt=0.0,
            autoscale=False, max_steps=10**9)
        if cuda:
            torch.cuda.synchronize(st.device)
    t_open = clock.now()
    if not fill:
        for r, it in zip(reqs, items):
            r.arrival_t = t_open + it.offset_s
    t_close = t_open + seconds
    if mix["stop"] == "window":
        stop = lambda d: d.clock.now() >= t_close
    elif mix["stop"] == "drain":
        limit = t_close + float(mix.get("drain_limit_s", 60))
        stop = lambda d: d._e.drained() or d.clock.now() >= limit
    else:
        raise ValueError(f"unknown stop rule {mix['stop']!r}")
    profs: list = []
    capture = None
    on_work = None
    if trace:
        # single work steps spread over the window: at each of n evenly
        # spaced instants from its open, the step after the first work
        # step to end there or later, each under a profiler of its own
        n = int(mix.get("trace", {}).get("steps", 12))
        marks = [t_open + k * seconds / n for k in range(n)]
        capture = tracing.KernelCapture(spec.kernel_entries(bench_dir))
        capture.install()
        _spans(engine, cluster)

        def on_work(d):
            if d.traced:  # the traced step has ended
                if cuda:
                    torch.cuda.synchronize(st.device)
                capture.active = d.traced = False
                profs[-1].stop()
            due = sum(1 for m in marks if m <= d.clock.now())
            if due:
                del marks[:due]
                if cuda:
                    torch.cuda.synchronize(st.device)
                profs.append(tracing.profiler(st.device))
                profs[-1].start()
                capture.active = d.traced = True
    driver = Driven(engine, tracker, stop, on_work)
    counters = {"open": _counters(engine)}
    cluster.serve(driver, () if fill else reqs, dt=0.0, autoscale=False,
                  max_steps=10**9)
    if cuda:
        torch.cuda.synchronize(st.device)
    if driver.traced:  # the window closed inside a traced step
        capture.active = driver.traced = False
        profs[-1].stop()
    counters["close"] = _counters(engine)
    if capture is not None:
        capture.remove()
    return RunRecord(
        cell=cell.name, cfg=cell.config, mix=mix, items=items, reqs=reqs,
        stamps=tracker.stamps, t_start=t_start, t_open=t_open,
        t_close=t_close,
        t_stop=driver.iterations[-1].t1 if driver.iterations else t_open,
        iterations=driver.iterations, control_s=driver.control_s,
        counters=counters,
        kind=torch.cuda.get_device_name(st.device) if cuda else "cpu",
        timeline=tracing.merge([tracing.reduce(p) for p in profs])
        if trace else None,
        captures=capture.caps if capture is not None else [])


def release(st: Setup) -> None:
    """Free the program's state (its pool, its engine); the weights stay
    for the reference."""
    st.engine = st.cluster = None
    gc.collect()
    if st.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(cell: spec.Cell, rec: RunRecord, tree: dict, seed: int,
          device: torch.device, control: bool = False):
    """The numbers that decide `correct`, each beside its limit. With
    control=True, a pair: the program's and the control's (the reference
    in float8 at the same positions), both held to the same limits."""
    mix, reqs = cell.mix, rec.reqs
    if mix["stop"] == "drain":
        failed = sum(1 for r in reqs if r.t_done is None)
    else:
        failed = 0
    picked = check.choose(rec.items, reqs, int(mix["check"]["requests"]),
                          seed)
    numbers = check.compare(cell.config, tree,
                            lambda i: weights.layer_view(tree, i),
                            rec.items, reqs, picked, device, control)
    lim = cell.limits

    def held(gap: float) -> Dict[str, dict]:
        return {"gap": {"value": gap, "limit": lim["gap"]["limit"]},
                "positions": {"value": numbers["positions"],
                              "limit": lim["positions"]["limit"]},
                "failed": {"value": failed, "limit": 0}}
    if control:
        return held(numbers["gap"]), held(numbers["control_gap"])
    return held(numbers["gap"])


def correct(compared: Dict[str, dict]) -> bool:
    return (compared["gap"]["value"] <= compared["gap"]["limit"]
            and compared["positions"]["value"]
            >= compared["positions"]["limit"]
            and compared["failed"]["value"] <= compared["failed"]["limit"])


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        hooks: Optional[Dict[str, Callable]] = None,
        bench_dir: Path = spec.BENCH_DIR) -> dict:
    """One run: the result's fields, the numbers compared last under
    "check". hooks (tests): "engine" is called with the engine before the
    window, to plant a fault."""
    hooks = hooks or {}
    items = traffic.generate(cell.mix, cell.config["vocab_size"], seed,
                             seconds)
    st = setup(cell, seed, device)
    if "engine" in hooks:
        hooks["engine"](st.engine)
    rec = window(st, cell, items, seconds, trace, t_start, bench_dir)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    release(st)
    compared = judge(cell, rec, st.tree, seed, device)
    reqs = rec.reqs
    attempted = (len(reqs) if cell.mix["stop"] == "drain"
                 else sum(1 for r in reqs if r.t_admit is not None))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = spec.reader(m["name"], bench_dir).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": rec.kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct(compared), "attempted": attempted,
           "failed": compared["failed"]["value"], "metrics": metrics,
           "device": dev}
    if trace and rec.timeline is not None:
        dev["busy_s"] = rec.timeline.busy_s
        dev["window_s"] = rec.timeline.window_s
        out["breakdown"] = {
            "device_ops": tracing.top(rec.timeline.kernel_s),
            "idle_gaps": tracing.top(rec.timeline.idle_by)}
    out["check"] = compared
    return out
