"""The port's multi-replica data plane (serve/router.py) on the CPU.

Inside the port, as tests/test_replicas.py holds the JAX package (the
fleet's swap tier is in tests/test_torch_swap.py): routing
policies, the fleet bit-identical to one engine (greedy and seeded, bf16
and int8 KV), scale-up and drain mid-serve under both drain modes, warm
undrain before a cold spawn, backpressure, the cluster-driven lifecycle
with per-source metric tombstones and the metrics TTL, and the fleet
snapshot roll-up.

Against the JAX package, end to end: the fleet command of the CLI (smoke
config, a 16-request burst, 2 replicas autoscaled up to 4 nodes, int8
KV, --verify) through the port's run_trace and JAX's gives the same
tokens, the same (sim time, nodes) timeline, the same autoscaler actions,
the same released replicas and the same fleet counters.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core import VirtualCluster as JaxCluster
from repro.launch import serve as jax_serve
from repro.models import model as JMo
from repro.models.env import Env as JEnv
from repro.serve import SERVE_PLAN
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import QueueDepthPolicy, VirtualCluster
from repro_torch.core.clock import ManualClock
from repro_torch.launch.serve import parse_args, run_trace
from repro_torch.serve import (HostSwapPool, LeastOccupancyRouting,
                               PrefixAffineRouting,
                               ReplicaSet, RoutingPolicy, SamplingParams,
                               ServingEngine, burst_trace,
                               make_routing_policy, make_serving_engine,
                               poisson_trace, run_to_completion,
                               sysprompt_trace)

CFG = get_smoke("paper-demo")
JPARAMS = JMo.init_params(jax.random.PRNGKey(0), CFG,
                          JEnv(mesh=None, plan=SERVE_PLAN))
PARAMS = bridge.to_torch(jax.tree.map(np.asarray, JPARAMS), "cpu")
P = 16  # prompt length used throughout
BS = 4


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


def _fleet(replicas=2, routing="occupancy", num_slots=2, max_gen=8, **kw):
    return ReplicaSet(CFG, PARAMS, replicas=replicas, routing=routing,
                      num_slots=num_slots, prompt_len=P, max_gen=max_gen,
                      clock=ManualClock(), device="cpu", **kw)


def _single(num_slots=2, max_gen=8, **kw):
    return ServingEngine(CFG, PARAMS, num_slots=num_slots, prompt_len=P,
                         max_gen=max_gen, clock=ManualClock(), device="cpu",
                         **kw)


def _fresh(trace):
    return [dataclasses.replace(r, tokens=[], t_admit=None,
                                t_first_token=None, t_done=None)
            for r in trace]


def _trace(n=8, gen_len=6, rate=32.0, seed=0, sampling=None):
    return poisson_trace(n, rate, prompt_len=P, vocab_size=CFG.vocab_size,
                         gen_len=gen_len, sampling=sampling, seed=seed)


def _shared_trace(n=12, rate=48.0, sampling=None, n_prefixes=2, seed=0):
    return sysprompt_trace(n, rate, prompt_len=P, vocab_size=CFG.vocab_size,
                           prefix_len=12, gen_len=6, n_prefixes=n_prefixes,
                           sampling=sampling, seed=seed)


# ---------------------------------------------------------------------------
# routing policies
# ---------------------------------------------------------------------------


def test_routing_registry_and_protocol():
    assert isinstance(make_routing_policy("occupancy"),
                      LeastOccupancyRouting)
    assert isinstance(make_routing_policy("prefix"), PrefixAffineRouting)
    assert isinstance(LeastOccupancyRouting(), RoutingPolicy)
    assert isinstance(PrefixAffineRouting(), RoutingPolicy)
    with pytest.raises(ValueError):
        make_routing_policy("round-robin")


def test_least_occupancy_spreads_a_burst_across_replicas():
    rs = _fleet(replicas=2, num_slots=2)
    trace = burst_trace(4, prompt_len=P, vocab_size=CFG.vocab_size,
                        gen_len=6, seed=1)
    rs.submit(trace)
    rs.step()  # all four arrive at t=0; one lane opens per replica/step
    assert sorted(len(r._inflight) for r in rs.replicas) == [1, 1]
    rs.step()  # ... so the burst spreads 2+2, never 3+1
    assert sorted(len(r._inflight) for r in rs.replicas) == [2, 2]
    out = run_to_completion(rs, dt=0.05)
    assert sorted(out) == [0, 1, 2, 3]


def test_prefix_affine_routes_to_the_warm_replica():
    rs = _fleet(replicas=2, routing="prefix", num_slots=2, block_size=BS)
    trace = _shared_trace(n=3, n_prefixes=1, rate=1000.0)
    warm = rs.replicas[1]
    warm.admit(trace[0], 0.0)
    while warm.busy:
        warm.step_decode(rs.clock.now())
        rs.clock.sleep(0.05)
    assert warm.pool.probe_prefix(trace[1].prompt) > 0
    # both replicas idle (replica-0 would win a least-occupancy tie):
    # affinity must still route to the warm cache
    rs.submit(trace[1:])
    rs.step()
    assert not rs.replicas[0]._inflight, "cold replica stole a warm prompt"
    assert warm._inflight
    out = run_to_completion(rs, dt=0.05)
    assert sorted(out) == [0, 1, 2]
    assert warm.pool.prefix_hit_rate >= 0.5  # 2 of 3 prompts hit 12/16


def test_prefix_affine_beats_occupancy_on_fleet_hit_rate():
    runs = {}
    for routing in ("prefix", "occupancy"):
        rs = _fleet(replicas=2, routing=routing, num_slots=2, block_size=BS)
        run_to_completion(rs, _shared_trace(n=12, n_prefixes=2), dt=0.05)
        runs[routing] = rs.snapshot()["prefix_hit_rate"]
    assert runs["prefix"] > runs["occupancy"], runs


# ---------------------------------------------------------------------------
# exactness: the router moves requests, never tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routing,kv", [("occupancy", "paged"),
                                        ("prefix", "paged"),
                                        ("occupancy", "quant")])
def test_fleet_output_matches_single_engine_greedy(routing, kv):
    trace = _trace(n=8)
    base = run_to_completion(_single(kv=kv), _fresh(trace), dt=0.05)
    out = run_to_completion(_fleet(replicas=3, routing=routing, kv=kv),
                            _fresh(trace), dt=0.05)
    assert out == base


def test_fleet_output_matches_single_engine_seeded():
    sp = SamplingParams(temperature=0.9, top_k=40, top_p=0.95, seed=7)
    trace = _trace(n=8, sampling=sp)
    base = run_to_completion(_single(), _fresh(trace), dt=0.05)
    out = run_to_completion(_fleet(replicas=3, routing="prefix"),
                            _fresh(trace), dt=0.05)
    assert out == base


def test_make_serving_engine_dispatches_on_replica_count():
    kw = dict(num_slots=2, prompt_len=P, max_gen=8, clock=ManualClock(),
              device="cpu")
    assert isinstance(make_serving_engine(CFG, PARAMS, replicas=1, **kw),
                      ServingEngine)
    rs = make_serving_engine(CFG, PARAMS, replicas=2, **kw)
    assert isinstance(rs, ReplicaSet) and len(rs.replicas) == 2
    # every replica reads the one set of weights: a spawn copies nothing
    wq = PARAMS["blocks"][0]["attn"]["wq"]
    assert all(r.params["blocks"][0]["attn"]["wq"] is wq
               for r in rs.replicas)
    # swap=True: one engine gets a private host pool, a fleet ONE pool
    # shared by every replica (a drained request resumes on a peer)
    one = make_serving_engine(CFG, PARAMS, replicas=1, swap=True, **kw)
    assert isinstance(one.pool.swap_pool, HostSwapPool)
    rs = make_serving_engine(CFG, PARAMS, replicas=2, swap=True, **kw)
    pools = {id(r.pool.swap_pool) for r in rs.replicas}
    assert len(pools) == 1 and rs.replicas[0].pool.swap_pool is not None


# ---------------------------------------------------------------------------
# scale-out / drain lifecycle
# ---------------------------------------------------------------------------


def _run_with_rescale(rs, trace, *, up_at=3, up_to=3, down_at=8,
                      down_to=1, dt=0.05):
    rs.submit(trace)
    steps = 0
    while not rs.drained() and steps < 5000:
        rs.step()
        if steps == up_at:
            rs.reconcile(up_to)
        if steps == down_at:
            rs.reconcile(down_to)
        rs.clock.sleep(dt)
        steps += 1
    assert rs.drained()
    return rs.results()


@pytest.mark.parametrize("drain_mode", ["finish", "preempt"])
def test_scale_up_and_drain_mid_serve_is_bit_identical(drain_mode):
    trace = _trace(n=12, rate=32.0)
    base = run_to_completion(_single(), _fresh(trace), dt=0.05)
    rs = _fleet(replicas=1, routing="prefix", drain_mode=drain_mode)
    out = _run_with_rescale(rs, _fresh(trace))
    assert out == base, f"{drain_mode} drain perturbed tokens"
    assert rs.replica_warmups == 2, "scale-up must spawn cold replicas"
    assert len(rs.released) >= 2, "scale-down must release drained pools"
    if drain_mode == "preempt":
        assert rs.snapshot()["preemptions"] > 0


def test_seeded_output_survives_drain_preemption():
    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.95, seed=11)
    trace = _trace(n=12, rate=32.0, sampling=sp)
    base = run_to_completion(_single(), _fresh(trace), dt=0.05)
    out = _run_with_rescale(_fleet(replicas=1, drain_mode="preempt"),
                            _fresh(trace))
    assert out == base


def test_draining_replica_accepts_no_new_work_and_releases_clean():
    rs = _fleet(replicas=2, num_slots=2)
    trace = burst_trace(6, prompt_len=P, vocab_size=CFG.vocab_size,
                        gen_len=6, seed=3)
    rs.submit(trace)
    rs.step()
    victim = rs.replicas[1]
    pool = victim.pool
    rs.reconcile(1)
    assert victim.draining
    assert not victim.can_accept(trace[-1])
    inflight_before = set(victim._inflight)
    out = run_to_completion(rs, dt=0.05)
    assert sorted(out) == list(range(6)), "drained requests must finish"
    assert victim.name in rs.released
    assert inflight_before, "test needs in-flight work on the victim"
    assert pool.blocks_in_use == 0
    assert pool._reserved_total == 0
    assert (len(pool._free_blocks) + len(pool._reclaim)
            == pool.usable_blocks)
    assert pool.caches is None


def test_reconcile_prefers_warm_undrain_over_cold_spawn():
    rs = _fleet(replicas=2)
    rs.reconcile(1)
    draining = [r for r in rs.replicas if r.draining]
    assert len(draining) == 1
    rs.reconcile(2)  # scale back up before the drain completes
    assert not draining[0].draining, "warm replica must be un-drained"
    assert rs.replica_warmups == 0, "no cold spawn was needed"
    rs.reconcile(4)
    assert rs.replica_warmups == 2
    assert len(rs.live_replicas()) == 4


def test_router_applies_backpressure_when_fleet_is_full():
    rs = _fleet(replicas=2, num_slots=1)
    trace = burst_trace(6, prompt_len=P, vocab_size=CFG.vocab_size,
                        gen_len=8, seed=5)
    rs.submit(trace)
    rs.step()
    assert sum(len(r._inflight) for r in rs.replicas) == 2
    assert rs.pending() == 4, "over-capacity arrivals must queue"
    out = run_to_completion(rs, dt=0.05)
    assert sorted(out) == list(range(6))


# ---------------------------------------------------------------------------
# cluster integration: autoscaler plans become replica lifecycle
# ---------------------------------------------------------------------------


def _vc(**kw):
    return VirtualCluster(device="cpu", **kw)


def test_cluster_serve_drives_fleet_lifecycle_and_tombstones():
    pol = QueueDepthPolicy(target_per_node=2, min_nodes=1, max_nodes=4)
    c = _vc(n_compute=1, policy=pol, cooldown_s=0.3)
    rs = ReplicaSet(CFG, PARAMS, replicas=1, routing="prefix", num_slots=2,
                    prompt_len=P, max_gen=8, clock=c.clock, device="cpu")
    trace = burst_trace(12, prompt_len=P, vocab_size=CFG.vocab_size,
                        gen_len=8, seed=2)
    base = run_to_completion(_single(), _fresh(trace), dt=0.05)
    fleet_sizes = []
    out = c.serve(rs, _fresh(trace), dt=0.05,
                  on_step=lambda i, s, cl: fleet_sizes.append(
                      int(s["replicas_live"])))
    assert out == base, "the cluster-driven fleet perturbed tokens"
    assert max(fleet_sizes) > 1, "burst must scale the fleet out"
    assert fleet_sizes[-1] == 1, "drained queue must scale the fleet in"
    assert rs.released, "scale-down must have released replicas"
    m = c.scaler.read_metrics(c.registry)
    for name in rs.released:
        assert not any(k.endswith(f"/{name}") for k in m), (name, m)
    live = rs.replicas[0].name
    assert any(k.endswith(f"/{live}") for k in m)
    c.shutdown()


def test_node_drain_tombstones_step_metrics_immediately():
    c = _vc(n_compute=3)
    nodes = c.compute_nodes()
    for i, nid in enumerate(nodes):
        c.sim.nodes[nid].agent.report_step_time(0, 0.1 * (i + 1))
    m = c.scaler.read_metrics(c.registry)
    assert len([k for k in m if k.startswith("node_step_time/")]) == 3
    c.sim.remove_nodes([nodes[2]])  # graceful drain (the slowest node)
    m = c.scaler.read_metrics(c.registry)
    times = {k: v for k, v in m.items() if k.startswith("node_step_time/")}
    assert len(times) == 2, times
    assert m["step_time"] == pytest.approx(0.15)  # median of survivors
    c.shutdown()


def test_retire_source_is_idempotent_and_scoped():
    c = _vc(n_compute=1)
    agent = c.sim.nodes[c.head_id].agent
    agent.report_serving({"tokens_per_s": 5.0}, source="replica-0")
    agent.report_serving({"tokens_per_s": 7.0}, source="replica-1")
    assert c.scaler.read_metrics(c.registry)["tokens_per_s"] == 12.0
    agent.retire_source("replica-0")
    agent.retire_source("replica-0")  # idempotent
    assert c.scaler.read_metrics(c.registry)["tokens_per_s"] == 7.0
    c.shutdown()


def test_metrics_ttl_ages_out_killed_replica_without_drain():
    c = _vc(n_compute=1, metrics_ttl_s=1.0)
    agent = c.sim.nodes[c.head_id].agent
    agent.report_serving({"tokens_per_s": 5.0, "latency_p95_ms": 900.0},
                         source="replica-0")
    agent.report_serving({"tokens_per_s": 7.0, "latency_p95_ms": 40.0},
                         source="replica-1")
    m = c.scaler.read_metrics(c.registry)
    assert m["tokens_per_s"] == 12.0 and m["latency_p95_ms"] == 900.0
    c.clock.advance(0.6)
    agent.report_serving({"tokens_per_s": 7.0, "latency_p95_ms": 40.0},
                         source="replica-1")
    assert c.scaler.read_metrics(c.registry)["tokens_per_s"] == 12.0
    c.clock.advance(0.6)  # replica-0's stamp is now 1.2s old (> TTL)
    agent.report_serving({"tokens_per_s": 7.0, "latency_p95_ms": 40.0},
                         source="replica-1")
    m = c.scaler.read_metrics(c.registry)
    assert m["tokens_per_s"] == 7.0 and m["latency_p95_ms"] == 40.0
    assert not any(k.endswith("/replica-0") for k in m), m
    assert not any("__ts" in k for k in m), m
    c.shutdown()


def test_metrics_ttl_spares_plain_and_fresh_sources():
    c = _vc(n_compute=1, metrics_ttl_s=1.0)
    node = c.compute_nodes()[0]
    c.sim.nodes[node].agent.report_step_time(0, 0.25)
    head = c.sim.nodes[c.head_id].agent
    head.report_serving({"tokens_per_s": 5.0}, source="replica-0")
    c.clock.advance(5.0)
    m = c.scaler.read_metrics(c.registry)
    assert m["step_time"] == pytest.approx(0.25), "no stamp == always fresh"
    assert "tokens_per_s" not in m, "stale serving source dropped"
    c.shutdown()
    c2 = _vc(n_compute=1)  # TTL disabled (default None)
    head2 = c2.sim.nodes[c2.head_id].agent
    head2.report_serving({"tokens_per_s": 5.0}, source="replica-0")
    c2.clock.advance(1e6)
    assert c2.scaler.read_metrics(c2.registry)["tokens_per_s"] == 5.0
    c2.shutdown()


# ---------------------------------------------------------------------------
# fleet metrics rollup
# ---------------------------------------------------------------------------


def test_fleet_hit_rate_is_count_weighted_not_a_mean_of_ratios():
    rs = _fleet(replicas=3, routing="prefix", num_slots=2, block_size=BS)
    run_to_completion(rs, _shared_trace(n=6, n_prefixes=1, rate=2.0),
                      dt=0.05)
    hits = sum(r.pool.prefix_hit_tokens for r in rs.replicas)
    lookups = sum(r.pool.prefix_lookup_tokens for r in rs.replicas)
    fleet = rs.snapshot()["prefix_hit_rate"]
    assert fleet == pytest.approx(hits / lookups)
    ratios = [r.pool.prefix_hit_rate for r in rs.replicas]
    assert 0.0 in ratios, "test needs an idle replica"
    assert fleet > sum(ratios) / len(ratios)
    assert fleet >= 0.5


def test_fleet_snapshot_rolls_up_and_stays_monotonic_across_release():
    rs = _fleet(replicas=2, num_slots=2, drain_mode="preempt")
    rs.submit(_trace(n=10, rate=32.0))
    for _ in range(6):
        rs.step()
        rs.clock.sleep(0.05)
    rs.reconcile(1)  # preempt-drain one replica mid-serve
    pre = rs.snapshot()["preemptions"]
    assert pre > 0
    while not rs.drained():
        rs.step()
        rs.clock.sleep(0.05)
    snap = rs.snapshot()
    assert snap["preemptions"] >= pre, \
        "released replicas' counters must stay absorbed in fleet totals"
    assert snap["replicas_live"] == 1.0
    assert rs.completed_count == 10
    srcs = rs.metric_sources()
    assert "router" in srcs and "queue_depth" in srcs["router"]
    for name, m in srcs.items():
        if name != "router":
            assert "queue_depth" not in m, \
                "replica sources must not multiply the router's depth"


# ---------------------------------------------------------------------------
# the CLI's fleet path against the JAX package's
# ---------------------------------------------------------------------------

FLEET_ARGV = ["--smoke", "--trace", "burst", "--requests", "16",
              "--replicas", "2", "--max-nodes", "4", "--kv", "quant",
              "--verify"]


def _timeline(steps):
    """(sim time, nodes) at every change of the compute-node count, as
    run_trace prints it."""
    out = []
    for t, n in steps:
        if not out or out[-1][1] != n:
            out.append((t, n))
    return out


def test_fleet_cli_run_matches_the_jax_run(monkeypatch, capsys):
    seen = {}
    serve = JaxCluster.serve

    def spy(self, engine, requests=(), *, dt=0.05, autoscale=True,
            max_steps=100_000, on_step=None):
        steps = []

        def record(i, snap, c):
            steps.append((c.clock.now(), len(c.current_view().compute)))
            on_step(i, snap, c)

        out = serve(self, engine, requests, dt=dt, autoscale=autoscale,
                    max_steps=max_steps, on_step=record)
        seen.update(out=out, engine=engine, steps=steps,
                    history=list(self.scaler.history),
                    snap=engine.snapshot())
        return out

    monkeypatch.setattr(JaxCluster, "serve", spy)
    monkeypatch.setattr(sys, "argv", ["serve"] + FLEET_ARGV)
    assert jax_serve.main() == 0
    jax_log = capsys.readouterr().out
    assert "bit-identical MATCH" in jax_log

    run = run_trace(parse_args(FLEET_ARGV + ["--device", "cpu"]), CFG,
                    PARAMS)
    assert run["rc"] == 0 and "bit-identical MATCH" in run["verify"]
    assert run["out"] == seen["out"]
    assert run["sizes"] == _timeline(seen["steps"])
    assert [n for _, n in run["sizes"]] == [4, 1]  # from 2 nodes
    assert (run["start"], run["peak"], run["final"]) == (2, 4, 1)
    assert run["actions"] == seen["history"] and len(run["actions"]) == 2
    assert run["engine"].released == seen["engine"].released
    assert len(run["engine"].released) == 3
    assert run["engine"].replica_warmups == seen["engine"].replica_warmups
    snap, jsnap = run["snapshot"], seen["snap"]
    assert sorted(snap) == sorted(jsnap)
    for name, value in jsnap.items():
        if name == "kv_quant_divergence":  # f32 mean, another sum order
            assert snap[name] == pytest.approx(value, rel=1e-5)
        else:
            assert snap[name] == value, name
