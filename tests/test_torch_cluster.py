"""The port's virtual cluster (src/repro_torch/core) on the CPU.

Inside the port, the paper's behaviours as tests/test_cluster_core.py
holds them in the JAX package: auto-registration renders the hostfile and
the device list, scale-up re-renders, a crash is reaped by TTL, a
partition acts like a failure and heals, a straggler is replaced, image
skew is detected, scale_to keeps the installed policy, and membership
invariants hold under random churn. The mpirun analogue runs a function
over the rendered device list.

Against the JAX package: the same scripted sequence of adds, crashes,
partitions, scale_to calls, published queue depths and pumps, through
both packages' VirtualClusters, gives identical hostfiles, view epochs
and autoscaler histories (time and reason of every action). Image digests
differ by design (the port pins torch, not jax) and are never compared.
"""
import pytest
import torch

try:  # optional test dep: falls back to fixed deterministic examples
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:
    from _hypothesis_fallback import given, settings, st

from repro.core import QueueDepthPolicy as JaxQueueDepthPolicy
from repro.core import VirtualCluster as JaxCluster
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.core import (ClusterImage, QueueDepthPolicy,
                              StragglerPolicy, VirtualCluster, render_devices)
from repro_torch.core.image import software_pins
from repro_torch.core.membership import HPC_SERVICE, ClusterView, Member
from repro_torch.core.template import HOSTFILE_KEY

CPU = torch.device("cpu")


def _cluster(**kw):
    return VirtualCluster(device="cpu", **kw)


def test_hostfile_renders_live_set():
    c = _cluster(n_compute=2)
    hf = c.hostfile
    assert "compute001" in hf and "compute002" in hf and "head000" in hf
    # published to KV like consul-template writing the file (paper Fig. 5)
    assert c.registry.kv_get(HOSTFILE_KEY).value == hf
    # two simulated nodes on one real device: an oversubscribed rendering
    assert c.rendering.devices == (CPU,) and c.rendering.oversubscribed
    c.shutdown()


def test_render_devices_maps_disjoint_members_onto_their_devices():
    cards = [torch.device("cuda", i) for i in range(2)]
    members = tuple(Member(f"compute00{i}", f"simnet://compute00{i}"
                           f"?devices={i}", 1) for i in range(2))
    devs, oversub = render_devices(ClusterView(1, members), cards)
    assert devs == tuple(cards) and not oversub
    both_on_0 = tuple(Member(f"compute00{i}", f"simnet://compute00{i}"
                             "?devices=0", 1) for i in range(2))
    devs, oversub = render_devices(ClusterView(2, both_on_0), cards)
    assert devs == tuple(cards) and oversub
    assert render_devices(ClusterView(3, ()), cards) == ((), False)


def test_scale_up_auto_joins_and_rerenders():
    c = _cluster(n_compute=2)
    e0 = c.rendering.epoch
    c.scale_to(4)
    r = c.rendering
    assert r.epoch > e0
    assert len(r.view.compute) == 4
    assert all(f"compute00{i}" in r.hostfile for i in (1, 2, 3, 4))
    c.shutdown()


def test_crash_is_reaped_by_ttl_and_view_shrinks():
    c = _cluster(n_compute=3, ttl=2.0)
    victims = c.compute_nodes()
    c.crash_node(victims[-1])
    c.pump(dt=3.0)  # TTL lapses
    assert len(c.compute_nodes()) == 2
    assert victims[-1] not in c.hostfile
    c.shutdown()


def test_partition_acts_like_failure_then_rejoin():
    c = _cluster(n_compute=2, ttl=2.0)
    n = c.compute_nodes()[0]
    c.sim.partition(n)
    c.pump(dt=3.0)
    assert n not in c.compute_nodes()
    c.sim.heal(n)
    c.sim.nodes[n].agent.start()  # re-register after partition heals
    c.pump()
    assert n in c.compute_nodes()
    c.shutdown()


def test_straggler_policy_replaces_slow_node():
    c = _cluster(n_compute=3, policy=StragglerPolicy(factor=2.0))
    slow = c.compute_nodes()[1]
    c.sim.make_straggler(slow, bias_s=5.0)
    c.sim.report_step_times(step=1, base_s=1.0)
    c.pump(autoscale=True)
    nodes = c.compute_nodes()
    assert slow not in nodes, "straggler drained"
    assert len(nodes) == 3, "replaced, not shrunk"
    c.shutdown()


def test_mpirun_analogue_runs_on_the_rendered_devices():
    c = _cluster(n_compute=2)

    def job(devices):
        # the paper's Fig. 8: a reduction over the rendered devices
        return float(torch.arange(16.0, device=devices[0]).sum())

    assert c.submit(job) == 120.0
    c.shutdown()


def test_image_skew_detection_and_torch_pins():
    cfg = get_smoke("paper-demo")
    img = ClusterImage.build("t", cfg, ParallelPlan(), "train")
    assert dict(img.pins)["torch"] == torch.__version__
    assert "jax" not in software_pins()
    c = _cluster(n_compute=2, image=img)
    assert c.verify_images()
    # a node advertising a different digest is version skew (paper §I)
    c.registry.register(HPC_SERVICE, "rogue", "simnet://rogue",
                        meta={"image": "sha256:deadbeef", "n_devices": "1"})
    assert not c.verify_images()
    c.shutdown()


def test_scale_to_retargets_default_policy_for_autoscale_pumps():
    c = _cluster(n_compute=2)
    c.scale_to(4)
    assert len(c.compute_nodes()) == 4
    c.pump(autoscale=True)
    assert len(c.compute_nodes()) == 4, "pump reverted the operator resize"
    c.shutdown()


def test_scale_to_does_not_replace_installed_policy():
    pol = QueueDepthPolicy(target_per_node=2, min_nodes=1, max_nodes=8)
    c = _cluster(n_compute=1, policy=pol)
    c.scale_to(3)
    assert len(c.compute_nodes()) == 3
    assert c.scaler.policy is pol, "scale_to must not overwrite the policy"
    c.registry.kv_put("metrics/head000/queue_depth", "8")
    c.pump(autoscale=True)
    assert len(c.compute_nodes()) == 4, "policy resumed after scale_to"
    c.shutdown()


def test_a_cuda_cluster_needs_a_card():
    """The cluster's devices default to the cards; with none it refuses
    rather than mapping the nodes onto the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VirtualCluster(n_compute=1)


@settings(max_examples=20, deadline=None)
@given(ops=st.lists(st.sampled_from(["add", "drain", "crash"]),
                    min_size=1, max_size=12))
def test_membership_invariants_under_random_churn(ops):
    """Epochs are monotonic; the rendered hostfile always equals the live
    catalog; node count never goes negative."""
    c = _cluster(n_compute=2, ttl=2.0)
    last_epoch = c.rendering.epoch
    for op in ops:
        nodes = c.compute_nodes()
        if op == "add":
            c.sim.add_nodes(1)
        elif op == "drain" and len(nodes) > 1:
            c.sim.remove_nodes([nodes[-1]])
        elif op == "crash" and len(nodes) > 1:
            c.crash_node(nodes[0])
            c.pump(dt=3.0)
        r = c.pump()
        if r is not None:
            assert r.epoch >= last_epoch
            last_epoch = r.epoch
            live = {m.node_id for m in r.view.members}
            for nid in live:
                assert nid in r.hostfile
            assert r.devices == (CPU,)
    c.shutdown()


# ---------------------------------------------------------------------------
# parity with the JAX package's cluster
# ---------------------------------------------------------------------------

SCRIPT = [
    ("pump", 0.1), ("add", 1), ("queue", 9.0), ("autoscale", 0.1),
    ("crash", 0), ("pump", 3.0), ("autoscale", 0.4), ("partition", 1),
    ("pump", 3.0), ("heal", 1), ("scale_to", 3), ("queue", 2.0),
    ("autoscale", 0.4), ("queue", 0.0), ("autoscale", 0.1),
    ("autoscale", 0.4), ("add", 2), ("drain", -1), ("pump", 0.5),
]


def _drive(c, script):
    """Run the script on a cluster; record what it publishes after each
    operation."""
    seen = []
    for op, arg in script:
        nodes = c.compute_nodes()
        if op == "pump":
            c.pump(dt=arg)
        elif op == "autoscale":
            c.pump(dt=arg, autoscale=True)
        elif op == "add":
            c.sim.add_nodes(arg)
            c.pump()
        elif op == "crash":
            c.crash_node(nodes[arg])
        elif op == "partition":
            c.sim.partition(nodes[arg])
        elif op == "heal":
            nid = sorted(set(c.sim.nodes) - {c.head_id})[arg]
            c.sim.heal(nid)
            c.sim.nodes[nid].agent.start()
            c.pump()
        elif op == "scale_to":
            c.scale_to(arg)
        elif op == "queue":
            c.registry.kv_put(f"metrics/{c.head_id}/queue_depth", str(arg))
        elif op == "drain":
            c.sim.remove_nodes([nodes[arg]])
            c.pump()
        r = c.rendering
        seen.append((op, r.epoch, r.hostfile, tuple(c.compute_nodes()),
                     c.registry.index))
    history = list(c.scaler.history)
    c.shutdown()
    return seen, history


def test_scripted_churn_matches_the_jax_cluster():
    pol = dict(target_per_node=2, min_nodes=1, max_nodes=6)
    kw = dict(n_compute=2, ttl=2.0, cooldown_s=0.3)
    ours = _drive(_cluster(policy=QueueDepthPolicy(**pol), **kw), SCRIPT)
    theirs = _drive(JaxCluster(policy=JaxQueueDepthPolicy(**pol), **kw),
                    SCRIPT)
    assert ours == theirs
    seen, history = ours
    assert len(history) >= 3 and any("scale_to" in r for _, r in history)
    assert len({s[1] for s in seen}) > 5, "the script must re-render"
