"""Fault-tolerance demo on the port (the JAX package's
examples/fault_tolerance.py): a node crashes mid-training (no
deregistration), the Consul-analogue TTL reaps it, the view shrinks, and
the job restores from the last durable checkpoint on the survivors. A
straggler is then detected from step-time metrics and replaced.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance
    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance \
        --device cpu
"""
import os

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import StragglerPolicy, VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.examples import check_device, ckpt_root, device_args


def main(argv=None) -> int:
    args = device_args(__doc__.splitlines()[0]).parse_args(argv)
    check_device(args.device)
    plan = ParallelPlan(fsdp=False, remat="full", attn_impl="naive")
    # 4 nodes: 3 survive the crash below; median-based straggler detection
    # needs >=3 reporters for one 5x outlier to clear factor*median
    cluster = VirtualCluster(n_compute=4, ttl=2.0,
                             policy=StragglerPolicy(factor=2.0),
                             device=args.device)
    cfg = get_smoke("paper-demo")
    shape = ShapeConfig("ft", 32, 8, "train")
    tr = ElasticTrainer(cluster.template, cfg, shape,
                        os.path.join(ckpt_root(args), "ft_ckpt"),
                        plan=plan, ckpt_every=5)

    tr.run_steps(7)
    # the save at step 5 writes its files on a thread (save_async): wait
    # for it, so the line names the durable checkpoint whatever the
    # thread's timing (the JAX example reads the directory while that
    # save may still be in flight; on its CPU runs it has landed)
    tr.ckpt.wait()
    print(f"trained to step {tr.step}; durable ckpt at "
          f"{tr.ckpt.latest_step()}")

    victim = cluster.compute_nodes()[-1]
    print(f"\n--- CRASH {victim} (stops heartbeating; no dereg) ---")
    cluster.crash_node(victim)
    cluster.pump(dt=3.0)  # TTL lapses -> reaped -> epoch bump
    tr.run_steps(1, planned_changes=False)
    print(f"recovered on {len(cluster.compute_nodes())} nodes at step "
          f"{tr.step}; rolled back {tr.stats.steps_lost} steps "
          f"(restores={tr.stats.restores})")

    print("\n--- STRAGGLER: one node reports 5x step times ---")
    slow = cluster.compute_nodes()[0]
    cluster.sim.make_straggler(slow, bias_s=5.0)
    cluster.sim.report_step_times(step=tr.step, base_s=1.0)
    cluster.pump(autoscale=True)
    tr.run_steps(2)
    print(f"straggler {slow} replaced; nodes={cluster.compute_nodes()} "
          f"step={tr.step}")
    assert slow not in cluster.compute_nodes()
    cluster.shutdown()
    print("\nfault-tolerance demo OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
