"""Elastic scaling demo on the port (the JAX package's
examples/elastic_scaling.py): the training job keeps running through
2 -> 4 -> 3 nodes, resharding its state at each membership epoch with
zero lost steps.

    PYTHONPATH=src python -m repro_torch.examples.elastic_scaling
    PYTHONPATH=src python -m repro_torch.examples.elastic_scaling \
        --device cpu
"""
import os

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.examples import check_device, ckpt_root, device_args


def main(argv=None) -> int:
    ap = device_args(__doc__.splitlines()[0])
    args = ap.parse_args(argv)
    check_device(args.device)
    plan = ParallelPlan(fsdp=False, remat="full", attn_impl="naive")
    cluster = VirtualCluster(n_compute=2, device=args.device)
    cfg = get_smoke("paper-demo")
    shape = ShapeConfig("elastic", 32, 8, "train")
    tr = ElasticTrainer(cluster.template, cfg, shape,
                        os.path.join(ckpt_root(args), "elastic_ckpt"),
                        plan=plan, ckpt_every=25)

    schedule = {5: 4, 12: 3}  # step -> target nodes
    for i in range(20):
        if i in schedule:
            n = schedule[i]
            print(f"--- scaling to {n} nodes (epoch "
                  f"{cluster.rendering.epoch} -> ...) ---")
            cluster.scale_to(n)
        m = tr.run_steps(1)
        print(f"step {tr.step:3d} loss={m['loss']:.4f} "
              f"nodes={len(cluster.compute_nodes())} "
              f"epoch={cluster.rendering.epoch}")
    st = tr.stats
    print(f"\nepoch_changes={st.epoch_changes} reshards={st.reshards} "
          f"steps_lost={st.steps_lost} (expected 0: planned changes)")
    assert st.steps_lost == 0
    cluster.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
