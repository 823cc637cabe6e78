"""Quickstart: the paper's workflow in five steps, on the port (the JAX
package's examples/quickstart.py).

1. Build a ClusterImage (the Dockerfile of Fig. 2, as data).
2. Form a VirtualCluster: nodes self-register in the Consul-analogue.
3. Read the auto-rendered hostfile (consul-template of Fig. 5).
4. Submit an SPMD job over the rendering (`mpirun` of Fig. 8): a
   16-domain stencil in torch on the rendered device.
5. Train a ~100M-param LM for a few steps with elastic checkpoints.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
"""
import os
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import ClusterImage, VirtualCluster
from repro_torch.core.elastic import ElasticTrainer
from repro_torch.examples import check_device, ckpt_root, device_args


def stencil_job(target) -> float:
    """The 16-domain job: 8 sweeps of a periodic 3-point stencil over a
    16 x 64 grid on the rendered device; returns the grid's sum."""
    dev = (target[0] if isinstance(target, list)
           else torch.device(target.device_type))
    x = torch.linspace(0, 1, 16 * 64, device=dev).reshape(16, 64)
    for _ in range(8):
        x = 0.25 * (2 * x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0))
    return float(x.sum())


def main(argv=None) -> int:
    ap = device_args(__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full-110m", action="store_true",
                    help="train the full paper-demo 110M model")
    args = ap.parse_args(argv)
    check_device(args.device)

    # (1) image encapsulation
    cfg = get_config("paper-demo") if args.full_110m else get_smoke(
        "paper-demo")
    plan = ParallelPlan(fsdp=False, remat="full", attn_impl="naive")
    image = ClusterImage.build("mpi-computenode", cfg, plan, "train")
    print(f"[1] built image {image.digest}")
    print(image.dockerfile())

    # (2) discovery: 1 head + 2 compute, exactly the paper's Fig. 4
    cluster = VirtualCluster(n_compute=2, image=image, device=args.device)
    print("[2] nodes registered:", cluster.compute_nodes())

    # (3) the rendered hostfile
    print("[3] hostfile:\n" + cluster.hostfile)

    # (4) a 16-domain SPMD job (paper Fig. 8)
    print(f"[4] 16-domain job result: {cluster.submit(stencil_job):.4f}")

    # (5) train with elastic checkpoints
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=8,
                        kind="train")
    trainer = ElasticTrainer(cluster.template, cfg, shape,
                             os.path.join(ckpt_root(args), "quickstart_ckpt"),
                             plan=plan, ckpt_every=50)
    t0 = time.time()
    for _ in range(args.steps // 10):
        m = trainer.run_steps(10)
        print(f"[5] step {trainer.step:4d} loss={m['loss']:.4f} "
              f"({time.time() - t0:.1f}s)")
    trainer.finalize()
    print(f"done; checkpoints at steps {trainer.ckpt.available_steps()}")
    cluster.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
