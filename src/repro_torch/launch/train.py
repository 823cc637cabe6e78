"""Elastic training CLI (port of the JAX package's launch/train.py).

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-demo \
      --steps 100 --nodes 3 --scale-to 4@50   # scale to 4 nodes at step 50
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --nodes 2 --scale-to 3@8 --crash-at 14 --ckpt-every 5

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
      --steps 20 --nodes 2 --scale-to 3@8 --crash-at 14 --ckpt-every 5
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke \
      --device cpu ...                       # gloo ranks on the CPU

The cluster is simulated (core/simnet); its nodes map onto the one device
named by --device (the card by default). Under torchrun (RANK,
WORLD_SIZE, LOCAL_RANK and the rendezvous address in the environment)
each rank joins a process group (NCCL on cuda:LOCAL_RANK, gloo with
--device cpu), every rank runs the same cluster, and the nodes' devices
are the ranks: the trainer steps over the DeviceMesh the live members
render (core/template.py). The trainer checkpoints and restores through
a planned scale, rolls back to the last durable checkpoint after a
crash, and rank 0 prints, the last line counting what it did:
`done: N steps; epochs=… reshards=… restores=… steps_lost=…`, where N is
the loop's iterations (after a rollback the trainer's own step is lower).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.core import ClusterImage, VirtualCluster
from repro_torch.core.elastic import ElasticTrainer


def join_ranks(device: str) -> int:
    """Join torchrun's process group when its environment names one (NCCL
    on the card LOCAL_RANK names, gloo on the CPU). Returns this rank (0
    without a group)."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0
    import torch
    import torch.distributed as dist
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dist.get_rank()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-demo")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--nodes", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"),
                    help="an existing checkpoint there is resumed from")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--scale-to", default=None,
                    help="N@STEP: scale to N nodes at step STEP")
    ap.add_argument("--crash-at", type=int, default=None,
                    help="crash a node at this step (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)

    rank = join_ranks(args.device)
    say = print if rank == 0 else (lambda *a, **kw: None)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeConfig("cli", args.seq_len, args.global_batch, "train")
    plan = ParallelPlan(fsdp=False, remat="nothing", attn_impl="naive",
                        kv_cache="replicated")
    image = ClusterImage.build(f"{cfg.name}-train", cfg, plan, "train")
    cluster = VirtualCluster(n_compute=args.nodes, image=image,
                             device=args.device)
    say(f"image {image.digest}\n{image.dockerfile()}")
    say("rendered hostfile:\n" + cluster.hostfile)

    trainer = ElasticTrainer(cluster.template, cfg, shape, args.ckpt_dir,
                             plan=plan, ckpt_every=args.ckpt_every)

    scale_step, scale_n = None, None
    if args.scale_to:
        n, s = args.scale_to.split("@")
        scale_n, scale_step = int(n), int(s)

    t0 = time.time()

    def on_step(step, metrics):
        # a rank outside the rendered mesh has no metrics
        if metrics and (step % args.log_every == 0 or step == 1):
            say(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"epoch={cluster.rendering.epoch} "
                  f"nodes={len(cluster.compute_nodes())} "
                  f"t={time.time()-t0:.1f}s", flush=True)

    done = 0
    while done < args.steps:
        if scale_step is not None and done == scale_step:
            say(f"--- scaling to {scale_n} nodes (paper §IV auto-join) ---")
            cluster.scale_to(scale_n)
        if args.crash_at is not None and done == args.crash_at:
            victim = cluster.compute_nodes()[-1]
            say(f"--- crashing {victim} (TTL will reap it) ---")
            cluster.crash_node(victim)
            cluster.pump(dt=10.0)  # let the TTL lapse
            trainer.ensure_ready(planned=False)
        cluster.pump(dt=0.1)
        trainer.run_steps(1, on_step=on_step)
        done += 1

    trainer.finalize()
    st = trainer.stats
    say(f"done: {args.steps} steps; epochs={st.epoch_changes} "
        f"reshards={st.reshards} restores={st.restores} "
        f"steps_lost={st.steps_lost}")
    cluster.shutdown()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
