"""Serving demo on the port (the JAX package's examples/serve_demo.py):
continuous batching with load-driven autoscaling.

A Poisson arrival trace is served by the continuous-batching engine over
the paged KV backend; the engine publishes queue depth / latency /
occupancy into the registry KV, and the cluster's autoscaling policy
grows the node set while the backlog is deep, then shrinks it as the
queue drains. The greedy pass verifies tokens against the one-shot
baseline; the second pass serves the same trace with seeded nucleus
sampling under EDF admission and verifies the sampled streams are
bit-identical across two engine shapes. Both run in this process through
repro_torch.launch.serve (the CLI's run_trace), the kernels on the card.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu
"""
from repro_torch.configs import get_smoke
from repro_torch.examples import check_device, device_args
from repro_torch.launch import serve as S
from repro_torch.models import model as Mo
from repro_torch.models.env import Env

BASE = ["--arch", "paper-demo", "--smoke", "--trace", "poisson", "--verify"]
SAMPLED = ["--temperature", "0.8", "--top-k", "40", "--top-p", "0.95",
           "--sched", "edf", "--deadline", "2.0"]


def main(argv=None) -> int:
    args = device_args(__doc__.splitlines()[0], ckpt=False).parse_args(argv)
    check_device(args.device)
    cfg = get_smoke("paper-demo")
    params = Mo.init_params(cfg, Env(), seed=0, device=args.device)
    for extra in ([], SAMPLED):
        run = S.run_trace(S.parse_args(BASE + extra + ["--device",
                                                      args.device]),
                          cfg, params)
        if run["rc"]:
            return run["rc"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
