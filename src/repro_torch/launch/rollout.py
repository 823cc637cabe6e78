"""Rollout CLI for the port — the serving fleet as a post-training
generation engine, on the GPU.

Closed loop: fan a prompt set out as seeded rollouts over the
continuous-batching fleet (the autoscaler grows into the burst; decode
and prompt lanes run the paged-decode kernel, sampled rows the top-k /
top-p mask kernel, `--kv quant` the int8 paged-decode kernel), score the
completions, pair them, step the serving model's own params with DPO
updates in train mode, and swap the new params into every replica
(set_params) so the next round samples from the trained policy:

  PYTHONPATH=src python -m repro_torch.launch.rollout --smoke --verify \\
      --device cpu

--verify checks, as the JAX package's CLI does, that the same prompt set
through --replicas N and through one engine at another slot count emits
bit-identical completions per (prompt, sample, turn), and that the DPO
loss falls; and beyond it, that the first DPO loss is log 2 (policy equal
to reference) and that each later round samples from the weights swapped
in: it differs from the round before on the same seeds and equals a
fresh engine built on those weights. `--trace multiturn` re-enters
completions as follow-up turns with grown shared prefixes. `--device cpu`
runs the kernels' plain versions. Simulated time drives the cluster (a
ManualClock); wall time is measured around each phase.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import (ClusterImage, LatencyPolicy, QueueDepthPolicy,
                              VirtualCluster)
from repro_torch.core.clock import ManualClock
from repro_torch.models import model as Mo
from repro_torch.models.env import SERVE_PLAN, Env
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.rollout import (PreferenceTrainer, RolloutEngine,
                                 RolloutLoop, make_scorer, rollout_signature)
from repro_torch.serve import (SamplingParams, make_scheduler_policy,
                               make_serving_engine)


def _build_policy(args):
    if args.policy == "latency":
        return LatencyPolicy(target_p95_ms=args.target_p95_ms,
                             min_nodes=args.nodes, max_nodes=args.max_nodes)
    return QueueDepthPolicy(target_per_node=args.queue_per_node,
                            min_nodes=args.nodes, max_nodes=args.max_nodes)


def _sampling_of(args) -> SamplingParams:
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.sample_seed)


def prompts_of(args, cfg):
    rng = np.random.default_rng(args.seed)
    return [rng.integers(0, cfg.vocab_size, size=(args.prompt_len,),
                         dtype=np.int32) for _ in range(args.prompts)]


def make_engine(args, cfg, params, *, replicas=None, num_slots=None,
                clock=None):
    """An engine budgeted for the multi-turn context growth: turn t's
    prompts are base + t * gen tokens, so prompt_len covers the last
    turn."""
    return make_serving_engine(
        cfg, params,
        replicas=args.replicas if replicas is None else replicas,
        routing=args.routing,
        num_slots=num_slots or args.slots,
        prompt_len=args.prompt_len + (args.turns - 1) * args.gen,
        max_gen=args.gen,
        kv=args.kv, block_size=args.block_size,
        prefix_cache=True,
        prefill_chunk=args.prefill_chunk,
        policy=make_scheduler_policy("fifo"),
        clock=clock or ManualClock(), device=args.device)


def _make_scorer(args, cfg, params):
    if args.scorer == "length":
        return make_scorer("length", target=args.gen)
    if args.scorer == "logprob":
        return make_scorer("logprob", cfg=cfg, params=params)
    # keyword: reward the low-id eighth of the vocab, an arbitrary but
    # deterministic target the DPO rounds can steer toward
    return make_scorer("keyword",
                       keywords=tuple(range(max(cfg.vocab_size // 8, 1))))


def generate(args, cfg, params, prompts, **engine_kw):
    """The prompt set through a fresh engine (no cluster): its rollouts'
    signature."""
    ro = RolloutEngine(make_engine(args, cfg, params, **engine_kw),
                       n_samples=args.n_samples, gen_len=args.gen,
                       sampling=_sampling_of(args))
    return rollout_signature(ro.generate(prompts, dt=args.step_time,
                                         turns=args.turns))


def verify_fleet(args, cfg, params, prompts) -> tuple:
    """(ok, line): the rollouts of --replicas N x --slots and of one
    replica at another slot count, bit-identical per coordinate."""
    sig_a = generate(args, cfg, params, prompts)
    alt = args.slots // 2 if args.slots > 1 else args.slots + 1
    sig_b = generate(args, cfg, params, prompts, replicas=1, num_slots=alt)
    ok = sig_a == sig_b
    return ok, (f"verify rollouts: {args.replicas} replicas x {args.slots} "
                f"slots vs 1 replica x {alt} slots: "
                f"{'bit-identical MATCH' if ok else 'MISMATCH'} "
                f"({len(sig_a)} rollouts)")


def _sync(args):
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()


def _timed(args, obj, name: str, acc: list):
    """Wrap obj.name so each call's wall time (device work included) is
    appended to acc."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        _sync(args)
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        _sync(args)
        acc.append(time.perf_counter() - t0)
        return out

    setattr(obj, name, timed)


def run_loop(args, cfg, params, prompts) -> dict:
    """The rollout loop on a VirtualCluster: --rounds generate -> score ->
    train -> set_params rounds. Prints the rounds and the autoscaler's
    view; returns the loop, each round's rollout signature and the
    weights it was sampled from, and the phases' wall times."""
    sampling = _sampling_of(args)
    image = ClusterImage.build(f"{cfg.name}-rollout", cfg, SERVE_PLAN,
                               "serve")
    n0 = max(args.nodes, args.replicas)
    cluster = VirtualCluster(n_compute=n0, image=image,
                             policy=_build_policy(args),
                             cooldown_s=args.cooldown, device=args.device)
    print("rollout replicas register to the catalog:\n" + cluster.hostfile)

    engine = make_engine(args, cfg, params, clock=cluster.clock)
    multi = args.replicas > 1
    plane = engine.describe() if multi else engine.pool.describe()
    print(f"{cfg.name} on {args.device}: {plane}, sampling={sampling}, "
          f"scorer={args.scorer}, n_samples={args.n_samples}, "
          f"turns={args.turns}")

    sizes = []  # capacity timeline across serve and train phases

    def on_step(i, snap, c):
        n = len(c.current_view().compute)
        if not sizes or sizes[-1][1] != n:
            sizes.append((c.clock.now(), n))

    ro = RolloutEngine(engine, n_samples=args.n_samples, gen_len=args.gen,
                       sampling=sampling)
    trainer = PreferenceTrainer(
        cfg, params, beta=args.beta,
        opt=AdamWConfig(lr=args.lr, warmup_steps=0,
                        total_steps=max(args.rounds * args.train_steps, 1),
                        weight_decay=0.0))
    loop = RolloutLoop(cluster, ro, _make_scorer(args, cfg, params), trainer,
                       prompts=prompts, dt=args.step_time, turns=args.turns,
                       train_steps=args.train_steps, on_step=on_step)
    times = {"generate": [], "dpo_step": [], "set_params": []}
    _timed(args, ro, "generate", times["generate"])
    _timed(args, trainer, "step", times["dpo_step"])
    _timed(args, engine, "set_params", times["set_params"])

    rounds = []  # (signature, the weights it was sampled from)
    t0 = time.perf_counter()
    for rnd in range(args.rounds):
        served = engine.params
        m = loop.round()
        rounds.append((rollout_signature(loop.last_rollouts), served))
        nodes = len(cluster.current_view().compute)
        print(f"  round {rnd}: {m['rollout_tokens']:.0f} rollout tokens, "
              f"reward_mean={m['reward_mean']:.4f}, "
              f"pairs={m['pairs_per_round']:.0f}, "
              f"train_loss={m['train_loss']:.4f}  (nodes={nodes})")
    wall = time.perf_counter() - t0

    n_req = args.prompts * args.n_samples
    peak = max((n for _, n in sizes), default=n0)
    final = len(cluster.current_view().compute)
    snap = engine.snapshot()
    print(f"{args.rounds} rounds x {n_req} rollouts in "
          f"{cluster.clock.now():.2f}s sim ({wall:.2f}s wall); "
          f"autoscale start={n0} peak={peak} final={final} "
          f"({len(cluster.scaler.history)} actions)")
    if snap.get("prefix_hit_rate", 0.0) > 0.0:
        print(f"prefix cache: hit rate {snap['prefix_hit_rate']:.2f} "
              f"(multi-turn lineages and {args.n_samples}-way sibling "
              f"fan-out share prompt blocks)")
    tokens = sum(h["rollout_tokens"] for h in loop.history)
    gen_s = sum(times["generate"])
    print(f"wall on {args.device}: rollout {tokens:.0f} tokens in "
          f"{gen_s:.3f}s ({tokens / gen_s:.1f} tokens/s), DPO step "
          f"{1e3 * np.mean(times['dpo_step']):.1f} ms (mean of "
          f"{len(times['dpo_step'])}), set_params "
          f"{1e3 * np.mean(times['set_params'] or [math.nan]):.3f} ms "
          f"(mean of {len(times['set_params'])})")

    # the loop's phase metrics reach the autoscaler through the registry
    # the serve snapshots use: what the policy last saw
    ms = cluster.scaler.read_metrics(cluster.registry)
    got = {k: ms.get(k) for k in ("rollout_tokens", "reward_mean",
                                  "pairs_per_round", "train_loss")}
    print(f"autoscaler view: {got}")
    loop.retire()
    cluster.shutdown()
    return {"loop": loop, "rounds": rounds, "times": times, "wall_s": wall,
            "tokens": tokens, "autoscaler_view": got,
            "start": n0, "peak": peak, "final": final}


def verify_rounds(args, cfg, prompts, run) -> tuple:
    """(ok, lines): the first DPO loss log 2 (the policy starts equal to
    its reference), the loss falling (the JAX package's check), and each
    later round sampled from the weights swapped in after the one before:
    other tokens on the same seeds, the tokens of a fresh engine built on
    those weights."""
    hist = run["loop"].history
    h0, hN = hist[0], hist[-1]
    first_ok = abs(h0["train_loss_first"] - math.log(2)) <= 1e-4
    dec = (h0["train_loss"] < h0["train_loss_first"]
           or hN["train_loss"] < h0["train_loss_first"])
    lines = [f"verify training: loss {h0['train_loss_first']:.4f} -> "
             f"{hN['train_loss']:.4f} over {args.rounds} rounds: "
             f"{'DECREASING' if dec else 'NOT DECREASING'}",
             f"verify first DPO loss {h0['train_loss_first']:.7f} vs log 2: "
             f"{'MATCH' if first_ok else 'MISMATCH'}"]
    ok = first_ok and dec
    for r in range(1, len(run["rounds"])):
        sig, weights = run["rounds"][r]
        moved = sig != run["rounds"][r - 1][0]
        fresh = generate(args, cfg, weights, prompts) == sig
        lines.append(f"verify round {r}: sampled from the swapped-in "
                     f"weights: {'differs' if moved else 'SAME AS'} round "
                     f"{r - 1} on the same seeds, fresh engine on them "
                     f"{'bit-identical MATCH' if fresh else 'MISMATCH'}")
        ok = ok and moved and fresh
    return ok, lines


def run(args, cfg, params) -> int:
    prompts = prompts_of(args, cfg)
    rc = 0
    if args.verify:
        ok, line = verify_fleet(args, cfg, params, prompts)
        print(line)
        rc |= 0 if ok else 1
    res = run_loop(args, cfg, params, prompts)
    rc |= 0 if all(v is not None for v in
                   res["autoscaler_view"].values()) else 1
    if args.verify:
        ok, lines = verify_rounds(args, cfg, prompts, res)
        print("\n".join(lines))
        rc |= 0 if ok else 1
        h0, hN = res["loop"].history[0], res["loop"].history[-1]
        improved = hN["reward_mean"] >= h0["reward_mean"]
        print(f"reward_mean {h0['reward_mean']:.4f} -> "
              f"{hN['reward_mean']:.4f} "
              f"({'improved/held' if improved else 'regressed'})")
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="paper-demo", choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="burst",
                    choices=("burst", "multiturn"),
                    help="burst: every prompt's samples arrive at once; "
                    "multiturn: completions re-enter the queue as "
                    "follow-up turns with grown shared prefixes")
    ap.add_argument("--prompts", type=int, default=4,
                    help="distinct prompts per round")
    ap.add_argument("--n-samples", type=int, default=4,
                    help="sampled completions per prompt")
    ap.add_argument("--turns", type=int, default=1,
                    help="conversation turns per lineage (multiturn "
                    "trace forces >= 2)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="generate -> score -> train rounds")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=8,
                    help="completion length per turn")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--routing", default="prefix",
                    choices=("occupancy", "prefix"),
                    help="prefix-affine routing keeps a lineage's turns "
                    "on the replica caching its grown prefix")
    ap.add_argument("--kv", default="paged", choices=("paged", "quant"))
    ap.add_argument("--block-size", type=int, default=4,
                    help="small blocks so short shared prefixes span "
                    "full blocks (prefix-cache hits)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill lane width (default: auto)")
    ap.add_argument("--scorer", default="keyword",
                    choices=("keyword", "length", "logprob"))
    ap.add_argument("--temperature", type=float, default=0.7,
                    help="> 0 so a prompt's samples differ (greedy "
                    "rollouts all tie and yield no preference pairs)")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--beta", type=float, default=0.5,
                    help="DPO inverse temperature")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-steps", type=int, default=4,
                    help="optimizer steps per round")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--max-nodes", type=int, default=6)
    ap.add_argument("--policy", default="queue", choices=("queue", "latency"))
    ap.add_argument("--queue-per-node", type=int, default=2)
    ap.add_argument("--target-p95-ms", type=float, default=400.0)
    ap.add_argument("--step-time", type=float, default=0.05)
    ap.add_argument("--cooldown", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0,
                    help="prompt seed (weights are seeded separately)")
    ap.add_argument("--verify", action="store_true",
                    help="check the rollouts and the training (see the "
                    "module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.trace == "multiturn":
        args.turns = max(args.turns, 2)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions of the kernels")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = Mo.init_params(cfg, Env(), seed=0, device=args.device)
    return run(args, cfg, params)


if __name__ == "__main__":
    raise SystemExit(main())
