"""Serving CLI for the port — the continuous-batching engine on one device.

Serve a seeded Poisson trace through the paged engine (chunked prefill,
prefix cache) on the GPU and check every greedy token against the
streamed-prefill one-shot baseline:

  PYTHONPATH=src python -m repro_torch.launch.serve --trace poisson --verify

`--smoke` swaps in the tiny smoke config; `--device cpu` runs the kernels'
plain versions on the CPU. The engine runs under run_to_completion with a
ManualClock (simulated seconds per step); wall time is measured around it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.serve import (SamplingParams, ServingEngine, burst_trace,
                               poisson_trace, run_to_completion,
                               sysprompt_trace)


def serve_batch(cfg, params, prompts, gen_len: int, *,
                streamed_prefill: bool = True, device="cuda") -> np.ndarray:
    """One-shot batch serving, the correctness baseline for the engine:
    feed every prompt token by token through the contiguous-cache decode
    step (streamed prefill — the fp path of chunked prefill), then decode
    the uniform batch greedily to gen_len. Returns [B, gen_len] int32."""
    if not streamed_prefill:
        raise NotImplementedError(
            "the port has no full-sequence prefill: streamed_prefill=True")
    env = Env()
    prompts = torch.as_tensor(np.asarray(prompts), device=device)
    B, S = prompts.shape
    decode = St.make_decode_step(cfg, env)
    caches = Mo.init_cache(cfg, env, B, S + gen_len, device=device)
    logits = None
    for i in range(S):
        logits, caches = decode(params, caches, prompts[:, i:i + 1], i)
    V = cfg.vocab_size
    tok = torch.argmax(logits[:, :V], dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(gen_len - 1):
        logits, caches = decode(params, caches, tok, S + i)
        tok = torch.argmax(logits[:, :V], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1).cpu().numpy()


def _sampling_of(args) -> SamplingParams:
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.sample_seed)


def make_trace(args, cfg):
    """The arrival trace (deterministic for the args — --verify
    regenerates it for a second engine)."""
    kw = dict(prompt_len=args.prompt_len, vocab_size=cfg.vocab_size,
              gen_len=args.gen, sampling=_sampling_of(args), seed=args.seed)
    if args.trace == "burst":
        return burst_trace(args.requests, **kw)
    if args.trace == "sysprompt":
        return sysprompt_trace(args.requests, args.rate,
                               prefix_len=(3 * args.prompt_len) // 4, **kw)
    return poisson_trace(args.requests, args.rate, **kw)


def make_engine(args, cfg, params, *, num_slots=None) -> ServingEngine:
    return ServingEngine(cfg, params, num_slots=num_slots or args.slots,
                         prompt_len=args.prompt_len, max_gen=args.gen,
                         block_size=args.block_size,
                         kv_blocks=args.kv_blocks,
                         prefix_cache=args.prefix_cache == "on",
                         clock=ManualClock(), device=args.device)


def serve(args, cfg, params) -> dict:
    """Serve the trace; returns rid -> tokens plus the run's numbers."""
    engine = make_engine(args, cfg, params)
    trace = make_trace(args, cfg)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_to_completion(engine, trace, dt=args.step_time)
    wall = time.perf_counter() - t0  # each step ends in a host transfer
    n_tok = sum(len(t) for t in out.values())
    return {"out": out, "trace": trace, "engine": engine, "wall_s": wall,
            "tokens": n_tok, "steps": engine.decode_steps}


def verify(args, cfg, params, run) -> tuple:
    """(ok, what): greedy runs against the streamed one-shot baseline;
    seeded runs against a fresh engine at another slot count (sampling
    has no one-shot oracle; output must be lane-placement-invariant)."""
    out, trace = run["out"], run["trace"]
    if args.temperature > 0:
        alt = args.slots // 2 if args.slots > 1 else args.slots + 1
        out2 = run_to_completion(make_engine(args, cfg, params,
                                             num_slots=alt),
                                 make_trace(args, cfg), dt=args.step_time)
        return out == out2, f"seeded sampling ({args.slots} vs {alt} slots)"
    base = serve_batch(cfg, params, np.stack([r.prompt for r in trace]),
                       args.gen, device=args.device)
    ok = all(np.array_equal(base[r.rid][:r.eff_gen_len], np.array(out[r.rid]))
             for r in trace)
    return ok, "streamed-prefill one-shot baseline"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="paper-demo")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "burst", "sysprompt"))
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--rate", type=float, default=16.0,
                    help="poisson arrival rate, requests/s (sim time)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots (max concurrent decodes)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV: tokens per block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV: physical blocks (default: worst case)")
    ap.add_argument("--prefix-cache", default="on", choices=("on", "off"))
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k logit cutoff (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="sampling PRNG root (per-request seeds derive "
                    "from it)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (weights are seeded separately)")
    ap.add_argument("--step-time", type=float, default=0.05,
                    help="simulated seconds per decode step")
    ap.add_argument("--verify", action="store_true",
                    help="check tokens against the one-shot baseline")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def main() -> int:
    args = build_parser().parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions of the kernels")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = Mo.init_params(cfg, Env(), seed=0, device=args.device)
    run = serve(args, cfg, params)
    eng = run["engine"]
    snap = eng.snapshot()
    print(f"{cfg.name} on {args.device}: {eng.pool.describe()}, chunked "
          f"prefill={eng.prefill_chunk}, sampling="
          f"{'greedy' if args.temperature <= 0 else _sampling_of(args)}")
    print(f"served {len(run['out'])} requests, {run['tokens']} tokens in "
          f"{run['steps']} steps, {run['wall_s']:.3f}s wall "
          f"({run['tokens'] / run['wall_s']:.1f} tokens/s wall)")
    print(f"p50={snap.get('latency_p50_ms', 0.0):.0f}ms "
          f"p95={snap.get('latency_p95_ms', 0.0):.0f}ms (sim) "
          f"prefix hit rate {snap['prefix_hit_rate']:.2f}")
    if not args.verify:
        return 0
    ok, what = verify(args, cfg, params, run)
    print(f"verify vs {what}: {'MATCH' if ok else 'MISMATCH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
