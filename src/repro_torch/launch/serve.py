"""Serving CLI for the port — the paper's closed loop on the GPU.

Inject an arrival trace, serve it by continuous batching over a paged
(block-table) KV cache with chunked prefill, on a VirtualCluster whose
autoscaling policy reads the engine's published metrics: the cluster grows
while the queue is deep and shrinks as it drains. With --replicas N the
data plane is a ReplicaSet fleet: every scale-up spawns a cold replica,
every scale-down drains one and releases its pool with a leak check.
--kv quant serves from an int8 KV pool (the quantized paged-decode
kernel), --kv slot from contiguous per-request slots. --prefill-chunk 0
(and always --kv slot) admits by classic prefill: one batch-1 prefill of
the whole prompt (the flash-attention kernel past 128 tokens) inserted
into the cache. --swap on gives the paged pools a host swap tier:
preemptions (EDF with --edf-preempt, --drain preempt) copy the victim's
blocks to host memory and resume it with nothing recomputed. --spec
ngram|model verifies --spec-k drafted tokens a slot per step (auto: a
depth per request from its own acceptance). --verify checks the tokens
(against one engine for a fleet, against --spec off for a speculative
run, at another slot count for quant or seeded runs, else against the
one-shot baseline: streamed prefill for chunked admission, full prefill
for classic):

  PYTHONPATH=src python -m repro_torch.launch.serve --trace burst \\
      --replicas 2 --max-nodes 4 --kv quant --verify

--trace oneshot runs the one-shot baseline alone (a full-prefill batch
submitted to the cluster), as the JAX CLI's legacy path does. Under
torchrun it runs SPMD over the DeviceMesh the cluster renders from its
hostfile, one process per rank (NCCL on cuda:LOCAL_RANK, gloo with
--device cpu; rank 0 prints), the JAX CLI's way of running the job:

  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --smoke \\
      --device cpu --trace oneshot --nodes 2

--arch picks the model, one of eleven: paper-demo, yi-9b, granite-3-8b,
qwen3-32b (qk-norm) and qwen2-1.5b (qkv bias), the dense attention archs;
grok-1-314b and llama4-scout-17b-a16e, attention with a mixture of
experts; recurrentgemma-9b (Griffin: RG-LRU blocks and sliding-window
attention) and rwkv6-1.6b (attention-free RWKV-6); qwen2-vl-7b (a VLM
with M-RoPE) and whisper-small (an encoder-decoder), behind zero stubs of
their vision and audio front ends. The two recurrent archs admit only by
classic prefill (their prompts run through the RG-LRU-scan and WKV6
kernels), on any pool (--kv quant: int8 window rings beside their state
rows). The two modality archs run --trace oneshot and nothing else: the
engines refuse them (ValueError), as the JAX package's do. An MoE
layer's capacity depends on the tokens one dispatch holds, so an MoE
arch's tokens change with the batch around them; --verify compares what
it compares for every arch and prints MISMATCH there where the JAX
package's CLI does.
`--smoke` swaps in the tiny smoke config; `--device cpu` runs the kernels'
plain versions on the CPU. Time on the cluster is simulated (a
ManualClock advanced per step); wall time is measured around the serve.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core import (ClusterImage, LatencyPolicy, QueueDepthPolicy,
                              VirtualCluster)
from repro_torch.core.clock import ManualClock
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models.env import SERVE_PLAN, Env, modality, sharded
from repro_torch.parallel import collectives as C
from repro_torch.parallel import rules
from repro_torch.serve import (SamplingParams, burst_trace,
                               make_scheduler_policy, make_serving_engine,
                               poisson_trace, repetitive_trace,
                               run_to_completion, sysprompt_trace)


def modality_stubs(cfg, B: int, S: int, device="cuda") -> dict:
    """The prefill batch's modality stubs for B prompts of S tokens, zeros
    of the JAX package's shapes (its serve_batch feeds the same): a VLM's
    vision_embeds [B, num_vision_embeds, d_model], an encoder-decoder's
    frames [B, S // enc_downsample, d_model] (f32); none for a text
    arch."""
    z = lambda n: torch.zeros((B, n, cfg.d_model), dtype=torch.float32,
                              device=device)
    if cfg.family == "vlm":
        return {"vision_embeds": z(cfg.num_vision_embeds)}
    if cfg.is_encdec:
        return {"frames": z(S // cfg.enc_downsample)}
    return {}


def serve_batch(cfg, params, prompts, gen_len: int, *,
                streamed_prefill: bool = True, device="cuda",
                stubs=None, mesh=None, plan=SERVE_PLAN) -> np.ndarray:
    """One-shot batch serving, the correctness baseline for the engine:
    prefill every prompt together, then decode the uniform batch greedily
    to gen_len. Returns [B, gen_len] int32.

    streamed_prefill=True feeds the prompts token by token through the
    contiguous-cache decode step (the fp path of chunked prefill);
    streamed_prefill=False runs one full-sequence prefill of the batch
    (the fp path of classic admission) and grows its caches for decode
    (window rings only to min(window, prompt + gen_len); recurrent states
    and cross-attention caches as they are).
    The two reduce attention in another order, so greedy argmax can flip
    on a near-tie between them.

    A VLM or an encoder-decoder takes the full prefill only (a streamed
    prefill would carry no modality), with its stubs: `stubs` ({"vision_
    embeds"} or {"frames"}, tensors or arrays of the whole batch's rows),
    zeros of modality_stubs' shapes by default. A VLM's decode positions
    start past its vision embeddings, at S + num_vision_embeds.

    mesh (the JAX package's serve_batch signature; None: one device): a
    DeviceMesh of a process group's ranks, every rank of it calling with
    the same whole (one-device) params and prompts. Each rank keeps its
    shards of the params (bridge.rank_shards) and its rows of the batch
    (B / dp; the stubs' rows too), prefills and decodes them per rank
    (models/model.py _Ranks) under `plan` (its kv_cache picks the layout: "replicated" or
    "seq_sharded", flash-decoding over the positions split across tp),
    and picks each token by the vocabulary-parallel argmax. The tokens
    come back gathered, the same on every rank."""
    return _oneshot(cfg, params, prompts, gen_len, streamed_prefill,
                    device, stubs, mesh, plan)[0]


def serve_logits(cfg, params, prompts, tokens, *, streamed_prefill=True,
                 device="cuda", stubs=None, mesh=None,
                 plan=SERVE_PLAN) -> np.ndarray:
    """The one-shot's logits along given tokens [B, G] (teacher forcing):
    step i's logits [B, V] f32, from which serve_batch picks token i
    when tokens are its own. Returns [G, B, V] (gathered over a mesh's
    ranks, the same on every rank): the near-tie oracle's input (a
    greedy token may flip where the top two logits are within a
    tolerance of each other)."""
    return _oneshot(cfg, params, prompts, np.asarray(tokens).shape[1],
                    streamed_prefill, device, stubs, mesh, plan,
                    forced=tokens)[1]


def _oneshot(cfg, params, prompts, gen_len, streamed_prefill, device,
             stubs, mesh, plan, forced=None):
    """serve_batch's loop. Returns (tokens [B, gen_len] int32, and with
    `forced` [B, gen_len] the logits along those tokens, else None)."""
    env = Env(mesh=mesh, plan=plan)
    per_rank = sharded(cfg, env)
    prompts = torch.as_tensor(np.asarray(prompts), device=device)
    if forced is not None:
        forced = torch.as_tensor(np.asarray(forced), device=device)
    if stubs is not None:
        stubs = {k: torch.as_tensor(v, device=device)
                 for k, v in stubs.items()}
    if per_rank:
        params = bridge.rank_shards(params, cfg, env)
        rows = lambda x: rules.local_shard(x, rules.Spec(
            (env.dpx or None,) + (None,) * (x.dim() - 1)), env)
        prompts = rows(prompts)
        if forced is not None:
            forced = rows(forced)
        if stubs is not None:
            stubs = {k: rows(v) for k, v in stubs.items()}
    B, S = prompts.shape
    decode = St.make_decode_step(cfg, env)
    if streamed_prefill and modality(cfg):
        raise ValueError(f"{cfg.name}: a streamed prefill carries no "
                         "modality; serve it with streamed_prefill=False")
    if streamed_prefill:
        caches = Mo.init_cache(cfg, env, B * env.dp, S + gen_len,
                               device=device)
        logits = None
        for i in range(S):
            logits, caches = decode(params, caches, prompts[:, i:i + 1], i)
    else:
        if stubs is None:
            stubs = modality_stubs(cfg, B, S, device)
        logits, caches = St.make_prefill_step(cfg, env)(
            params, {"tokens": prompts, **stubs})
        caches = Mo.grow_caches(caches, gen_len, cfg, env)
    offset = cfg.num_vision_embeds if cfg.family == "vlm" else 0
    out, seen = [], []
    for i in range(gen_len):
        if i:
            logits, caches = decode(params, caches, tok, S + offset + i - 1)
        tok = St.greedy(logits, cfg, env)
        if forced is not None:
            seen.append(_whole_logits(logits, cfg, env, per_rank))
            tok = forced[:, i:i + 1].to(torch.int32)
        out.append(tok)
    out = torch.cat(out, dim=1)
    if per_rank:
        out = C.gather(out, env, env.dp_axes, 0)
    return (out.cpu().numpy(),
            None if forced is None else torch.stack(seen).numpy())


def _whole_logits(logits, cfg, env, per_rank):
    """Step logits [B, V] f32 on the host: over a mesh gathered from the
    ranks' vocabulary columns and rows."""
    if per_rank and env.tp_axis is not None:
        logits = C.gather(logits, env, env.tp_axis, 1)
    if per_rank:
        logits = C.gather(logits, env, env.dp_axes, 0)
    return logits[:, :cfg.vocab_size].float().cpu()


def _sampling_of(args) -> SamplingParams:
    return SamplingParams(temperature=args.temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.sample_seed)


def make_trace(args, cfg):
    """The arrival trace (deterministic for the args — --verify
    regenerates it for a second engine)."""
    kw = dict(prompt_len=args.prompt_len, vocab_size=cfg.vocab_size,
              gen_len=args.gen, deadline_s=args.deadline,
              sampling=_sampling_of(args), seed=args.seed)
    if args.trace == "burst":
        return burst_trace(args.requests, **kw)
    if args.trace == "sysprompt":
        return sysprompt_trace(args.requests, args.rate,
                               prefix_len=args.prefix_len,
                               gen_len_max=args.gen_max, **kw)
    if args.trace == "repetitive":
        return repetitive_trace(args.requests, args.rate,
                                gen_len_max=args.gen_max, **kw)
    return poisson_trace(args.requests, args.rate, gen_len_max=args.gen_max,
                         **kw)


def make_policy(args):
    """The autoscaling policy (--policy)."""
    if args.policy == "latency":
        return LatencyPolicy(target_p95_ms=args.target_p95_ms,
                             min_nodes=args.nodes, max_nodes=args.max_nodes)
    return QueueDepthPolicy(target_per_node=args.queue_per_node,
                            min_nodes=args.nodes, max_nodes=args.max_nodes)


def make_engine(args, cfg, params, *, num_slots=None, replicas=None,
                clock=None, spec=None, mesh=None, plan=None):
    """A ServingEngine (replicas == 1) or a Router + ReplicaSet data
    plane. --kv-blocks is per replica; --prefill-chunk 0 admits by classic
    prefill. `spec` overrides --spec (the --verify re-serve passes
    "off"). `mesh` (a DeviceMesh; the CLI passes none, as the JAX CLI)
    serves per rank over it under `plan` (SERVE_PLAN by default; its
    kv_cache "seq_sharded" splits the slot pool's positions over tp),
    with every option of the CLI's: --spec and --spec-k (a drafter per
    rank), --swap (a host pool per rank), --kv slot."""
    sched = {"preemptive": True} if (args.sched == "edf"
                                     and args.edf_preempt) else {}
    return make_serving_engine(
        cfg, params,
        replicas=args.replicas if replicas is None else replicas,
        routing=args.routing, drain_mode=args.drain,
        num_slots=num_slots or args.slots,
        prompt_len=args.prompt_len, max_gen=args.gen_max,
        kv=args.kv, block_size=args.block_size, kv_blocks=args.kv_blocks,
        prefix_cache=args.prefix_cache == "on",
        prefill_chunk=args.prefill_chunk,
        spec=args.spec if spec is None else spec, spec_k=args.spec_k,
        swap=args.swap == "on", swap_budget_blocks=args.swap_budget_blocks,
        policy=make_scheduler_policy(args.sched, **sched),
        clock=clock or ManualClock(), device=args.device, mesh=mesh,
        plan=plan)


def serve(args, cfg, params, mesh=None, plan=None) -> dict:
    """Serve the trace on one engine (or fleet) without a cluster, over
    `mesh` under `plan` if given (make_engine); returns rid -> tokens plus
    the run's numbers."""
    engine = make_engine(args, cfg, params, mesh=mesh, plan=plan)
    trace = make_trace(args, cfg)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_to_completion(engine, trace, dt=args.step_time)
    wall = time.perf_counter() - t0  # each step ends in a host transfer
    n_tok = sum(len(t) for t in out.values())
    return {"out": out, "trace": trace, "engine": engine, "wall_s": wall,
            "tokens": n_tok, "steps": engine.decode_steps}


def verify(args, cfg, params, run, mesh=None, plan=None) -> tuple:
    """(ok, line): the acceptance bar of the run, in the JAX package's
    order. A fleet emits bit-identically what one zero-router engine
    emits; a speculative run what a fresh engine with --spec off emits
    (drafters and verify rows are invisible in the output, greedy and
    seeded); a greedy quant run (bounded divergence, so the fp one-shot is
    no oracle) and a seeded run what a fresh engine at another slot count
    emits; a greedy fp run equals the one-shot baseline token for token:
    the streamed-prefill one under chunked admission, the full-prefill one
    under classic admission. Swap and preemption events are invisible in
    every one of these. Over `mesh` under `plan` (a run of serve(mesh=,
    plan=)) each oracle runs over the same mesh and plan: the one-shot is
    serve_batch's over them, in the same KV layout."""
    out, trace, engine = run["out"], run["trace"], run["engine"]
    alt = args.slots // 2 if args.slots > 1 else args.slots + 1
    again = lambda **kw: run_to_completion(
        make_engine(args, cfg, params, mesh=mesh, plan=plan, **kw),
        make_trace(args, cfg), dt=args.step_time)
    match = lambda ok: "bit-identical MATCH" if ok else "MISMATCH"
    if args.replicas > 1:
        ok = out == again(replicas=1)
        return ok, (f"verify {args.replicas} replicas "
                    f"({engine.routing.name} routing) vs 1: {match(ok)}")
    if args.spec != "off":
        ok = out == again(spec="off")
        return ok, (f"verify --spec {args.spec} (k={args.spec_k}) vs "
                    f"--spec off: {match(ok)}")
    if args.kv == "quant" and args.temperature <= 0:
        ok = out == again(num_slots=alt)
        return ok, (f"verify quant KV ({args.slots} vs {alt} slots): "
                    f"{match(ok)}")
    if args.temperature > 0:
        ok = out == again(num_slots=alt)
        return ok, (f"verify seeded sampling ({args.slots} vs {alt} "
                    f"slots): {match(ok)}")
    # chunked prefill's fp path is the streamed one-shot's, classic
    # prefill's the full-prefill one-shot's
    streamed = bool(engine.prefill_chunk)
    base = serve_batch(cfg, params, np.stack([r.prompt for r in trace]),
                       args.gen_max, streamed_prefill=streamed,
                       device=args.device, mesh=mesh,
                       plan=SERVE_PLAN if plan is None else plan)
    # slice by the admitted budget (gen_len capped by max_tokens)
    ok = all(np.array_equal(base[r.rid][:r.eff_gen_len], np.array(out[r.rid]))
             for r in trace)
    tag = "streamed-prefill one-shot" if streamed else "one-shot"
    return ok, (f"verify vs {tag} baseline: "
                f"{'token-for-token MATCH' if ok else 'MISMATCH'}")


def run_trace(args, cfg, params) -> dict:
    """The paper's loop: serve the trace on a VirtualCluster whose
    autoscaler resizes it from the engine's published metrics (port of
    the JAX package's launch/serve.py run_trace). Prints the scaling
    timeline and the run's numbers; returns them with rc (0, or 1 when
    --verify fails)."""
    policy = make_policy(args)
    image = ClusterImage.build(f"{cfg.name}-serve", cfg, SERVE_PLAN, "serve")
    n0 = max(args.nodes, args.replicas)  # fleet replicas track nodes 1:1
    cluster = VirtualCluster(n_compute=n0, image=image, policy=policy,
                             cooldown_s=args.cooldown, device=args.device)
    print("serving replicas register to the catalog:\n" + cluster.hostfile)

    engine = make_engine(args, cfg, params, clock=cluster.clock)
    multi = args.replicas > 1
    plane = engine.describe() if multi else engine.pool.describe()
    spec_tag = ("off" if args.spec == "off"
                else f"{args.spec} k={args.spec_k}")
    print(f"{cfg.name} on {args.device}: {plane}, chunked prefill="
          f"{engine.prefill_chunk or 'off (classic)'}, scheduler={engine.policy.name}, "
          f"spec={spec_tag}, sampling="
          f"{'greedy' if args.temperature <= 0 else _sampling_of(args)}")
    trace = make_trace(args, cfg)

    sizes = []  # scaling timeline: (sim_t, n_compute)

    def on_step(i, snap, c):
        n = len(c.current_view().compute)
        if not sizes or sizes[-1][1] != n:
            sizes.append((c.clock.now(), n))
            extra = (f"  replicas={snap['replicas_live']:.0f}"
                     if multi else "")
            print(f"  t={c.clock.now():7.2f}s  nodes={n}  "
                  f"queue={snap['queue_depth']:.0f}  "
                  f"p95={snap.get('latency_p95_ms', 0.0):.0f}ms  "
                  f"occ={snap['slot_occupancy']:.2f}{extra}")

    if multi:
        # every live replica decodes its own batch within the tick, so one
        # step costs step_time flat
        dt = args.step_time
    else:
        # one decode step costs step_time on one node; N data-parallel
        # serving nodes drain the shared queue ~N x faster (the JAX
        # package's simulated speedup model for the single engine)
        dt = lambda n: args.step_time / max(n, 1)
    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cluster.serve(engine, trace, dt=dt, on_step=on_step)
    wall = time.perf_counter() - t0  # each step ends in a host transfer

    peak = max((n for _, n in sizes), default=n0)
    final = len(cluster.current_view().compute)
    n_tok = sum(len(t) for t in out.values())
    snap = engine.snapshot()
    print(f"served {len(out)}/{len(trace)} requests, {n_tok} tokens "
          f"in {engine.clock.now():.2f}s sim, {engine.decode_steps} decode "
          f"steps ({wall:.3f}s wall, {n_tok / wall:.1f} tokens/s wall)")
    print(f"autoscale: start={n0} peak={peak} final={final} "
          f"({len(cluster.scaler.history)} actions)")
    if multi:
        print(f"fleet: replicas live={snap['replicas_live']:.0f} "
              f"cold warmups={snap['replica_warmups']:.0f} "
              f"drained+released={len(engine.released)} "
              f"routing={engine.routing.name}")
    print(f"p50={snap.get('latency_p50_ms', 0.0):.0f}ms "
          f"p95={snap.get('latency_p95_ms', 0.0):.0f}ms "
          f"tokens/s(sim)={snap['tokens_per_s']:.1f}")
    if snap.get("prefix_hit_rate", 0.0) > 0.0:
        print(f"prefix cache: hit rate "
              f"{snap['prefix_hit_rate']:.2f}, prefill tokens computed "
              f"{snap['prefill_tokens']:.0f}, shared occupancy "
              f"{snap['kv_shared_occupancy']:.2f}")
    if "accepted_per_step" in snap:
        print(f"speculative ({spec_tag}): accepted/step "
              f"{snap['accepted_per_step']:.2f}, acceptance rate "
              f"{snap['spec_acceptance_rate']:.2f}")
    if args.swap == "on":
        print(f"swap tier: {snap.get('swapped_blocks', 0.0):.0f} blocks "
              f"out ({snap.get('swap_out_bytes', 0.0):.0f}B), "
              f"{snap.get('swap_in_bytes', 0.0):.0f}B restored, "
              f"recomputed tokens {snap.get('recomputed_tokens', 0.0):.0f}")
    if "kv_quant_divergence" in snap:
        print(f"quant KV: calibrated divergence "
              f"{snap['kv_quant_divergence']:.4f} relative RMS")

    run = {"out": out, "trace": trace, "engine": engine, "cluster": cluster,
           "sizes": sizes, "start": n0, "peak": peak, "final": final,
           "actions": list(cluster.scaler.history), "wall_s": wall,
           "tokens": n_tok, "steps": engine.decode_steps, "snapshot": snap,
           "verify": None, "rc": 0}
    if args.verify:
        ok, line = verify(args, cfg, params, run)
        print(line)
        run["verify"], run["rc"] = line, 0 if ok else 1
    cluster.shutdown()
    return run


def run_oneshot(args, cfg, params, plan=SERVE_PLAN) -> dict:
    """The one-shot baseline alone (the JAX CLI's --trace oneshot): a
    batch of --requests random prompts of --prompt-len tokens (numpy,
    seeded by --seed) prefilled together and decoded greedily to --gen,
    submitted to a VirtualCluster: serve_batch over its rendered devices,
    or under a process group (torchrun) SPMD over the DeviceMesh it
    renders from the hostfile, every rank with the same params, as the
    JAX CLI submits over its rendered mesh. `plan` (the CLI's: SERVE_PLAN)
    picks the KV layout over a mesh. A VLM or an encoder-decoder
    prefills with zero modality stubs, as the JAX CLI does (serve_batch).
    Rank 0 prints; a rank outside the rendered mesh gets no tokens."""
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    say = print if rank == 0 else (lambda *a, **kw: None)
    image = ClusterImage.build(f"{cfg.name}-serve", cfg, plan, "serve")
    cluster = VirtualCluster(n_compute=args.nodes, image=image,
                             device=args.device)
    say("serving replicas register to the catalog:\n" + cluster.hostfile)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32)

    def job(target):
        if isinstance(target, list):  # the rendered devices
            return serve_batch(cfg, params, prompts, args.gen,
                               streamed_prefill=False, device=target[0],
                               plan=plan)
        return serve_batch(cfg, params, prompts, args.gen,
                           streamed_prefill=False, device=args.device,
                           mesh=target, plan=plan)

    if args.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = cluster.submit(job)
    wall = time.perf_counter() - t0  # ends in the tokens' host transfer
    n_tok = args.requests * args.gen
    say(f"generated {n_tok} tokens in {wall:.3f}s wall "
        f"({n_tok / wall:.1f} tokens/s wall on {args.device})")
    if toks is not None:
        say("sample:", toks[0][:16])
    cluster.shutdown()
    return {"tokens": toks, "prompts": prompts, "wall_s": wall, "rc": 0}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", default="paper-demo", choices=ARCH_IDS,
                    help="the model: " + ", ".join(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace", default="poisson",
                    choices=("poisson", "burst", "sysprompt", "repetitive",
                             "oneshot"),
                    help="arrival trace; oneshot serves one full-prefill "
                    "batch on the cluster, without the engine")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--gen-max", type=int, default=None,
                    help="max gen length (default: --gen)")
    ap.add_argument("--rate", type=float, default=16.0,
                    help="poisson arrival rate, requests/s (sim time)")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-cache slots per replica (max concurrent "
                    "decodes each)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serving replicas, each with its own KV pool and "
                    "prefix cache; a Router admits requests across them "
                    "and the autoscaler drains/spawns them live (1 = the "
                    "zero-router single-engine data plane)")
    ap.add_argument("--routing", default="occupancy",
                    choices=("occupancy", "prefix"),
                    help="replica routing policy: least committed KV, or "
                    "prefix-affine")
    ap.add_argument("--drain", default="finish",
                    choices=("finish", "preempt"),
                    help="scale-down drain mode: let a draining replica's "
                    "requests finish, or restart-preempt them back to the "
                    "router queue (bit-identical either way)")
    ap.add_argument("--kv", default="paged",
                    choices=("paged", "quant", "slot"),
                    help="paged block-table cache, int8-quantized paged "
                    "cache (~2x blocks per byte, bounded divergence), or "
                    "contiguous worst-case slots (classic prefill only)")
    ap.add_argument("--swap", default="off", choices=("on", "off"),
                    help="host swap tier for paged/quant KV: preemptions "
                    "copy victim blocks to host memory and resume "
                    "bit-identically with zero recompute")
    ap.add_argument("--swap-budget-blocks", type=int, default=None,
                    help="host swap residency cap in blocks (default: "
                    "unbounded); a full budget falls back to restart "
                    "preemption")
    ap.add_argument("--spec", default="off",
                    choices=("off", "ngram", "model"),
                    help="speculative decoding drafter: prompt-lookup "
                    "self-drafting (ngram) or a tiny draft model; the "
                    "target verifies k drafts per slot in one fused step "
                    "and output stays bit-identical to --spec off "
                    "(attention archs)")
    ap.add_argument("--spec-k", default="4",
                    help="draft tokens proposed per slot per step, or "
                    "'auto': adapt each request's draft depth from its own "
                    "acceptance (AIMD, floor 1)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV: tokens per block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="paged KV: physical blocks per replica (default: "
                    "worst case)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill lane width (default: prompt_len; "
                    "0 = classic batch-1 prefill + insert)")
    ap.add_argument("--prefix-cache", default="on", choices=("on", "off"))
    ap.add_argument("--prefix-len", type=int, default=None,
                    help="sysprompt trace: shared system-prompt length "
                    "(default: 3/4 of --prompt-len)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k logit cutoff (0 disables)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 disables)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="sampling PRNG root (per-request seeds derive "
                    "from it)")
    ap.add_argument("--sched", default="fifo", choices=("fifo", "edf"),
                    help="admission-order scheduler policy")
    ap.add_argument("--edf-preempt", action="store_true",
                    help="EDF only: allow restart-preemption of the "
                    "slackest running request for an urgent arrival")
    ap.add_argument("--deadline", type=float, default=float("inf"),
                    help="per-request completion deadline, seconds (EDF "
                    "orders by it; misses feed the autoscaler)")
    ap.add_argument("--nodes", type=int, default=1,
                    help="initial / minimum compute nodes")
    ap.add_argument("--max-nodes", type=int, default=6)
    ap.add_argument("--policy", default="queue", choices=("queue", "latency"))
    ap.add_argument("--queue-per-node", type=int, default=2)
    ap.add_argument("--target-p95-ms", type=float, default=400.0)
    ap.add_argument("--cooldown", type=float, default=0.3,
                    help="autoscaler cooldown between actions (sim seconds)")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (weights are seeded separately)")
    ap.add_argument("--step-time", type=float, default=0.05,
                    help="simulated seconds per decode step on one node")
    ap.add_argument("--verify", action="store_true",
                    help="check the tokens (see the module docstring)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    """Parse the CLI and fill the defaults that depend on other flags."""
    args = build_parser().parse_args(argv)
    if args.spec_k != "auto":
        args.spec_k = int(args.spec_k)
    if args.gen_max is None:
        args.gen_max = args.gen
    if args.prefix_len is None:
        args.prefix_len = (3 * args.prompt_len) // 4
    return args


def main() -> int:
    args = parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the plain "
                         "versions of the kernels")
    import torch.distributed as dist
    from repro_torch.launch.train import join_ranks
    if "RANK" in os.environ and args.trace != "oneshot":
        raise SystemExit("under torchrun the CLI serves --trace oneshot over "
                         "the rendered mesh, as the JAX CLI passes no mesh "
                         "to its engines (serve/scheduler.py takes mesh= "
                         "from a script)")
    join_ranks(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = Mo.init_params(cfg, Env(), seed=0, device=args.device)
    try:
        if args.trace == "oneshot":
            return run_oneshot(args, cfg, params)["rc"]
        return run_trace(args, cfg, params)["rc"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
