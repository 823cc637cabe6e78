"""Speculative decoding, the host swap tier and the slot pool under a
seq_sharded plan over the cluster's rendered mesh (serve/scheduler.py,
serve/spec.py, serve/blocks.py, serve/slots.py and models/model.py
_attn_seq_sharded), over four gloo ranks on the CPU, against the port's
one-device engine, its own runs without speculation, preemption or
sharding, its one-shot over the same mesh and JAX's ServingEngine over
its own mesh of the same shape; and kernel #5's per-row form
(kernels/flash_decode) that the slot pool under seq_sharded runs.

One spawn of four rank children (torch and repro_torch only), started
when the module starts, runs every port case: the (1, 2) mesh the
VirtualCluster renders from its hostfile (one device a node), and
make_test_mesh's (2, 2) and (1, 1). Two JAX children on eight forced
host devices run JAX's ServingEngine over VirtualCluster(n_compute=2,
devices_per_node=1).rendering.mesh and over a (2, 2) Mesh, and write the
JAX package's PRNGKey(0) smoke parameters first (and its draft model's
over the (1, 2) mesh), which every case uses. 4 requests of 16 prompt tokens
and 8 generated tokens (a swap victim: 1 slot, a deadline-free request
of 8 tokens preempted under EDF by an urgent one of 2), greedy unless a
case says seeded (temperature 0.8, top-k 50, top-p 0.9). Tolerances, and
why:
- (a) A 1 x 1 mesh: none for n-gram and model speculation on the paged,
  int8 and slot pools, a swap victim on the bf16 and int8 pools and the
  drain-preempt swap fleet: it computes the one-device products (the
  same row tiles), so its tokens, and its swap counters, equal the
  one-device engine's. The slot pool under seq_sharded at 1 x 1 runs
  kernel #5's plain version over its positions where one device runs the
  paged-decode attention: it is held to what the seq_sharded one-shot
  over a mesh is held to in tests/test_torch_mesh_serving.py,
  LAYOUT_TOL = 0.0625 on every step's logits (both along the one-device
  engine's tokens) and the tokens equal up to the first step whose top-2
  margin is under LAYOUT_TOL.
- (b) Inside the port over (1, 2) and (2, 2): none. Spec equals spec off
  on the same pool; a swap victim equals its unpreempted run with
  nothing recomputed, the bytes swapped out equal to the bytes swapped
  in and the host pool empty at the end; a 2-replica ReplicaSet under
  VirtualCluster.serve with drain="preempt" and swap on, through a
  scale-down that swaps in-flight requests out, equals one engine; the
  slot pool under seq_sharded by classic admission equals the
  full-prefill one-shot over the same mesh in the same layout (the
  `--verify` contract); every rank's tokens are equal.
- (c) Against JAX's engine over the same mesh: the tokens are equal up
  to each request's first step where the port's top-2 margin is under
  JAX_TOL = 0.125 (tests/test_torch_mesh_engines.py's near-tie oracle;
  the margins are the port's one-shot logits over the mesh, in the
  case's layout, along the port's tokens). The model drafter's
  proposals over (1, 2), on JAX's draft weights over that mesh, equal
  JAX's ModelDrafter's up to the first position where the draft model's
  top two lie within DRAFT_MARGIN = 3/32 (tests/test_torch_spec.py's
  bound: JAX's slot pool rounds attention probabilities to bf16, the
  port's keeps f32), and every proposal is the argmax of the draft
  model's full forward over the mesh where the top two lie further
  apart. swap_out_bytes over a mesh count a rank's share: over tp 2,
  half of JAX's (paper-demo smoke's 2 KV heads split one a rank).
- (d) Kernel #5's plain version in its per-row form equals its scalar
  form row by row, bit for bit, over row-to-slot maps with repeated
  slots and rows at -1; against JAX's flash_decode_kernel in interpret
  mode run with each row's scalar cur_len, within
  tests/test_torch_flash_decode.py's tolerances (2e-3 f32, 3e-2 bf16).
- (e) On the (1, 2) ranks, a per-rank prefill (models/model.py
  _prefill_sharded) of one prompt alone and inside a batch of 8 gives
  the same logits and caches bit for bit, in both KV layouts: each
  sequence is padded to whole row tiles at every tp degree.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 4
N, S, GEN = 4, 16, 8
JAX_TOL = 0.125
LAYOUT_TOL = 0.0625
DRAFT_MARGIN = 3 / 32
MESHES = ("1x2", "2x2")
PD = "paper-demo"


def _case(kind, mesh, kv="paged", spec=None, layout="replicated",
          sample=False, jax_draft=False):
    return {"kind": kind, "mesh": mesh, "kv": kv, "spec": spec,
            "layout": layout, "sample": sample, "jax_draft": jax_draft}


# name: what a case runs. "spec": the engine with a drafter (and, inside
# the port, the same engine with spec off); "swap": an EDF victim on one
# slot (and its unpreempted run); "fleet": a drain-preempt swap fleet;
# "slotseq": the slot pool under a seq_sharded plan by classic admission
CASES = {}
for m in ("1x1",) + MESHES:
    for kv in ("paged", "quant", "slot"):
        CASES[f"spec/ngram/{m}/{kv}"] = _case("spec", m, kv, "ngram")
        CASES[f"spec/model/{m}/{kv}"] = _case("spec", m, kv, "model")
    CASES[f"swap/{m}/paged"] = _case("swap", m)
    CASES[f"swap/{m}/quant"] = _case("swap", m, "quant")
    CASES[f"fleet/{m}/quant"] = _case("fleet", m, "quant")
    CASES[f"slotseq/{m}"] = _case("slotseq", m, "slot",
                                  layout="seq_sharded")
for m in MESHES:
    CASES[f"spec/ngram/{m}/paged/seeded"] = _case("spec", m, spec="ngram",
                                                  sample=True)
    CASES[f"swap/{m}/paged/seeded"] = _case("swap", m, sample=True)
    CASES[f"spec/ngram/{m}/slotseq"] = _case("spec", m, "slot", "ngram",
                                             "seq_sharded")
    CASES[f"spec/model/{m}/slotseq"] = _case("spec", m, "slot", "model",
                                             "seq_sharded")
CASES["spec/model/1x2/paged/jax"] = _case("spec", "1x2", spec="model",
                                          jax_draft=True)
ONE = sorted(k for k, c in CASES.items() if c["mesh"] == "1x1"
             and c["kind"] != "slotseq")
# JAX's engine over its mesh of the same shape (greedy)
JAX_CASES = ("spec/ngram/1x2/paged", "spec/model/1x2/paged/jax",
             "swap/1x2/paged", "slotseq/1x2", "spec/ngram/2x2/paged",
             "slotseq/2x2")
JAX_GROUPS = (("spec/ngram/1x2/paged", "spec/model/1x2/paged/jax",
               "swap/1x2/paged"),
              ("slotseq/1x2", "spec/ngram/2x2/paged", "slotseq/2x2"))
# the drafter rounds: (requests proposing, rids retired after the round)
ROUNDS = (((0, 1, 2), (1,)), ((0, 2), ()), ((0, 2, 3), (0,)),
          ((1, 2, 3), (3,)), ((1, 2, 4), ()), ((2, 4), ()))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_COMMON = """
import dataclasses
import json
import os
import sys
import time
import numpy as np

SPEC = json.load(open(sys.argv[-1] + ".cases.json"))
N, S, GEN = SPEC["N"], SPEC["S"], SPEC["GEN"]


def prompts(vocab, n, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (n, S),
                                                dtype=np.int32)


def swap_prompts(vocab):
    # the victim's and the urgent request's prompts
    return prompts(vocab, 2, seed=5)


def histories(vocab):
    # the drafter rounds' histories, the same in both packages: each
    # request's prompt and first token, then 1 to 3 random tokens a round
    # (a catch-up); k from 1 to 4 (a history stays inside the draft pool's
    # prompt + max_gen + spec_k positions)
    rng = np.random.default_rng(5)
    hist, out = {}, []
    for live, retire in SPEC["rounds"]:
        for rid in live:
            if rid not in hist:
                hist[rid] = [int(t) for t in rng.integers(0, vocab, (S + 1,))]
            k = int(rng.integers(1, 5))
            out.append((rid, list(hist[rid]), k))
            hist[rid] += [int(t) for t in rng.integers(
                0, vocab, (int(rng.integers(1, 4)),))]
        out.append(("retire", list(retire), 0))
    return out
"""

_RANK = _COMMON + """
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.core import VirtualCluster
from repro_torch.core.clock import ManualClock
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models.env import SERVE_PLAN, Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import collectives as C
from repro_torch.serve import EDFPolicy
from repro_torch.serve.request import Request
from repro_torch.serve.router import ReplicaSet
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import ServingEngine, run_to_completion
from repro_torch.serve.spec import ModelDrafter, draft_config

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
CFG = get_smoke("paper-demo")
SEQ = dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")


def load(path, struct):
    t0 = time.time()
    while not os.path.exists(path):
        assert time.time() - t0 < 600, "no params from the JAX child"
        time.sleep(0.2)
    z = np.load(path)
    i = iter(range(len(A.tree_leaves(struct))))
    return A.tree_map(lambda s: torch.from_numpy(
        z["p%d" % next(i)]).view(s.dtype), struct)


PARAMS = load(out + ".params.npz",
              Mo.init_params(CFG, Env(), device="meta"))
CLUSTER = VirtualCluster(n_compute=2, devices_per_node=1, device="cpu")
MESH = {"1x1": make_test_mesh(1, model=1, device_type="cpu"),
        "1x2": CLUSTER.rendering.mesh,
        "2x2": make_test_mesh(4, model=2, device_type="cpu")}
assert tuple(MESH["1x2"].shape) == (1, 2)


def draft_params(mesh_name):
    # JAX's draft model over its mesh of this shape, the whole tree
    env = Env(mesh=MESH[mesh_name], plan=SERVE_PLAN)
    return load(out + f".draft.{mesh_name}.npz",
                Mo.init_params(draft_config(CFG), env, device="meta"))


def plan_of(c):
    return SEQ if c["layout"] == "seq_sharded" else SERVE_PLAN


def requests(n, sample):
    P = prompts(CFG.vocab_size, n)
    sp = lambda i: (SamplingParams(temperature=0.8, top_k=50, top_p=0.9,
                                   seed=7 + i) if sample
                    else SamplingParams())
    return [Request(rid=i, prompt=P[i], gen_len=GEN, sampling=sp(i))
            for i in range(n)]


def swap_requests(sample, victim_only=False):
    P = swap_prompts(CFG.vocab_size)
    sp = (SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7)
          if sample else SamplingParams())
    out = [Request(rid=0, prompt=P[0], gen_len=GEN, sampling=sp)]
    if not victim_only:
        out.append(Request(rid=1, prompt=P[1], gen_len=2, arrival_t=0.12,
                           deadline_s=0.4))
    return out


def ordered(res):
    return [list(map(int, res[i])) for i in sorted(res)]


def engine(c, mesh, **kw):
    spec = c["spec"]
    if c["jax_draft"]:
        env = Env(mesh=mesh, plan=plan_of(c))
        spec = ModelDrafter(CFG, env, num_slots=4, prompt_len=S,
                            max_gen=GEN, spec_k=4, device="cpu",
                            params=draft_params(c["mesh"]))
    base = dict(num_slots=4, prompt_len=S, max_gen=GEN, kv=c["kv"],
                block_size=4, spec=spec, plan=plan_of(c), device="cpu")
    base.update(kw)
    return ServingEngine(CFG, PARAMS, mesh=mesh, **base)


def run_spec(c, mesh):
    eng = engine(c, mesh)
    got = {"tokens": ordered(run_to_completion(eng, requests(
        N, c["sample"])))}
    m = eng.metrics
    got["accepted"] = [m.spec_proposed, m.spec_accepted]
    if mesh is not None:
        got["off"] = ordered(run_to_completion(
            engine(c, mesh, spec=None), requests(N, c["sample"])))
    return got


def run_swap(c, mesh):
    kw = dict(num_slots=1, spec=None)
    solo = run_to_completion(engine(c, mesh, clock=ManualClock(), **kw),
                             swap_requests(c["sample"], True), dt=0.05)
    eng = engine(c, mesh, swap=True, clock=ManualClock(),
                 policy=EDFPolicy(preemptive=True, min_slack_s=1.0), **kw)
    res = run_to_completion(eng, swap_requests(c["sample"]), dt=0.05)
    pm = eng.pool.metrics()
    got = {"tokens": ordered(res), "solo": ordered(solo),
           "preemptions": eng.metrics.preemptions,
           "recomputed": eng.metrics.recomputed_tokens,
           "out_bytes": pm["swap_out_bytes"],
           "in_bytes": pm["swap_in_bytes"],
           "blocks": pm["swapped_blocks"],
           "resident": eng.pool.swap_pool.blocks_resident}
    eng.pool.release()
    return got


def run_fleet(c, mesh_name):
    # a 2-replica ReplicaSet with drain="preempt" and swap on, under
    # VirtualCluster.serve over the mesh the cluster renders (every rank
    # builds the cluster alike), scaled up and then down mid-serve; 2 N
    # requests
    kw = dict(num_slots=2, prompt_len=S, max_gen=GEN, kv=c["kv"],
              block_size=4, device="cpu")
    if mesh_name == "1x1":  # no cluster: a reconcile drains replica 1
        mesh = MESH["1x1"]
        if mesh.get_coordinate() is None:
            return None
        got = {}
        for tag, m in (("tokens", mesh), ("one_device", None)):
            fleet = ReplicaSet(CFG, PARAMS, replicas=2, clock=ManualClock(),
                               drain_mode="preempt", swap=True, mesh=m, **kw)
            fleet.submit(requests(2 * N, False))
            steps = 0
            while not fleet.drained():
                fleet.step()
                if steps == 3:
                    fleet.reconcile(1)
                fleet.clock.sleep(0.05)
                steps += 1
            got[tag] = ordered(fleet.results())
            got["snap_" + tag] = {k: fleet.snapshot()[k] for k in (
                "preemptions", "recomputed_tokens", "swapped_blocks",
                "swap_out_bytes", "swap_in_bytes")}
        got["one"] = ordered(run_to_completion(ServingEngine(
            CFG, PARAMS, mesh=mesh, **kw), requests(2 * N, False)))
        return got
    if mesh_name == "1x2":
        cl = VirtualCluster(n_compute=2, devices_per_node=1, device="cpu")
    else:  # a (2, 2) rendering of four nodes
        cl = VirtualCluster(n_compute=4, devices_per_node=1, device="cpu")
        cl.template.mesh_rule = lambda n: ((2, n // 2), ("data", "model"))
        cl.template.poll(force=True)
    mesh = cl.rendering.mesh
    n0 = len(cl.compute_nodes())
    fleet = None
    if mesh.get_coordinate() is not None:
        fleet = ReplicaSet(CFG, PARAMS, replicas=2, clock=cl.clock,
                           drain_mode="preempt", swap=True, mesh=mesh, **kw)

    def on_step(i, snap, cluster):
        if i == 1:
            cluster.scale_to(n0 + 1)
        elif i == 3:
            cluster.scale_to(1)

    res = cl.serve(fleet, requests(2 * N, False), on_step=on_step)
    if res is None:
        return None
    snap = fleet.snapshot()
    one = ServingEngine(CFG, PARAMS, mesh=mesh, **kw)
    return {"tokens": ordered(res), "released": len(fleet.released),
            "snap": {k: snap[k] for k in (
                "preemptions", "recomputed_tokens", "swapped_blocks",
                "swap_out_bytes", "swap_in_bytes")},
            "resident": fleet.replicas[0].pool.swap_pool.blocks_resident,
            "one": ordered(run_to_completion(one, requests(2 * N, False)))}


def run_slotseq(c, mesh):
    eng = engine(c, mesh)
    got = {"tokens": ordered(run_to_completion(eng, requests(N, False))),
           "kv_positions": int(eng.pool.caches["blocks"][0]["k"].shape[3])}
    got["oneshot"] = cli.serve_batch(CFG, PARAMS, prompts(CFG.vocab_size, N),
                                     GEN, streamed_prefill=False,
                                     device="cpu", mesh=mesh,
                                     plan=SEQ).tolist()
    return got


def margins(name, c, mesh, got):
    # the near-tie oracle's margins: the one-shot's logits over the mesh
    # (the case's layout) along the port's tokens
    if c["kind"] == "swap":
        P = swap_prompts(CFG.vocab_size)
        lg = [cli.serve_logits(CFG, PARAMS, P[i:i + 1],
                               np.asarray([got["tokens"][i]]),
                               streamed_prefill=True, device="cpu",
                               mesh=mesh) for i in range(2)]
        return [x[:, 0] for x in lg]
    lanes = c["kv"] != "slot"
    lg = cli.serve_logits(CFG, PARAMS, prompts(CFG.vocab_size, N),
                          np.asarray(got["tokens"]), streamed_prefill=lanes,
                          device="cpu", mesh=mesh, plan=plan_of(c))
    return [lg[:, i] for i in range(N)]


def drafter_rounds():
    # the port's ModelDrafter over (1, 2) on JAX's draft weights over that
    # mesh, through the rounds; each proposal's top-2 gaps from the draft
    # model's full forward over the mesh (the vocabulary gathered)
    mesh = MESH["1x2"]
    env = Env(mesh=mesh, plan=SERVE_PLAN)
    dcfg = draft_config(CFG)
    whole = draft_params("1x2")
    td = ModelDrafter(CFG, env, num_slots=3, prompt_len=S, max_gen=16,
                      spec_k=8, params=whole, device="cpu")
    rows = []
    for rid, hist, k in histories(CFG.vocab_size):
        if rid == "retire":
            for r in hist:
                td.retire(r)
            continue
        req = Request(rid=rid, prompt=np.asarray(hist[:S], np.int32),
                      gen_len=16)
        req.tokens = list(hist[S:])
        got = td.propose(req, k)
        seq = torch.as_tensor([hist + got[:-1]], dtype=torch.int32)
        lg, _ = Mo.forward(td.params, seq, dcfg, env, mode="prefill")
        lg = C.gather(lg, env, env.tp_axis, -1)[0, :, :CFG.vocab_size]
        lg = lg.float()[len(hist) - 1:]
        top = torch.topk(lg, 2, dim=-1)
        rows.append({"got": got,
                     "gap": (top.values[:, 0] - top.values[:, 1]).tolist(),
                     "argmax": top.indices[:, 0].tolist()})
    return rows


def prefill_rows():
    # (e): a per-rank prefill of one prompt alone and inside a batch of
    # 8, every row and every cache leaf bit for bit
    mesh = MESH["1x2"]
    bad = {}
    for arch in ("paper-demo", "recurrentgemma-9b"):
        cfg = get_smoke(arch)
        params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
        for plan in (SERVE_PLAN, SEQ):
            env = Env(mesh=mesh, plan=plan)
            p = bridge.rank_shards(params, cfg, env)
            tok = torch.as_tensor(np.random.default_rng(1).integers(
                0, cfg.vocab_size, (8, S), dtype=np.int32))
            lb, cb = Mo.forward(p, tok, cfg, env, mode="prefill")
            n = 0
            for i in range(8):
                l1, c1 = Mo.forward(p, tok[i:i + 1], cfg, env,
                                    mode="prefill")
                n += int(not torch.equal(l1[0], lb[i]))
                n += sum(int(not torch.equal(a[:, 0], b[:, i]))
                         for a, b in zip(Mo._all_views(c1),
                                         Mo._all_views(cb)))
            bad[f"{arch}/{plan.kv_cache}"] = n
    return bad


RUN = {"spec": run_spec, "swap": run_swap, "slotseq": run_slotseq}
report = {"cases": {}, "one": {}, "seconds": {}}
for name, c in sorted(SPEC["cases"].items()):
    t0 = time.time()
    if c["kind"] == "fleet":
        got = run_fleet(c, c["mesh"])
        if got is not None:
            report["cases"][name] = got
        continue
    mesh = MESH[c["mesh"]]
    if mesh.get_coordinate() is None:
        continue
    got = RUN[c["kind"]](c, mesh)
    report["cases"][name] = got
    if c["mesh"] == "1x1":
        one = RUN[c["kind"]](c, None)
        report["one"][name] = one
        if c["kind"] == "slotseq" and rank == 0:
            # the one-device run's and the 1 x 1 seq_sharded one-shot's
            # logits along the one-device run's tokens
            P = prompts(CFG.vocab_size, N)
            tok = np.asarray(one["tokens"])
            for tag, kw in (("one", {}), ("seq", {"mesh": mesh,
                                                  "plan": SEQ})):
                np.save(out + f".slotseq1x1.{tag}.npy", cli.serve_logits(
                    CFG, PARAMS, P, tok, streamed_prefill=False,
                    device="cpu", **kw))
    if name in SPEC["jax"]:  # a collective over the mesh's ranks
        lg = margins(name, c, mesh, got)
        if rank == 0:
            np.savez(out + ".margins." + name.replace("/", "_") + ".npz",
                     *lg)
    report["seconds"][name] = time.time() - t0
if MESH["1x2"].get_coordinate() is not None:
    report["drafter"] = drafter_rounds()
    report["prefill"] = prefill_rows()

assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
"""

_JAX = _COMMON + """
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_smoke
from repro.core import VirtualCluster
from repro.core.clock import ManualClock
from repro.models import model as Mo
from repro.models.env import Env
from repro.serve import SERVE_PLAN, EDFPolicy
from repro.serve.request import Request
from repro.serve.scheduler import ServingEngine, run_to_completion
from repro.serve.spec import ModelDrafter, draft_config

out, group = sys.argv[1], int(sys.argv[2])
CFG = get_smoke("paper-demo")
SEQ = dataclasses.replace(SERVE_PLAN, kv_cache="seq_sharded")
MESHES = {"1x2": VirtualCluster(n_compute=2,
                                devices_per_node=1).rendering.mesh,
          "2x2": Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                      ("data", "model"))}


def save(tree, path):
    leaves = [np.asarray(x) for x in jax.tree.leaves(tree)]
    np.savez(path + ".part.npz", **{
        f"p{i}": x.view(np.uint16) if x.dtype == jnp.bfloat16 else x
        for i, x in enumerate(leaves)})
    os.replace(path + ".part.npz", path)


params = Mo.init_params(jax.random.PRNGKey(0), CFG, Env(None, SERVE_PLAN))
if group == 0:  # written first: the rank children load them
    save(params, out + ".params.npz")
    with MESHES["1x2"]:  # the draft model JAX's drafter builds over it
        save(Mo.init_params(jax.random.PRNGKey(0), draft_config(CFG),
                            Env(MESHES["1x2"], SERVE_PLAN)),
             out + ".draft.1x2.npz")
report = {}
for name in SPEC["jax_groups"][group]:
    c = SPEC["cases"][name]
    mesh = MESHES[c["mesh"]]
    plan = SEQ if c["layout"] == "seq_sharded" else SERVE_PLAN
    try:
        with mesh:
            if c["kind"] == "swap":
                eng = ServingEngine(CFG, params, num_slots=1, prompt_len=S,
                                    max_gen=GEN, kv=c["kv"], block_size=4,
                                    swap=True, clock=ManualClock(),
                                    policy=EDFPolicy(preemptive=True,
                                                     min_slack_s=1.0),
                                    mesh=mesh, plan=plan)
                P = swap_prompts(CFG.vocab_size)
                reqs = [Request(rid=0, prompt=P[0], gen_len=GEN),
                        Request(rid=1, prompt=P[1], gen_len=2,
                                arrival_t=0.12, deadline_s=0.4)]
                res = run_to_completion(eng, reqs, dt=0.05)
                pm = eng.pool.metrics()
                report[name + "/bytes"] = [pm["swap_out_bytes"],
                                           pm["swapped_blocks"]]
            else:
                eng = ServingEngine(CFG, params, num_slots=4, prompt_len=S,
                                    max_gen=GEN, kv=c["kv"], block_size=4,
                                    spec=c["spec"], mesh=mesh, plan=plan)
                P = prompts(CFG.vocab_size, N)
                res = run_to_completion(eng, [
                    Request(rid=i, prompt=P[i], gen_len=GEN)
                    for i in range(N)])
        report[name] = [list(map(int, res[i])) for i in sorted(res)]
    except Exception as e:  # reported to the test, which fails
        report[name] = f"{type(e).__name__}: {str(e)[:300]}"
if group == 1:  # JAX's ModelDrafter over (1, 2) through the rounds
    mesh = MESHES["1x2"]
    with mesh:
        jd = ModelDrafter(CFG, Env(mesh, SERVE_PLAN), num_slots=3,
                          prompt_len=S, max_gen=16, spec_k=8)
        rows = []
        for rid, hist, k in histories(CFG.vocab_size):
            if rid == "retire":
                for r in hist:
                    jd.retire(r)
                continue
            req = Request(rid=rid, prompt=np.asarray(hist[:S], np.int32),
                          gen_len=16)
            req.tokens = list(hist[S:])
            rows.append(jd.propose(req, k))
    report["drafter"] = rows
with open(out + f".jax.{group}.json", "w") as f:
    json.dump(report, f)
"""


@pytest.fixture(autouse=True, scope="module")
def children(tmp_path_factory):
    """The four rank children and the two JAX children, started when the
    module starts (JAX's group 0 writes the params the ranks wait for)."""
    tmp = tmp_path_factory.mktemp("mesh_spec_swap")
    out = str(tmp / "run")
    with open(out + ".cases.json", "w") as f:
        json.dump({"cases": CASES, "jax": JAX_CASES, "jax_groups": JAX_GROUPS,
                   "rounds": ROUNDS, "N": N, "S": S, "GEN": GEN}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs += [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out, str(g), out],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for g in range(len(JAX_GROUPS))]
    state = {"procs": procs, "out": out, "reports": None}
    yield state
    for p in procs:
        p.kill()


def _results(state):
    """(output prefix, the ranks' reports, JAX's report), once the
    children have ended."""
    if state["reports"] is None:
        logs = []
        for p in state["procs"]:
            try:
                logs.append(p.communicate(timeout=600)[0])
            finally:
                p.kill()
        assert all(p.returncode == 0 for p in state["procs"]), \
            "\n".join(logs)[-20000:]
        reports = []
        for r in range(WORLD):
            with open(state["out"] + f".report.{r}.json") as f:
                reports.append(json.load(f))
        jax_report = {}
        for g in range(len(JAX_GROUPS)):
            with open(state["out"] + f".jax.{g}.json") as f:
                jax_report.update(json.load(f))
        state["reports"] = (reports, jax_report)
    return (state["out"],) + state["reports"]


def _ranks_of(mesh):
    d, m = map(int, mesh.split("x"))
    return d * m


def _got(reports, name):
    """The case's report, after checking every rank of its mesh reported
    the same one."""
    got = [rep["cases"][name] for rep in reports if name in rep["cases"]]
    assert len(got) == _ranks_of(CASES[name]["mesh"]), name
    assert all(g == got[0] for g in got), name
    return got[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_picks_the_same_tokens(children, name):
    """Every case runs to the end on every rank of its mesh (the engine
    also checks every step's rows and drafts), and every rank reports the
    same tokens and counters."""
    _, reports, _ = _results(children)
    got = _got(reports, name)
    n = {"fleet": 2 * N, "swap": 2}.get(CASES[name]["kind"], N)
    assert len(got["tokens"]) == n


@pytest.mark.parametrize("name", ONE)
def test_one_rank_mesh_is_the_one_device_engine(children, name):
    """(a) Over a 1 x 1 DeviceMesh: the one-device engine's tokens bit for
    bit, with n-gram and model speculation on the three pools (and the
    same acceptance), a swap victim on the bf16 and int8 pools (and the
    same swap counters), the drain-preempt swap fleet."""
    _, reports, _ = _results(children)
    got = _got(reports, name)
    one = reports[0]["one"].get(name)
    if CASES[name]["kind"] == "fleet":
        assert got["tokens"] == got["one_device"] == got["one"]
        assert got["snap_tokens"] == got["snap_one_device"]
        assert got["snap_tokens"]["preemptions"] > 0
    elif CASES[name]["kind"] == "spec":
        assert (got["tokens"], got["accepted"]) == (one["tokens"],
                                                    one["accepted"])
    else:
        assert got == one


def _margin(logits):
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_one_rank_mesh_slot_pool_under_seq_sharded(children):
    """(a) The slot pool under seq_sharded over a 1 x 1 mesh (kernel #5
    over the positions) against the one-device slot pool: the one-shot's
    logits in the two layouts along the one-device run's tokens within
    LAYOUT_TOL at every step, and the tokens equal up to the first step
    whose margin is under LAYOUT_TOL; the engine equals the seq_sharded
    one-shot over the same mesh bit for bit."""
    out, reports, _ = _results(children)
    got = _got(reports, "slotseq/1x1")
    assert got["tokens"] == got["oneshot"]
    one = np.load(out + ".slotseq1x1.one.npy")
    seq = np.load(out + ".slotseq1x1.seq.npy")
    assert np.abs(one - seq).max() <= LAYOUT_TOL
    want = np.asarray(reports[0]["one"]["slotseq/1x1"]["tokens"])
    for row, (a, b) in enumerate(zip(np.asarray(got["tokens"]), want)):
        diff = np.nonzero(a != b)[0]
        if diff.size:
            assert _margin(one[diff[0], row]) < LAYOUT_TOL, (row, diff)


SPECS = sorted(k for k, c in CASES.items() if c["kind"] == "spec"
               and c["mesh"] != "1x1")


@pytest.mark.parametrize("name", SPECS)
def test_spec_equals_spec_off_over_the_mesh(children, name):
    """(b) Speculative serving over the mesh emits what the same engine
    with spec off emits, bit for bit (the paged, int8 and slot pools;
    the slot pool under seq_sharded with a seq_sharded draft pool), and
    the drafter was heard: some drafts were proposed."""
    _, reports, _ = _results(children)
    got = _got(reports, name)
    assert got["tokens"] == got["off"]
    assert got["accepted"][0] > 0


SWAPS = sorted(k for k, c in CASES.items() if c["kind"] == "swap"
               and c["mesh"] != "1x1")


@pytest.mark.parametrize("name", SWAPS + ["swap/1x1/paged",
                                          "swap/1x1/quant"])
def test_swap_victim_resumes_without_recompute_over_the_mesh(children,
                                                             name):
    """(b) A swap victim over the mesh: its tokens equal its unpreempted
    run's, nothing is recomputed, the bytes swapped out equal the bytes
    swapped in, and the host pool is empty at the end."""
    _, reports, _ = _results(children)
    got = _got(reports, name)
    assert got["preemptions"] >= 1
    assert got["tokens"][0] == got["solo"][0]
    assert got["recomputed"] == 0
    assert got["out_bytes"] == got["in_bytes"] > 0 and got["blocks"] > 0
    assert got["resident"] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_drain_preempt_swap_fleet_under_serve_equals_one_engine(children,
                                                                mesh):
    """(b) A 2-replica ReplicaSet with drain="preempt" and swap on under
    VirtualCluster.serve over the cluster's rendered mesh: the scale-down
    swaps in-flight requests out of the drained replicas and they resume
    on the survivor (nothing recomputed, bytes out equal bytes in, the
    rank's host pool empty at the end); the tokens equal one engine's
    over the same mesh, request for request."""
    _, reports, _ = _results(children)
    got = _got(reports, f"fleet/{mesh}/quant")
    snap = got["snap"]
    assert got["released"] >= 1 and snap["preemptions"] > 0
    assert snap["recomputed_tokens"] == 0 and snap["swapped_blocks"] > 0
    assert snap["swap_out_bytes"] == snap["swap_in_bytes"] > 0
    assert got["resident"] == 0
    assert got["tokens"] == got["one"]


@pytest.mark.parametrize("mesh", MESHES)
def test_slot_pool_under_seq_sharded_equals_the_oneshot(children, mesh):
    """(b) The slot pool under a seq_sharded plan by classic admission
    (each rank holding every slot's share of the positions, kernel #5 at
    each row's own depth, merged over tp) equals the full-prefill
    one-shot over the same mesh in the same layout, bit for bit."""
    _, reports, _ = _results(children)
    got = _got(reports, f"slotseq/{mesh}")
    assert got["kv_positions"] == (S + GEN) // 2
    assert got["tokens"] == got["oneshot"]


@pytest.mark.parametrize("name", JAX_CASES)
def test_engine_over_the_mesh_matches_jax(children, name):
    """(c) JAX's ServingEngine over its mesh of the same shape: the
    port's tokens equal JAX's up to each request's first step where the
    port's top-2 margin is under JAX_TOL. A swap victim's bytes out are
    the rank's share: half of JAX's over tp 2, in as many blocks."""
    out, reports, jax_report = _results(children)
    assert not isinstance(jax_report[name], str), jax_report[name]
    got = _got(reports, name)
    z = np.load(out + ".margins." + name.replace("/", "_") + ".npz")
    lg = [z[f"arr_{i}"] for i in range(len(z.files))]
    for row, want in enumerate(jax_report[name]):
        a, b = np.asarray(got["tokens"][row]), np.asarray(want)
        assert a.shape == b.shape
        diff = np.nonzero(a != b)[0]
        if diff.size:
            assert _margin(lg[row][diff[0]]) < JAX_TOL, (name, row, diff)
    if CASES[name]["kind"] == "swap":
        jbytes, jblocks = jax_report[name + "/bytes"]
        assert got["out_bytes"] * 2 == jbytes and got["blocks"] == jblocks


def test_model_drafter_proposes_what_jax_proposes_over_the_mesh(children):
    """(c) The port's ModelDrafter over (1, 2) on JAX's draft weights over
    that mesh against JAX's ModelDrafter over it, through the same rounds
    of histories (requests interleaved, catch-ups of 1 to k + 1 tokens, k
    from 1 to 8, requests retired and re-admitted lazily): each proposal
    equals JAX's up to the first position where the draft model's top
    two lie within DRAFT_MARGIN, and where they lie further apart every
    proposed token is the argmax of the draft model's full forward over
    the mesh. Both ranks propose the same."""
    _, reports, jax_report = _results(children)
    rows = [rep["drafter"] for rep in reports if "drafter" in rep]
    assert len(rows) == 2 and rows[0] == rows[1]
    total = held = 0
    assert len(rows[0]) == len(jax_report["drafter"])
    for r, want in zip(rows[0], jax_report["drafter"]):
        got = r["got"]
        assert len(got) == len(want)
        for j, tok in enumerate(got):
            total += 1
            if r["gap"][j] > DRAFT_MARGIN:
                assert tok == r["argmax"][j]
                held += 1
            if tok != want[j]:
                assert r["gap"][j] <= DRAFT_MARGIN, (r, want)
                break
    assert total >= 30 and held >= 0.6 * total, (held, total)


def test_prefill_rows_do_not_depend_on_the_batch(children):
    """(e) Over the (1, 2) ranks, in both KV layouts, paper-demo and
    recurrentgemma-9b: each prompt's per-rank prefill alone and inside a
    batch of 8 gives the same logits and cache leaves, bit for bit."""
    _, reports, _ = _results(children)
    bad = [rep["prefill"] for rep in reports if "prefill" in rep]
    assert len(bad) == 2
    for b in bad:
        assert set(b) == {f"{a}/{l}" for a in ("paper-demo",
                                                "recurrentgemma-9b")
                          for l in ("replicated", "seq_sharded")}
        assert all(n == 0 for n in b.values()), b


# ---- (d) kernel #5's per-row form --------------------------------------------

FD = dict(B=6, HQ=8, HKV=2, S=512, HD=64, SLOTS=4)
FD_ROWS = ([-1, 0, 17, 255, 511, 300], [3, 3, 0, 2, 1, 3])
FD_DTYPES = {"f32": (torch.float32, 2e-3), "bf16": (torch.bfloat16, 3e-2)}


def _fd_inputs(dtype):
    g = np.random.default_rng(31)
    mk = lambda *s: torch.from_numpy(g.standard_normal(s).astype(
        np.float32)).to(FD_DTYPES[dtype][0])
    return (mk(FD["B"], FD["HQ"], FD["HD"]),
            mk(FD["SLOTS"], FD["HKV"], FD["S"], FD["HD"]),
            mk(FD["SLOTS"], FD["HKV"], FD["S"], FD["HD"]))


@pytest.mark.parametrize("dtype", sorted(FD_DTYPES))
def test_per_row_form_is_the_scalar_form_row_by_row(dtype):
    """(d) flash_decode_partials with a [B] cur_len and a row-to-slot map
    (repeated slots, rows at -1): each row's (o, m, l) is the scalar
    form's on that slot's row at that row's depth, bit for bit; a row at
    -1 reads m = -1e30, l = 0, o = 0. The seq-sharded op takes the per-row
    form too (its plain version over slices, merged)."""
    from repro_torch.kernels.flash_decode.ops import (
        flash_decode_partials, merge_partials_stacked)
    q, k, v = _fd_inputs(dtype)
    cur = torch.tensor(FD_ROWS[0], dtype=torch.int32)
    slots = torch.tensor(FD_ROWS[1], dtype=torch.int32)
    o, m, l = flash_decode_partials(q, k, v, cur, slots)
    for b, (c, s) in enumerate(zip(*FD_ROWS)):
        so, sm, sl = flash_decode_partials(q[b:b + 1], k[s:s + 1],
                                           v[s:s + 1], c)
        assert torch.equal(so[0], o[b]) and torch.equal(sm[0], m[b]) \
            and torch.equal(sl[0], l[b]), b
    dead = cur < 0
    assert not o[dead].any() and not l[dead].any()
    assert bool((m[dead] == -1e30).all())
    # four slices of the positions, each row clamped to its own depth
    n = 4
    sl_ = FD["S"] // n
    parts = [flash_decode_partials(
        q, k[:, :, i * sl_:(i + 1) * sl_].contiguous(),
        v[:, :, i * sl_:(i + 1) * sl_].contiguous(),
        (cur - i * sl_).clamp(-1, sl_ - 1), slots) for i in range(n)]
    merged = merge_partials_stacked(*(torch.stack(x) for x in zip(*parts)))
    whole = flash_decode_partials(q, k, v, cur, slots)[0]
    live = ~dead
    assert float((merged[live] - whole[live]).abs().max()) < 1e-3


@pytest.mark.parametrize("dtype", sorted(FD_DTYPES))
def test_per_row_form_matches_the_jax_kernel(dtype):
    """(d) Each row of the per-row form against JAX's flash_decode_kernel
    in interpret mode, run on that row's slot with the row's scalar
    cur_len, within tests/test_torch_flash_decode.py's tolerance."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode.kernel import flash_decode_kernel
    from repro_torch.kernels.flash_decode.ops import flash_decode_partials
    q, k, v = _fd_inputs(dtype)
    cur = torch.tensor(FD_ROWS[0], dtype=torch.int32)
    slots = torch.tensor(FD_ROWS[1], dtype=torch.int32)
    o, m, l = flash_decode_partials(q, k, v, cur, slots)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jdt)
    tol = FD_DTYPES[dtype][1]
    for b, (c, s) in enumerate(zip(*FD_ROWS)):
        jo, jm, jl = flash_decode_kernel(j(q[b:b + 1]), j(k[s:s + 1]),
                                         j(v[s:s + 1]), c, block_k=128,
                                         interpret=True)
        for mine, ref in ((o[b], jo[0]), (m[b], jm[0]), (l[b], jl[0])):
            assert float(np.abs(mine.numpy() - np.asarray(
                ref.astype(jnp.float32))).max()) < tol, b
