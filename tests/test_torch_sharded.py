"""The port's sharded train step (FSDP / TP / sequence parallelism over a
DeviceMesh) and the MoE layer's ep and tp modes, over eight gloo ranks on
the CPU, against the port's own one-device results and the JAX package.

JAX's sharded train step raises under jax 0.9.0 (ROADMAP.md section 3),
so the oracle is the reference test's own claim in two steps
(tests/test_multidevice.py::test_sharded_train_step_matches_single_device):
the port's sharded loss is held to the port's one-device loss on the same
bridged state, and that to JAX's one-device loss. JAX's moe_layer does
run in both modes on eight forced host devices, so the port's layer is
held to it there too.

One spawn of eight rank children (torch and repro_torch only) runs every
case, one DeviceMesh each, and one JAX child on eight host devices runs
JAX's moe_layer. Tolerances, and why:
- STEP1_TOL = 5e-5 relative, the first step's loss against the port's
  one-device loss. The bf16 products are the same; a row product's
  shares are summed in f32 over the tp ranks and rounded once, in
  another order than one device's one product, so a few of its bf16
  roundings land a step apart, and the log-sum-exp is taken over the
  vocabulary's shards (measured up to 1.1e-5; 0 at tp 1, where every
  product is the one device's).
- LOSS_TOL (tests/test_torch_train.py) and 2e-2 relative against JAX's
  one-device loss.
- LATER_TOL = 5e-4 relative, steps 2 and 3: each rank rounds its share
  of a gradient to bf16 before the shares are summed (in f32), so the
  weights part by a bf16 rounding from step 2 (measured up to 1.1e-4).
- PARAM_TOL = lr / 4 absolute, the gathered parameters after three
  steps, fp32 moments: one AdamW step moves a weight by about lr
  whatever its gradient, so weights whose gradients part by a rounding
  stay far inside one step (measured up to 1.2e-4: one bf16 step of the
  largest weights). MOMENT_TOL = 2^-6 relative L2 for each fp32 moment
  leaf (measured up to 9.2e-3: the gradients' shares' roundings).
- int8 moments after one train step: within INT8_STEPS = 8 quantization
  steps of their row (8 x the row's max / 127; measured up to 4.1): the
  values quantized part as the gradients do, by up to a few hundredths
  of a row's largest value where the ranks' rounded shares cancel. The
  weights are not compared: where a row's scale rounds a second moment
  to 0 the update divides by eps (ROADMAP.md section 3), so a gradient a
  rounding apart moves such a weight by lr x (a quantization step) /
  eps, in one device as on eight ranks. What the sharding itself does
  to the moments is held exactly by test_sharded_adamw_update_is_one_
  devices: on the same gradients the sharded update (int8 row scales
  taken over the ranks that split the row) equals one device's bit for
  bit, fp32 and int8.
- The MoE layer against the one-device layer on the rank's tokens: ep
  mode bit for bit (the same products per expert); tp mode sums the down
  projection's shares in f32 and rounds once: within BF16_REL = 2^-8
  relative (measured 0). Against JAX's moe_layer on eight host devices:
  ep mode bit for bit; tp mode within JAX_TP_REL = 2^-5 of each token's
  largest output, since JAX rounds each rank's share to bf16 before its
  psum (its tp mode differs from its own one-device layer in 34% of the
  outputs, by up to 2^-6 at outputs up to 2.6; measured 1.2e-2).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.launch import steps as JSt
from repro.models import model as JMo
from repro.models import moe as JM
from repro.models.env import Env as JEnv
from repro.optim import adamw as JA
from repro_torch import bridge
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.configs.base import ParallelPlan
from repro_torch.launch import steps as St
from repro_torch.models import model as Mo
from repro_torch.models import moe as M
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A

import _torch_mesh_refusals as refusals

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
WORLD = 8
LR = 1e-3
LOSS_TOL = 5e-4  # tests/test_torch_train.py
STEP1_TOL = 5e-5
LATER_TOL = 5e-4
PARAM_TOL = LR / 4
MOMENT_TOL = 2.0 ** -6
INT8_STEPS = 8
BF16_REL = 2.0 ** -8
JAX_TP_REL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_drops(cfg):
    """cfg with a capacity factor of E: an expert takes every token."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


# name: (arch, mesh (data, model), plan, moment dtype, steps, no-drop MoE)
TRAIN = {
    "ref-4x2": ("yi-9b", (4, 2), dict(fsdp=True), "fp32", 3, False),
    "2x4": ("yi-9b", (2, 4), dict(fsdp=True), "fp32", 3, False),
    "8x1": ("yi-9b", (8, 1), dict(fsdp=True), "fp32", 3, False),
    "int8-4x2": ("yi-9b", (4, 2), dict(fsdp=True), "int8", 1, False),
    "seq-unsplit-2x4": ("yi-9b", (2, 4), dict(fsdp=False,
                                              seq_shard_acts=False),
                        "fp32", 3, False),
    "vocab-pad-4x2": ("granite-3-8b", (4, 2), dict(fsdp=True), "fp32", 3,
                      False),
    "head-pad-2x4": ("qwen2-1.5b", (2, 4), dict(fsdp=True), "fp32", 1,
                     False),
    "grok-ep-4x2": ("grok-1-314b", (4, 2), dict(fsdp=True), "fp32", 1,
                    True),
    "llama4-tp-2x4": ("llama4-scout-17b-a16e", (2, 4),
                      dict(fsdp=True, moe_mode="tp"), "fp32", 1, True),
}
MOE = [(arch, mode, cap) for arch in ("grok-1-314b", "llama4-scout-17b-a16e")
       for mode in ("ep", "tp") for cap in ("config", "no-drops")]
MOE_MESH = (4, 2)
MOE_X = (8, 16)  # the layer's input, batch x positions


_RANK = """
import json
import sys
import dataclasses
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import bridge
from repro_torch.configs import get_smoke
from repro_torch.configs.base import ParallelPlan, ShapeConfig
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as Mo
from repro_torch.models import moe as M
from repro_torch.models.env import Env
from repro_torch.optim import adamw as A
from repro_torch.parallel import rules as R

rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
with open(out + ".cases.json") as f:
    cases = json.load(f)
ref = np.load(out + ".ref.npz")


def no_drops(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def spec_leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in spec_leaves(t[k])]
    if isinstance(t, (tuple, list)) and not isinstance(t, R.Spec):
        return [x for v in t for x in spec_leaves(v)]
    return [] if t is None else [t]


def bad_shards(state, dist_state, specs, mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bad = []
    for x, d, s in zip(A.tree_leaves(state), A.tree_leaves(dist_state),
                       spec_leaves(specs)):
        want = list(x.shape)
        for i, e in enumerate(s):
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                want[i] //= sizes[a]
        if list(d.to_local().shape) != want:
            bad.append([list(x.shape), list(s)])
    return bad


report = {}
for name, (arch, shape, plan_kw, moments, steps, nd) in cases["train"].items():
    cfg = get_smoke(arch)
    cfg = no_drops(cfg) if nd else cfg
    env = Env(plan=ParallelPlan(remat="nothing", attn_impl="naive",
                                **plan_kw),
              mesh=make_test_mesh(world, model=shape[1], device_type="cpu"))
    opt = A.AdamWConfig(lr=%(lr)r, state_dtype=moments)
    if arch == "yi-9b":  # the bridged PRNGKey(0) state
        struct = Mo.init_params(cfg, Env(), device="meta")
        leaves = iter(range(len(A.tree_leaves(struct))))
        params = A.tree_map(lambda s: torch.from_numpy(
            ref["p%%d" %% next(leaves)]).view(s.dtype), struct)
        tokens = torch.from_numpy(ref["tokens"])
    else:
        params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
        g = np.random.default_rng(3)
        tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (8, 16))
                                  .astype(np.int32))
    params = bridge.pad_for_mesh(params, cfg, env)
    state = {"params": params, "opt": A.adamw_init(params, opt)}
    specs = R.state_specs(state, cfg, env)
    st = R.apply_shardings(state, specs, env)
    bad = bad_shards(state, st, specs, env.mesh)
    batch = {"tokens": tokens, "labels": tokens}
    batch = R.apply_shardings(batch, R.batch_specs(
        batch, cfg, ShapeConfig("t", 16, 8, "train"), env), env)
    step = St.make_train_step(cfg, env, opt)
    metrics = []
    for _ in range(steps):
        st, m = step(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    full = [x.full_tensor().float().numpy()
            for x in A.tree_leaves(st["params"])]
    mom = {}
    for k in ("m", "v"):
        if moments == "int8":  # q and s gathered, dequantized
            flat = []

            def walk(t):
                if isinstance(t, dict) and set(t) == {"q", "s"}:
                    q = t["q"].full_tensor()
                    sc = None if t["s"] is None else t["s"].full_tensor()
                    flat.append(q.float() if sc is None
                                else q.float() * sc[..., None])
                elif isinstance(t, dict):
                    for kk in sorted(t):
                        walk(t[kk])
                else:
                    for v in t:
                        walk(v)
            walk(st["opt"][k])
            mom[k] = [x.numpy() for x in flat]
        else:
            mom[k] = [x.full_tensor().numpy()
                      for x in A.tree_leaves(st["opt"][k])]
    if rank == 0:
        np.savez(out + f".train.{name}.npz", *full)
        np.savez(out + f".moments.{name}.npz",
                 **{f"{k}{i}": x for k in mom for i, x in enumerate(mom[k])})
    report[name] = {"metrics": metrics, "bad": bad,
                    "sharded": sum(p.to_local().shape != p.shape
                                   for p in A.tree_leaves(st["params"]))}

for arch, mode, cap in cases["moe"]:
    cfg = get_smoke(arch)
    cfg = no_drops(cfg) if cap == "no-drops" else cfg
    mesh = make_test_mesh(world, model=cases["moe_mesh"][1], device_type="cpu")
    env = Env(plan=ParallelPlan(fsdp=True, moe_mode=mode), mesh=mesh)
    z = np.load(out + f".moe.{arch}.npz")
    p = {"moe": {k: torch.from_numpy(z[k]) for k in
                 ("router", "w_gate", "w_up", "w_down")}}
    for k in ("w_gate", "w_up", "w_down"):
        p["moe"][k] = p["moe"][k].view(torch.int16).view(torch.bfloat16)
    local = A.tree_map(lambda t: t.to_local(), R.apply_shardings(
        p, R.param_specs(p, cfg, env), env))["moe"]
    x = torch.from_numpy(z["x"]).view(torch.int16).view(torch.bfloat16)
    d, dp = mesh.get_local_rank("data"), mesh.size(0)
    rows = x.chunk(dp)[d]
    with M.dispatch_stats() as rec:
        y, aux = M.moe_layer(local, rows, cfg, env)
    np.save(out + f".moe.{arch}.{mode}.{cap}.{rank}.npy",
            y.view(torch.int16).numpy())
    report[f"{arch}/{mode}/{cap}"] = {"aux": float(aux), "stats": rec,
                                      "coord": list(mesh.get_coordinate())}

for moments in ("fp32", "int8"):  # AdamW alone, the same gradients
    cfg = get_smoke("yi-9b")
    env = Env(plan=ParallelPlan(fsdp=True),
              mesh=make_test_mesh(world, model=2, device_type="cpu"))
    opt = A.AdamWConfig(lr=%(lr)r, state_dtype=moments, grad_clip=1e9,
                        warmup_steps=0)
    params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
    pspecs = R.param_specs(params, cfg, env)
    state = A.adamw_init(params, opt)
    dstate = R.apply_shardings(state, R.state_specs(state, cfg, env), env)
    local = A.tree_map(St._local, dstate)
    g = np.random.default_rng(5)
    for _ in range(2):
        grads = A.tree_map(lambda p: torch.from_numpy(g.standard_normal(
            p.shape).astype(np.float32) * 1e-2).to(p.dtype), params)
        dgrads = R.apply_shardings(grads, pspecs, env)
        new_p, local = A.adamw_update(A.tree_map(St._local, dgrads), local,
                                      opt, pspecs, env)
    whole = [x.full_tensor() for x in
             A.tree_leaves(St._rewrap(new_p, dgrads))
             + A.tree_leaves(St._rewrap(local, dstate))]
    if rank == 0:
        torch.save(whole, out + f".adamw.{moments}.pt")

mesh = make_test_mesh(world, model=2, device_type="cpu")
exec(sys.argv[5])  # tests/_torch_mesh_refusals.py RANK_CODE: `refused`
report["refused"] = refused
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules), "a rank imported jax or repro"
with open(out + f".report.{rank}.json", "w") as f:
    json.dump(report, f)
dist.destroy_process_group()
""" % {"lr": LR}

_JAX = """
import sys
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan
from repro.models import moe as M
from repro.models.env import Env

out, cases, shape = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
mesh = jax.make_mesh(shape, ("data", "model"))
for arch, mode in cases:
    cfg = get_smoke(arch)
    z = np.load(out + f".moe.{arch}.npz")
    p = {k: jnp.asarray(z[k]) for k in ("router",)}
    for k in ("w_gate", "w_up", "w_down"):
        p[k] = jnp.asarray(z[k].view(jnp.bfloat16))
    x = jnp.asarray(z["x"].view(jnp.bfloat16))
    env = Env(mesh, ParallelPlan(fsdp=True, moe_mode=mode))
    with mesh:
        y, aux = M.moe_layer(p, x, cfg, env)
    np.savez(out + f".jax.{arch}.{mode}.npz",
             y=np.asarray(y).view(np.uint16), aux=np.asarray(aux))
"""


def _bits(a):
    return np.asarray(a).view(np.uint16) if a.dtype == jnp.bfloat16 else \
        np.asarray(a)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of eight gloo children for every case of the module, and
    one JAX child on eight forced host devices for JAX's moe_layer; the
    inputs they share written by this process. Returns (output prefix,
    the ranks' reports)."""
    tmp = tmp_path_factory.mktemp("sharded")
    out = str(tmp / "run")
    # the reference test's state and tokens (tests/test_multidevice.py)
    jcfg = get_smoke("yi-9b")
    key = jax.random.PRNGKey(0)
    p0 = JMo.init_params(key, jcfg, JEnv(None, JPlan(fsdp=False)))
    tokens = jax.random.randint(key, (8, 16), 0, jcfg.vocab_size)
    np.savez(out + ".ref.npz", tokens=np.asarray(tokens, np.int32),
             **{f"p{i}": _bits(x) for i, x in
                enumerate(jax.tree.leaves(p0))})
    for arch in ("grok-1-314b", "llama4-scout-17b-a16e"):
        cfg = get_smoke(arch)
        p = JM.init_moe(jax.random.PRNGKey(0), cfg, JEnv(None, JPlan()))
        x = np.random.default_rng(1).normal(
            size=MOE_X + (cfg.d_model,)).astype(jnp.bfloat16)
        np.savez(out + f".moe.{arch}.npz", x=x.view(np.uint16),
                 **{k: _bits(v) for k, v in p.items()})
    with open(out + ".cases.json", "w") as f:
        json.dump({"train": TRAIN, "moe": MOE, "moe_mesh": MOE_MESH}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK), str(r), str(WORLD),
         str(tmp / "store"), out, refusals.RANK_CODE], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jenv = dict(env, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=8")
    jcases = sorted({(a, m) for a, m, c in MOE if c == "config"})
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX), out, repr(jcases),
         repr(MOE_MESH)], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0])
        finally:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-20000:]
    reports = []
    for r in range(WORLD):
        with open(out + f".report.{r}.json") as f:
            reports.append(json.load(f))
    return out, reports


# ---- the port's one-device references ------------------------------------

_SINGLE = {}


def _single(name):
    """The port's one-device run of TRAIN[name] from the same state and
    batch: (metrics by step, parameters after the steps as f32 numpy)."""
    if name in _SINGLE:
        return _SINGLE[name]
    arch, _, plan_kw, moments, steps, nd = TRAIN[name]
    cfg = torch_smoke(arch)
    cfg = _no_drops(cfg) if nd else cfg
    if arch == "yi-9b":
        p0 = JMo.init_params(jax.random.PRNGKey(0), get_smoke(arch),
                             JEnv(None, JPlan(fsdp=False)))
        params = bridge.to_torch(jax.tree.map(np.asarray, p0), "cpu")
        tokens = torch.from_numpy(np.asarray(jax.random.randint(
            jax.random.PRNGKey(0), (8, 16), 0, cfg.vocab_size), np.int32))
    else:
        params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (8, 16)).astype(np.int32))
    opt = A.AdamWConfig(lr=LR, state_dtype=moments)
    plan = {k: v for k, v in plan_kw.items() if k == "moe_mode"}
    env = Env(plan=ParallelPlan(fsdp=False, remat="full", attn_impl="naive",
                                **plan))
    step = St.make_train_step(cfg, env, opt)
    state = {"params": params, "opt": A.adamw_init(params, opt)}
    metrics = []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens, "labels": tokens})
        metrics.append({k: float(v) for k, v in m.items()})
    _SINGLE[name] = (metrics, [x.float().numpy()
                               for x in A.tree_leaves(state["params"])],
                     {k: _moments(state["opt"][k]) for k in ("m", "v")})
    return _SINGLE[name]


def _moments(tree):
    """A moment tree's leaves as f32 numpy, int8 {"q", "s"} dequantized."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        q = tree["q"].float()
        return [(q if tree["s"] is None else q * tree["s"][..., None])
                .numpy()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _moments(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _moments(v)]
    return [tree.float().numpy()]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _unpad(sharded, like):
    """A gathered leaf cut to the one-device leaf's shape (the padded
    vocabulary's rows and columns)."""
    return sharded[tuple(slice(0, n) for n in like.shape)]


def test_reference_case_matches_one_device_and_jax(ranks):
    """yi-9b smoke, batch 8 x 16, the bridged PRNGKey(0) state, a 4 x 2
    (data, model) mesh with fsdp and remat "nothing": the first loss
    within STEP1_TOL of the port's one-device loss and within 2e-2
    relative and LOSS_TOL of JAX's; the gathered parameters after three
    steps within PARAM_TOL; every rank's shard of every leaf has the
    whole shape divided by its spec's axes."""
    out, reports = ranks
    jcfg = get_smoke("yi-9b")
    key = jax.random.PRNGKey(0)
    env0 = JEnv(None, JPlan(fsdp=False, remat="full", attn_impl="naive"))
    opt = JA.AdamWConfig(lr=LR)
    p0 = JMo.init_params(key, jcfg, env0)
    tokens = jax.random.randint(key, (8, 16), 0, jcfg.vocab_size)
    _, m0 = jax.jit(JSt.make_train_step(jcfg, env0, opt))(
        {"params": p0, "opt": JA.adamw_init(p0, opt)},
        {"tokens": tokens, "labels": tokens})
    jax_loss = float(m0["loss"])
    single, params, moments = _single("ref-4x2")
    for rep in reports:
        got = rep["ref-4x2"]
        loss = got["metrics"][0]["loss"]
        assert _rel(loss, single[0]["loss"]) <= STEP1_TOL
        assert _rel(loss, jax_loss) < 2e-2 and abs(loss - jax_loss) <= LOSS_TOL
        assert got["bad"] == [] and got["sharded"] > 0
        for g, s in zip(got["metrics"][1:], single[1:]):
            assert _rel(g["loss"], s["loss"]) <= LATER_TOL
    z = np.load(out + ".train.ref-4x2.npz")
    for i, want in enumerate(params):
        assert np.abs(z[f"arr_{i}"] - want).max() <= PARAM_TOL, i
    z = np.load(out + ".moments.ref-4x2.npz")
    for k in ("m", "v"):
        for i, want in enumerate(moments[k]):
            got = z[f"{k}{i}"]
            assert np.linalg.norm(got - want) <= MOMENT_TOL * np.linalg.norm(
                want), (k, i)


@pytest.mark.parametrize("name", ["2x4", "8x1", "int8-4x2", "seq-unsplit-2x4",
                                  "vocab-pad-4x2", "head-pad-2x4"])
def test_other_meshes_match_one_device(ranks, name):
    """The same step over a 2 x 4 and an 8 x 1 mesh, with int8 moments
    (one step: INT8_STEPS), with the residual stream left whole over tp and
    no FSDP, and over the two configs whose shapes pad under tp:
    granite-3-8b smoke's vocabulary (515 -> 640 at tp 2, held over three
    steps: the padded columns are masked, their rows never looked up) and
    qwen2-1.5b smoke's heads (3 -> 4 at tp 4, in each KV group: a zero
    head adds nothing to the first step, but its wo rows take gradients,
    so only the first step is the one-device model's)."""
    out, reports = ranks
    single, params, moments = _single(name)
    for rep in reports:
        got = rep[name]
        assert got["bad"] == []
        assert _rel(got["metrics"][0]["loss"], single[0]["loss"]) <= STEP1_TOL
        for g, s in zip(got["metrics"][1:], single[1:]):
            assert _rel(g["loss"], s["loss"]) <= LATER_TOL
    if name.startswith("int8"):
        z = np.load(out + f".moments.{name}.npz")
        for k in ("m", "v"):
            for i, want in enumerate(moments[k]):
                got = z[f"{k}{i}"]
                if want.ndim == 1:  # fp32 moments for a 1-D leaf
                    assert np.linalg.norm(got - want) <= MOMENT_TOL * \
                        np.linalg.norm(want), (k, i)
                    continue
                step = np.abs(want).max(axis=-1, keepdims=True) / 127
                assert (np.abs(got - want) <= INT8_STEPS * step).all(), (k, i)
    if len(single) > 1:
        tol = PARAM_TOL
        z = np.load(out + f".train.{name}.npz")
        for i, want in enumerate(params):
            assert np.abs(_unpad(z[f"arr_{i}"], want) - want).max() <= tol, i


@pytest.mark.parametrize("name", ["grok-ep-4x2", "llama4-tp-2x4"])
def test_moe_train_step_matches_one_device(ranks, name):
    """grok-1-314b smoke in ep mode over 4 x 2 and llama4-scout smoke in tp
    mode over 2 x 4, at a capacity factor of E (no token dropped): the
    cross-entropy of the first step within STEP1_TOL of the one-device
    step's. The aux loss is a mean over the ranks' own dispatches, which
    the one-device layer does not compute (test_moe_layer_ep_and_tp)."""
    _, reports = ranks
    single, _, _ = _single(name)
    for rep in reports:
        assert _rel(rep[name]["metrics"][0]["ce"], single[0]["ce"]) \
            <= STEP1_TOL


def _moe_tokens(x, coord, mode, mesh):
    """The tokens rank `coord` dispatches: its data rows, and in ep mode
    its model rank's positions."""
    rows = np.array_split(np.arange(x.shape[0]), mesh[0])[coord[0]]
    if mode == "ep":
        cols = np.array_split(np.arange(x.shape[1]), mesh[1])[coord[1]]
        return x[rows][:, cols], (rows, cols)
    return x[rows], (rows, slice(None))


@pytest.mark.parametrize("arch,mode,cap", MOE)
def test_moe_layer_ep_and_tp(ranks, arch, mode, cap):
    """moe_layer over a 4 x 2 mesh (fsdp) in ep and tp modes on grok and
    llama4-scout smoke, each rank its data rows, against the one-device
    layer on the same JAX-initialised weights. Without drops (capacity
    factor E, every dispatch counter 0): the whole output equal to the
    one-device layer's over all tokens. At the config's capacity factor:
    each rank's output equal to the one-device dispatch of that rank's
    tokens (its capacity the local one, its dispatch counters equal), the
    whole output within one bf16 rounding of JAX's moe_layer in the same
    mode, the port's aux loss the mean of the ranks' own, and JAX's that
    of the rank at mesh position (0, 0) (ROADMAP.md section 3)."""
    out, reports = ranks
    cfg = torch_smoke(arch)
    cfg = _no_drops(cfg) if cap == "no-drops" else cfg
    z = np.load(out + f".moe.{arch}.npz")
    t = lambda n, bf=True: (torch.from_numpy(z[n]).view(torch.bfloat16)
                            if bf else torch.from_numpy(z[n]))
    p = {"router": t("router", False), "w_gate": t("w_gate"),
         "w_up": t("w_up"), "w_down": t("w_down")}
    x = t("x")
    tol = 0.0 if mode == "ep" else BF16_REL

    def close(got, want):
        got, want = got.float(), want.float()
        return bool(((got - want).abs() <= tol * want.abs()).all())

    whole = torch.zeros_like(x)
    auxes = []
    for r, rep in enumerate(reports):
        got = rep[f"{arch}/{mode}/{cap}"]
        y = torch.from_numpy(np.load(
            out + f".moe.{arch}.{mode}.{cap}.{r}.npy")).view(torch.bfloat16)
        tok, (rows, cols) = _moe_tokens(x, got["coord"], mode, MOE_MESH)
        with M.dispatch_stats() as rec:
            want, aux = M.moe_layer(p, tok, cfg)
        mine = y[:, cols] if mode == "ep" else y
        assert got["stats"] == [{k: int(v) for k, v in rec[0].items()}]
        if cap == "config":
            assert close(mine, want), (arch, mode, r)
        else:
            assert got["stats"][0]["dropped"] == 0
        whole[rows] = y
        auxes.append(float(aux))
    for rep in reports:
        assert abs(rep[f"{arch}/{mode}/{cap}"]["aux"] - np.mean(auxes)) \
            <= 1e-6 * abs(np.mean(auxes))
    if cap == "no-drops":
        want, _ = M.moe_layer(p, x, cfg)
        assert close(whole, want)
        return
    j = np.load(out + f".jax.{arch}.{mode}.npz")
    jy = torch.from_numpy(j["y"].view(np.int16)).view(torch.bfloat16).float()
    if mode == "ep":
        assert torch.equal(whole.float(), jy)
    else:
        assert bool(((whole.float() - jy).abs() <= JAX_TP_REL * jy.abs().amax(
            dim=-1, keepdim=True)).all())
    assert abs(float(j["aux"]) - auxes[0]) <= 1e-6 * abs(auxes[0])


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_sharded_adamw_update_is_one_devices(ranks, moments):
    """Two AdamW updates (clipping off) on the same seeded gradients, of
    yi-9b smoke's parameters sharded over a 4 x 2 mesh with fsdp and of
    the whole tree on one device: the gathered parameters, master
    weights, moments (int8 values and row scales) and step equal bit for
    bit. A row split over the ranks takes its scale from the whole row's
    max, so each shard quantizes as one device does."""
    out, _ = ranks
    cfg = torch_smoke("yi-9b")
    opt = A.AdamWConfig(lr=LR, state_dtype=moments, grad_clip=1e9,
                        warmup_steps=0)
    params = Mo.init_params(cfg, Env(), seed=0, device="cpu")
    state = A.adamw_init(params, opt)
    g = np.random.default_rng(5)
    for _ in range(2):
        grads = A.tree_map(lambda p: torch.from_numpy(g.standard_normal(
            p.shape).astype(np.float32) * 1e-2).to(p.dtype), params)
        new, state = A.adamw_update(grads, state, opt)
    want = A.tree_leaves(new) + A.tree_leaves(state)
    got = torch.load(out + f".adamw.{moments}.pt")
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want))


def test_recurrent_archs_over_a_mesh_name_item_8_4(ranks):
    """ROADMAP item 8.4 is closed: over the eight ranks' DeviceMesh every
    arch is accepted, the recurrent and modality archs included (they
    compute per rank: tests/test_torch_mesh_serving.py,
    tests/test_torch_mesh_modality.py), on every rank; block tables and
    row slots (the engines' pools, ROADMAP item 12) decode over it in
    either KV layout, a 1 x 1 mesh as one device does (row slots under
    seq_sharded within the seq_sharded decode's tolerance); what the
    model still refuses there keeps refusing (an axis the plan does not
    name), and over a
    shape-only (1, 2) mesh the modality archs get the JAX package's
    padded shapes and refuse to compute (tests/_torch_mesh_refusals.py)."""
    _, reports = ranks
    refusals.check([rep["refused"] for rep in reports])
