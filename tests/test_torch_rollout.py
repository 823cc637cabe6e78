"""The port's rollout loop (src/repro_torch/rollout) against the JAX
package's, on the CPU.

Both packages run the rollout CLI's smoke setting (paper-demo smoke,
4 samples a prompt, prompt 12, gen 8, temperature 0.7, 2 replicas x 4
slots, block 4, prefix-affine routing) over 2 prompts with two turns per
lineage, on the
port's seed-0 weights handed to JAX as arrays of the same bits. JAX's
rollout engine serves under the pallas plan (its paged-decode kernel in
interpret mode: the port's semantics, as tests/test_torch_serving.py
holds them; its CPU serving plan, "naive", rounds decode probabilities
to bf16, and 3 of 32 sampled rollouts (4 prompts) then part from the port's,
ROADMAP.md §3); its CLI, whose verdicts the port's must print, runs
under that CPU plan. What is held:

- the turn-0 requests (rids, seeds, prompts) equal JAX's;
- the rollout tokens equal JAX's, and equal across fleet shapes inside
  the port (2 replicas x 4 slots against 1 replica x 2 slots);
- the multi-turn follow-ups hit the prefix cache as JAX's do;
- the scorers: length and keyword equal, logprob (a mean over 8 or 16
  completion tokens) within 1e-2 of JAX's: train mode's logits round
  apart from JAX's by a bf16 step here and there (3.8e-3 measured, CPU);
- build_pairs and pack_pair_batch give JAX's arrays;
- DPO: the first loss is log 2 within 1e-4 on both sides, the loss falls,
  each step's loss within 2e-3 of JAX's and its margin within 2e-3
  relative (the train step's drift: tests/test_torch_train.py);
- set_params refuses while requests are in flight, and drops the prefix
  cache: the stale-prefix finding (ROADMAP.md §3) pinned on both sides;
- the loop publishes its phase metrics to the port's registry;
- no module of repro_torch imports jax or repro;
- the port's CLI prints JAX's verdict lines.
"""
import math
import pkgutil
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import get_smoke
from repro.configs.base import ParallelPlan as JPlan
from repro.core.clock import ManualClock as JClock
from repro.launch import rollout as jcli
from repro.rollout import PreferenceTrainer as JTrainer
from repro.rollout import RolloutEngine as JRollouts
from repro.rollout import build_pairs as jbuild_pairs
from repro.rollout import make_scorer as jmake_scorer
from repro.rollout import pack_pair_batch as jpack
from repro.rollout import rollout_signature as jsig
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.serve import make_scheduler_policy as jmake_policy
from repro.serve import make_serving_engine as jmake_engine
from repro.serve.request import Request as JRequest
from repro.serve.scheduler import run_to_completion as jrun
from repro_torch.configs import get_smoke as torch_smoke
from repro_torch.core.clock import ManualClock
from repro_torch.launch import rollout as cli
from repro_torch.models import model as Mo
from repro_torch.models.env import Env
from repro_torch.optim.adamw import AdamWConfig, tree_leaves, tree_map
from repro_torch.rollout import (PreferenceTrainer, RolloutEngine,
                                 build_pairs, make_scorer, pack_pair_batch,
                                 rollout_signature)
from repro_torch.serve import make_serving_engine, run_to_completion
from repro_torch.serve.request import Request

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's eager CPU ops at these sizes gain nothing from torch's
    intra-op pool, and under several test workers its spinning threads
    only take cores from the others: one thread while this module runs,
    the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARGS = cli.parse_args(["--smoke", "--device", "cpu", "--turns", "2",
                       "--prompts", "2"])
JCFG, CFG = get_smoke("paper-demo"), torch_smoke("paper-demo")
PARAMS = Mo.init_params(CFG, Env(), seed=0, device="cpu")
PROMPTS = cli.prompts_of(ARGS, CFG)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=8, weight_decay=0.0)
STEPS = 4


def _jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


JPARAMS = tree_map(_jax, PARAMS)


PALLAS = JPlan(fsdp=False, remat="full", attn_impl="pallas",
               kv_cache="replicated")


def _jax_rollouts_engine():
    """JAX's CLI engine (its _make_engine's arguments) under the pallas
    plan."""
    eng = jmake_engine(
        JCFG, JPARAMS, replicas=ARGS.replicas, routing=ARGS.routing,
        num_slots=ARGS.slots,
        prompt_len=ARGS.prompt_len + (ARGS.turns - 1) * ARGS.gen,
        max_gen=ARGS.gen, kv=ARGS.kv, block_size=ARGS.block_size,
        prefix_cache=True, prefill_chunk=ARGS.prefill_chunk,
        policy=jmake_policy("fifo"), clock=JClock(), plan=PALLAS)
    return eng, JRollouts(eng, n_samples=ARGS.n_samples, gen_len=ARGS.gen,
                          sampling=jcli._sampling_of(ARGS))


def _port_rollouts_engine(**kw):
    eng = cli.make_engine(ARGS, CFG, PARAMS, **kw)
    return eng, RolloutEngine(eng, n_samples=ARGS.n_samples,
                              gen_len=ARGS.gen,
                              sampling=cli._sampling_of(ARGS))


@pytest.fixture(scope="module")
def jax_run():
    eng, ro = _jax_rollouts_engine()
    ros = ro.generate(PROMPTS, dt=ARGS.step_time, turns=ARGS.turns)
    return {"rollouts": ros, "snapshot": eng.snapshot()}


@pytest.fixture(scope="module")
def port_run():
    eng, ro = _port_rollouts_engine()
    ros = ro.generate(PROMPTS, dt=ARGS.step_time, turns=ARGS.turns)
    return {"rollouts": ros, "snapshot": eng.snapshot()}


@pytest.fixture(scope="module")
def scored(jax_run, port_run):
    """Both packages' rollouts scored by their keyword scorers."""
    kw = tuple(range(CFG.vocab_size // 8))
    for ros, make in ((jax_run["rollouts"], jmake_scorer),
                      (port_run["rollouts"], make_scorer)):
        rewards = make("keyword", keywords=kw).score(ros)
        for r, w in zip(ros, rewards):
            r.reward = float(w)
    return jax_run["rollouts"], port_run["rollouts"]


def test_requests_for_seeds_equal_jax():
    sampling = cli._sampling_of(ARGS)
    mine = RolloutEngine(None, n_samples=3, gen_len=5,
                         sampling=sampling).requests_for(PROMPTS)
    ref = JRollouts(None, n_samples=3, gen_len=5,
                    sampling=jcli._sampling_of(ARGS)).requests_for(PROMPTS)
    assert [(r.rid, r.sampling.seed, r.gen_len) for r in mine] == \
        [(r.rid, r.sampling.seed, r.gen_len) for r in ref]
    assert all(np.array_equal(a.prompt, b.prompt) for a, b in zip(mine, ref))


def test_rollout_tokens_equal_jax_and_across_fleet_shapes(jax_run, port_run):
    """Two turns of 8 sampled lineages: the port's fleet emits JAX's
    fleet's tokens per (prompt, sample, turn), and one port engine at 2
    slots emits them too."""
    sig = rollout_signature(port_run["rollouts"])
    assert len(sig) == ARGS.prompts * ARGS.n_samples * ARGS.turns
    assert sig == jsig(jax_run["rollouts"])
    _, single = _port_rollouts_engine(replicas=1, num_slots=2)
    assert rollout_signature(single.generate(
        PROMPTS, dt=ARGS.step_time, turns=ARGS.turns)) == sig
    # turn 1 prompts are turn 0's prompt and completion
    by_rid = {r.rid: r for r in port_run["rollouts"]}
    stride = ARGS.prompts * ARGS.n_samples
    for r in port_run["rollouts"]:
        if r.turn == 1:
            parent = by_rid[r.rid - stride]
            assert list(r.prompt) == list(parent.prompt) + list(parent.tokens)


def test_multi_turn_follow_ups_hit_the_prefix_cache_as_jax(jax_run,
                                                           port_run):
    hit = port_run["snapshot"]["prefix_hit_rate"]
    assert hit > 0.0
    assert hit == pytest.approx(jax_run["snapshot"]["prefix_hit_rate"])


def test_scorers_match_jax(jax_run, port_run):
    jr, pr = jax_run["rollouts"], port_run["rollouts"]
    for kind, kw in (("length", {"target": ARGS.gen}),
                     ("keyword", {"keywords": tuple(range(64))})):
        assert make_scorer(kind, **kw).score(pr) == \
            jmake_scorer(kind, **kw).score(jr)
    mine = make_scorer("logprob", cfg=CFG, params=PARAMS).score(pr)
    ref = jmake_scorer("logprob", cfg=JCFG, params=JPARAMS).score(jr)
    assert np.abs(np.array(mine) - np.array(ref)).max() <= 1e-2
    with pytest.raises(ValueError):
        make_scorer("judge")


def test_pairs_and_packed_batches_equal_jax(scored):
    jr, pr = scored
    pairs, jpairs = build_pairs(pr), jbuild_pairs(jr)
    assert [(c.rid, r.rid) for c, r in pairs] == \
        [(c.rid, r.rid) for c, r in jpairs]
    pad = dict(pad_pairs=ARGS.prompts * ARGS.turns,
               pad_len=max(len(r.prompt) + len(r.tokens) for r in pr))
    mine, ref = pack_pair_batch(pairs, **pad), jpack(jpairs, **pad)
    assert mine.keys() == ref.keys()
    for k in mine:
        assert mine[k].dtype == ref[k].dtype
        assert np.array_equal(mine[k], ref[k]), k


def test_dpo_steps_track_jax(scored):
    """STEPS DPO steps on the same packed pairs from the same weights:
    the first loss log 2 (policy == reference) on both sides, each step's
    loss within 2e-3 of JAX's and margin within 2e-3 relative (it sums
    log-probabilities over a pair's completions: 12.48 against 12.49 at
    the last step, CPU), the loss falling and the final margin
    positive. The trainer never writes the params it was given."""
    jr, pr = scored
    pad = dict(pad_pairs=ARGS.prompts * ARGS.turns,
               pad_len=max(len(r.prompt) + len(r.tokens) for r in pr))
    batch = pack_pair_batch(build_pairs(pr), **pad)
    jt = JTrainer(JCFG, JPARAMS, beta=ARGS.beta, opt=JAdamW(**OPT))
    before = tree_map(lambda x: x.clone(), PARAMS)
    pt = PreferenceTrainer(CFG, PARAMS, beta=ARGS.beta,
                           opt=AdamWConfig(**OPT))
    jm = [jt.step(batch) for _ in range(STEPS)]
    pm = [pt.step(batch) for _ in range(STEPS)]
    for m in (jm, pm):
        assert abs(m[0]["train_loss"] - math.log(2)) <= 1e-4
        assert m[0]["dpo_margin"] == 0.0
        assert m[-1]["train_loss"] < m[0]["train_loss"]
        assert m[-1]["dpo_margin"] > 0.0
    for a, b in zip(pm, jm):
        assert abs(a["train_loss"] - b["train_loss"]) <= 2e-3, (pm, jm)
        assert abs(a["dpo_margin"] - b["dpo_margin"]) <= \
            2e-3 * max(1.0, abs(b["dpo_margin"]))
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(before), tree_leaves(PARAMS)))
    assert not any(t.requires_grad for t in tree_leaves(pt.params))


def _one(rid, gen_len=8):
    return Request(rid=rid, prompt=PROMPTS[0], gen_len=gen_len,
                   arrival_t=0.0)


@pytest.mark.parametrize("replicas", [1, 2])
def test_set_params_refuses_while_requests_are_in_flight(replicas):
    eng = make_serving_engine(CFG, PARAMS, replicas=replicas, num_slots=2,
                              prompt_len=12, max_gen=8, block_size=4,
                              clock=ManualClock(), device="cpu")
    eng.submit([_one(0)])
    eng.step()
    with pytest.raises(RuntimeError, match="in flight"):
        eng.set_params(PARAMS)
    while not eng.drained():
        eng.step()
        eng.clock.sleep(0.05)
    other = Mo.init_params(CFG, Env(), seed=1, device="cpu")
    eng.set_params(other)
    assert eng.params is other


def test_stale_prefix_blocks_after_set_params_pinned_on_both_sides():
    """One greedy 12-token prompt (block 4) served on weights A, the
    weights swapped for B, the prompt served again. JAX's engine keeps
    its prefix index across set_params, so round 2 attends over round 1's
    prompt K/V and parts from a fresh engine on B; the port drops the
    index on set_params and equals the fresh engine."""
    a, b = PARAMS, Mo.init_params(CFG, Env(), seed=1, device="cpu")
    ja, jb = JPARAMS, tree_map(_jax, b)

    def jeng(p):
        return jmake_engine(JCFG, p, num_slots=2, prompt_len=12, max_gen=8,
                            block_size=4, prefix_cache=True, clock=JClock())

    def peng(p):
        return make_serving_engine(CFG, p, num_slots=2, prompt_len=12,
                                   max_gen=8, block_size=4,
                                   prefix_cache=True, clock=ManualClock(),
                                   device="cpu")

    jreq = lambda rid: [JRequest(rid=rid, prompt=PROMPTS[0], gen_len=8,
                                 arrival_t=0.0)]
    swapped = jeng(ja)
    jrun(swapped, jreq(0))
    swapped.set_params(jb)
    stale = jrun(swapped, jreq(1))[1]
    fresh = jrun(jeng(jb), jreq(1))[1]
    assert stale != fresh  # the reference-side finding

    mine = peng(a)
    run_to_completion(mine, [_one(0)])
    mine.set_params(b)
    assert mine.pool.probe_prefix(PROMPTS[0]) == 0  # the index is gone
    again = run_to_completion(mine, [_one(1)])[1]
    assert again == run_to_completion(peng(b), [_one(1)])[1]
    assert again == fresh  # and it is JAX's fresh engine's too


def test_loop_publishes_its_phase_metrics_to_the_registry():
    """One round of the CLI's loop: the four phase metrics reach the
    autoscaler through the registry, the history holds the round, and
    round 1 samples from the weights swapped in."""
    args = cli.parse_args(["--smoke", "--device", "cpu", "--rounds", "2",
                           "--train-steps", "2", "--prompts", "2"])
    res = cli.run_loop(args, CFG, PARAMS, PROMPTS)
    view = res["autoscaler_view"]
    assert set(view) == {"rollout_tokens", "reward_mean", "pairs_per_round",
                         "train_loss"}
    assert all(v is not None for v in view.values())
    assert view["rollout_tokens"] == args.prompts * args.n_samples * args.gen
    hist = res["loop"].history
    assert len(hist) == 2 and hist[0]["n_rollouts"] == 8
    assert res["rounds"][1][1] is not PARAMS  # round 1 served new weights
    assert res["rounds"][0][1] is PARAMS


def test_no_module_of_the_port_imports_jax_or_repro():
    """A fresh interpreter imports every module of repro_torch, the
    rollout, optimizer and CLI modules included, and finds neither jax
    nor the JAX package in sys.modules."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert {"repro_torch.rollout.loop", "repro_torch.optim.adamw",
            "repro_torch.launch.rollout", "repro_torch.launch.serve"} \
        <= set(names)
    code = ("import importlib, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": repro_torch.__path__[0] + "/..",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_smoke_verify_prints_jax_verdicts(capsys):
    """`python -m repro_torch.launch.rollout --smoke --verify --device
    cpu` exits 0; its fleet verdict is JAX's CLI's line on the same
    weights, and its training verdict JAX's word; the port's own checks
    (first loss log 2, round 1 from the swapped-in weights) pass."""
    assert cli.main(["--smoke", "--verify", "--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    jargs = cli.parse_args(["--smoke", "--verify", "--device", "cpu"])
    assert jcli.run(jargs, JCFG, JPARAMS) == 0
    ref = capsys.readouterr().out
    line = lambda out, key: next(s for s in out.splitlines()
                                 if s.startswith(key))
    assert line(mine, "verify rollouts:") == line(ref, "verify rollouts:")
    verdict = lambda s: re.sub(r"[-0-9.]+", "#", s)
    assert verdict(line(mine, "verify training:")) == \
        verdict(line(ref, "verify training:"))
    assert "DECREASING" in line(mine, "verify training:")
    assert "MATCH" in line(mine, "verify first DPO loss")
    assert "bit-identical MATCH" in line(mine, "verify round 1:")
