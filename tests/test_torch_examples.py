"""The port's four examples (src/repro_torch/examples) on the CPU against
the JAX package's (examples/), each JAX example run as a child
(JAX_PLATFORMS=cpu) while the port's runs in this process with
--device cpu.

The JAX examples write their checkpoints under fixed /tmp paths; the
children run them through runpy with ElasticTrainer's directory moved
into this test's tmp_path (nothing of the JAX package is edited).

What is held, and why:
- quickstart: the registered nodes, the rendered hostfile and the
  checkpoint steps equal; the 16-domain stencil's result within 1e-5
  relative (torch's and XLA's f32 linspace may round apart); the losses
  finite and falling (the mean of the last three logged below the
  first three's) in both packages, which draw different random
  weights. Both run 100 steps: at the 20 steps of a short run neither
  package's loss falls yet (AdamW warms up over 100 steps; JAX's own
  20-step run logs 6.6799 then 6.7533), at 100 both do.
- elastic_scaling: every step's node count and epoch, the scaling
  lines and the closing counters (epochs, reshards, steps lost 0)
  equal; the losses finite.
- fault_tolerance: every line equal (the crash, the rollback's step,
  steps lost and restores, the straggler and the nodes that replace it).
- serve_demo: both verdicts MATCH in both packages, and the autoscaler's
  timeline, the served counts and the latency percentiles (simulated
  time) equal.
"""
import contextlib
import io
import math
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.examples import (elastic_scaling, fault_tolerance,
                                  quickstart, serve_demo)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK_STEPS = 100

# runs a JAX example with its checkpoint directory under argv[1]
_JAX = """
import os, runpy, sys
tmp, path = sys.argv[1], sys.argv[2]
import repro.core.elastic as E
init = E.ElasticTrainer.__init__
def moved(self, template, cfg, shape, ckpt_dir, *a, **kw):
    init(self, template, cfg, shape,
         os.path.join(tmp, os.path.basename(ckpt_dir)), *a, **kw)
E.ElasticTrainer.__init__ = moved
sys.argv = [path] + sys.argv[3:]
runpy.run_path(path, run_name="__main__")
"""

EXAMPLES = {"quickstart": ["--steps", str(QUICK_STEPS)],
            "elastic_scaling": [], "fault_tolerance": [], "serve_demo": []}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The four JAX examples started at once as children; each test
    waits for its own. Returns {name: Popen}."""
    tmp = tmp_path_factory.mktemp("jax_examples")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = {}
    for name, extra in EXAMPLES.items():
        path = os.path.join(ROOT, "examples", f"{name}.py")
        if name == "serve_demo":  # it runs the JAX CLI as children
            cmd = [sys.executable, path]
        else:
            cmd = [sys.executable, "-c", textwrap.dedent(_JAX),
                   str(tmp / name), path] + extra
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    yield procs
    for p in procs.values():
        p.kill()


def jax_output(jax_runs, name: str) -> str:
    p = jax_runs[name]
    out = p.communicate(timeout=600)[0]
    assert p.returncode == 0, out[-5000:]
    return out


def port_output(module, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    assert rc == 0, buf.getvalue()[-5000:]
    return buf.getvalue()


def _lines(out: str, prefix: str):
    return [l for l in out.splitlines() if l.startswith(prefix)]


def _hostfile(out: str):
    lines = out.splitlines()
    i = lines.index("[3] hostfile:")
    j = next(k for k in range(i, len(lines)) if lines[k].startswith("[4]"))
    return lines[i + 1:j]


def _losses(out: str):
    return [float(x) for x in re.findall(r"loss=([-\d.naif]+)", out)]


def test_quickstart_matches_jax(jax_runs, tmp_path):
    got = port_output(quickstart, ["--device", "cpu", "--steps",
                                   str(QUICK_STEPS), "--ckpt-dir",
                                   str(tmp_path)])
    want = jax_output(jax_runs, "quickstart")
    for prefix in ("[2] nodes registered:", "done; checkpoints at steps"):
        assert _lines(got, prefix) == _lines(want, prefix), prefix
    assert _hostfile(got) == _hostfile(want)
    job = [float(_lines(o, "[4] 16-domain job result:")[0].split()[-1])
           for o in (got, want)]
    assert abs(job[0] - job[1]) <= 1e-5 * abs(job[1]), job
    steps = [re.findall(r"\[5\] step +(\d+)", o) for o in (got, want)]
    assert steps[0] == steps[1] == [str(s) for s in
                                    range(10, QUICK_STEPS + 1, 10)]
    for losses in (_losses(got), _losses(want)):
        assert len(losses) == QUICK_STEPS // 10
        assert all(math.isfinite(l) for l in losses), losses
        assert sum(losses[-3:]) < sum(losses[:3]), losses


def test_elastic_scaling_matches_jax(jax_runs, tmp_path):
    got = port_output(elastic_scaling, ["--device", "cpu", "--ckpt-dir",
                                        str(tmp_path)])
    want = jax_output(jax_runs, "elastic_scaling")
    strip = lambda out: [re.sub(r"loss=\S+ ", "", l) for l in
                         out.splitlines() if l.startswith(("step ", "---"))]
    assert strip(got) == strip(want)
    assert len(_lines(got, "step ")) == 20
    assert _lines(got, "epoch_changes=") == _lines(want, "epoch_changes=")
    assert "epoch_changes=3 reshards=2 steps_lost=0" in got
    assert all(math.isfinite(l) for l in _losses(got))


def test_fault_tolerance_matches_jax(jax_runs, tmp_path):
    got = port_output(fault_tolerance, ["--device", "cpu", "--ckpt-dir",
                                        str(tmp_path)])
    want = jax_output(jax_runs, "fault_tolerance")
    assert got.strip().splitlines() == want.strip().splitlines()
    assert "rolled back 2 steps (restores=1)" in got
    assert "fault-tolerance demo OK" in got


def test_serve_demo_matches_jax(jax_runs):
    got = port_output(serve_demo, ["--device", "cpu"])
    want = jax_output(jax_runs, "serve_demo")
    for out in (got, want):
        assert ("verify vs streamed-prefill one-shot baseline: "
                "token-for-token MATCH") in out
        assert "verify seeded sampling (4 vs 2 slots): bit-identical " \
            "MATCH" in out
    for prefix in ("  t=", "autoscale:", "p50="):
        assert _lines(got, prefix) == _lines(want, prefix), prefix
    served = [re.findall(r"served \S+ requests, \d+ tokens in \S+ sim", o)
              for o in (got, want)]
    assert served[0] == served[1] and len(served[0]) == 2


def test_examples_refuse_a_missing_card():
    """--device cuda (the default) without a card exits with the CLIs'
    message; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for module in (quickstart, elastic_scaling, fault_tolerance,
                   serve_demo):
        with pytest.raises(SystemExit, match="no CUDA device"):
            module.main([])
