"""replint for the port (repro_torch.analysis) on the CPU:

(a) each rule fires on its positive cases (one per PyTorch form it
    knows), stays silent on its negatives and honours reasoned
    suppressions, over a corpus written here as strings;
(b) the engine: directives without a reason, directives in strings,
    unused notes, syntax errors, the JSON report, the CLI's exit codes;
(c) parity with the JAX package's linter: on its fixture corpus
    (tests/fixtures/replint/) the port's R000, R001, R004, R005 and R006
    give exactly its findings, field for field. R002 and R003 are left
    out: the fixtures' positives are jax.jit and the JAX registry, which
    the port's forms (torch.compile, CUDA graphs) do not name. Over
    src/repro_torch both linters give the same five suppressed R001
    findings and nothing else;
(d) the masking the JAX linter has over a tree holding both packages
    (one class per name, one union of schemas): a renamed protocol
    parameter and a dropped schema key in the port's copy are caught by
    the port's linter and by neither rule of the JAX one;
(e) the self-run: the port's linter over src/repro_torch and over src
    reports nothing unsuppressed and no unused suppression, and a
    `replint-torch` directive is invisible to the JAX linter.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.analysis.core import run_lint as jax_lint
from repro.analysis.rules import ALL_RULES as JAX_RULES
from repro_torch.analysis.core import Corpus, SourceFile, discover, run_lint
from repro_torch.analysis.rules import ALL_RULES

HERE = Path(__file__).parent
REPO = HERE.parent
SRC = REPO / "src"
FIXTURES = HERE / "fixtures" / "replint"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread while this module runs (the other test workers
    keep their cores), the caller's count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- (a) the rule corpus ----------------------------------------------------

def _src(body):
    return textwrap.dedent(body).lstrip("\n")


R001_TORCH = ["rand((2,))", "randn(2)", "randint(0, 9, (2,))", "randperm(4)",
              "rand_like(x)", "randn_like(x)", "randint_like(x, 9)",
              "normal(x, 1.0)", "bernoulli(x)", "multinomial(x, 1)",
              "poisson(x)", "manual_seed(0)", "seed()",
              "random.manual_seed(0)", "cuda.manual_seed(0)",
              "cuda.manual_seed_all(0)"]
INPLACE = ["uniform_", "normal_", "random_", "bernoulli_", "exponential_",
           "geometric_", "cauchy_", "log_normal_"]
R002_FORMS = {
    "torch.compile": "torch.compile(fn)",
    "torch.jit.script": "torch.jit.script(fn)",
    "torch.jit.trace": "torch.jit.trace(fn, (x,))",
    "torch.cuda.graph": "torch.cuda.graph(g)",
    "torch.cuda.CUDAGraph": "torch.cuda.CUDAGraph()",
    "torch.cuda.make_graphed_callables":
        "torch.cuda.make_graphed_callables(fn, (x,))",
}
R006_FORMS = {
    "if": "if x > 0:\n    return x",
    "while": "while x.sum() > 0:\n    x = x - 1",
    "ternary": "x = x if x.any() else -x",
    "assert": "assert x.all()",
    "item": "s = x.item()",
    "float": "s = float(x)",
    "int": "s = int(x)",
    "bool": "s = bool(x)",
    "np.asarray": "s = np.asarray(x)",
    "np.array": "s = np.array(x)",
    "tolist": "s = x.tolist()",
    "cpu": "s = x.cpu()",
    "numpy": "s = x.numpy()",
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
}

R006_STEP = ("import numpy as np\nimport torch\n\n\n"
             "def make_corpus_step(scale):\n"
             "    def step(x):\n"
             "{body}\n"
             "        return x * scale\n\n"
             "    return step\n")


def _cases():
    """(rule, kind, label, relpath, source): one corpus file per case."""
    out = []
    for form in R001_TORCH:
        out.append(("R001", "pos", f"torch.{form}", _src(f"""
            import torch


            def draw(x):
                return torch.{form}
            """)))
    for m in INPLACE:
        out.append(("R001", "pos", f".{m}", _src(f"""
            def init(x):
                x.{m}()
            """)))
    out.append(("R001", "pos", "nn.init.normal_", _src("""
        import torch


        def init(w):
            torch.nn.init.normal_(w)
        """)))
    out.append(("R001", "pos", "wall-clock", _src("""
        import time


        def stamp():
            return time.perf_counter()
        """)))
    out.append(("R001", "pos", "random", _src("""
        import random


        def jitter():
            return random.random()
        """)))
    out.append(("R001", "pos", "numpy.random", _src("""
        import numpy as np


        def jitter():
            return np.random.rand()
        """)))
    out.append(("R001", "pos", "set-iteration", _src("""
        def drain(keys):
            return [k for k in set(keys)]
        """)))
    out.append(("R001", "neg", "seeded", _src("""
        import numpy as np
        import torch


        def draw(clock, x, seed):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn(2, generator=g)
            x.uniform_(generator=g)
            torch.nn.init.normal_(x, generator=g)
            b = np.random.default_rng(seed).random()
            return clock.now(), a, b, [k for k in sorted(set(x.tolist()))]
        """)))
    out.append(("R001", "sup", "torch-form", _src("""
        import torch


        def reseed():
            # replint-torch: ignore[R001] -- corpus: the process's one sanctioned reseed
            torch.manual_seed(0)
        """)))
    out.append(("R001", "sup", "jax-form", _src("""
        import time


        def stamp():
            return time.time()  # replint: ignore[R001] -- corpus: the wall-clock boundary
        """)))

    for label, call in R002_FORMS.items():
        out.append(("R002", "pos", label, _src(f"""
            import torch


            def build(fn, g, x):
                return {call}
            """)))
    out.append(("R002", "pos", "@torch.compile", _src("""
        import torch


        @torch.compile
        def step(x):
            return x + 1
        """)))
    out.append(("R002", "neg", "registry", _src("""
        from repro_torch.serve.kv import shared_jit


        def build(cfg, fn):
            return shared_jit(("corpus_step", cfg), lambda: fn)
        """)))
    out.append(("R002", "neg", "kv.py", _src("""
        import torch


        def shared_jit(key, builder):
            return torch.compile(builder())
        """)))
    out.append(("R002", "sup", "torch-form", _src("""
        import torch


        def build(fn):
            # replint-torch: ignore[R002] -- corpus: one-off offline tool, never built per replica
            return torch.compile(fn)
        """)))

    out.append(("R003", "pos", "len", _src("""
        import torch

        _step = torch.compile(torch.cumsum)


        def run(tokens):
            return _step(torch.zeros(len(tokens)), 0)
        """)))
    out.append(("R003", "pos", ".shape", _src("""
        import torch

        from repro_torch.serve.kv import shared_jit


        class Engine:
            def __init__(self, cfg):
                self._step = shared_jit(("corpus", cfg), lambda: torch.ones)

            def run(self, x):
                return self._step(x.shape[0])
        """)))
    out.append(("R003", "pos", ".size()", _src("""
        import torch


        @torch.compile(dynamic=False)
        def step(n):
            return torch.zeros(n)


        def run(x):
            return step(x.size(0))
        """)))
    out.append(("R003", "neg", "pinned", _src("""
        import torch

        PAD = 128
        _step = torch.cuda.make_graphed_callables(torch.cumsum,
                                                  (torch.zeros(PAD),))


        def run(tokens):
            del tokens  # padded to PAD: the shape never varies per request
            return _step(torch.zeros(PAD))
        """)))
    out.append(("R003", "sup", "torch-form", _src("""
        import torch

        _step = torch.compile(torch.cumsum)


        def run(tokens):
            # replint-torch: ignore[R003] -- corpus: fixed-length prompts, the shape set is closed
            return _step(torch.zeros(len(tokens)), 0)
        """)))

    out.append(("R004", "pos", "missing-and-renamed", _src("""
        from typing import Protocol


        class CorpusSelector(Protocol):
            def select(self, queue, now): ...

            def victim(self, slots): ...


        class HalfSelector(CorpusSelector):
            def select(self, queue, now):
                return queue[0]


        class RenamedSelector(CorpusSelector):
            def select(self, q, now):
                return q[-1]

            def victim(self, slots):
                return None
        """)))
    out.append(("R004", "neg", "full-surface", _src("""
        from typing import Protocol


        class CorpusRanker(Protocol):
            def rank(self, items, now): ...


        class FullRanker(CorpusRanker):
            def rank(self, items, now):
                return sorted(items)
        """)))
    out.append(("R004", "sup", "torch-form", _src("""
        from typing import Protocol


        class CorpusDrain(Protocol):
            def drain(self, slots): ...

            def flush(self, slots): ...


        # replint-torch: ignore[R004] -- corpus: partial test double, only drain() is exercised
        class PartialDrain(CorpusDrain):
            def drain(self, slots):
                return slots
        """)))

    out.append(("R005", "pos", "off-schema", _src("""
        class CorpusMetricsPos:
            def snapshot(self):
                return {"corpus_unregistered_key": 1.0}
        """)))
    out.append(("R005", "neg", "declared", _src("""
        METRIC_SCHEMA = frozenset({"corpus_known_key"})


        class CorpusMetricsNeg:
            def snapshot(self):
                return {"corpus_known_key": 2.0}
        """)))
    out.append(("R005", "sup", "torch-form", _src("""
        class CorpusMetricsSup:
            def snapshot(self):
                # replint-torch: ignore[R005] -- corpus: experimental key, off-schema on purpose
                return {"corpus_offschema_key": 3.0}
        """)))

    for label, stmt in R006_FORMS.items():
        out.append(("R006", "pos", label, R006_STEP.format(
            body=textwrap.indent(stmt, " " * 8))))
    out.append(("R006", "pos", "lambda-to-compile", _src("""
        import torch

        step = torch.compile(lambda x: x.tolist())
        """)))
    out.append(("R006", "pos", "@torch.compile", _src("""
        import torch


        @torch.compile
        def step(x):
            return x.cpu()
        """)))
    out.append(("R006", "neg", "static-metadata", _src("""
        import torch


        def make_corpus_step(scale, use_bias):
            bias = 1.0 if use_bias else 0.0  # closure value: static

            def step(x):
                if x.size(0) > 1 and x.dim() == 2 and x.numel():
                    x = x * 2
                if x.device.type == "cuda" and x.shape[-1] % 2 == 0:
                    x = x + 0
                return torch.where(x > 0, x * scale + bias, x)

            return step
        """)))
    out.append(("R006", "sup", "torch-form", _src("""
        def make_corpus_sup_step(scale):
            def step(x):
                # replint-torch: ignore[R006] -- corpus: debug-only host read, outside any capture
                return x.cpu() * scale

            return step
        """)))
    return out


DIRS = {"R001": "serve", "R002": "serve", "R003": "serve", "R004": "any",
        "R005": "serve", "R006": "any"}
CASES = _cases()


def _relpath(i, rule, kind, label):
    if (rule, label) == ("R002", "kv.py"):
        return "serve/kv.py"  # the registry's own file
    return f"{DIRS[rule]}/{rule.lower()}_{kind}_{i}.py"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("replint_corpus")
    for i, (rule, kind, label, src) in enumerate(CASES):
        path = root / _relpath(i, rule, kind, label)
        path.parent.mkdir(exist_ok=True)
        path.write_text(src)
    return root, run_lint([str(root)])


@pytest.mark.parametrize(
    "i", range(len(CASES)),
    ids=[f"{r}-{k}-{lab}" for r, k, lab, _ in CASES])
def test_rule_case(corpus, i):
    rule, kind, label, _ = CASES[i]
    path = _relpath(i, rule, kind, label)
    hits = [f for f in corpus[1].findings
            if f.rule == rule and f.path == path]
    if kind == "pos":
        assert [f for f in hits if not f.suppressed], \
            f"{rule} missed its {label} form"
    elif kind == "neg":
        assert not hits, [f.format() for f in hits]
    else:
        assert hits and all(f.suppressed and f.reason for f in hits), \
            [f.format() for f in hits]


def test_corpus_leaves_no_suppression_unused(corpus):
    assert not corpus[1].unused_suppressions
    assert not [f for f in corpus[1].findings if f.rule == "R000"]


def test_registry_keeps_the_jax_ids_and_names():
    assert [(c.id, c.name) for c in ALL_RULES] == \
        [(c.id, c.name) for c in JAX_RULES]


def test_r004_distinguishes_missing_method_from_renamed_param(corpus):
    msgs = [f.message for f in corpus[1].findings if f.rule == "R004"
            and not f.suppressed]
    assert any("missing" in m and "victim" in m for m in msgs)
    assert any("positional arg" in m and "`queue`" in m for m in msgs)


# ---- (b) the engine ---------------------------------------------------------

@pytest.mark.parametrize("form", ["replint", "replint-torch"])
def test_suppression_without_reason_is_an_engine_finding(tmp_path, form):
    f = tmp_path / "bad.py"
    f.write_text(f"import time\nx = time.time()  # {form}: ignore[R001]\n")
    res = run_lint([str(f)])
    assert any(fi.rule == "R000" and "no reason" in fi.message
               for fi in res.unsuppressed)


@pytest.mark.parametrize("form", ["replint", "replint-torch"])
def test_unparseable_directive_is_an_engine_finding(tmp_path, form):
    f = tmp_path / "bad.py"
    f.write_text(f"x = 1  # {form}: skip R001\n")
    res = run_lint([str(f)])
    assert [fi.rule for fi in res.unsuppressed] == ["R000"]
    assert "unparseable" in res.unsuppressed[0].message


@pytest.mark.parametrize("form", ["replint", "replint-torch"])
def test_directive_in_a_string_is_not_a_suppression(tmp_path, form):
    f = tmp_path / "doc.py"
    f.write_text(f'GRAMMAR = "# {form}: ignore[R001] -- why"\n')
    res = run_lint([str(f)])
    assert not res.findings and not res.unused_suppressions


@pytest.mark.parametrize("form", ["replint", "replint-torch"])
def test_unused_suppression_is_noted(tmp_path, form):
    f = tmp_path / "stale.py"
    f.write_text(f"# {form}: ignore[R002] -- nothing here fires R002\n"
                 "x = 1\n")
    res = run_lint([str(f)])
    assert [(p, ln, ids) for p, ln, ids in res.unused_suppressions] == \
        [("stale.py", 1, "R002")]


def test_syntax_error_is_an_engine_finding(tmp_path):
    f = tmp_path / "broken.py"
    f.write_text("def oops(:\n")
    res = run_lint([str(f)])
    assert any(fi.rule == "R000" and "syntax error" in fi.message
               for fi in res.unsuppressed)


def test_json_report_round_trips(corpus):
    res = corpus[1]
    doc = json.loads(res.format_json())
    assert doc["files_scanned"] == res.files_scanned == len(CASES)
    assert doc["unsuppressed"] == len(res.unsuppressed)
    assert doc["suppressed"] == len(res.suppressed)
    assert [dict(f) for f in doc["findings"]] == \
        [dataclasses.asdict(f) for f in res.findings]


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", *args],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120)


def test_cli_exit_codes_and_json(corpus):
    dirty = _cli(str(corpus[0]), "--rules", "R002", "--format", "json")
    assert dirty.returncode == 1
    doc = json.loads(dirty.stdout)
    assert doc["unsuppressed"] == len([f for f in corpus[1].unsuppressed
                                       if f.rule == "R002"]) > 0
    assert {f["rule"] for f in doc["findings"]} == {"R002"}
    clean = _cli("src/repro_torch")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "0 finding(s)" in clean.stdout
    assert _cli("src", "--rules", "R099").returncode == 2


# ---- (c) parity with the JAX package's linter ------------------------------

PARITY_RULES = ("R000", "R001", "R004", "R005", "R006")


def _fields(res, rules=PARITY_RULES):
    return sorted((f.rule, f.path, f.line, f.col, f.suppressed, f.reason)
                  for f in res.findings if f.rule in rules)


def test_parity_on_the_jax_fixture_corpus():
    ours, theirs = run_lint([str(FIXTURES)]), jax_lint([str(FIXTURES)])
    assert _fields(ours) == _fields(theirs)
    assert {f[0] for f in _fields(theirs)} >= {"R001", "R004", "R005",
                                                "R006"}


@pytest.fixture(scope="module")
def port_tree():
    return run_lint([str(SRC / "repro_torch")])


def test_parity_over_the_port(port_tree):
    theirs = jax_lint([str(SRC / "repro_torch")])
    every = ("R000",) + tuple(c.id for c in ALL_RULES)
    got = _fields(port_tree, every)
    assert got == _fields(theirs, every)
    assert len(got) == 5 and all(f[0] == "R001" and f[4] for f in got)


# ---- (d) the masking over a tree holding both packages ----------------------

EDITS = {
    "R004": ("repro_torch/serve/slots.py",
             "def can_admit(self, gen_len: int, *, prompt=None)",
             "def can_admit(self, n_tokens: int, *, prompt=None)"),
    "R005": ("repro_torch/serve/metrics.py",
             '    "swapped_blocks", "swap_out_bytes"',
             '    "swap_out_bytes"'),
}


@pytest.mark.parametrize("rule", sorted(EDITS))
def test_port_catches_what_the_jax_linter_masks(tmp_path, rule):
    root = tmp_path / "src"
    shutil.copytree(SRC, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, old, new = EDITS[rule]
    text = (root / rel).read_text()
    assert text.count(old) == 1
    (root / rel).write_text(text.replace(old, new))
    only = lambda rules: [c() for c in rules if c.id == rule]
    pick = lambda res: [f for f in res.unsuppressed if f.rule == rule]
    ours = pick(run_lint([str(root)], only(ALL_RULES)))
    assert ours and all(f.path.startswith("repro_torch/") for f in ours)
    if rule == "R004":
        assert [f.path for f in ours] == [rel]
        assert "`n_tokens`" in ours[0].message
    else:
        assert all("'swapped_blocks'" in f.message for f in ours)
        assert len(ours) == 3
    # the JAX linter finds it in the port alone, and not beside repro/
    assert len(pick(jax_lint([str(root / "repro_torch")],
                             only(JAX_RULES)))) == len(ours)
    assert not pick(jax_lint([str(root)], only(JAX_RULES)))


# ---- (e) the self-run ----------------------------------------------------

@pytest.fixture(scope="module")
def src_tree():
    return run_lint([str(SRC)])


@pytest.mark.parametrize("which", ["src/repro_torch", "src"])
def test_self_run_is_clean(port_tree, src_tree, which):
    res = port_tree if which == "src/repro_torch" else src_tree
    assert not res.unsuppressed, "\n".join(
        f.format() for f in res.unsuppressed)
    assert not res.unused_suppressions, res.unused_suppressions


@pytest.mark.parametrize("root, packages", [
    ("src", {"repro", "repro_torch"}), ("src/repro_torch", {""}),
    ("tests/fixtures/replint", {""})])
def test_package_scopes(root, packages):
    """A scan root holding both packages gives each its own scope; one
    package, or a corpus with no package prefix, is one scope."""
    files = [SourceFile(p, rel, p.read_text())
             for p, rel in discover([str(REPO / root)])]
    assert {pkg for pkg, _ in Corpus(files).scopes()} == packages
    if root == "src":
        assert all(sf.package == sf.parts[0] for sf in files)


def test_src_scan_finds_the_port_as_its_own_scan_does(src_tree,
                                                      port_tree):
    ours = [dataclasses.replace(f, path=f.path[len("repro_torch/"):])
            for f in src_tree.findings if f.path.startswith("repro_torch/")]
    assert ours == port_tree.findings


def test_torch_directive_is_invisible_to_the_jax_linter(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("x = 1  # replint-torch: ignore[R006] -- no finding here\n")
    theirs = jax_lint([str(f)])
    assert not theirs.findings and not theirs.unused_suppressions
    assert run_lint([str(f)]).unused_suppressions == [("m.py", 1, "R006")]


def test_no_comment_in_the_linter_reads_as_a_directive():
    """The JAX linter's gate over src reads every comment holding its
    directive prefix; the port's analysis package holds none."""
    pkg = SRC / "repro_torch" / "analysis"
    for res in (jax_lint([str(pkg)]), run_lint([str(pkg)])):
        assert not res.findings and not res.unused_suppressions
