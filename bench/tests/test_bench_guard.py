"""Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX
package `repro` (top-level names compared whole); the reference imports
nothing of the program either."""
import ast
import subprocess
import sys
from pathlib import Path

from bench import guard, spec

ROOT = spec.ROOT


def test_top_level_names_compared_whole():
    names = ["repro_torch.serve", "repro_torch", "reprobe", "jaxtyping",
             "numpy"]
    assert guard.loaded(modules=names) == []
    assert guard.loaded(modules=names + ["repro.serve.x", "jax.numpy",
                                         "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE,
                        ["repro_torch.kernels"]) == ["repro_torch"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_sources_import_no_program():
    files = sorted((spec.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for f in files:
        bad = guard.loaded(guard.FORBIDDEN_IN_REFERENCE, _imports(f))
        assert not bad, f"{f.name} imports {bad}"


def test_no_bench_source_imports_jax_or_the_jax_package():
    for f in sorted(spec.BENCH_DIR.rglob("*.py")):
        assert not guard.loaded(modules=_imports(f)), f


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT}/src"})
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_reference_loads_no_program_module():
    mods = _modules_after("import bench.check, bench.reference.model, "
                          "bench.reference.sampler")
    assert guard.loaded(guard.FORBIDDEN_IN_REFERENCE, mods) == []


def test_a_whole_run_loads_no_jax():
    mods = _modules_after(
        "import time, torch\n"
        "from bench import harness\n"
        "from bench.tests import smoke\n"
        "out = harness.run(smoke.cell('qwen3-32b-l32.rag-shared'), 3, 1.0, "
        "False, torch.device('cpu'), time.monotonic())\n"
        "assert out['correct'], out")
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    assert guard.loaded(modules=mods) == []
