"""replint for the port: the repo's contracts checked statically over
`src/repro_torch/` (port of the JAX package's analysis/).

The serving plane's claims (bit-reproducible seeded rollouts, steps built
once per config, schema'd metrics, and for the coming CUDA-graph capture
of the fused step: no host sync and no per-request shape inside it) are
contracts that runtime tests catch late. The six rules keep the JAX
package's ids and names in their PyTorch forms (README.md, "Lint").

    python -m repro_torch.analysis.lint src/repro_torch
    python -m repro_torch.analysis.lint src --format json

The engine (analysis/core.py) is stdlib-only: it imports neither torch
nor jax. Rules live in analysis/rules/ and register in rules.ALL_RULES;
suppressions need a written reason (`# replint: ignore[R001] -- why`, or
`# replint-torch: ignore[R006] -- why` for a finding only these rules
make).
"""
from repro_torch.analysis.core import (Corpus, Finding, LintResult, Rule,
                                       SourceFile, run_lint)
from repro_torch.analysis.rules import ALL_RULES

__all__ = ["ALL_RULES", "Corpus", "Finding", "LintResult", "Rule",
           "SourceFile", "run_lint"]
