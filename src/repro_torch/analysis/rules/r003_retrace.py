"""R003 — retrace hazards: per-request Python scalars flowing into the
arguments of a captured or compiled callable (port of the JAX package's
rule).

torch.compile specializes a compiled step on its input shapes (and on
the Python ints it is passed), and a CUDA graph replays one fixed shape.
An argument built from `len(request.tokens)`, `x.shape[...]` or
`x.size(...)` is a Python int that varies per request: anything whose
shape derives from it re-compiles or re-captures the step on every new
value, and the continuous-batching promise ("admission never
re-compiles") dies quietly. The repo idiom is static pinning: fixed-shape
padded batches (rollout/preference.py pad_pairs / pad_len) and
pool-shaped metadata tensors.

Detection: a call through a name bound to a capture factory or the
registry (common.CAPTURE_FACTORIES, a capture decorator included, and the
dual greedy/sampling dict tables) whose argument expression contains a
bare len(...) call, a .shape access or a .size(...) call.
"""
from __future__ import annotations

import ast
from typing import Iterator, Set

from repro_torch.analysis.core import Corpus, Finding, Rule
from repro_torch.analysis.rules import common


def _has_dynamic_scalar(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "len":
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "size":
            return True
        if isinstance(n, ast.Attribute) and n.attr == "shape":
            return True
    return False


class RetraceRule(Rule):
    id = "R003"
    name = "retrace"
    doc = ("per-request Python scalars (len(...), .shape, .size(...)) "
           "flowing into the args of a captured or compiled callable")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for sf in corpus:
            if not sf.in_dirs(common.DATA_PLANE_SCOPES):
                continue
            imports = sf.imports
            captured = common.collect_captured_names(sf.nodes, imports)
            for node in sf.nodes:
                if not isinstance(node, ast.Call):
                    continue
                if not self._is_captured_call(node, captured, imports):
                    continue
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if _has_dynamic_scalar(arg):
                        yield self.finding(
                            sf, arg,
                            "argument to a captured or compiled callable "
                            "is built from a per-request Python scalar "
                            "(len / .shape / .size()) — each new value "
                            "re-compiles or re-captures the step; pin the "
                            "shape (pad to a fixed size or pass a "
                            "pool-shaped tensor)")

    @staticmethod
    def _is_captured_call(node: ast.Call, captured: Set[str],
                          imports) -> bool:
        fn = node.func
        # f(...) / self._step(...) through a captured name
        dn = common.dotted_name(fn)
        if dn is not None and dn in captured:
            return True
        # self._decode[sample](...) through a dict table of captures
        if isinstance(fn, ast.Subscript):
            dn = common.dotted_name(fn.value)
            if dn is not None and dn in captured:
                return True
        # torch.compile(f)(...) invoked in place
        return common.is_capture_factory(fn, imports)
