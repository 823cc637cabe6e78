"""R006 — tracer hygiene: no Python control flow on tensor arguments and
no host syncs inside the fused step builders (port of the JAX package's
rule, with PyTorch's host syncs added).

A fused-step builder (launch/steps.py make_*_step / make_*_fn, a
trainer's _build_step) returns the function the engines call every
step. PyTorch runs it eagerly, so `if` / `while` / a ternary / `assert`
on one of its tensor arguments is bool() of a device tensor: the host
waits for the device there, every step. The same holds for .item(),
.tolist(), .cpu(), .numpy(), float() / int() / bool() of an argument,
np.asarray / np.array of one, and torch.cuda.synchronize(). A CUDA graph
cannot capture any of these, and torch.compile breaks its graph on them,
so a step that is to be captured must hold none. Branching on CLOSURE
values (cfg, sample, prompt_len) is static and fine: the rule flags only
expressions that reference the step function's own parameters, and a
tensor's metadata (.shape, .size(), .dim(), .numel(), .dtype, .ndim,
.device) is exempt (common.STATIC_ATTRS). The function handed to a
capture factory (a lambda, or a def under a capture decorator) is
checked the same way.
"""
from __future__ import annotations

import ast
import re
from typing import Iterator, List, Set, Tuple

from repro_torch.analysis.core import Corpus, Finding, Rule, SourceFile
from repro_torch.analysis.rules import common

BUILDER_NAME = re.compile(r"^(make_\w*_(step|fn)|_build_step)$")
HOST_CASTS = ("float", "int", "bool")
HOST_ARRAY_CASTS = ("numpy.asarray", "numpy.array")
# tensor methods that copy to the host and wait for the device
HOST_METHODS = ("item", "tolist", "cpu", "numpy")
DEVICE_SYNC = "torch.cuda.synchronize"


class TracerHygieneRule(Rule):
    id = "R006"
    name = "tracer-hygiene"
    doc = ("Python bool()/if on tensor arguments and .item() / .tolist() "
           "/ .cpu() / .numpy() / float() / torch.cuda.synchronize() host "
           "syncs inside fused step builders")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for sf in corpus:
            imports = sf.imports
            for traced, params in self._traced_functions(sf, imports):
                yield from self._check_traced(sf, traced, params, imports)

    # -- what counts as a step ---------------------------------------------
    def _traced_functions(self, sf: SourceFile, imports
                          ) -> Iterator[Tuple[ast.AST, Set[str]]]:
        """(function node, its param names) for every step function: inner
        defs/lambdas of make_*_step builders, lambdas handed to a capture
        factory or returned by a registry builder thunk, and defs under a
        capture decorator."""
        seen: List[ast.AST] = []
        for node in sf.nodes:
            if isinstance(node, ast.FunctionDef) \
                    and BUILDER_NAME.match(node.name):
                for inner in ast.walk(node):
                    if inner is node:
                        continue
                    if isinstance(inner, (ast.FunctionDef, ast.Lambda)):
                        seen.append(inner)
            elif isinstance(node, ast.FunctionDef) \
                    and common.capture_decorator(node, imports) is not None:
                seen.append(node)
            elif isinstance(node, ast.Call) \
                    and common.is_capture_factory(node, imports):
                for arg in node.args:
                    if isinstance(arg, ast.Lambda):
                        # the registry takes a zero-arg builder thunk
                        # whose BODY is the step; torch.compile takes the
                        # step directly
                        body = arg.body
                        if not arg.args.args and isinstance(body,
                                                            ast.Lambda):
                            seen.append(body)
                        elif arg.args.args:
                            seen.append(arg)
        emitted = set()
        for fn in seen:
            if id(fn) in emitted:
                continue
            emitted.add(id(fn))
            yield fn, set(common.func_params(fn))

    # -- the checks --------------------------------------------------------
    def _check_traced(self, sf: SourceFile, fn: ast.AST, params: Set[str],
                      imports) -> Iterator[Finding]:
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                # nested defs inherit the param set (their own params
                # join it: they are tensors when called from the step)
                if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                    params = params | set(common.func_params(node))
                if isinstance(node, (ast.If, ast.While)):
                    if common.refs_names(node.test, params):
                        yield self.finding(
                            sf, node,
                            "Python branch on a tensor argument inside a "
                            "fused step builder — bool() of a device "
                            "tensor is a host sync every step and no CUDA "
                            "graph can capture it; use torch.where")
                elif isinstance(node, ast.IfExp):
                    if common.refs_names(node.test, params):
                        yield self.finding(
                            sf, node,
                            "ternary on a tensor argument inside a fused "
                            "step builder — a host sync every step; use "
                            "torch.where")
                elif isinstance(node, ast.Assert):
                    if common.refs_names(node.test, params):
                        yield self.finding(
                            sf, node,
                            "assert on a tensor argument inside a fused "
                            "step builder — it forces a host sync every "
                            "step; check it on the host side, outside "
                            "the step")
                elif isinstance(node, ast.Call):
                    yield from self._check_call(sf, node, params, imports)

    def _check_call(self, sf: SourceFile, node: ast.Call,
                    params: Set[str], imports) -> Iterator[Finding]:
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in HOST_METHODS:
            yield self.finding(
                sf, node,
                f".{node.func.attr}() inside a fused step builder — a "
                "device->host copy that waits for the device in the "
                "step's hot path (a CUDA graph cannot capture it); keep "
                "the value on the device or return it")
            return
        dn = common.resolve_call(node, imports)
        if dn == DEVICE_SYNC:
            yield self.finding(
                sf, node,
                "torch.cuda.synchronize() inside a fused step builder — "
                "the host waits for the device every step; synchronize "
                "where the host needs the result, outside the step")
        elif dn in HOST_CASTS and node.args \
                and common.refs_names(node.args[0], params):
            yield self.finding(
                sf, node,
                f"{dn}() of a tensor argument inside a fused step builder "
                "— a host sync every step; keep it on the device (torch "
                "ops) or return it")
        elif dn in HOST_ARRAY_CASTS and node.args \
                and common.refs_names(node.args[0], params):
            yield self.finding(
                sf, node,
                f"{dn.replace('numpy', 'np')}() of a tensor argument "
                "inside a fused step builder — a host copy in the step's "
                "hot path; keep it a tensor on the device")
