"""R002 — bare-jit: no graph capture or compilation in the serving data
plane outside the registry (port of the JAX package's rule; its jax.jit
is torch.compile, torch.jit.script / trace and the CUDA graph API here).

A fleet builds N replicas per config; each ReplicaEngine, drafter,
trainer and scorer owns step callables. A step captured or compiled
inside one of them (torch.compile, torch.jit.script / trace,
torch.cuda.graph, torch.cuda.CUDAGraph, torch.cuda.make_graphed_callables)
is captured again for every instance, and the cost shows only as a
warmup-skewed benchmark. serve/kv.py is where the JAX package's
shared_jit registry lives and where the port's captures are to be keyed
on the frozen config, so the whole fleet captures once per config: that
file is the one sanctioned caller.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Corpus, Finding, Rule
from repro_torch.analysis.rules import common


class BareJitRule(Rule):
    id = "R002"
    name = "bare-jit"
    doc = ("graph capture or torch.compile in serve/ or rollout/ outside "
           "the registry in serve/kv.py (fleets must capture once per "
           "config)")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for sf in corpus:
            if not sf.in_dirs(common.DATA_PLANE_SCOPES):
                continue
            if sf.is_file("serve", "kv.py"):
                continue  # the registry itself captures
            imports = sf.imports
            for node in sf.nodes:
                if isinstance(node, ast.Call):
                    site, dn = node, common.resolve_call(node, imports)
                elif isinstance(node, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    # a bare decorator (@torch.compile) is no call
                    site = common.capture_decorator(node, imports)
                    if site is None or isinstance(site, ast.Call):
                        continue
                    dn = common.resolve_name(site, imports)
                else:
                    continue
                if dn in common.CAPTURE_CALLS:
                    yield self.finding(
                        sf, site,
                        f"bare {dn}(...) in the serving data plane — "
                        "every replica captures or compiles it again; "
                        "route it through serve/kv.py's registry keyed "
                        "on the frozen config so a fleet captures once "
                        "per config")
