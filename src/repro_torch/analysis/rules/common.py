"""Shared AST helpers for the port's replint rules: name resolution,
import maps, set-typedness, and the tracking of captured callables (port
of the JAX package's rules/common.py). Stdlib-only."""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

# directory scopes: the simulated data plane (determinism contracts apply)
SIM_SCOPES = ("serve", "rollout", "core")
# the serving data plane (capture-once / re-capture contracts apply)
DATA_PLANE_SCOPES = ("serve", "rollout")


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_name(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """The canonical dotted name of a Name/Attribute chain, de-aliasing
    its leading segment through the module's imports (SourceFile.imports)."""
    dn = dotted_name(node)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    canon = imports.get(head)
    if canon is not None:
        dn = canon + ("." + rest if rest else "")
    return dn


def resolve_call(node: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """The canonical dotted name a call resolves to (np.random.rand ->
    numpy.random.rand; from torch import randn; randn() -> torch.randn)."""
    return resolve_name(node.func, imports)


def has_kwarg(node: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in node.keywords)


def func_params(fn: ast.AST) -> List[str]:
    """Parameter names (self/cls dropped) of a def or lambda."""
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return [n for n in names if n not in ("self", "cls")]


# a tensor's metadata: reading it needs no device work, so a branch on it
# is no host sync (x.shape, x.size(0), x.dim(), x.numel(), x.device)
STATIC_ATTRS = ("shape", "dtype", "ndim", "sharding", "device", "size",
                "dim", "numel")


def refs_names(node: ast.AST, names: Set[str]) -> bool:
    """Does `node` reference any of `names` OUTSIDE a static-metadata
    attribute access?"""

    class V(ast.NodeVisitor):
        hit = False

        def visit_Attribute(self, n: ast.Attribute) -> None:
            if n.attr in STATIC_ATTRS:
                return  # static metadata: don't descend into n.value
            self.generic_visit(n)

        def visit_Name(self, n: ast.Name) -> None:
            if n.id in names:
                self.hit = True

    v = V()
    v.visit(node)
    return v.hit


def is_setlike(node: ast.AST, local_sets: Set[str],
               attr_sets: Set[str]) -> bool:
    """Syntactically set-typed: a set literal / comprehension, a
    set()/frozenset() call, a union/difference/intersection of set-likes,
    or a name (self.attr) the enclosing scope assigned one of those."""
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)):
        return (is_setlike(node.left, local_sets, attr_sets)
                or is_setlike(node.right, local_sets, attr_sets))
    if isinstance(node, ast.Name):
        return node.id in local_sets
    if isinstance(node, ast.Attribute):
        return dotted_name(node) in attr_sets
    return False


def collect_set_bindings(nodes: Iterable[ast.AST]
                         ) -> Tuple[Set[str], Set[str]]:
    """(local names, self.X dotted names) assigned a set-like value by any
    of `nodes` (a module's: self attrs are tracked module-wide)."""
    local: Set[str] = set()
    attrs: Set[str] = set()
    for node in nodes:
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        value = node.value
        if value is None or not is_setlike(value, local, attrs):
            continue
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                local.add(t.id)
            else:
                dn = dotted_name(t)
                if dn is not None and dn.startswith("self."):
                    attrs.add(dn)
    return local, attrs


# graph capture and compilation (the JAX package's jax.jit / jax.pmap)
CAPTURE_CALLS = ("torch.compile", "torch.jit.script", "torch.jit.trace",
                 "torch.cuda.graph", "torch.cuda.CUDAGraph",
                 "torch.cuda.make_graphed_callables")
# the once-per-config registry: serve/kv.py, under the JAX package's name
REGISTRY = ("shared_jit", "repro_torch.serve.kv.shared_jit")
CAPTURE_FACTORIES = CAPTURE_CALLS + REGISTRY


def is_capture_factory(node: ast.AST, imports: Dict[str, str]) -> bool:
    """Is `node` a call to a capture/compile factory or the registry?
    (JAX: is_jit_factory.)"""
    if not isinstance(node, ast.Call):
        return False
    return resolve_call(node, imports) in CAPTURE_FACTORIES


def capture_decorator(fn: ast.AST, imports: Dict[str, str]
                      ) -> Optional[ast.AST]:
    """The decorator of a def that captures or compiles it
    (`@torch.compile`, `@torch.compile(mode=...)`, `@torch.jit.script`),
    else None."""
    for d in getattr(fn, "decorator_list", ()):
        if is_capture_factory(d, imports) \
                or resolve_name(d, imports) in CAPTURE_FACTORIES:
            return d
    return None


def collect_captured_names(nodes: Iterable[ast.AST],
                           imports: Dict[str, str]) -> Set[str]:
    """Names (locals and self attributes, dotted) bound to a captured or
    compiled callable: `f = torch.compile(...)`, `self._f =
    shared_jit(...)`, dict literals / comprehensions whose VALUES are
    factory calls (the dual greedy/sampling step tables), and defs under
    a capture decorator. (JAX: collect_jitted_names.)"""
    out: Set[str] = set()
    for node in nodes:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and capture_decorator(node, imports) is not None:
            out.add(node.name)
            continue
        if not isinstance(node, ast.Assign):
            continue
        v = node.value
        captured = is_capture_factory(v, imports)
        if isinstance(v, ast.Dict):
            captured = captured or any(is_capture_factory(x, imports)
                                       for x in v.values)
        if isinstance(v, ast.DictComp):
            captured = captured or is_capture_factory(v.value, imports)
        if not captured:
            continue
        for t in node.targets:
            dn = dotted_name(t)
            if dn is not None:
                out.add(dn)
    return out
