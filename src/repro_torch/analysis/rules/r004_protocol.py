"""R004 — protocol conformance: every concrete implementation carries the
full protocol surface with compatible signatures (port of the JAX
package's rule, resolved per package scope).

The serving plane is seamed on runtime-checkable Protocols (KVBackend,
Scorer, SchedulerPolicy, RoutingPolicy, the autoscaler's Policy and
Provisioner) plus one plain base class (Drafter). runtime_checkable's
isinstance() only checks NAMES at runtime: a backend that renames a
parameter or forgets `cancel_resume_plans` passes isinstance and
explodes deep inside a drain. This rule does the structural check
statically, over the AST:

  * protocol definitions are discovered in the scanned corpus: classes
    with `Protocol` among their bases, plus registered plain base
    classes (Drafter-style, whose abstract surface is the methods that
    `raise NotImplementedError`);
  * a class IMPLEMENTS a protocol if the protocol is among its
    (transitive) bases, or if it structurally matches the protocol's
    marker methods (a distinctive subset; single-marker protocols also
    require one shared parameter name so e.g. an unrelated `route()`
    method doesn't match);
  * each implementation must then define every protocol method
    (inherited concrete defs count; inherited abstract ones don't) and
    every annotated protocol attribute, with compatible signatures:
    positional names in protocol order, extras defaulted, protocol
    keyword-onlys present; *args/**kwargs absorb.

Classes, bases and protocols resolve inside each package scope
(core.Corpus.scopes): the port reuses the JAX package's class names, and
a scan of `src` that kept one class per name across both packages would
check only the JAX package's.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import Corpus, Finding, Rule, SourceFile

# distinctive marker-method sets for the repo's protocols (structural
# detection); a corpus protocol not listed here falls back to its first
# declared method as the marker
KNOWN_MARKERS: Dict[str, Tuple[str, ...]] = {
    "KVBackend": ("can_admit", "admit", "decode", "evict"),
    "Drafter": ("propose",),
    "Scorer": ("score",),
    "SchedulerPolicy": ("select", "victim"),
    "RoutingPolicy": ("route",),
    "Policy": ("decide",),
    "Provisioner": ("add_nodes", "remove_nodes"),
}

# plain base classes whose abstract surface (raise NotImplementedError)
# is treated as a protocol for their subclasses
BASE_CLASS_PROTOCOLS = ("Drafter",)


@dataclasses.dataclass
class MethodSig:
    name: str
    pos: List[str]           # positional param names, self/cls dropped
    defaults: int            # how many trailing positionals have defaults
    kwonly: List[str]
    kwonly_defaults: Set[str]
    has_vararg: bool
    has_kwarg: bool
    is_property: bool
    lineno: int


@dataclasses.dataclass
class ClassInfo:
    name: str
    sf: SourceFile
    node: ast.ClassDef
    bases: List[str]
    methods: Dict[str, MethodSig]
    attrs: Set[str]          # class-level assigns/annotations + self.X
    abstract: Set[str]       # methods whose body raises NotImplementedError
    is_protocol: bool


def _method_sig(fn: ast.FunctionDef, *, is_property: bool) -> MethodSig:
    a = fn.args
    pos = [p.arg for p in a.posonlyargs + a.args]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    return MethodSig(
        name=fn.name, pos=pos, defaults=len(a.defaults),
        kwonly=[p.arg for p in a.kwonlyargs],
        kwonly_defaults={p.arg for p, d in zip(a.kwonlyargs, a.kw_defaults)
                         if d is not None},
        has_vararg=a.vararg is not None, has_kwarg=a.kwarg is not None,
        is_property=is_property, lineno=fn.lineno)


def _is_abstract(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Raise):
            exc = node.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name) \
                    and exc.id == "NotImplementedError":
                return True
    return False


def _collect_class(sf: SourceFile, node: ast.ClassDef) -> ClassInfo:
    bases = []
    for b in node.bases:
        if isinstance(b, ast.Name):
            bases.append(b.id)
        elif isinstance(b, ast.Attribute):
            bases.append(b.attr)  # typing.Protocol -> Protocol
    methods: Dict[str, MethodSig] = {}
    attrs: Set[str] = set()
    abstract: Set[str] = set()
    for item in node.body:
        if isinstance(item, ast.FunctionDef):
            is_prop = any(isinstance(d, ast.Name) and d.id == "property"
                          for d in item.decorator_list)
            methods[item.name] = _method_sig(item, is_property=is_prop)
            if _is_abstract(item):
                abstract.add(item.name)
        elif isinstance(item, ast.AnnAssign) \
                and isinstance(item.target, ast.Name):
            attrs.add(item.target.id)
        elif isinstance(item, ast.Assign):
            for t in item.targets:
                if isinstance(t, ast.Name):
                    attrs.add(t.id)
    # dataclass fields and self.X assignments both count as attributes
    for fn in node.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for sub in ast.walk(fn):
            if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        attrs.add(t.attr)
    return ClassInfo(node.name, sf, node, bases, methods, attrs, abstract,
                     is_protocol="Protocol" in bases)


class ProtocolRule(Rule):
    id = "R004"
    name = "protocol"
    doc = ("concrete KVBackend/Drafter/Scorer/SchedulerPolicy/"
           "RoutingPolicy/Policy/Provisioner implementations must carry "
           "the full protocol surface with compatible signatures")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for _, files in corpus.scopes():
            yield from self._check_scope(files)

    def _check_scope(self, files: List[SourceFile]) -> Iterator[Finding]:
        classes: Dict[str, ClassInfo] = {}
        for sf in files:
            for node in sf.nodes:
                if isinstance(node, ast.ClassDef):
                    # first definition wins (names are unique in a package)
                    classes.setdefault(node.name, _collect_class(sf, node))

        protocols = {c.name: c for c in classes.values()
                     if c.is_protocol or c.name in BASE_CLASS_PROTOCOLS}
        for proto in protocols.values():
            for impl in classes.values():
                if impl.name == proto.name or impl.is_protocol:
                    continue
                if not self._implements(impl, proto, classes):
                    continue
                yield from self._check_impl(impl, proto, classes)

    # -- detection ---------------------------------------------------------
    def _implements(self, impl: ClassInfo, proto: ClassInfo,
                    classes: Dict[str, ClassInfo]) -> bool:
        if self._inherits(impl, proto.name, classes):
            return True
        if proto.name in BASE_CLASS_PROTOCOLS:
            return False  # plain bases are nominal-only
        markers = KNOWN_MARKERS.get(proto.name)
        if markers is None:
            markers = tuple(list(proto.methods)[:1])
        if not markers:
            return False
        methods = self._transitive_methods(impl, classes)
        if not all(m in methods for m in markers):
            return False
        if len(markers) == 1:
            # single-marker protocols also need one shared non-self param
            # name, so an unrelated method with the same name (a network
            # sim's route()) doesn't get conscripted into the protocol
            pm = proto.methods.get(markers[0])
            im = methods.get(markers[0])
            if pm is None or im is None:
                return False
            if pm.pos and not (set(pm.pos) & set(im.pos)) \
                    and not im.has_vararg:
                return False
        return True

    def _inherits(self, impl: ClassInfo, base_name: str,
                  classes: Dict[str, ClassInfo], _depth: int = 0) -> bool:
        if _depth > 10:
            return False
        for b in impl.bases:
            if b == base_name:
                return True
            parent = classes.get(b)
            if parent is not None and self._inherits(parent, base_name,
                                                     classes, _depth + 1):
                return True
        return False

    def _transitive_methods(self, impl: ClassInfo,
                            classes: Dict[str, ClassInfo],
                            _depth: int = 0) -> Dict[str, MethodSig]:
        """impl's methods, with concrete inherited defs from bases found
        in the corpus (protocol bases contribute nothing — `...` stubs
        are not implementations). Abstract base methods don't satisfy."""
        out: Dict[str, MethodSig] = {}
        if _depth <= 10:
            for b in impl.bases:
                parent = classes.get(b)
                if parent is None or parent.is_protocol:
                    continue
                for name, sig in self._transitive_methods(
                        parent, classes, _depth + 1).items():
                    if name not in parent.abstract:
                        out[name] = sig
                out.update({n: s for n, s in parent.methods.items()
                            if n not in parent.abstract})
        out.update(impl.methods)
        return out

    def _transitive_attrs(self, impl: ClassInfo,
                          classes: Dict[str, ClassInfo],
                          _depth: int = 0) -> Set[str]:
        out = set(impl.attrs)
        if _depth <= 10:
            for b in impl.bases:
                parent = classes.get(b)
                if parent is not None and not parent.is_protocol:
                    out |= self._transitive_attrs(parent, classes,
                                                  _depth + 1)
        return out

    # -- conformance -------------------------------------------------------
    def _check_impl(self, impl: ClassInfo, proto: ClassInfo,
                    classes: Dict[str, ClassInfo]) -> Iterator[Finding]:
        methods = self._transitive_methods(impl, classes)
        attrs = self._transitive_attrs(impl, classes)
        required = {n for n in proto.methods
                    if n in proto.abstract or proto.is_protocol}
        for name in sorted(required):
            psig = proto.methods[name]
            isig = methods.get(name)
            if isig is None:
                if psig.is_property and name in attrs:
                    continue  # a plain attribute satisfies a property
                yield self.finding(
                    impl.sf, impl.node,
                    f"{impl.name} implements {proto.name} but is missing "
                    f"{name}() (declared at {proto.sf.relpath}:"
                    f"{psig.lineno})")
                continue
            if name in impl.methods:  # only check defs we can see verbatim
                msg = self._sig_mismatch(psig, isig)
                if msg:
                    f = self.finding(impl.sf, impl.node, "")
                    yield dataclasses.replace(
                        f, line=isig.lineno,
                        message=f"{impl.name}.{name} signature "
                                f"incompatible with {proto.name}.{name}: "
                                f"{msg}")
        for attr in sorted(proto.attrs):
            if attr not in attrs and attr not in methods:
                yield self.finding(
                    impl.sf, impl.node,
                    f"{impl.name} implements {proto.name} but never "
                    f"defines the protocol attribute `{attr}`")

    @staticmethod
    def _sig_mismatch(proto: MethodSig, impl: MethodSig) -> Optional[str]:
        if proto.is_property != impl.is_property:
            want = "a property" if proto.is_property else "a method"
            return f"protocol declares {want}"
        if impl.has_vararg and impl.has_kwarg:
            return None  # absorbs anything
        n = len(proto.pos)
        ipos = impl.pos
        if not impl.has_vararg:
            if len(ipos) < n:
                return (f"takes {len(ipos)} positional arg(s), protocol "
                        f"declares {n}")
            for i, pname in enumerate(proto.pos):
                if ipos[i] != pname:
                    return (f"positional arg {i + 1} is `{ipos[i]}`, "
                            f"protocol names it `{pname}` (callers pass "
                            "it by keyword)")
            extra = ipos[n:]
            undefaulted = len(ipos) - impl.defaults
            if extra and undefaulted > n:
                return (f"extra required positional arg(s) "
                        f"{ipos[n:undefaulted]} beyond the protocol "
                        "surface")
        if not impl.has_kwarg:
            for k in proto.kwonly:
                if k not in impl.kwonly and k not in impl.pos:
                    return f"missing keyword-only arg `{k}`"
            for k in impl.kwonly:
                if k not in proto.kwonly and k not in proto.pos \
                        and k not in impl.kwonly_defaults:
                    return (f"extra required keyword-only arg `{k}` "
                            "beyond the protocol surface")
        return None
