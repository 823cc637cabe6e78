"""R005 — metric schema: every published or consumed metric key must be
declared in METRIC_SCHEMA (port of the JAX package's rule, resolved per
package scope).

The metrics plane is stringly-typed end to end: ServingMetrics.snapshot
emits keys, NodeAgent.report_serving namespaces them into the registry
KV, AutoScaler.read_metrics re-aggregates them by name, and the scaling
policies .get() them back out. A typo'd key at ANY of those four hops
doesn't error — the reading side just silently sees nothing, and the
symptom is an autoscaler that stops reacting (a silently-unaggregated
counter looks exactly like an idle fleet). METRIC_SCHEMA
(serve/metrics.py) is the single declared key set; this rule statically
collects every key the plane publishes or consumes and checks membership:

  * string keys of dict literals, `out["key"] = ...` subscript stores,
    for-loop tuple iterables, and .update(key=...) kwargs inside
    functions named snapshot / metrics / metric_sources under serve/ and
    rollout/ (dict-literal keys whose values are themselves dict
    literals are source names, not metrics, and are skipped);
  * string tuples bound to module-level SERVING_* / *_METRICS constants
    (the autoscaler aggregation tables, the rollout phase-metric list);
  * `metrics.get("key")` reads inside decide() / read_metrics() under
    core/.

Each key is checked against the METRIC_SCHEMA of its file's own package
(core.Corpus.scopes): a scan of `src` that took the union of both
packages' schemas would let a key the port dropped pass on the JAX
package's. A package that publishes keys and declares no schema gets one
finding that says so.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import Corpus, Finding, Rule, SourceFile
from repro_torch.analysis.rules import common

PUBLISH_FUNCS = ("snapshot", "metrics", "metric_sources")
CONSUME_FUNCS = ("decide", "read_metrics")
EXEMPT = ("__ts",)


def _schema_keys(files: List[SourceFile]
                 ) -> Tuple[Optional[SourceFile], Set[str]]:
    keys: Set[str] = set()
    where = None
    for sf in files:
        for node in sf.nodes:
            if not isinstance(node, ast.Assign):
                continue
            if not any(isinstance(t, ast.Name) and t.id == "METRIC_SCHEMA"
                       for t in node.targets):
                continue
            where = where or sf
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    keys.add(sub.value)
    return where, keys


def _strings_in(node: ast.AST) -> Iterator[ast.Constant]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub


class MetricSchemaRule(Rule):
    id = "R005"
    name = "metric-schema"
    doc = ("every key published via ServingMetrics.snapshot/"
           "report_serving and consumed by the autoscaler must appear "
           "in METRIC_SCHEMA")

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        for package, files in corpus.scopes():
            yield from self._check_scope(package, files)

    def _check_scope(self, package: str,
                     files: List[SourceFile]) -> Iterator[Finding]:
        used: List[Tuple[SourceFile, ast.AST, str, str]] = []
        for sf in files:
            if sf.in_dirs(common.DATA_PLANE_SCOPES):
                used += [(sf, n, k, "published")
                         for n, k in self._published(sf)]
            if sf.in_dirs(("core",)):
                used += [(sf, n, k, "consumed")
                         for n, k in self._consumed(sf)]
            used += [(sf, n, k, "aggregated")
                     for n, k in self._table_constants(sf)]
        if not used:
            return
        schema_sf, schema = _schema_keys(files)
        if schema_sf is None:
            sf, node, _, _ = used[0]
            where = (f"in package {package}" if package
                     else "anywhere in the scanned tree")
            yield self.finding(
                sf, node,
                f"metric keys are published but no METRIC_SCHEMA is "
                f"declared {where} (declare the full key set in "
                "serve/metrics.py)")
            return
        for sf, node, key, how in used:
            if key in schema or key in EXEMPT:
                continue
            yield self.finding(
                sf, node,
                f"metric key '{key}' is {how} but not declared in "
                f"METRIC_SCHEMA ({schema_sf.relpath}) — an undeclared "
                "key is invisible to the aggregation/tombstone paths")

    # -- collectors --------------------------------------------------------
    def _published(self, sf: SourceFile
                   ) -> Iterator[Tuple[ast.AST, str]]:
        for fn in sf.nodes:
            if not isinstance(fn, ast.FunctionDef) \
                    or fn.name not in PUBLISH_FUNCS:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    for k, v in zip(node.keys, node.values):
                        if isinstance(v, ast.Dict):
                            continue  # {source: {…}} nesting: outer key
                        if isinstance(k, ast.Constant) \
                                and isinstance(k.value, str):
                            yield k, k.value
                elif isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.slice, ast.Constant) \
                                and isinstance(t.slice.value, str):
                            yield t, t.slice.value
                elif isinstance(node, (ast.For, ast.AsyncFor)) \
                        and isinstance(node.iter, (ast.Tuple, ast.List)):
                    for s in _strings_in(node.iter):
                        yield s, s.value
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "update":
                    for kw in node.keywords:
                        if kw.arg is not None:
                            yield node, kw.arg

    def _consumed(self, sf: SourceFile) -> Iterator[Tuple[ast.AST, str]]:
        for fn in sf.nodes:
            if not isinstance(fn, ast.FunctionDef) \
                    or fn.name not in CONSUME_FUNCS:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "get" and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    yield node, node.args[0].value

    def _table_constants(self, sf: SourceFile
                         ) -> Iterator[Tuple[ast.AST, str]]:
        for node in sf.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if not any(n.isupper() and (n.endswith("_METRICS")
                                        or n.startswith("SERVING_"))
                       for n in names):
                continue
            for s in _strings_in(node.value):
                yield s, s.value
