"""replint core for the port: findings, suppressions, package scopes, the
rule base and the runner (port of the JAX package's analysis/core.py).

Stdlib-only (ast + re + pathlib): it imports neither torch nor jax, so a
contract break fails in seconds, before anything touches a device.

Suppression grammar (a reason is mandatory: a suppression is a recorded
decision, not an escape hatch). The engine reads two directive forms:

    <offending code>  # replint: ignore[R001] -- why this is sanctioned
    # replint-torch: ignore[R002,R003] -- a standalone comment covers the NEXT line

The first is the JAX package's own form, which its linter reads too, so
one directive serves both linters where both rules fire. The second is
read by this engine only: a finding that only the port's rules make is
suppressed with it, since the JAX linter would report a `replint:`
directive it has no finding for as unused. A suppression with no
`-- reason` is itself reported (rule R000), and a suppression of either
form that matches no finding is reported as unused.

Package scopes: when the scan root holds two or more top-level
packages (scanning `src` gives repro/... and repro_torch/...), each file
belongs to its package, and the corpus-wide rules (protocols, metric
schema) resolve names inside it. A top-level directory is a package when
the corpus imports it by that name. A scan of one package, or of a
fixture corpus with no package prefix, is one scope.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import io
import json
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*replint(?:-torch)?:\s*ignore\[(?P<ids>[A-Za-z0-9_,\s]*)\]"
    r"(?:\s*--\s*(?P<reason>.*\S))?")
DIRECTIVE_RE = re.compile(r"replint(?:-torch)?:")

# engine-level findings (suppression syntax, parse failures) use this id
ENGINE_RULE = "R000"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str        # "R001"
    name: str        # "determinism"
    path: str        # scan-root-relative posix path
    line: int
    col: int
    message: str
    suppressed: bool = False
    reason: str = ""  # the suppression's written reason, when suppressed

    def format(self) -> str:
        tag = f"{self.rule} [{self.name}]"
        loc = f"{self.path}:{self.line}:{self.col}"
        suf = f"  (suppressed: {self.reason})" if self.suppressed else ""
        return f"{loc}: {tag} {self.message}{suf}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    line: int        # line the suppression comment sits on
    ids: Tuple[str, ...]
    reason: str
    covers_next: bool  # standalone comment line: applies to line + 1
    used: bool = False

    def covers(self, rule: str, line: int) -> bool:
        if rule not in self.ids:
            return False
        return line == self.line or (self.covers_next
                                     and line == self.line + 1)


class SourceFile:
    """One parsed module: source text, AST, path parts, suppressions, and
    the package scope the corpus assigns it ("" for none)."""

    def __init__(self, path: Path, relpath: str, text: str):
        self.path = path
        self.relpath = relpath          # posix, relative to the scan root
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:  # surfaced as an R000 finding by the runner
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        # every node of the module in ast.walk's order, walked once: the
        # rules scan each module many times
        self.nodes: List[ast.AST] = (list(ast.walk(self.tree))
                                     if self.tree is not None else [])
        parts = Path(relpath).parts
        self.parts = parts              # every segment, filename included
        self.dir_parts = parts[:-1]
        self.package = ""
        self.suppressions: List[Suppression] = []
        self.malformed_suppressions: List[Tuple[int, str]] = []
        self._parse_suppressions()

    def _parse_suppressions(self) -> None:
        # tokenize so only real COMMENT tokens count: a directive quoted
        # in a docstring or string literal is documentation
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return  # unparseable file, already reported via parse_error
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i, col = tok.start
            comment = tok.string
            m = SUPPRESS_RE.search(comment)
            if not m:
                if DIRECTIVE_RE.search(comment):
                    self.malformed_suppressions.append(
                        (i, "unparseable replint directive (expected "
                            "'# replint: ignore[R00X] -- reason' or "
                            "'# replint-torch: ignore[R00X] -- reason')"))
                continue
            ids = tuple(s.strip().upper()
                        for s in m.group("ids").split(",") if s.strip())
            reason = (m.group("reason") or "").strip()
            if not ids:
                self.malformed_suppressions.append(
                    (i, "suppression lists no rule ids"))
                continue
            if not reason:
                self.malformed_suppressions.append(
                    (i, f"suppression of {', '.join(ids)} has no reason "
                        "(grammar: # replint: ignore[R00X] -- why)"))
                continue
            src_line = self.lines[i - 1] if i <= len(self.lines) else ""
            covers_next = not src_line[:col].strip()
            self.suppressions.append(
                Suppression(i, ids, reason, covers_next))

    @functools.cached_property
    def imports(self) -> Dict[str, str]:
        """Local alias -> canonical dotted module/name for every import."""
        out: Dict[str, str] = {}
        for node in self.nodes:
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    # -- path scoping helpers (rules call these) ---------------------------
    def in_dirs(self, names: Sequence[str]) -> bool:
        """Any directory segment of the path matches: works for both
        src/repro_torch/serve/x.py and a fixture corpus's serve/x.py."""
        return any(p in names for p in self.dir_parts)

    def is_file(self, *tail: str) -> bool:
        """Path ends with the given segments (e.g. is_file('serve', 'kv.py'))."""
        return self.parts[-len(tail):] == tuple(tail)


def top_level_packages(files: Sequence[SourceFile]) -> Set[str]:
    """The scan root's top-level directories that the corpus imports by
    name (`from repro_torch.serve import ...`), when there are two or
    more; else none (the corpus is one scope)."""
    dirs = {sf.parts[0] for sf in files if len(sf.parts) > 1}
    imported: Set[str] = set()
    for sf in files:
        for node in sf.nodes:
            if isinstance(node, ast.Import):
                imported.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                imported.add(node.module.split(".")[0])
    tops = dirs & imported
    return tops if len(tops) > 1 else set()


class Corpus:
    """Every parsed file of one lint run. Corpus-wide rules (protocol
    conformance, metric schema) see all modules of a package scope at
    once; the constructor assigns each file its scope."""

    def __init__(self, files: List[SourceFile]):
        self.files = files
        tops = top_level_packages(files)
        for sf in files:
            sf.package = sf.parts[0] if sf.parts[0] in tops \
                and len(sf.parts) > 1 else ""

    def __iter__(self) -> Iterator[SourceFile]:
        return iter(self.files)

    def scopes(self) -> List[Tuple[str, List[SourceFile]]]:
        """(package, its files) per package scope, in scan order."""
        out: Dict[str, List[SourceFile]] = {}
        for sf in self.files:
            out.setdefault(sf.package, []).append(sf)
        return list(out.items())


class Rule:
    """Base rule: subclass, set id/name/doc, implement check()."""

    id = "R???"
    name = "unnamed"
    doc = ""

    def check(self, corpus: Corpus) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, sf: SourceFile, node: ast.AST, message: str) -> Finding:
        return Finding(self.id, self.name, sf.relpath,
                       getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]          # suppressed + unsuppressed, sorted
    files_scanned: int
    unused_suppressions: List[Tuple[str, int, str]]  # (path, line, ids)

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> List[Finding]:
        return [f for f in self.findings if f.suppressed]

    def format_text(self, *, show_suppressed: bool = False) -> str:
        out = [f.format() for f in self.unsuppressed]
        if show_suppressed:
            out += [f.format() for f in self.suppressed]
        for path, line, ids in self.unused_suppressions:
            out.append(f"{path}:{line}:0: note: unused suppression [{ids}]")
        out.append(f"replint: {len(self.unsuppressed)} finding(s), "
                   f"{len(self.suppressed)} suppressed, "
                   f"{self.files_scanned} file(s) scanned")
        return "\n".join(out)

    def format_json(self) -> str:
        return json.dumps({
            "findings": [f.to_json() for f in self.findings],
            "unsuppressed": len(self.unsuppressed),
            "suppressed": len(self.suppressed),
            "files_scanned": self.files_scanned,
            "unused_suppressions": [
                {"path": p, "line": ln, "ids": ids}
                for p, ln, ids in self.unused_suppressions],
        }, indent=2)


def discover(paths: Sequence[str]) -> List[Tuple[Path, str]]:
    """(abs path, scan-root-relative posix path) for every .py file.

    Relative paths are computed against each argument, so scanning `src`
    yields repro_torch/serve/... and scanning a fixture corpus yields its
    own serve/... layout: path-scoped rules match either."""
    out: List[Tuple[Path, str]] = []
    for arg in paths:
        root = Path(arg)
        if root.is_file():
            out.append((root, root.name))
            continue
        for p in sorted(root.rglob("*.py")):
            if "__pycache__" in p.parts:
                continue
            out.append((p, p.relative_to(root).as_posix()))
    return out


def run_lint(paths: Sequence[str],
             rules: Optional[Sequence[Rule]] = None) -> LintResult:
    """Parse every file under `paths`, run every rule, apply suppressions."""
    if rules is None:
        from repro_torch.analysis.rules import ALL_RULES
        rules = [cls() for cls in ALL_RULES]
    files = [SourceFile(p, rel, p.read_text())
             for p, rel in discover(paths)]
    corpus = Corpus([f for f in files if f.tree is not None])

    findings: List[Finding] = []
    for sf in files:
        if sf.parse_error:
            findings.append(Finding(ENGINE_RULE, "engine", sf.relpath, 1, 0,
                                    sf.parse_error))
        for line, msg in sf.malformed_suppressions:
            findings.append(Finding(ENGINE_RULE, "engine", sf.relpath,
                                    line, 0, msg))
    for rule in rules:
        findings.extend(rule.check(corpus))

    by_path = {sf.relpath: sf for sf in files}
    resolved: List[Finding] = []
    for f in findings:
        sf = by_path.get(f.path)
        sup = None
        if sf is not None and f.rule != ENGINE_RULE:
            sup = next((s for s in sf.suppressions
                        if s.covers(f.rule, f.line)), None)
        if sup is not None:
            sup.used = True
            resolved.append(dataclasses.replace(f, suppressed=True,
                                                reason=sup.reason))
        else:
            resolved.append(f)
    resolved.sort(key=lambda f: (f.path, f.line, f.rule, f.col))

    unused = [(sf.relpath, s.line, ",".join(s.ids))
              for sf in files for s in sf.suppressions if not s.used]
    return LintResult(resolved, len(files), unused)
