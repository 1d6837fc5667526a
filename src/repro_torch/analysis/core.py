"""Checker framework: file walking, rule registry, findings, suppressions
(a copy of ``repro/analysis/core.py`` with the port's rule battery).

A :class:`Rule` sees every analyzed file once (:meth:`Rule.check_file`,
over a parsed :class:`SourceFile`) and the whole file set once at the end
(:meth:`Rule.finish`, over the :class:`Project`) — per-file rules use the
former, cross-file invariants (kernel/oracle pairing, fault-kind
exhaustiveness, dead dataclass fields, repo hygiene) the latter.  Every
:class:`Finding` carries ``rule``, ``file:line``, and a message; a
``# repro: allow(<rule>)`` comment on the flagged line or the line above
suppresses it (several rules comma-separate).

The rule battery lives in :mod:`repro_torch.analysis.rules` (per-file) and
:mod:`repro_torch.analysis.project` (cross-file); :func:`run_analysis` wires
walking, checking, and suppression together and is what the CLI
(``python -m repro_torch.analysis``) and the tier-1 gate call.
"""
from __future__ import annotations

import ast
import json
import os
import re
import sys
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")
_HOT_RE = re.compile(r"#\s*repro:\s*hot\b")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored at ``path:line``."""
    rule: str
    path: str            # repo-relative (or as-given) path
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


@dataclass
class SourceFile:
    """One parsed Python file: source, AST, and per-line annotations."""
    path: str            # absolute
    rel: str             # path relative to the project root ('/'-separated)
    source: str
    tree: ast.Module
    allows: Dict[int, Set[str]] = field(default_factory=dict)
    hot_lines: Set[int] = field(default_factory=set)

    @classmethod
    def parse(cls, path: str, rel: str) -> "SourceFile":
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
        allows: Dict[int, Set[str]] = {}
        hot: Set[int] = set()
        for i, line in enumerate(source.splitlines(), start=1):
            m = _ALLOW_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                allows[i] = rules
            if _HOT_RE.search(line):
                hot.add(i)
        return cls(path=path, rel=rel, source=source, tree=tree,
                   allows=allows, hot_lines=hot)

    def allowed(self, rule: str, line: int) -> bool:
        """An ``allow(rule)`` comment on the flagged line or the line
        immediately above suppresses the finding."""
        for ln in (line, line - 1):
            if rule in self.allows.get(ln, ()):
                return True
        return False

    def is_hot_marked(self, node: ast.AST) -> bool:
        """A ``# repro: hot`` comment on the ``def`` line or the line
        immediately above (above any decorators) marks a function hot."""
        lines = {node.lineno, node.lineno - 1}
        for dec in getattr(node, "decorator_list", []):
            lines.add(dec.lineno - 1)
        return bool(lines & self.hot_lines)


@dataclass
class Project:
    """The analyzed file set plus the repo root project rules need for
    out-of-set context (``tests/``, ``git ls-files``, ``.gitignore``)."""
    root: str
    files: List[SourceFile] = field(default_factory=list)

    def find(self, rel_suffix: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.rel.endswith(rel_suffix):
                return f
        return None


class Rule:
    """Base checker.  Subclasses set ``name`` and override one or both
    hooks; ``check_file`` runs once per analyzed file, ``finish`` once at
    the end with the whole :class:`Project`."""
    name: str = "rule"

    def check_file(self, f: SourceFile) -> Iterable[Finding]:
        return ()

    def finish(self, project: Project) -> Iterable[Finding]:
        return ()


def default_rules() -> List[Rule]:
    from repro_torch.analysis import project as project_rules
    from repro_torch.analysis import rules as file_rules
    return [
        file_rules.GlobalRngRule(),
        file_rules.HostSyncRule(),
        project_rules.KernelOracleRule(),
        project_rules.FaultKindRule(),
        project_rules.DeadDecisionFieldRule(),
        project_rules.TrackedBytecodeRule(),
    ]


def _iter_py_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def run_analysis(paths: Sequence[str], root: Optional[str] = None,
                 rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Walk ``paths``, run every rule, and return suppression-filtered
    findings sorted by location.  ``root`` anchors relative finding paths
    and the project-level context (defaults to the CWD)."""
    root = os.path.abspath(root or os.getcwd())
    rules = list(default_rules() if rules is None else rules)
    project = Project(root=root)
    findings: List[Finding] = []
    by_rel: Dict[str, SourceFile] = {}
    for path in _iter_py_files(paths):
        apath = os.path.abspath(path)
        rel = os.path.relpath(apath, root).replace(os.sep, "/")
        if rel in by_rel:
            continue
        try:
            sf = SourceFile.parse(apath, rel)
        except SyntaxError as e:
            findings.append(Finding("parse-error", rel, e.lineno or 1,
                                    f"cannot parse: {e.msg}"))
            continue
        by_rel[rel] = sf
        project.files.append(sf)
    for sf in project.files:
        for rule in rules:
            for fnd in rule.check_file(sf):
                if not sf.allowed(fnd.rule, fnd.line):
                    findings.append(fnd)
    for rule in rules:
        for fnd in rule.finish(project):
            sf = by_rel.get(fnd.path)
            if sf is not None and sf.allowed(fnd.rule, fnd.line):
                continue
            findings.append(fnd)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def report(findings: Sequence[Finding], as_json: bool = False,
           stream=None) -> None:
    stream = stream or sys.stdout
    if as_json:
        json.dump([f.to_dict() for f in findings], stream, indent=1)
        stream.write("\n")
        return
    for f in findings:
        print(f.format(), file=stream)
    n = len(findings)
    print(f"repro_torch.analysis: {n} finding{'s' if n != 1 else ''}",
          file=stream)
