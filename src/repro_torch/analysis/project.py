"""Cross-file rules: kernel/plain-version pairing, fault-kind
exhaustiveness, dead ``Decision``/``ControllerConfig`` fields, and
tracked bytecode hygiene.

These run in :meth:`Rule.finish` over the whole analyzed file set; the
kernel and fault rules additionally read sibling files (``ref.py``,
``csrc/*.cu``, ``tests/``, ``chip_smoke.py``) from disk so the analyzed
paths don't have to include them.  The last three are copies of the
reference's (``repro/analysis/project.py``).
"""
from __future__ import annotations

import ast
import os
import re
import subprocess
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Project, Rule, SourceFile
from repro_torch.analysis.rules import dotted

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')


def _word(name: str, text: str) -> bool:
    return re.search(rf"\b{re.escape(name)}\b", text) is not None


def _read(path: str) -> Optional[str]:
    try:
        with open(path, encoding="utf-8") as f:
            return f.read()
    except OSError:
        return None


def _parse(path: str) -> Optional[ast.Module]:
    src = _read(path)
    if src is None:
        return None
    try:
        return ast.parse(src)
    except SyntaxError:
        return None


def _names(node: ast.AST) -> Set[str]:
    """Every name, attribute and string constant a node mentions."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def _closure(tree: ast.Module, seeds: Set[str],
             found: Set[str] = frozenset()) -> Set[str]:
    """Top-level defs and classes of ``tree`` that are in ``found`` or
    mention a name in ``seeds``, directly or through another such def or
    class."""
    tops = {n.name: _names(n) for n in tree.body
            if isinstance(n, _DEFS + (ast.ClassDef,))}
    found = set(found)
    grow = True
    while grow:
        grow = False
        for name, used in tops.items():
            if name not in found and used & (seeds | found):
                found.add(name)
                grow = True
    return found


def _declares(top: ast.AST, node: ast.Attribute) -> bool:
    """``node`` is the ``lib.entry`` of ``lib.entry.argtypes`` or
    ``.restype`` inside ``top``."""
    return any(isinstance(p, ast.Attribute) and p.value is node
               and p.attr in ("argtypes", "restype") for p in ast.walk(top))


# --------------------------------------------------------- kernel-oracle --
class KernelOracleRule(Rule):
    """Every ``extern "C"`` entry of ``csrc/*.cu`` that a binding module
    under ``kernels/`` reaches must have a public ``ops.py`` wrapper
    that reaches the binding, and that wrapper a plain version in
    ``ref.py`` (a ``ref.<fn>`` it calls); the wrapper and its plain
    version must be exercised together in some ``tests/test_torch_*.py``
    and in ``chip_smoke.py`` (both under the analysis root).  The
    counterpart of the reference's pallas_call/oracle pairing; CUDA has
    no BlockSpec, so its ``index_map`` arity check has none."""
    name = "kernel-oracle"
    skip = ("ops.py", "ref.py", "__init__.py", "cost.py", "_build.py")

    def finish(self, project: Project) -> Iterable[Finding]:
        findings: List[Finding] = []
        bindings = [f for f in project.files if "kernels/" in f.rel
                    and os.path.basename(f.rel) not in self.skip]
        if not bindings:
            return findings
        kdir = os.path.dirname(bindings[0].path)
        entries: Set[str] = set()
        csrc = os.path.join(os.path.dirname(kdir), "csrc")
        for fn in sorted(os.listdir(csrc)) if os.path.isdir(csrc) else ():
            if fn.endswith(".cu"):
                entries |= set(_EXTERN_RE.findall(
                    _read(os.path.join(csrc, fn)) or ""))
        ops = _parse(os.path.join(kdir, "ops.py"))
        ref = _parse(os.path.join(kdir, "ref.py"))
        plain = {n.name for n in (ref.body if ref else [])
                 if isinstance(n, _DEFS)}
        tests = self._tests_source(project)
        smoke = _read(os.path.join(project.root, "chip_smoke.py")) or ""
        for f in bindings:
            stem = os.path.basename(f.rel)[:-3]
            for entry in sorted(entries):
                node = next((n for n in ast.walk(f.tree)
                             if isinstance(n, ast.Attribute)
                             and n.attr == entry), None)
                if node is None:
                    continue
                problem = self._check(f.tree, ops, stem, entry, plain,
                                      tests, smoke)
                if problem:
                    findings.append(Finding(
                        self.name, f.rel, node.lineno,
                        f"kernel entry '{entry}' {problem}"))
        return findings

    def _check(self, tree, ops, stem, entry, plain, tests, smoke):
        # defs that use the entry (setting its argtypes/restype is not a
        # use), and those that reach them
        reach = _closure(tree, set(), {
            top.name for top in tree.body
            if isinstance(top, _DEFS + (ast.ClassDef,))
            and any(isinstance(n, ast.Attribute) and n.attr == entry
                    and not _declares(top, n) for n in ast.walk(top))})
        if ops is None:
            return "has no ops.py wrapper (ops.py not found)"
        # ops.py reaches the binding through ``<module alias>.<def>``
        aliases = {stem}
        for n in ast.walk(ops):
            if isinstance(n, ast.ImportFrom):
                for a in n.names:
                    if a.name == stem and a.asname:
                        aliases.add(a.asname)
        calls = {top.name for top in ops.body
                 if isinstance(top, _DEFS + (ast.ClassDef,))
                 and any(isinstance(n, ast.Attribute) and n.attr in reach
                         and isinstance(n.value, ast.Name)
                         and n.value.id in aliases for n in ast.walk(top))}
        wrappers = sorted(w for w in _closure(ops, set(), calls)
                          if not w.startswith("_"))
        if not wrappers:
            return "has no public ops.py wrapper"
        for w in wrappers:
            node = next(n for n in ops.body
                        if getattr(n, "name", None) == w)
            refs = sorted({n.attr for n in ast.walk(node)
                           if isinstance(n, ast.Attribute)
                           and dotted(n.value) == "ref"
                           and n.attr in plain})
            if not refs:
                return f"has an ops.py wrapper '{w}' with no ref.py " \
                    "plain version"
            if not any(_word(w, src) and any(_word(r, src) for r in refs)
                       for src in tests):
                return f"wrapper '{w}' is not exercised with its plain " \
                    f"version {refs} in a tests/test_torch_*.py"
            if not (_word(w, smoke) and any(_word(r, smoke) for r in refs)):
                return f"wrapper '{w}' is not exercised with its plain " \
                    f"version {refs} in chip_smoke.py"
        return None

    def _tests_source(self, project: Project) -> List[str]:
        out = []
        tests_dir = os.path.join(project.root, "tests")
        if not os.path.isdir(tests_dir):
            return out
        for fn in sorted(os.listdir(tests_dir)):
            if fn.startswith("test_torch_") and fn.endswith(".py"):
                src = _read(os.path.join(tests_dir, fn))
                if src:
                    out.append(src)
        return out


# ------------------------------------------------------------ fault-kind --
class FaultKindRule(Rule):
    """Every fault kind declared in ``fault/inject.py::KINDS`` must
    appear (as a string literal) in ``fault/supervisor.py`` — the
    supervisor's classification/recovery must stay exhaustive."""
    name = "fault-kind"

    def finish(self, project: Project) -> Iterable[Finding]:
        inject = project.find("fault/inject.py")
        if inject is None:
            return []
        kinds_node = None
        for node in inject.tree.body:
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == "KINDS"
                            for t in node.targets):
                kinds_node = node
        if kinds_node is None or not isinstance(
                kinds_node.value, (ast.Tuple, ast.List)):
            return []
        kinds = [e.value for e in kinds_node.value.elts
                 if isinstance(e, ast.Constant) and isinstance(e.value, str)]
        sup = project.find("fault/supervisor.py")
        if sup is not None:
            sup_tree = sup.tree
        else:
            src = _read(os.path.join(os.path.dirname(inject.path),
                                     "supervisor.py"))
            if src is None:
                return [Finding(self.name, inject.rel, kinds_node.lineno,
                                "fault/supervisor.py not found next to "
                                "inject.py; fault kinds have no handler")]
            sup_tree = ast.parse(src)
        handled = {n.value for n in ast.walk(sup_tree)
                   if isinstance(n, ast.Constant)
                   and isinstance(n.value, str)}
        return [Finding(self.name, inject.rel, kinds_node.lineno,
                        f"fault kind '{k}' is declared in KINDS but never "
                        "referenced by the supervisor — recovery is not "
                        "exhaustive")
                for k in kinds if k not in handled]


# --------------------------------------------------- dead-decision-field --
class DeadDecisionFieldRule(Rule):
    """Fields of the controller's ``Decision``/``ControllerConfig``
    dataclasses that no analyzed file ever reads (no attribute access,
    no ``getattr(x, "field")``) are dead weight in the control plane."""
    name = "dead-decision-field"
    target_classes = ("Decision", "ControllerConfig")

    def finish(self, project: Project) -> Iterable[Finding]:
        decls: List[Tuple[SourceFile, str, str, int]] = []
        for f in project.files:
            for node in f.tree.body:
                if isinstance(node, ast.ClassDef) \
                        and node.name in self.target_classes:
                    for item in node.body:
                        if isinstance(item, ast.AnnAssign) \
                                and isinstance(item.target, ast.Name) \
                                and not item.target.id.startswith("_"):
                            ann = ast.dump(item.annotation)
                            if "ClassVar" in ann:
                                continue
                            decls.append((f, node.name, item.target.id,
                                          item.lineno))
        if not decls:
            return []
        read: Set[str] = set()
        for f in project.files:
            for node in ast.walk(f.tree):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Load):
                    read.add(node.attr)
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in ("getattr", "hasattr"):
                    if len(node.args) >= 2 \
                            and isinstance(node.args[1], ast.Constant) \
                            and isinstance(node.args[1].value, str):
                        read.add(node.args[1].value)
        return [Finding(self.name, f.rel, line,
                        f"{cls}.{field} is never read by any analyzed "
                        "file (no attribute access or getattr); delete "
                        "it or wire it up")
                for f, cls, field, line in decls if field not in read]


# ------------------------------------------------------ tracked-bytecode --
def _git(root: str, *argv: str) -> Optional[str]:
    try:
        proc = subprocess.run(["git", *argv], cwd=root,
                              capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout if proc.returncode == 0 else None


class TrackedBytecodeRule(Rule):
    """No ``__pycache__``/``.pyc`` artifact may be tracked by git, and
    ``.gitignore`` must keep covering bytecode patterns.  Only applies
    when the analysis root IS a git toplevel (it has happened twice:
    8436fa0 removed six tracked .pyc, bd262a9 re-committed them)."""
    name = "tracked-bytecode"

    def finish(self, project: Project) -> Iterable[Finding]:
        root = project.root
        top = _git(root, "rev-parse", "--show-toplevel")
        if top is None or os.path.realpath(top.strip()) \
                != os.path.realpath(root):
            return []
        findings: List[Finding] = []
        listed = _git(root, "ls-files")
        for path in (listed or "").splitlines():
            if path.endswith((".pyc", ".pyo")) \
                    or "__pycache__" in path.split("/"):
                findings.append(Finding(
                    self.name, path, 1,
                    "bytecode artifact is tracked by git; `git rm "
                    "--cached` it"))
        gi = _read(os.path.join(root, ".gitignore")) or ""
        patterns = [ln.strip() for ln in gi.splitlines()
                    if ln.strip() and not ln.lstrip().startswith("#")]
        if "__pycache__/" not in patterns:
            findings.append(Finding(
                self.name, ".gitignore", 1,
                "missing a `__pycache__/` ignore pattern"))
        if not any(p in ("*.pyc", "*.py[cod]") for p in patterns):
            findings.append(Finding(
                self.name, ".gitignore", 1,
                "missing a `*.pyc`/`*.py[cod]` ignore pattern"))
        return findings
