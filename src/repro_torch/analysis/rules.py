"""Per-file AST rules: host syncs in hot paths (the reference's rule with
PyTorch's forms) and the port's explicit-generator discipline, the
counterpart of the reference's ``prng-reuse``.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Rule, SourceFile

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _stmt_exprs(stmt: ast.stmt) -> Iterable[ast.AST]:
    """The value expressions a statement evaluates (left-to-right-ish),
    excluding nested function/class bodies."""
    if isinstance(stmt, _DEFS + (ast.ClassDef,)):
        return
    for fld, value in ast.iter_fields(stmt):
        if fld in ("body", "orelse", "finalbody", "handlers", "target",
                   "targets"):
            continue
        if isinstance(value, ast.expr):
            yield value
        elif isinstance(value, list):
            for v in value:
                if isinstance(v, ast.expr):
                    yield v
                elif isinstance(v, ast.withitem):
                    yield v.context_expr
                elif isinstance(v, ast.keyword):
                    yield v.value


def _calls_in(expr: ast.AST) -> List[ast.Call]:
    out: List[ast.Call] = []

    def visit(node: ast.AST) -> None:
        if isinstance(node, (ast.Lambda,) + _DEFS):
            return  # deferred bodies don't execute here
        if isinstance(node, ast.Call):
            out.append(node)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(expr)
    return out


def _module_aliases(tree: ast.Module, module: str) -> Set[str]:
    """Names that resolve to ``module`` in this file."""
    out = {module}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == module and alias.asname:
                    out.add(alias.asname)
    return out


# ------------------------------------------------- host-sync-in-hot-path --
def _time_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(module aliases of ``time``, bare names imported from ``time``)."""
    bare: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                bare.add(alias.asname or alias.name)
    return _module_aliases(tree, "time"), bare


# tensor methods that copy device data to the host or wait for the device
_SYNC_METHODS = {
    "item": ".item() forces a device->host sync",
    "tolist": ".tolist() copies device data to the host",
    "cpu": ".cpu() copies device data to the host",
    "numpy": ".numpy() needs the data on the host",
    "synchronize": ".synchronize() blocks on the device",
}


class HostSyncRule(Rule):
    """Host-synchronizing constructs (``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize`` and event or
    stream ``.synchronize()``, ``np.asarray``/``np.array``, non-constant
    ``float()``, ``time.*``) inside hot code: functions marked
    ``# repro: hot`` or anything under ``kernels/``."""
    name = "host-sync-in-hot-path"

    def check_file(self, f: SourceFile) -> Iterable[Finding]:
        file_hot = "kernels/" in f.rel or f.rel.startswith("kernels/")
        np_aliases = _module_aliases(f.tree, "numpy") | {"np"}
        time_mods, time_bare = _time_names(f.tree)
        findings: List[Finding] = []

        def check_call(call: ast.Call) -> None:
            d = dotted(call.func)
            msg = None
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _SYNC_METHODS and (
                        not call.args or call.func.attr == "synchronize"):
                msg = _SYNC_METHODS[call.func.attr]
            if msg is None and d is not None:
                if "." in d:
                    mod, fn = d.rsplit(".", 1)
                    if mod in np_aliases and fn in ("asarray", "array"):
                        msg = f"{d}() copies device data to the host"
                    elif mod in time_mods:
                        msg = f"{d}() is host-side timing"
                elif d in time_bare:
                    msg = f"{d}() (from time) is host-side timing"
                elif d == "float" and call.args and not isinstance(
                        call.args[0], ast.Constant):
                    msg = "float() on a non-constant forces a " \
                          "device->host sync"
            if msg is not None:
                findings.append(Finding(
                    self.name, f.rel, call.lineno,
                    msg + "; hoist it out of the hot path or annotate "
                    "`# repro: allow(host-sync-in-hot-path)`"))

        def scan_stmts(stmts: List[ast.stmt], hot: bool) -> None:
            for stmt in stmts:
                if isinstance(stmt, _DEFS):
                    scan_stmts(stmt.body,
                               hot or file_hot or f.is_hot_marked(stmt))
                    continue
                if isinstance(stmt, ast.ClassDef):
                    scan_stmts(stmt.body, hot)
                    continue
                if hot:
                    for expr in _stmt_exprs(stmt):
                        for call in _calls_in(expr):
                            check_call(call)
                for fld in ("body", "orelse", "finalbody"):
                    scan_stmts(getattr(stmt, fld, []) or [], hot)
                for handler in getattr(stmt, "handlers", []) or []:
                    scan_stmts(handler.body, hot)

        scan_stmts(list(f.tree.body), False)
        return findings


# ------------------------------------------------------------ global-rng --
# torch functions that draw from a generator (``generator=`` keyword)
_SAMPLERS = {"randn", "rand", "randint", "randperm", "normal", "bernoulli",
             "multinomial", "poisson", "rand_like", "randn_like",
             "randint_like"}
# in-place tensor samplers
_INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "exponential_",
                     "random_", "cauchy_", "log_normal_", "geometric_"}
# seeding the process-wide generators
_GLOBAL_SEEDS = {"manual_seed", "seed", "manual_seed_all"}


class GlobalRngRule(Rule):
    """The port draws every random number from an explicit
    ``torch.Generator``, so two runs with one seed agree whatever else
    ran in the process: a torch sampler (``torch.randn``/``rand``/
    ``randint``/``randperm``/``normal``/..., and the in-place
    ``x.normal_()``/``uniform_()``/...) called without ``generator=``, or
    a seeding of the process-wide generator (``torch.manual_seed``,
    ``torch.cuda.manual_seed[_all]``), is a finding.  The ``*_like``
    samplers take no generator, so every call of one is a finding."""
    name = "global-rng"

    def check_file(self, f: SourceFile) -> Iterable[Finding]:
        torch_mods = _module_aliases(f.tree, "torch")
        bare: Set[str] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "torch", "torch.random", "torch.cuda"):
                for alias in node.names:
                    if alias.name in _SAMPLERS | _GLOBAL_SEEDS:
                        bare.add(alias.asname or alias.name)
        findings: List[Finding] = []
        for call in (n for n in ast.walk(f.tree) if isinstance(n, ast.Call)):
            d = dotted(call.func) or ""
            mod, _, fn = d.rpartition(".")
            is_torch = mod.split(".")[0] in torch_mods if mod else \
                fn in bare
            has_gen = any(kw.arg == "generator" for kw in call.keywords)
            msg = None
            if is_torch and fn in _GLOBAL_SEEDS:
                msg = f"{d}() seeds the process-wide generator; draw from " \
                      "an explicit torch.Generator instead"
            elif is_torch and fn in _SAMPLERS and not has_gen:
                msg = f"{d}() without generator= draws from the " \
                      "process-wide generator"
            elif isinstance(call.func, ast.Attribute) \
                    and call.func.attr in _INPLACE_SAMPLERS and not has_gen:
                msg = f".{call.func.attr}() without generator= draws from " \
                      "the process-wide generator"
            if msg is not None:
                findings.append(Finding(self.name, f.rel, call.lineno, msg))
        return findings
