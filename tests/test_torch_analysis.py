"""The port's invariant checker (``repro_torch.analysis``): each torch
rule fires on a bad fixture and stays quiet on a good one; the rules
copied from the reference give the reference's findings on the
reference's own fixtures; the CLI's ``--strict`` and ``--json``; and the
tier-1 gate that the port's tree is finding-free."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.analysis import run_analysis as jrun_analysis
from repro.analysis.project import DeadDecisionFieldRule as JDeadField
from repro.analysis.project import FaultKindRule as JFaultKind
from repro.analysis.rules import PrngReuseRule as JPrngReuse
from repro_torch.analysis import default_rules, run_analysis
from repro_torch.analysis.__main__ import DEFAULT_PATHS
from repro_torch.analysis.project import (DeadDecisionFieldRule,
                                          FaultKindRule, KernelOracleRule)
from repro_torch.analysis.rules import GlobalRngRule, HostSyncRule

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
FIX = os.path.join(ROOT, "tests", "analysis_fixtures_torch")
JFIX = os.path.join(ROOT, "tests", "analysis_fixtures")


def _analyze(name, rule, root=FIX):
    return run_analysis([os.path.join(root, name)], root=root, rules=[rule])


# ------------------------------------------------ host-sync-in-hot-path ----
def test_hostsync_bad_fires_on_every_torch_form():
    found = _analyze("hostsync_bad.py", HostSyncRule())
    assert {f.rule for f in found} == {"host-sync-in-hot-path"}
    msgs = " ".join(f.message for f in found)
    for needle in (".item()", ".tolist()", ".cpu()", ".numpy()",
                   ".synchronize()", "np.asarray()", "host-side timing",
                   "float()"):
        assert needle in msgs, needle
    # torch.cuda.synchronize() and the event's .synchronize() both fire
    assert len(found) == 10


def test_hostsync_good_stays_quiet():
    assert _analyze("hostsync_good.py", HostSyncRule()) == []


def test_kernels_dir_is_implicitly_hot(tmp_path):
    kdir = tmp_path / "kernels"
    kdir.mkdir()
    (kdir / "hotfile.py").write_text("def f(x):\n    return x.cpu()\n")
    found = run_analysis([str(kdir)], root=str(tmp_path),
                         rules=[HostSyncRule()])
    assert [f.rule for f in found] == ["host-sync-in-hot-path"]


# ------------------------------------------------------------ global-rng ----
def test_global_rng_bad_fires_per_draw_and_seed():
    found = _analyze("rng_bad.py", GlobalRngRule())
    assert [f.rule for f in found] == ["global-rng"] * 8
    assert [f.line for f in found] == list(range(7, 15))


def test_global_rng_good_stays_quiet():
    assert _analyze("rng_good.py", GlobalRngRule()) == []


# --------------------------------------------------------- kernel-oracle ----
def test_kernel_bad_fires_for_each_entry_without_a_plain_version():
    root = os.path.join(FIX, "kernel_bad")
    found = run_analysis([root], root=root, rules=[KernelOracleRule()])
    assert [(f.path, f.rule) for f in found] == \
        [("pkg/kernels/k.py", "kernel-oracle")] * 2
    msgs = " ".join(f.message for f in found)
    assert "'k_launch'" in msgs and "'k_scratch'" in msgs
    assert "no ref.py plain version" in msgs


def test_kernel_good_pairs_through_an_autograd_class_and_an_alias():
    root = os.path.join(FIX, "kernel_good")
    assert run_analysis([root], root=root, rules=[KernelOracleRule()]) == []


@pytest.mark.parametrize("drop,where", [
    ("tests/test_torch_kgood.py", "tests/test_torch_"),
    ("chip_smoke.py", "chip_smoke.py")])
def test_kernel_pair_must_be_exercised_in_tests_and_on_the_card(
        tmp_path, drop, where):
    root = tmp_path / "kernel_good"
    shutil.copytree(os.path.join(FIX, "kernel_good"), root)
    (root / drop).write_text("from pkg.kernels import ops\n\nops.k_op\n")
    found = run_analysis([str(root)], root=str(root),
                         rules=[KernelOracleRule()])
    assert len(found) == 2 and all(where in f.message for f in found)


# ---------------------------- the copied rules on the reference's fixtures --
@pytest.mark.parametrize("name,rules,jrules", [
    ("fault_bad", [FaultKindRule()], [JFaultKind()]),
    ("fault_good", [FaultKindRule()], [JFaultKind()]),
    ("decision_bad.py", [DeadDecisionFieldRule()], [JDeadField()]),
    ("decision_good.py", [DeadDecisionFieldRule()], [JDeadField()]),
    # the framework's suppression: an allow() of another rule does not
    # suppress (the reference's prng rule, run by the port's framework)
    ("suppress_wrong.py", [JPrngReuse()], [JPrngReuse()])])
def test_copied_rules_match_the_reference_on_its_fixtures(name, rules,
                                                          jrules):
    path = os.path.join(JFIX, name)
    root = path if os.path.isdir(path) else JFIX
    got = [(f.rule, f.path, f.line)
           for f in run_analysis([path], root=root, rules=rules)]
    want = [(f.rule, f.path, f.line)
            for f in jrun_analysis([path], root=root, rules=jrules)]
    assert got == want
    assert bool(got) == ("bad" in name or "wrong" in name)


def test_default_rules_have_no_jax_counterparts():
    names = {r.name for r in default_rules()}
    assert names == {"host-sync-in-hot-path", "global-rng", "kernel-oracle",
                     "fault-kind", "dead-decision-field", "tracked-bytecode"}


# ------------------------------------------------------------------ CLI ----
def _cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)


def test_cli_strict_exits_nonzero_on_findings_and_zero_without():
    bad = _cli("--strict", os.path.join(FIX, "rng_bad.py"))
    assert bad.returncode == 1 and "global-rng" in bad.stdout
    loose = _cli(os.path.join(FIX, "rng_bad.py"))
    assert loose.returncode == 0 and "global-rng" in loose.stdout
    good = _cli("--strict", os.path.join(FIX, "rng_good.py"))
    assert good.returncode == 0, good.stdout


def test_cli_json_output():
    proc = _cli("--json", os.path.join(FIX, "rng_bad.py"))
    rows = json.loads(proc.stdout)
    assert len(rows) == 8 and all(r["rule"] == "global-rng" for r in rows)
    assert {"rule", "path", "line", "message"} <= set(rows[0])


# ------------------------------------------------------ the tier-1 gate ----
def test_port_tree_is_finding_free():
    """``python -m repro_torch.analysis --strict`` over its default paths
    (the port's package, ``chip_smoke.py`` and ``kernel_times.py``) stays
    clean: hot paths free of unannotated syncs, every kernel paired with
    its plain version in the tests and on the card, draws from explicit
    generators, fault kinds handled, no dead controller fields."""
    paths = [os.path.join(ROOT, p) for p in DEFAULT_PATHS]
    assert all(os.path.exists(p) for p in paths)
    found = run_analysis(paths, root=ROOT)
    assert found == [], "\n" + "\n".join(f.format() for f in found)
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout
