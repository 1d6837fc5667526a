"""CLI: ``python -m repro_torch.analysis [--strict] [--json] [--root R]
[paths...]``."""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis.core import report, run_analysis

DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "kernel_times.py")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checks (see repro_torch.analysis "
                    "docstring for the rule reference).")
    p.add_argument("paths", nargs="*",
                   help="files/directories to analyze (default: "
                        + " ".join(DEFAULT_PATHS) + " under --root)")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on any finding")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit findings as JSON")
    p.add_argument("--root", default=None,
                   help="repo root for relative paths and project-level "
                        "context (default: cwd)")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root or os.getcwd())
    paths = args.paths or [os.path.join(root, d) for d in DEFAULT_PATHS
                           if os.path.exists(os.path.join(root, d))]
    findings = run_analysis(paths, root=root)
    report(findings, as_json=args.as_json)
    return 1 if (args.strict and findings) else 0


if __name__ == "__main__":
    sys.exit(main())
