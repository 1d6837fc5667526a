"""Everything a run needs, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The configuration's file is the one ``BENCHMARK.json`` gives it; the
traffic mix is ``traffic/<traffic>.json`` and names the runner that
drives it (``runners/<runner>.py``); the comparison's limits for the cell
are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``, a module with ``read(ctx)`` that returns a
number or None.  Adding a cell, a configuration, a traffic mix or a
metric adds files and edits none.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    entry: dict          # the cell's entry in BENCHMARK.json
    config: dict         # the configuration's file
    traffic: dict        # the traffic mix's file
    limits: dict         # the comparison's limits
    end_to_end: list     # metric entries the cell reports with --trace 0
    per_layer: list      # and with --trace 1


class Context(NamedTuple):
    """What a per-layer metric's ``read`` gets: the cell's configuration
    and traffic, the measured window (``iterations``, ``seconds``) and the
    traced stretch (``trace.Trace``; None in a run without tracing)."""
    config: dict
    traffic: dict
    window: dict
    trace: object


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    list, else every cell (an end-to-end metric, ``e2e_names`` None) or
    every cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load(cell: str, root: Path = ROOT) -> Cell:
    """Cell ``cell`` of ``root``'s ``BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    here = root / HERE.name
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, cell, names)]
    return Cell(cell, entry, _json(root / conf["file"]),
                _json(here / "traffic" / f"{entry['traffic']}.json"),
                _json(here / "limits" / f"{cell}.json"), e2e, per_layer)


def runner(cell: Cell) -> ModuleType:
    """The module that drives ``cell``'s traffic."""
    return importlib.import_module(
        f"{__package__}.runners.{cell.traffic['runner']}")


def reader(metric: str, root: Path = ROOT) -> ModuleType:
    """The module that reads per-layer metric ``metric``."""
    path = root / HERE.name / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
