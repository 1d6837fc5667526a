"""The benchmark finds its cells, configurations, traffic mixes, limits
and per-layer metrics by name, so that later ones come as new files."""
import json
import re
import shutil

import pytest

from _tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    from gmibench import compare, spec
    c = spec.load(cell)
    assert NAME.match(cell) and c.entry["chips"] in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.limits) == set(compare.NUMBERS)
    assert spec.runner(c).run
    for m in c.per_layer:
        assert spec.reader(m["name"]).read


def test_added_files_are_found(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric,
    added as files and entries, load with no existing file edited."""
    from gmibench import spec
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gmibench", root / "gmibench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "gmibench").rglob("*")
              if p.is_file()}
    cfg = json.loads((root / "gmibench/configs/shadowhand.json").read_text())
    cfg["name"] = "ant"
    (root / "gmibench/configs/ant.json").write_text(json.dumps(cfg))
    (root / "gmibench/traffic/ppo.gmi2.env8192.json").write_text(
        json.dumps({"runner": "ppo_gmis", "gmis": 2, "envs_per_gmi": 8192}))
    (root / "gmibench/limits/ant.ppo.gmi2.json").write_text(json.dumps(
        {"loss_gap": 1.0, "obs_gap": 1.0, "grad_gap": 1.0,
         "moment_gap": 1.0, "change_gap": 1.0}))
    (root / "gmibench/metrics/ppo.new_ms.py").write_text(
        "def read(ctx):\n    return ctx.window['seconds'] * 2\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="ant",
                                 file="gmibench/configs/ant.json"))
    bench["workloads"].append({"name": "ant.ppo.gmi2", "config": "ant",
                               "traffic": "ppo.gmi2.env8192", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "ppo.new_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "PPO update",
                               "moves": "env_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load("ant.ppo.gmi2", root)
    assert c.config["name"] == "ant" and c.traffic["gmis"] == 2
    # a metric without ``workloads`` goes to every cell reporting the
    # end-to-end metric it moves; the others keep their lists
    assert [m["name"] for m in c.per_layer] == ["ppo.new_ms"]
    ctx = spec.Context(c.config, c.traffic, {"seconds": 1.5}, None)
    assert spec.reader("ppo.new_ms", root).read(ctx) == 3.0
    old = spec.load("shadowhand.ppo.gmi1", root)
    assert "ppo.new_ms" in [m["name"] for m in old.per_layer]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_benchmark_json_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gmibench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names) and all(map(NAME.match, names))
    for m in BENCH["per_layer"]:
        assert m["moves"] == "env_steps_per_s"
        assert (ROOT / "gmibench/metrics" / f"{m['name']}.py").exists()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
