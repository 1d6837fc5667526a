"""What a run loads: no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` begins with ``repro``
and is allowed), and a reference that loads nothing of the program."""
import json
import os
import subprocess
import sys

from _tiny import ROOT

RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
sys.path.insert(0, {tests!r})
from _tiny import run_cpu, tiny
from gmibench import run
line = run_cpu(tiny("humanoid.ppo.gmi4", envs=4))
print(json.dumps({{"found": run.forbidden_modules(),
                   "correct": line["correct"],
                   "torch": "repro_torch" in sys.modules}}))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
from gmibench.references import ppo_chain
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0].startswith("repro"))))
"""


def _last_line(code):
    env = dict(os.environ, PYTHONHASHSEED="0")
    code = code.format(root=str(ROOT), src=str(ROOT / "src"),
                       tests=str(ROOT / "gmibench/tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_run_loads_no_jax():
    got = _last_line(RUN)
    assert got == {"found": [], "correct": True, "torch": True}


def test_reference_loads_nothing_of_the_program():
    assert _last_line(REFERENCE) == []


def test_forbidden_names_are_whole():
    from gmibench import run
    assert run.forbidden_modules({"repro_torch.envs", "jaxtyping",
                                  "flaxen", "torch"}) == []
    assert run.forbidden_modules({"repro.core.gmi", "jax._src",
                                  "jaxlib", "flax.linen"}) == \
        ["flax", "jax", "jaxlib", "repro"]
