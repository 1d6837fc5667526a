"""The comparison that decides ``correct``, on the CPU at a tiny size: the
program's plain path passes against the reference; the controls (the
reference in TF32, and with only its update in TF32, emulated on the
CPU) and each fault a training cell can have, planted under the timed
path, fail."""
import pytest
import torch

from _tiny import SEED, run_cpu, tiny

CELLS = ("shadowhand.ppo.gmi1", "humanoid.ppo.gmi4")


@pytest.mark.parametrize("cell", CELLS)
def test_program_matches_reference(cell):
    line = run_cpu(tiny(cell))
    assert line["correct"], line["checks"]
    # every GMI's first gradient is read, the same as the reference's
    assert line["checks"]["grad_gap"]["value"] < 1e-6, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 2
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"env_steps_per_s", "setup_s"}


@pytest.mark.parametrize("precision", ("tf32", "tf32_update"))
@pytest.mark.parametrize("cell", CELLS)
def test_tf32_control_fails(cell, precision):
    from gmibench import compare
    from gmibench.references import ppo_chain as ref
    from gmibench.runners import ppo_gmis as pg
    c = tiny(cell)
    dev = torch.device("cpu")
    inputs = pg.make_inputs(c.config, c.traffic, SEED, dev)
    want = ref.run(c.config, c.traffic, inputs, dev)
    control = ref.run(c.config, c.traffic, inputs, dev, precision=precision)
    ok, checks = compare.judge(compare.gaps(control, want), c.limits)
    assert not ok, checks


def _unchanged(orig):
    def step(params, opt_state, *rest, **kw):
        out = orig(params, opt_state, *rest, **kw)
        return (params, opt_state) + tuple(out[2:])
    return step


def _half_batch(orig):
    def loss_and_grads(params, batch, cfg, policy_fn):
        return orig(params, [x[:x.shape[0] // 2] for x in batch], cfg,
                    policy_fn)
    return loss_and_grads


def _no_average(orig):
    def train_gmis(grid, env, step, num_steps, num_env, iters, seed=0, *,
                   states, **kw):
        from repro_torch.core.gmi import InstanceGrid
        outs = [orig(InstanceGrid(grid.devices[:, i:i + 1],
                                  grid.axis_names,
                                  grid.gmi_ids[:, i:i + 1], (c,)),
                     env, step, num_steps, num_env // len(states), iters,
                     seed, states=[s], **kw)
                for i, (c, s) in enumerate(zip(grid.contexts, states))]
        return {"metrics": [[o["metrics"][0][0] for o in outs]]}
    return train_gmis


FAULTS = {"state_unchanged": ("repro_torch.rl.ppo", "train_iteration",
                              _unchanged),
          "half_batch": ("repro_torch.rl.ppo", "loss_and_grads",
                         _half_batch),
          "no_exchange": ("repro_torch.launch.steps", "train_gmis",
                          _no_average)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails(fault, monkeypatch):
    import importlib
    mod, attr, wrap = FAULTS[fault]
    m = importlib.import_module(mod)
    monkeypatch.setattr(m, attr, wrap(getattr(m, attr)))
    line = run_cpu(tiny("humanoid.ppo.gmi4"))
    assert not line["correct"], line["checks"]
