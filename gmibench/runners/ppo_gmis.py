"""Synchronous PPO over the GMIs of one card, driven through the port's
multi-GMI launcher loop, ``repro_torch.launch.steps.train_gmis``.

The program is built as ``launch/train.py --workload drl`` builds it: a
TCG_EX layout of ``gmis`` holistic GMIs on one card
(``core/placement.py::plan_tcg_ex_training``), each in a green context of
its share of the SMs (the whole card, on a stream of its own, for one
GMI); the env on the env megakernel; the step from
``make_drl_train_step`` with the fused kernels on, its gradient sync a
``GradTap``; dispatch on the GMIs' streams.

Set-up makes every input from the seed (the policy's params, Adam's
state, every env's state and observation, each GMI's generator), hands
them to ``train_gmis`` and runs its first ``CHECKED`` iterations one call
at a time, reading the losses, and after the first every env's
observation, each GMI's first gradient as its optimizer got it and its
Adam first moment, and the params' change after the last; they are also
the warm-up.
The window then calls ``train_gmis`` one iteration at a time on the same
state until its seconds have passed.  With tracing, a few more
iterations run under the profiler, each GMI's step inside a range of the
benchmark's own.  Once the program's state is freed, the reference
(``references/ppo_chain.py``) follows the checked iterations from the
same inputs, and the readings are compared (``compare.py``).
"""
from __future__ import annotations

import itertools
import math
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from gmibench import trace as tr
from gmibench.references import ppo_chain as ref

CHECKED = 3
TRACE_ITERATIONS = 3


class GradTap:
    """The launcher's gradient sync (``sync``; None for none), passed
    through, that while armed keeps the first gradient each GMI's step
    hands its optimizer.  ``step`` wraps the train step so that the tap
    knows, by the env state it is given, which GMI a call serves, on
    whichever thread it runs."""

    def __init__(self, sync=None):
        self.sync = sync
        self.gmi_of = None        # id of each GMI's env state, while armed
        self.first = {}
        self.local = threading.local()

    def arm(self, states):
        self.gmi_of = {id(s[2]): i for i, s in enumerate(states)}
        self.first = {}

    def disarm(self) -> dict:
        """Stops recording; the first gradient of each GMI, by index."""
        self.gmi_of = None
        first, self.first = self.first, {}
        return first

    def step(self, inner):
        def step(*args, **kw):
            if self.gmi_of is not None:
                self.local.gmi = self.gmi_of.get(id(args[2]))
            return inner(*args, **kw)
        return step

    def __call__(self, grads):
        if self.sync is not None:
            grads = self.sync(grads)
        if self.gmi_of is not None:
            i = getattr(self.local, "gmi", None)
            if i is not None and i not in self.first:
                self.first[i] = grads
        return grads


class Program(NamedTuple):
    grid: object
    env: object
    step: object
    tap: GradTap
    k: int
    n: int
    T: int


def build(cfg: dict, traffic: dict, device) -> Program:
    """The program under test for this configuration and traffic."""
    from repro_torch.comm.api import as_grad_sync
    from repro_torch.core.placement import plan_tcg_ex_training
    from repro_torch.envs import make_env
    from repro_torch.launch import steps
    from repro_torch.rl.ppo import PPOConfig
    device = torch.device(device)
    k = traffic["gmis"]
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    layout = plan_tcg_ex_training(1, k, devices=list(range(max(n_dev, k))),
                                  devices_per_gpu=k, device=device)
    env = make_env(cfg["env"], megakernel=True, device=device)
    p = cfg["ppo"]
    ppo_cfg = PPOConfig(
        num_steps=p["num_steps"], num_epochs=p["num_epochs"],
        num_minibatches=p["num_minibatches"], gamma=p["gamma"],
        lam=p["lam"], clip_eps=p["clip_eps"], vf_coef=p["vf_coef"],
        ent_coef=p["ent_coef"], lr=p["lr"],
        max_grad_norm=p["max_grad_norm"], use_fused_kernels=True)
    # as the launcher does: one GMI takes the layout's communicator (an
    # identity without a mesh), several meet in the parameter average
    tap = GradTap(as_grad_sync(layout.communicator()) if k == 1 else None)
    step, _ = steps.make_drl_train_step(env, ppo_cfg, grad_sync_fn=tap)
    return Program(layout.manager.instance_mesh("holistic"), env,
                   tap.step(step), tap, k, traffic["envs_per_gmi"],
                   p["num_steps"])


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """Every input of a run, from ``seed``: the policy's params (the same
    for every GMI), one stream id an env, one generator seed a GMI."""
    k, n = traffic["gmis"], traffic["envs_per_gmi"]
    words = np.random.SeedSequence(seed).generate_state(k + 1, np.uint64)
    gen = torch.Generator(device).manual_seed(int(words[0]))
    params = ref.init_params(cfg["policy_dims"], gen)
    env_seeds = torch.randint(0, 2 ** 31 - 1, (k * n,), generator=gen,
                              device=device, dtype=torch.int32)
    return {"params": params, "env_seeds": env_seeds,
            "gen_seeds": [int(w) for w in words[1:]]}


def named(tree) -> dict:
    """The program's params (or a tree of their shape) by leaf name."""
    out = {}
    for j, layer in enumerate(tree["trunk"]):
        out[f"trunk.{j}.w"], out[f"trunk.{j}.b"] = layer["w"], layer["b"]
    out["mu.w"], out["mu.b"] = tree["mu"]["w"], tree["mu"]["b"]
    out["log_std"] = tree["log_std"]
    out["value.w"], out["value.b"] = tree["value"]["w"], tree["value"]["b"]
    return out


def program_tree(leaves: dict) -> dict:
    """Leaves by name in the program's params layout."""
    depth = sum(k.startswith("trunk.") for k in leaves) // 2
    return {"trunk": [{"w": leaves[f"trunk.{j}.w"],
                       "b": leaves[f"trunk.{j}.b"]} for j in range(depth)],
            "mu": {"w": leaves["mu.w"], "b": leaves["mu.b"]},
            "log_std": leaves["log_std"],
            "value": {"w": leaves["value.w"], "b": leaves["value.b"]}}


def program_states(prog: Program, cfg: dict, inputs: dict) -> list:
    """Each GMI's ``[params, opt_state, env_state, obs, generator]`` from
    the inputs, as ``train_gmis`` takes them."""
    from repro_torch.envs.base import EnvState
    from repro_torch.optim import AdamState
    dev = inputs["env_seeds"].device
    with ref.matmul_precision("fp32"):
        st, obs = ref.reset(ref.Env(cfg, dev), inputs["env_seeds"])
    p0 = inputs["params"]
    zeros = lambda: program_tree({k: torch.zeros_like(x)
                                  for k, x in p0.items()})
    states = []
    for i in range(prog.k):
        rows = slice(i * prog.n, (i + 1) * prog.n)
        params = program_tree({k: x.clone() for k, x in p0.items()})
        opt = AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                        zeros(), zeros())
        env_state = EnvState(*[st[f][rows].clone() for f in EnvState._fields])
        gen = torch.Generator(dev).manual_seed(inputs["gen_seeds"][i])
        states.append([params, opt, env_state, obs[rows].clone(), gen])
    return states


def iterate(prog: Program, states: list, step=None) -> list:
    """One iteration of every GMI through ``train_gmis``; each GMI's loss."""
    from repro_torch.launch import steps
    out = steps.train_gmis(prog.grid, prog.env, step or prog.step, prog.T,
                           prog.k * prog.n, 1, dispatch="streams",
                           states=states)
    return [m["loss"] for m in out["metrics"][0]]


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(x.double()))
            for k, x in leaves.items()}


def checked(prog: Program, states: list, inputs: dict) -> dict:
    """The first ``CHECKED`` iterations, read as the reference reads its
    own (``references/ppo_chain.run``)."""
    losses, grads, moments, obs = [], None, None, None
    for it in range(CHECKED):
        if it == 0:
            prog.tap.arm(states)
        losses.append(iterate(prog, states))
        if it == 0:
            first = prog.tap.disarm()
            # a GMI whose optimizer got no gradient reads none
            grads = [_norms(named(first[i])) if i in first else {}
                     for i in range(prog.k)]
            moments = [_norms(named(s[1].mu)) for s in states]
            obs = torch.cat([s[3] for s in states]).cpu().numpy()
    now = named(states[0][0])
    change = _norms({k: now[k] - x for k, x in inputs["params"].items()})
    return {"loss": losses, "obs": obs, "grad": grads, "moment": moments,
            "change": change}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(prog: Program, states: list, seconds: float, dev):
    """Iterations one call at a time until ``seconds`` have passed.
    Returns (iterations, seconds from the start to the synchronise that
    ends the last, GMI-iterations whose loss is not finite)."""
    _sync(dev)
    t0 = time.perf_counter()
    iters = bad = 0
    while True:
        losses = iterate(prog, states)
        iters += 1
        bad += sum(not math.isfinite(x) for x in losses)
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return iters, elapsed, bad


def traced(prog: Program, states: list, iterations: int) -> tr.Trace:
    """``iterations`` more iterations under the profiler's device trace,
    each GMI's step timed by the host's clock, then one more with the
    host's operations traced, each call of ``train_gmis`` inside the range
    ``iteration`` and each GMI's step inside ``step.gmi<i>``, to name the
    idle gaps."""
    count = itertools.count()
    step_s = []

    def step(*a):
        i = next(count) % prog.k
        t = time.perf_counter()
        with torch.profiler.record_function(f"{tr.RANGE_PREFIX}step.gmi{i}"):
            out = prog.step(*a)
        step_s.append(time.perf_counter() - t)
        return out

    def run(n):
        def fn():
            for _ in range(n):
                with torch.profiler.record_function(
                        f"{tr.RANGE_PREFIX}iteration"):
                    iterate(prog, states, step)
        return fn
    wall, kernels, _, _, start = tr.profile(run(iterations), host=False)
    measured = list(step_s)
    named = tr.profile(run(1), host=True)
    return tr.Trace(kernels, wall, start, iterations, measured,
                    tr.named_gaps(named[1], named[2], named[3], named[4],
                                  named[0]))


def run(cell, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    """One run of ``cell`` (``spec.Cell``); ``t0`` is the process's start
    on ``time.perf_counter``'s clock."""
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    prog = build(cfg, traffic, dev)
    inputs = make_inputs(cfg, traffic, seed, dev)
    states = program_states(prog, cfg, inputs)
    got = checked(prog, states, inputs)
    setup_s = time.perf_counter() - t0
    iters, window_s, bad = window(prog, states, seconds, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t1 = time.perf_counter()
    prof = traced(prog, states, TRACE_ITERATIONS) if trace else None
    del states, prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    want = ref.run(cfg, traffic, inputs, dev, CHECKED)
    steps_done = iters * traffic["gmis"] * traffic["envs_per_gmi"] \
        * cfg["ppo"]["num_steps"]
    return {"env_steps_per_s": steps_done / window_s, "setup_s": setup_s,
            "window": {"iterations": iters, "seconds": window_s},
            "trace": prof, "attempted": iters * traffic["gmis"],
            "failed": bad, "memory_peak_bytes": int(peak),
            "readings": got, "reference": want,
            "phases_s": {"setup": setup_s, "window": window_s,
                         "trace": t2 - t1,
                         "reference": time.perf_counter() - t2}}
