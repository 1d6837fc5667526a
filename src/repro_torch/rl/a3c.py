"""A3C-style asynchronous DRL training (Mnih et al., ICML'16; GA3C), port
of ``repro/rl/a3c.py``.

The paper's async mode decouples *serving* (experience collection on agent
GMIs) from *training* (policy update on trainer GMIs), connected by the
channel-based experience pipeline (§4.2, ``core/channels.py``).  As in the
reference, the asynchrony is modeled as round-interleaved execution with
an explicit parameter-staleness counter: actors hold a possibly stale
snapshot of the policy; trainers consume experience batches in arrival
order.  Everything runs on one stream of one device; the runner's
``version`` is a Python int.
"""
from __future__ import annotations

import os
import time
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.models.policy import entropy, log_prob, policy_apply
from repro_torch.optim import adam_update
from repro_torch.rl.rollout import collect, collect_ring
from repro_torch.utils import resolve_device, tree_flatten, tree_unflatten


class Experience(NamedTuple):
    """One actor-produced experience batch (the unit shipped over channels)."""
    obs: torch.Tensor        # (T, N, obs_dim)
    actions: torch.Tensor    # (T, N, act_dim)
    rewards: torch.Tensor    # (T, N)
    dones: torch.Tensor      # (T, N)
    bootstrap: torch.Tensor  # (N,) value of last obs under the actor's params
    # params version used to act: a Python int from an actor, a 0-d int32
    # tensor from the Batcher
    actor_version: Union[int, torch.Tensor]


def actor_collect(params, version, env, env_state, obs, gen, num_steps: int,
                  noise: Optional[torch.Tensor] = None):
    """Experience collection on an agent instance (policy serving).
    Returns (exp, env_state, obs)."""
    traj, env_state, obs, last_value = collect(
        params, env, env_state, obs, gen, num_steps, noise=noise)
    exp = Experience(obs=traj.obs, actions=traj.actions, rewards=traj.rewards,
                     dones=traj.dones, bootstrap=last_value,
                     actor_version=version)
    return exp, env_state, obs


def nstep_returns(rewards, dones, bootstrap, gamma: float = 0.99, *,
                  use_fused_kernels: bool = False):
    """Reverse discounted-return scan; ``use_fused_kernels`` routes it
    through ``ops.nstep_returns`` (the n-step kernel on a CUDA tensor)
    instead of the plain loop."""
    if use_fused_kernels:
        from repro_torch.kernels import ops
        # a partial ring snapshot or a Batcher slice is a column view; the
        # kernel reads contiguous rows
        return ops.nstep_returns(rewards.contiguous(), dones.contiguous(),
                                 bootstrap.contiguous(), gamma=gamma)
    from repro_torch.kernels.ref import nstep_returns_ref
    return nstep_returns_ref(rewards, dones, bootstrap, gamma)


def a3c_loss(params, exp: Experience, gamma: float, vf_coef: float,
             ent_coef: float, use_fused_kernels: bool = False):
    # the returns depend on data only: no graph through the scan
    with torch.no_grad():
        rets = nstep_returns(exp.rewards, exp.dones, exp.bootstrap, gamma,
                             use_fused_kernels=use_fused_kernels)
    mu, log_std, value = policy_apply(params, exp.obs)
    adv = rets - value
    lp = log_prob(mu, log_std, exp.actions)
    pg = -(lp * adv.detach()).mean()
    vf = 0.5 * torch.square(adv).mean()
    ent = entropy(log_std).mean()
    return pg + vf_coef * vf - ent_coef * ent, (pg, vf, ent)


def trainer_update(params, opt_state, exp: Experience, *, lr=3e-4,
                   gamma=0.99, vf_coef=0.5, ent_coef=0.01,
                   grad_sync_fn: Optional[Callable] = None,
                   max_grad_norm=1.0, use_fused_kernels=False):
    """Policy update on a trainer instance from one experience batch.
    ``grad_sync_fn`` is a plain callable on the gradient dict.  Returns
    (params, opt_state, loss) with ``loss`` a 0-d tensor."""
    leaves, spec = tree_flatten(params)
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = a3c_loss(tree_unflatten(leaves, spec), exp, gamma, vf_coef,
                       ent_coef, use_fused_kernels)
    grads = tree_unflatten(list(torch.autograd.grad(loss, leaves)), spec)
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    params, opt_state = adam_update(grads, opt_state, params, lr=lr,
                                    beta1=0.9, beta2=0.999,
                                    grad_clip=max_grad_norm)
    return params, opt_state, loss.detach()


def staleness(current_version, exp: Experience):
    """Paper §5.1: async training trades throughput for parameter staleness."""
    return current_version - exp.actor_version


class AsyncRunner:
    """Round-interleaved async A3C over the device-resident MCC pipeline.

    Serving GMIs collect with a (possibly stale) parameter snapshot,
    pushes land in the per-group ring buffers, ``flush`` hands the round's
    experience to the trainers the Migrator picks, and every consumed batch
    advances the parameter version.  A megakernel env on a blocking ring
    produces straight into the ring slot (``collect_ring`` through
    ``MultiChannelPipeline.produce``); otherwise actors collect a staged
    Experience and ``push`` packs it (``ops.pack_channels``).

    ``overlap=True`` double-buffers the rings (paper §4.1): each round
    trains on the PREVIOUS round's experience; call :meth:`finish` at the
    end so the in-flight tail is trained on too.

    An attached :class:`~repro_torch.core.controller.OnlineGMIController`
    observes every round (throughput, ring occupancy, spills) and may hand
    back a re-plan between epochs; :meth:`replan` applies it by draining
    the old pipeline (lossless), rebuilding pipeline and actors under the
    new layout, and keeping model state.  An attached
    :class:`~repro_torch.comm.Communicator` holds the reduction decision
    state: a Decision carrying a ``reduction_strategy`` switches it in
    place.  A mesh-attached Communicator is refused: its sync closure is
    the collective one of a ``torch.distributed`` rank, which this
    one-process trainer cannot run.

    Fault seams (``repro_torch.fault``): ``fault_hook`` is called with
    ``("serving", gmi)`` before each actor collects and ``("trainer",
    gmi)`` before each batch update, and may raise to kill that GMI; a
    dying trainer first re-queues the batch it held and every batch behind
    it (spill, not drop).  With ``nonfinite_guard`` on, a batch whose loss
    is not finite (a poisoned flush) has its update discarded: params,
    Adam state and version stay the objects they were, since
    ``trainer_update`` writes nothing in place, and its samples are
    counted in ``poisoned_samples``.  :meth:`checkpoint` and
    :meth:`restore` write and read the atomic npz-plus-manifest pair of
    ``repro_torch.checkpoint``, in the reference's format.

    A serving front (``router=``, a ``RequestRouter`` or ``DisaggFront``)
    puts serving under the same controller: after each round the
    controller folds the front's telemetry epoch (``take_epoch``) into its
    serving half and the front applies the answer (``apply_decision``),
    the single-arbiter loop that arbitrates trainers, rollout actors,
    prefill GMIs and decode GMIs together.
    """

    def __init__(self, env, serving_gmis, trainer_gmis, *, gmi_gpu=None,
                 num_envs: int = 64, num_steps: int = 16, seed: int = 0,
                 lr: float = 3e-4, pipeline=None, overlap: bool = False,
                 controller=None, layout_builder=None, communicator=None,
                 router=None, use_fused_kernels: bool = False,
                 device="cuda"):
        from repro_torch.core.channels import MultiChannelPipeline
        from repro_torch.models.policy import init_policy
        from repro_torch.optim import adam_init

        if router is not None and not all(
                hasattr(router, a) for a in ("take_epoch", "apply_decision")):
            raise TypeError(
                f"router= takes a serving front (RequestRouter or "
                f"DisaggFront: take_epoch, apply_decision), got "
                f"{type(router).__name__}")
        if communicator is not None and communicator.mesh is not None:
            raise TypeError(
                "AsyncRunner's round-interleaved trainer runs in one "
                "process; a mesh-attached Communicator's sync closure is "
                "the collective one of a torch.distributed rank (SPMD-only; "
                "use Communicator.allreduce over grid-stacked gradients, or "
                "attach a mesh-less Communicator for decision state)")
        self.device = resolve_device(device)
        if env.device != self.device:
            raise ValueError(f"env lives on {env.device}, AsyncRunner asked "
                             f"for {self.device}")
        self.env = env
        self.num_steps = num_steps
        self.num_envs = num_envs
        self.serving_gmis = list(serving_gmis)
        self.lr = lr
        self.seed = seed
        self.overlap = overlap
        self.controller = controller
        self.router = router
        self.layout_builder = layout_builder
        self.communicator = communicator
        self.use_fused_kernels = use_fused_kernels
        if controller is not None and communicator is not None \
                and controller.communicator is None:
            controller.communicator = communicator
        self.pipe = pipeline or MultiChannelPipeline(
            serving_gmis, trainer_gmis, gmi_gpu=gmi_gpu, overlap=overlap)
        gen = torch.Generator(self.device).manual_seed(seed)
        self.params = init_policy(gen, env.spec.policy_dims)
        self.opt_state = adam_init(self.params)
        self.actor_params = self.params        # stale snapshot
        self.version = 0
        self.actors = {}
        self._reset_actors()
        self.predictions = 0
        self.trained_samples = 0
        self.replans = 0
        self.rounds = 0
        self.fault_hook = None
        self.nonfinite_guard = False
        self.poisoned_batches = 0
        self.poisoned_samples = 0

    def _reset_actors(self):
        """Per serving GMI: [env_state, obs, action generator], the env
        reset from seed ``seed + a`` and the actions drawn from
        ``seed + 100 + a``, as the reference keys them."""
        self.actors = {}
        for a in self.serving_gmis:
            reset_gen = torch.Generator(self.device).manual_seed(self.seed + a)
            es, obs = self.env.reset(reset_gen, self.num_envs)
            self.actors[a] = [es, obs, torch.Generator(self.device)
                              .manual_seed(self.seed + 100 + a)]

    # repro: hot
    def _train(self, routed):
        """Consume routed trainer batches; returns (losses, staleness)."""
        losses, stale = [], []
        # a mesh-less communicator's sync closure is the identity, and is
        # not timed: measured reduce seconds enter through
        # RoundSample.reduce_s or Communicator.observe
        sync = None if self.communicator is None \
            else self.communicator.grad_sync_fn
        # flat worklist, so a trainer fault can re-queue the failing batch
        # AND everything not yet consumed
        work = [(dst, exp) for dst, batches in routed.items()
                for exp in batches]
        for i, (dst, exp) in enumerate(work):
            if self.fault_hook is not None:
                try:
                    self.fault_hook("trainer", dst)
                except BaseException:
                    # spill, not drop: this batch's gradient is lost with
                    # the trainer, its experience (and every batch behind
                    # it) rejoins the pipeline for the survivors
                    self.pipe.requeue([e for _, e in work[i:]])
                    raise
            # one host read per batch, as in the reference
            stale.append(int(staleness(self.version, exp)))
            new_params, new_opt, loss = trainer_update(
                self.params, self.opt_state, exp, lr=self.lr,
                grad_sync_fn=sync, use_fused_kernels=self.use_fused_kernels)
            # a sync on the card, once a batch, as the reference reads it
            if self.nonfinite_guard and not bool(torch.isfinite(loss)):
                # discard the poisoned update; version stays put, so
                # staleness accounting is untouched
                self.poisoned_batches += 1
                self.poisoned_samples += exp.rewards.numel()
                continue
            self.params, self.opt_state = new_params, new_opt
            losses.append(loss)
            self.trained_samples += exp.rewards.numel()
            self.version += 1
        # losses stay on the device until this single read
        # repro: allow(host-sync-in-hot-path)
        return (torch.stack(losses).tolist() if losses else []), stale

    # repro: hot
    def round(self, noise=None):
        """One serve -> ship -> train round; returns (losses, staleness).
        ``noise`` optionally maps each serving GMI to its (T, N, act)
        action noise for this round.

        With overlap on, the trained batches are the previous round's
        flush (the first round returns no losses)."""
        # host wall time of the round feeds the controller's ladder
        t0 = time.perf_counter()  # repro: allow(host-sync-in-hot-path)
        # megakernel envs on blocking rings produce experience straight
        # into the ring slot (collect_ring): no staged Trajectory, no
        # pack_channels re-copy.  Overlap rings stage references, so they
        # keep actor_collect.
        direct = (getattr(self.env, "megakernel", False)
                  and not self.overlap and hasattr(self.pipe, "produce"))
        T, N, sp = self.num_steps, self.num_envs, self.env.spec
        for a in self.serving_gmis:
            if self.fault_hook is not None:
                # a kill here loses only THIS GMI's not-yet-collected
                # round; earlier actors' pushes are already ringed and
                # ride the recovery drain
                self.fault_hook("serving", a)
            es, obs, gen = self.actors[a]
            nz = None if noise is None else noise[a]
            if direct:
                # produce() calls the producer before it returns
                def producer(bufs, slot):
                    bufs, es2, obs2, boot = collect_ring(
                        self.actor_params, self.env, es, obs, gen, T, bufs,
                        slot, noise=nz)
                    self.actors[a] = [es2, obs2, gen]
                    return bufs, boot, self.version

                self.pipe.produce(a, T, N, sp.obs_dim, sp.act_dim, producer,
                                  device=self.device)
                self.predictions += T * N
                continue
            exp, es, obs = actor_collect(self.actor_params, self.version,
                                         self.env, es, obs, gen, T, noise=nz)
            self.actors[a] = [es, obs, gen]
            self.predictions += exp.rewards.numel()
            self.pipe.push(a, exp)
        before = self.trained_samples
        losses, stale = self._train(self.pipe.flush())
        self.actor_params = self.params        # model push AFTER acting
        if self.controller is not None:
            decision = self.controller.observe_pipeline(
                self.pipe, samples=self.trained_samples - before,
                # repro: allow(host-sync-in-hot-path)
                dt=time.perf_counter() - t0)
            if decision is not None:
                if decision.layout_changed:
                    self.replan(decision)
                elif decision.reduction_strategy \
                        and self.communicator is not None:
                    # strategy-only re-plan: communication plumbing, no
                    # pipeline drain or actor rebuild
                    self.communicator.switch(decision.reduction_strategy)
        if self.router is not None and self.controller is not None:
            # the serving half of the single-arbiter loop: fold the
            # front's telemetry epoch into the same controller and apply
            # whatever it answers through the thin hook.  A decision
            # captured before this round's rollout re-plan carries a
            # stale seq and is refused by the hook's fence.
            sdec = self.controller.observe_serving(self.router.take_epoch())
            if sdec is not None:
                self.router.apply_decision(sdec, controller=self.controller)
        self.rounds += 1
        return losses, stale

    def finish(self):
        """Drain the pipeline (both buffer halves in overlap mode) and
        train on the tail; returns (losses, staleness)."""
        losses, stale = self._train(self.pipe.drain())
        self.actor_params = self.params
        return losses, stale

    def replan(self, decision, layout=None):
        """Apply a controller Decision between epochs: drain and train on
        everything still buffered (nothing is lost across the re-plan),
        then rebuild the pipeline (carrying the old one's batching, ring
        and overlap configuration) and the actors under the new layout.
        Params, Adam state and version persist; a ``reduction_strategy``
        on the decision also switches the communicator in place.

        An explicit ``layout`` bypasses the controller and layout_builder:
        the FleetSupervisor's recovery path, which plans against the
        reduced (quarantined) pool."""
        if not hasattr(self.pipe, "clone_for"):
            raise TypeError(
                f"online re-planning needs a pipeline with clone_for "
                f"(MultiChannelPipeline), got {type(self.pipe).__name__}")
        if self.controller is not None:
            # staleness fence: a decision emitted before this drain
            # carries the old seq
            self.controller.plan_seq += 1
        self._train(self.pipe.drain())
        if layout is None:
            layout = (self.layout_builder(decision) if self.layout_builder
                      else self.controller.plan_layout(device=self.device))
        if self.communicator is not None:
            # the communicator's grid and cost model track the NEW layout
            self.communicator.rebind(layout)
            strat = getattr(decision, "reduction_strategy", None)
            if strat and strat in self.communicator.candidates():
                self.communicator.switch(strat)
        gmi_gpu = {g.gmi_id: g.gpu_id for g in layout.manager.gmis.values()}
        self.serving_gmis = list(layout.serving_gmis)
        self.pipe = self.pipe.clone_for(layout.serving_gmis,
                                        layout.trainer_gmis, gmi_gpu=gmi_gpu)
        self.num_envs = int(decision.num_env)
        self._reset_actors()
        self.actor_params = self.params
        self.replans += 1
        return layout

    # ------------------------------------------------- preemption safety --
    def _ckpt_template(self):
        return {"params": self.params, "opt_state": self.opt_state,
                "version": self.version}

    def checkpoint(self, directory, step=None, fault_hook=None):
        """Preemption-safe checkpoint: params, Adam state and version as
        the atomic npz+manifest pair (``repro_torch.checkpoint``), with
        counters and the controller's learned tables in the manifest's
        ``extra``.  Returns the checkpoint path prefix."""
        from repro_torch.checkpoint import ckpt
        if step is None:
            step = self.version
        extra = {"predictions": self.predictions,
                 "trained_samples": self.trained_samples,
                 "num_envs": self.num_envs,
                 "rounds": self.rounds}
        if self.controller is not None:
            extra["controller"] = self.controller.state_dict()
        path = os.path.join(directory, f"ckpt_{step}")
        ckpt.save(path, self._ckpt_template(), step=step, extra=extra,
                  fault_hook=fault_hook)
        return path

    def restore(self, directory):
        """Resume from the newest LOADABLE checkpoint in ``directory``.

        Torn pairs (manifest without npz) are invisible to ``ckpt.steps``;
        a pair that is present but unreadable (truncated npz, template
        mismatch) is skipped and the previous step tried.  Returns the
        restored step, or ``None`` when nothing loadable exists."""
        from repro_torch.checkpoint import ckpt
        for step in reversed(ckpt.steps(directory)):
            path = os.path.join(directory, f"ckpt_{step}")
            try:
                tree = ckpt.load(path, self._ckpt_template(),
                                 device=self.device)
                extra = ckpt.load_manifest(path).get("extra") or {}
            except (FileNotFoundError, ValueError, KeyError):
                continue
            self.params = tree["params"]
            self.opt_state = tree["opt_state"]
            self.version = tree["version"]
            self.actor_params = self.params
            self.predictions = int(extra.get("predictions",
                                             self.predictions))
            self.trained_samples = int(extra.get("trained_samples",
                                                 self.trained_samples))
            self.rounds = int(extra.get("rounds", self.rounds))
            new_envs = int(extra.get("num_envs", self.num_envs))
            if new_envs != self.num_envs:
                self.num_envs = new_envs
                self._reset_actors()
            if self.controller is not None and "controller" in extra:
                self.controller.load_state_dict(extra["controller"])
            return step
        return None
