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

    The reference's online controller, communicator, router, re-planning,
    fault seams and checkpointing are not part of this port yet.
    """

    def __init__(self, env, serving_gmis, trainer_gmis, *, gmi_gpu=None,
                 num_envs: int = 64, num_steps: int = 16, seed: int = 0,
                 lr: float = 3e-4, pipeline=None, overlap: bool = False,
                 use_fused_kernels: bool = False, device="cuda"):
        from repro_torch.core.channels import MultiChannelPipeline
        from repro_torch.models.policy import init_policy
        from repro_torch.optim import adam_init

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
        self.use_fused_kernels = use_fused_kernels
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
        self.rounds = 0

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

    def _train(self, routed):
        """Consume routed trainer batches; returns (losses, staleness)."""
        losses, stale = [], []
        for batches in routed.values():
            for exp in batches:
                # one host read per batch, as in the reference
                stale.append(int(staleness(self.version, exp)))
                self.params, self.opt_state, loss = trainer_update(
                    self.params, self.opt_state, exp, lr=self.lr,
                    use_fused_kernels=self.use_fused_kernels)
                losses.append(loss)
                self.trained_samples += exp.rewards.numel()
                self.version += 1
        # losses stay on the device until this single read
        return (torch.stack(losses).tolist() if losses else []), stale

    def round(self, noise=None):
        """One serve -> ship -> train round; returns (losses, staleness).
        ``noise`` optionally maps each serving GMI to its (T, N, act)
        action noise for this round.

        With overlap on, the trained batches are the previous round's
        flush (the first round returns no losses)."""
        # megakernel envs on blocking rings produce experience straight
        # into the ring slot (collect_ring): no staged Trajectory, no
        # pack_channels re-copy.  Overlap rings stage references, so they
        # keep actor_collect.
        direct = (getattr(self.env, "megakernel", False)
                  and not self.overlap and hasattr(self.pipe, "produce"))
        T, N, sp = self.num_steps, self.num_envs, self.env.spec
        for a in self.serving_gmis:
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
        losses, stale = self._train(self.pipe.flush())
        self.actor_params = self.params        # model push AFTER acting
        self.rounds += 1
        return losses, stale

    def finish(self):
        """Drain the pipeline (both buffer halves in overlap mode) and
        train on the tail; returns (losses, staleness)."""
        losses, stale = self._train(self.pipe.drain())
        self.actor_params = self.params
        return losses, stale
