"""Step builders, port of ``repro/launch/steps.py``.

The LM half: ``input_specs``, ``abstract_train_state``,
``abstract_cache`` (meta tensors in place of ``ShapeDtypeStruct``) and the
train / prefill / serve step builders, each returning ``(fn,
example_args)``.  The reference's builders take a mesh and jit the step
with its shardings; here the mesh is optional (``launch/mesh.py``), its
specs (``dist/partition.py``) ride on ``fn.specs``, and on one card they
are all replicated, so the step is the plain eager function.

The DRL and serving half (``make_communicator``, ``make_drl_train_step``,
the async factories ``make_experience_pipeline``,
``make_online_controller``, ``make_async_runner``, ``make_disagg_front``
and ``make_fleet_supervisor``), plus the multi-GMI loop that the training
launchers share (:func:`train_gmis`).  The launcher, not the algorithm
module, decides which hot path a step runs (the fused kernels by default)
and how GMIs share the card: each GMI of an instance grid runs its PPO
iteration under its own CUDA stream, and the params are averaged on the
default stream after every iteration.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig, TrainConfig
from repro_torch.dist import partition
from repro_torch.launch.mesh import batch_axes


# ----------------------------------------------------------- input specs ---
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    from repro_torch.models.transformer import torch_dtype
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = torch_dtype(cfg), torch.int32
    if shape.mode == "decode":
        return {"token": _meta((B,), i32), "pos": _meta((B,), i32)}
    if cfg.frontend == "audio":
        return {"features": _meta((B, S, cfg.frontend_feat_dim), dt),
                "mask": _meta((B, S), torch.bool),
                "targets": _meta((B, S), i32)}
    if cfg.frontend == "vision":
        Tt = S - cfg.num_patches
        return {"tokens": _meta((B, Tt), i32), "labels": _meta((B, Tt), i32),
                "patches": _meta((B, cfg.num_patches,
                                  cfg.frontend_feat_dim), dt)}
    return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}


def abstract_train_state(cfg: ModelConfig):
    """(params, Adam state) as meta tensors: params in ``cfg.dtype``, the
    moments f32, the step a 0-d int32."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam_init
    params = T.init_abstract(cfg)
    return params, adam_init(params)


def abstract_cache(cfg: ModelConfig, shape: InputShape,
                   window_override: Optional[int] = None,
                   per_layer: bool = False):
    from repro_torch.models import transformer as T
    return T.init_cache(cfg, shape.global_batch, shape.seq_len,
                        window_override, device="meta", per_layer=per_layer)


def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[InputShape] = None,
                    train_cfg: TrainConfig = TrainConfig(),
                    lgr: str = "har", moe_spec: str = "contract"):
    """The LM training step ``fn(params, opt_state, batch) -> (params,
    opt_state, {"loss"})``: the gradient of ``loss_fn`` (``remat`` from
    ``train_cfg``), accumulated over ``train_cfg.microbatches`` splits of
    the batch in f32 (each micro-gradient divided by M, one optimizer
    update), then ``adam_update`` with ``train_cfg``'s lr, betas, weight
    decay and clip.  Params may be f32 masters of a bf16 ``cfg``: every
    layer casts its weights to the activation type.  Returns ``(fn,
    (params, opt_state, batch))`` as meta tensors (``shape`` needed for the
    batch); ``fn.specs`` holds the mesh's param and batch specs (``lgr ==
    "har"``: FSDP over ``data``)."""
    from repro_torch.models import transformer as T
    from repro_torch.optim import adam_update
    from repro_torch.utils import tree_flatten, tree_unflatten
    params_sds, opt_sds = abstract_train_state(cfg)
    batch_sds = input_specs(cfg, shape) if shape is not None else None
    M = max(train_cfg.microbatches, 1)

    def value_and_grad(params, batch):
        flat, spec = tree_flatten(params)
        leaves = [p.detach().requires_grad_() for p in flat]
        loss = T.loss_fn(tree_unflatten(leaves, spec), cfg, batch,
                         remat=train_cfg.remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), tree_unflatten(list(grads), spec)

    def train_step(params, opt_state, batch):
        if M == 1:
            lval, grads = value_and_grad(params, batch)
        else:
            # gradient accumulation: activation memory scales 1/M, one
            # optimizer update
            B = next(iter(batch.values())).shape[0]
            if B % M:
                raise ValueError(f"batch of {B} does not split into {M} "
                                 "microbatches")
            grads = None
            lval = torch.zeros((), device=opt_state.step.device)
            for i in range(M):
                mb = {k: v[i * (B // M):(i + 1) * (B // M)]
                      for k, v in batch.items()}
                lv, g = value_and_grad(params, mb)
                g = [x.float() / M for x in tree_flatten(g)[0]]
                grads = g if grads is None else \
                    [a + b for a, b in zip(grads, g)]
                lval = lval + lv / M
            grads = tree_unflatten(grads, tree_flatten(params)[1])
        params, opt_state = adam_update(
            grads, opt_state, params, lr=train_cfg.learning_rate,
            beta1=train_cfg.beta1, beta2=train_cfg.beta2,
            weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip)
        return params, opt_state, {"loss": lval.float()}

    train_step.specs = None if mesh is None else {
        "params": partition.param_specs(params_sds, mesh, fsdp=lgr == "har",
                                        moe_spec=moe_spec),
        "batch": partition.batch_specs(batch_sds or {}, mesh,
                                       batch_axes=batch_axes(mesh))}
    return train_step, (params_sds, opt_sds, batch_sds)


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      shape: Optional[InputShape] = None,
                      window_override: Optional[int] = None):
    """``fn(params, batch) -> (last-position logits f32, caches)`` for
    prompts of ``shape.seq_len``.  Returns ``(fn, (params, batch))``."""
    from repro_torch.models import transformer as T
    params_sds = T.init_abstract(cfg)
    batch_sds = input_specs(cfg, shape)

    @torch.no_grad()
    def prefill_step(params, batch):
        logits, caches = T.prefill(params, cfg, batch, shape.seq_len,
                                   window_override)
        return logits.float(), caches

    prefill_step.specs = None if mesh is None else {
        "params": partition.param_specs(params_sds, mesh, fsdp=False),
        "batch": partition.batch_specs(batch_sds, mesh,
                                       batch_axes=batch_axes(mesh)),
        "cache": partition.cache_specs(
            abstract_cache(cfg, shape, window_override), mesh,
            batch_shardable=shape.global_batch > 1)}
    return prefill_step, (params_sds, batch_sds)


def make_serve_step(cfg: ModelConfig, mesh=None,
                    shape: Optional[InputShape] = None,
                    window_override: Optional[int] = None,
                    cache_layout: str = "heads", params_fsdp: bool = False,
                    per_layer_cache: bool = False):
    """One decode step over a ``shape.seq_len``-deep cache: ``fn(params,
    caches, token, pos) -> (logits f32, caches)``, caches written in
    place.  ``per_layer_cache`` (local/global archs only) takes a list of
    per-layer caches, each sized to its own window.  Returns ``(fn,
    (params, caches, token, pos))``."""
    from repro_torch.models import transformer as T
    per_layer_cache = per_layer_cache and cfg.local_global \
        and not cfg.block_pattern
    params_sds = T.init_abstract(cfg)
    cache_sds = abstract_cache(cfg, shape, window_override,
                               per_layer=per_layer_cache)
    tok_sds = input_specs(cfg, shape)

    @torch.no_grad()
    def serve_step(params, caches, token, pos):
        logits, caches = T.decode_step(params, cfg, token, pos, caches,
                                       window_override)
        return logits.float(), caches

    serve_step.specs = None if mesh is None else {
        "params": partition.param_specs(params_sds, mesh, fsdp=params_fsdp),
        "cache": partition.cache_specs(
            cache_sds, mesh, batch_shardable=shape.global_batch > 1,
            layout=cache_layout),
        "batch": partition.batch_specs(tok_sds, mesh,
                                       batch_axes=batch_axes(mesh))}
    return serve_step, (params_sds, cache_sds, tok_sds["token"],
                        tok_sds["pos"])


# how the host issues the GMIs' iterations: one thread in turn on their
# own streams, or one thread in turn on the default stream (the
# reference's loop)
DISPATCH_MODES = ("streams", "sequential")


def make_communicator(layout, cost_model=None, *, average: bool = True,
                      with_mesh: bool = False, calibrate: bool = False):
    """The layout's ``repro_torch.comm.Communicator``: instance grid off the
    trainer MPL (incl. the trailing ``dev`` axis for multi-device GMIs),
    strategy from Algorithm 1 — or Table-2 cost-scored when a
    ``ReduceCostModel`` is supplied.  ``None`` for serving-only layouts.
    ``calibrate=True`` attaches a ``BandwidthCalibrator`` so measured
    reduce/transfer timings replace the model's static per-axis
    bandwidth defaults once the Table-2 inversion is conditioned."""
    comm = layout.communicator(cost_model, average=average,
                               with_mesh=with_mesh)
    if comm is not None and calibrate:
        comm.enable_calibration()
    return comm


def make_drl_train_step(env, ppo_cfg=None, grad_sync_fn=None,
                        fused: Optional[bool] = None, communicator=None):
    """Sync-PPO iteration with the fused hot path on by default: the env
    megakernel (with a megakernel env), the fused trunk, and the gae_scan
    kernel (GAE + advantage normalization in one launch) with
    single-gather minibatches.  An explicit ``ppo_cfg`` keeps its own
    ``use_fused_kernels`` unless ``fused`` explicitly overrides it.
    Gradient sync comes from ``communicator`` (a
    ``repro_torch.comm.Communicator``) when given, else ``grad_sync_fn``.
    Returns ``(step, cfg)``."""
    from repro_torch.rl.ppo import PPOConfig, make_train_step
    cfg = ppo_cfg if ppo_cfg is not None \
        else PPOConfig(use_fused_kernels=True)
    if fused is not None and fused != cfg.use_fused_kernels:
        cfg = cfg._replace(use_fused_kernels=fused)
    if communicator is not None and communicator.mesh is not None:
        # a mesh-attached Communicator's sync closure is the collective one
        # of a torch.distributed rank: failing here beats a missing-group
        # error deep inside the first minibatch
        raise TypeError(
            "make_drl_train_step builds a per-instance step; a "
            "mesh-attached Communicator's sync closure is SPMD-only (use "
            "Communicator.allreduce over grid-stacked gradients, or a "
            "mesh-less Communicator here)")
    sync = communicator if communicator is not None else grad_sync_fn
    return make_train_step(env, cfg, sync), cfg


def init_gmis(grid, env, num_env: int, seed: int = 0, *,
              on_streams: bool = True):
    """Each GMI's PPO state for :func:`train_gmis`: GMI ``i`` (row-major
    over the instance grid) holds ``[params, opt_state, env_state, obs]``
    from ``init_train(seed + i)`` on ``num_env // n`` envs, drawn under its
    own stream on the card unless ``on_streams`` is false."""
    from repro_torch.rl.ppo import init_train
    ctxs = list(grid.contexts)
    n = len(ctxs)
    states = []
    for i, c in enumerate(ctxs):
        with _scope(c, on_streams):
            if on_streams and c.stream is not None:
                # the env's constants
                c.stream.wait_stream(torch.cuda.current_stream(grid.device))
            states.append(list(init_train(seed + i, env,
                                          env.spec.policy_dims,
                                          num_envs=num_env // n,
                                          device=grid.device)))
    return states


def _scope(ctx, on_streams):
    return ctx.scope() if on_streams else contextlib.nullcontext()


def train_gmis(grid, env, step, num_steps: int, num_env: int, iters: int,
               seed: int = 0, *, dispatch: str = "streams",
               log_every=None, states=None):
    """Synchronous PPO over the GMIs of an instance grid
    (``GMIManager.instance_mesh``): GMI ``i`` (row-major over the grid)
    runs ``step`` (from :func:`make_drl_train_step`, ``num_steps`` env
    steps an iteration) on ``num_env // n`` envs, and after every
    iteration the params are averaged (equivalent to averaged gradients
    for identical optimizer states).  ``states`` (from :func:`init_gmis`,
    updated in place) carries the GMIs on from an earlier call; without it
    they start from ``init_gmis(grid, env, num_env, seed)``.

    ``dispatch`` (one of :data:`DISPATCH_MODES`) says how the host issues
    the GMIs' iterations, one after another.  On the card each GMI's
    stream first waits for the default stream (the averaged params), and
    the default stream waits for every GMI's stream before it averages;
    tensors read across streams are marked with ``record_stream``.  Every
    GMI draws from its own generator, so both modes compute the same
    params.

    Returns a dict: ``params`` (the averaged params), ``metrics`` (each
    iteration's per-GMI metrics, as floats), ``iter_s`` (each iteration's
    wall seconds, synchronised) and ``steps_per_s`` (all iterations)."""
    from repro_torch.utils import tree_leaves, tree_map
    if dispatch not in DISPATCH_MODES:
        raise ValueError(f"dispatch must be one of {DISPATCH_MODES}, got "
                         f"{dispatch!r}")
    dev = grid.device
    ctxs = list(grid.contexts)
    n = len(ctxs)
    on_streams = dispatch == "streams" and ctxs[0].stream is not None
    streams = [c.stream for c in ctxs] if on_streams else [None] * n
    main = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    def sync():
        if main is not None:
            torch.cuda.synchronize(dev)

    if states is None:
        states = init_gmis(grid, env, num_env, seed, on_streams=on_streams)

    def run(i):
        with _scope(ctxs[i], on_streams):
            if streams[i] is not None:
                streams[i].wait_stream(main)      # the averaged params
            out = step(*states[i])
            states[i][:] = out[:5]
            return out[5]

    history, iter_s = [], []
    sync()
    t0 = time.perf_counter()
    for it in range(iters):
        ti = time.perf_counter()
        metrics = [run(i) for i in range(n)]
        for s in streams:
            if s is not None:
                main.wait_stream(s)
        if n > 1:
            params = [st[0] for st in states]
            if on_streams:
                for p in params:
                    for x in tree_leaves(p):
                        x.record_stream(main)
            mean_p = tree_map(lambda *xs: sum(xs) / n, *params)
            for i, s in enumerate(streams):
                if s is not None:
                    for x in tree_leaves(mean_p):
                        x.record_stream(s)
                states[i][0] = mean_p
        sync()
        iter_s.append(time.perf_counter() - ti)
        history.append([{k: float(v) for k, v in m.items()}
                        for m in metrics])
        if log_every and it % log_every == 0:
            done = (it + 1) * num_steps * num_env
            rm = sum(m["reward_mean"] for m in history[-1]) / n
            print(f"iter {it:4d} reward_mean={rm:8.3f} "
                  f"steps/s={done / (time.perf_counter() - t0):,.0f}")
    elapsed = time.perf_counter() - t0
    return {"params": states[0][0], "metrics": history, "iter_s": iter_s,
            "steps_per_s": iters * num_steps * num_env / elapsed}


def make_experience_pipeline(layout, batch_mode: str = "stack",
                             batch_envs: Optional[int] = None,
                             overlap: bool = False):
    """Device-resident MCC pipeline wired from an async placement layout:
    ring slots sized to the layout's serving GMIs and the per-GMI GPU map
    passed through so the Migrator can direct-forward same-GPU groups.
    ``overlap=True`` double-buffers the rings so a flush is a buffer swap
    (paper §4.1 serve/train overlap)."""
    from repro_torch.core.channels import MultiChannelPipeline
    gmi_gpu = {g.gmi_id: g.gpu_id for g in layout.manager.gmis.values()}
    return MultiChannelPipeline(layout.serving_gmis, layout.trainer_gmis,
                                gmi_gpu=gmi_gpu, batch_mode=batch_mode,
                                batch_envs=batch_envs, overlap=overlap)


def make_online_controller(layout, num_env: int, controller_cfg=None,
                           communicator=None):
    """Online Algorithm-2 controller seeded from an async placement
    layout: the live (serving_gpus, gmi_per_gpu, num_env) become the first
    measured configuration; the controller then re-plans the layout
    between training epochs from measured throughput and ring occupancy
    (``repro_torch.core.controller``).  With a ``communicator`` attached,
    measured reduce times can also re-plan the LGR strategy."""
    from repro_torch.core.controller import OnlineGMIController
    gmis = layout.manager.gmis.values()
    serving_gpus = {g.gpu_id for g in gmis if g.role == "serving"}
    all_gpus = {g.gpu_id for g in gmis}
    per_gpu = {}
    for g in gmis:
        per_gpu[g.gpu_id] = per_gpu.get(g.gpu_id, 0) + 1
    return OnlineGMIController(
        num_gpu=len(all_gpus), serving_gpus=max(len(serving_gpus), 1),
        gmi_per_gpu=max(per_gpu.values()), num_env=num_env,
        cfg=controller_cfg, communicator=communicator)


def make_async_runner(env, layout, overlap: bool = False,
                      online_controller: bool = False,
                      controller_cfg=None, communicator=None,
                      calibrate: bool = False, megakernel: bool = False,
                      device="cuda", **kwargs):
    """Async A3C runner over ``make_experience_pipeline(layout)`` on
    ``device`` (``env`` must live there).

    ``megakernel=True`` puts the env on the fused env step
    (``VectorEnv.with_megakernel``); on a blocking pipeline the runner
    then produces experience straight into the ring slots
    (``rl.rollout.collect_ring``).  ``overlap=True`` runs the
    double-buffered pipeline; ``online_controller=True`` attaches an
    Algorithm-2 controller that re-plans the layout between epochs from
    live stats.  ``communicator=True`` builds the layout's Communicator;
    an explicit one is used as-is.  ``calibrate=True`` enables
    measured-bandwidth calibration on the communicator (building one from
    the layout if none was asked for).  ``kwargs`` go to ``AsyncRunner``
    (``num_envs``, ``num_steps``, ``seed``, ``lr``,
    ``use_fused_kernels``, ``router``: a serving front that the one
    controller then arbitrates with the trainers and rollout actors)."""
    from repro_torch.rl.a3c import AsyncRunner
    if megakernel:
        env = env.with_megakernel(True)
    if communicator is True or (calibrate and communicator is None):
        communicator = make_communicator(layout, calibrate=calibrate)
    elif calibrate and communicator is not None:
        communicator.enable_calibration()
    controller = None
    layout_builder = None
    if online_controller:
        controller = make_online_controller(
            layout, num_env=kwargs.get("num_envs", 64),
            controller_cfg=controller_cfg, communicator=communicator)
        mgr = layout.manager

        def layout_builder(decision):
            # re-plan inside the SAME device universe the seed layout was
            # built over (logical ids on one card)
            from repro_torch.core.placement import plan_async
            return plan_async(controller.num_gpu, decision.serving_gpus,
                              decision.gmi_per_gpu, devices=mgr.devices,
                              devices_per_gpu=mgr.devices_per_gpu,
                              device=mgr.device)

    return AsyncRunner(env, layout.serving_gmis, layout.trainer_gmis,
                       pipeline=make_experience_pipeline(layout,
                                                         overlap=overlap),
                       overlap=overlap, controller=controller,
                       layout_builder=layout_builder,
                       communicator=communicator or None, device=device,
                       **kwargs)


def make_disagg_front(cfg, params, *, decode_engines: int = 2,
                      prefill_gmis: int = 1, max_slots: int = 4,
                      max_seq: int = 128,
                      window_override: Optional[int] = None,
                      communicator=None, latency_s: float = 100e-6,
                      min_gain: float = 1.05, device="cuda",
                      manager=None):
    """Disaggregated serving front: ``decode_engines`` continuous-batching
    decode GMIs behind a ``RequestRouter`` plus ``prefill_gmis`` prefill
    specialists, joined by a ``CacheChannel``, with the per-request
    migrate-vs-local decision priced by a ``MigrationPlanner`` in Table-2
    units (a ``communicator`` supplies calibrated bandwidths; the
    channel's own measured transfers sharpen them).  Both
    sides get factories, so ONE controller decision can re-split
    prefill/decode at runtime.  Pass the front as ``router=`` to
    :func:`make_async_runner` / :func:`make_fleet_supervisor` to put it
    under the single Algorithm-2 arbiter.

    ``params`` are moved to ``device`` and cast to ``cfg.dtype`` once, and
    every engine shares them.  With a ``manager``
    (``core/gmi.py::GMIManager``), each engine the factories build is a
    GMI of its own (role ``"serving"`` for decode, ``"prefill"`` for the
    specialists, on GPU 0, one logical device of its pool each) and runs
    under that GMI's stream (``manager.submesh``: a CUDA stream on the
    card); without one every engine runs on the current stream."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import (DisaggFront, MigrationPlanner,
                                   PrefillEngine, RequestRouter,
                                   ServeEngine)
    from repro_torch.utils import resolve_device, tree_map
    dev = resolve_device(manager.device if manager is not None else device)
    params = T.cast_params(tree_map(lambda t: t.to(dev), params), cfg)

    def gmi(role):
        if manager is None:
            return None
        gid = max(manager.gmis, default=-1) + 1
        manager.add_gmi(gid, role, 1.0 / manager.devices_per_gpu)
        manager.set_gpu(gid, 0)
        return manager.submesh(gid)

    def engine_factory(i, slots=max_slots):
        return ServeEngine(cfg, params, max_slots=slots, max_seq=max_seq,
                           window_override=window_override, device=dev,
                           gmi=gmi("serving"), name=f"decode{i}")

    def prefill_factory(i):
        return PrefillEngine(cfg, params, max_seq=max_seq,
                             window_override=window_override, device=dev,
                             gmi=gmi("prefill"), name=f"prefill{i}")

    router = RequestRouter(engine_factory=engine_factory,
                           num_engines=decode_engines)
    planner = MigrationPlanner(communicator=communicator,
                               latency_s=latency_s, min_gain=min_gain)
    return DisaggFront(
        router, [prefill_factory(i) for i in range(max(prefill_gmis, 1))],
        planner=planner, prefill_factory=prefill_factory)


def make_fleet_supervisor(env, layout, *, plan=None, router=None,
                          ckpt_dir: Optional[str] = None,
                          ckpt_every: int = 0, probation: int = 2,
                          max_retries: int = 2, overlap: bool = False,
                          online_controller: bool = False, **kwargs):
    """Fault-tolerant fleet over an async placement layout: a
    :func:`make_async_runner` runner wrapped in a
    :class:`repro_torch.fault.FleetSupervisor` — injection hooks armed at
    every seam, per-round failure classification, GPU quarantine with
    probation-gated re-admission, lossless re-plans onto the surviving
    pool, and (with ``ckpt_dir``/``ckpt_every``) periodic preemption-safe
    checkpoints.  ``plan`` is an optional
    :class:`repro_torch.fault.FaultPlan`; ``router`` an optional serving
    front (``RequestRouter`` or ``DisaggFront``) to supervise too — it is
    ALSO handed to the runner, so the one controller instance arbitrating
    trainers and rollout actors folds the serving epochs into the same
    Algorithm-2 loop.  ``kwargs`` go to :func:`make_async_runner`
    (``device`` among them)."""
    from repro_torch.fault import FleetSupervisor
    runner = make_async_runner(env, layout, overlap=overlap,
                               online_controller=online_controller,
                               router=router, **kwargs)
    return FleetSupervisor(runner, layout, plan=plan, router=router,
                           ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                           probation=probation, max_retries=max_retries)
