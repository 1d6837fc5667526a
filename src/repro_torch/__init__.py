"""PyTorch + CUDA port of the GMI-DRL reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch/envs/physics.py`` pairs
with ``repro/envs/physics.py``.  The port imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.  Five paths run end to end:
synchronous PPO (``rl/ppo.py``), multi-GMI synchronous PPO over the GMI
control plane and LGR (``core/gmi.py``, ``core/placement.py``,
``core/selection.py``, ``comm/``, ``launch/train.py``; GMIs of one
process share the card, one CUDA stream each), asynchronous A3C
over the MCC experience ring (``rl/a3c.py``, ``core/channels.py``,
``launch/async_a3c.py``) with its online GMI controller
(``core/controller.py``), fault injection and fleet supervision
(``fault/inject.py``, ``fault/supervisor.py``) and atomic checkpoints in
the reference's file format (``checkpoint/ckpt.py``), built by
``launch/steps.py``'s ``make_async_runner`` and
``make_fleet_supervisor``, and the paged LLM serving engine
(``serve/engine.py``, ``launch/serve.py``) over the dense model stack
(``models/transformer.py``) and over xlstm's mLSTM and sLSTM blocks
(``models/ssm.py``), with the multi-GMI request router
(``serve/router.py``) and the disaggregated prefill/decode front with
cache migration between GMIs (``serve/disagg.py``,
``core/channels.py::CacheChannel``; ``make_disagg_front``,
``launch/serve.py --disagg``), which the fleet supervisor and the online
controller also drive.  Their eight kernels (env megakernel, fused GAE,
fused policy trunk, n-step return scan, ring pack, paged decode
attention, flash attention, chunkwise mLSTM) are hand-written CUDA for
``sm_90a`` in ``repro_torch/csrc/``, built at first CUDA use.
"""
