"""PyTorch + CUDA port of the GMI-DRL reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch/envs/physics.py`` pairs
with ``repro/envs/physics.py``.  The port imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.  Two paths run end to end:
synchronous PPO (``rl/ppo.py``, ``launch/train.py``) and asynchronous A3C
over the MCC experience ring (``rl/a3c.py``, ``core/channels.py``,
``launch/async_a3c.py``).  Their five kernels (env megakernel, fused GAE,
fused policy trunk, n-step return scan, ring pack) are hand-written CUDA
for ``sm_90a`` in ``repro_torch/csrc/``, built at first CUDA use.
"""
