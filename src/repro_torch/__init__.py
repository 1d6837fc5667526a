"""PyTorch + CUDA port of the GMI-DRL reproduction (``repro``).

Module paths mirror the JAX package: ``repro_torch/envs/physics.py`` pairs
with ``repro/envs/physics.py``.  The port imports ``torch`` and numpy only,
never ``jax`` and nothing of ``repro``.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; the three hot-path kernels
(env megakernel, fused GAE, fused policy trunk) are hand-written CUDA for
``sm_90a`` in ``repro_torch/csrc/``, built at first CUDA use.
"""
