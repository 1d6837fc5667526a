"""repro_torch.analysis — static invariant checks for the PyTorch port
(port of ``repro/analysis``).

``python -m repro_torch.analysis [--strict] [--json] [--root R]
[paths...]`` walks the given paths (default: ``src/repro_torch``,
``chip_smoke.py`` and ``kernel_times.py`` under the root), parses every
``.py`` file, and reports ``file:line`` findings.  ``--strict`` exits
non-zero on any finding; ``tests/test_torch_analysis.py`` gates tier-1
on a clean tree, and ``chip_smoke.py`` runs it on the card's machine.

Rule reference
==============

``host-sync-in-hot-path``
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
    ``torch.cuda.synchronize()`` and event or stream ``.synchronize()``,
    ``np.asarray``/``np.array``, non-constant ``float()``, and
    ``time.*`` calls inside hot code.  Hot = any function under
    ``kernels/`` or one marked with a ``# repro: hot`` comment on (or
    right above) its ``def`` line.  Deliberate syncs (the decode loop's
    single token readback, A3C's one loss read a batch, the build's
    clock) carry ``# repro: allow(host-sync-in-hot-path)``.

``global-rng``
    The port's counterpart of the reference's ``prng-reuse``: JAX keys
    are values that can be consumed twice, a ``torch.Generator`` is
    state that advances, so the discipline that keeps a seeded run
    reproducible is that every draw names its generator.  A torch sampler
    (``randn``, ``rand``, ``randint``, ``randperm``, ``normal``, ...,
    and the in-place ``normal_``/``uniform_``/...) called without
    ``generator=``, or ``torch.manual_seed``/``torch.cuda.manual_seed``,
    is a finding.

``kernel-oracle``
    Every ``extern "C"`` entry in ``csrc/*.cu`` that a module under
    ``kernels/`` binds has a public ``ops.py`` wrapper, that wrapper a
    plain version in ``ref.py``, and the two are exercised together in
    a ``tests/test_torch_*.py`` and in ``chip_smoke.py``.

``fault-kind``
    Every kind in ``fault/inject.py::KINDS`` must be referenced by
    ``fault/supervisor.py`` — injected fault classes the supervisor
    cannot classify would silently break lossless recovery.

``dead-decision-field``
    ``Decision``/``ControllerConfig`` dataclass fields never read by
    any analyzed file (attribute access and ``getattr``/``hasattr``
    string literals both count as reads) must be deleted or wired up.

``tracked-bytecode``
    No ``__pycache__``/``.pyc`` artifact tracked by git, and
    ``.gitignore`` keeps covering ``__pycache__/`` + ``*.py[cod]``.
    Active only when the analysis root is the git toplevel.

Rules of the reference with no counterpart
==========================================

``donation-reuse``
    PyTorch has no buffer donation: a tensor passed to a step stays
    valid, so there is no donated buffer to read after the call.

``kernel-oracle``'s BlockSpec ``index_map`` arity check
    A CUDA kernel has no BlockSpec: its grid and indexing are C++ that
    the chip run checks against the plain version.

Suppressions
============

``# repro: allow(<rule>[, <rule>...])`` on the flagged line or the line
immediately above suppresses those rules there.  ``# repro: hot`` on or
above a ``def`` marks it hot for ``host-sync-in-hot-path``.

Adding a checker
================

Subclass :class:`repro_torch.analysis.core.Rule`, set ``name``,
implement ``check_file(SourceFile)`` (per-file) and/or
``finish(Project)`` (cross-file), and register it in
:func:`repro_torch.analysis.core.default_rules`.  Add a bad fixture
proving it fires and a good fixture proving it stays quiet under
``tests/analysis_fixtures_torch/``.
"""
from repro_torch.analysis.core import (Finding, Project, Rule,  # noqa: F401
                                       SourceFile, default_rules, report,
                                       run_analysis)

__all__ = ["Finding", "Project", "Rule", "SourceFile", "default_rules",
           "report", "run_analysis"]
