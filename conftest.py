"""Settings for every test process of this repository.

pytest loads this file first, in the xdist controller and in each worker,
before any test module imports torch or jax; so it imports neither, and
the "runs without jax" checks see the processes they saw without it.

- A CPU thread budget per xdist worker.  torch (OpenMP, MKL) starts one
  thread per core in every worker, so six workers on eight cores ran 48
  threads and each test several times slower than on one thread.  Under
  xdist each worker gets ``cores // workers`` threads (at least one); a
  lone pytest process keeps the libraries' own defaults.  The budget is
  set in ``os.environ``, so the children that tests spawn keep it.
- One JAX persistent compilation cache per run.  The reference's programs
  are compiled again and again (un-jitted scans, ``jax.clear_caches()`` at
  every module boundary in ``tests/conftest.py``); the disk cache keys on
  the lowered program and hits where the in-memory cache misses.  The
  directory is made fresh under the system's temp directory by the run's
  first process, inherited by its workers and children, and removed when
  the run ends, so every run starts cold.
- A time limit of 300 s for every test.  An alarm fails the test past
  it; a test stuck in C code, where the alarm cannot raise, is stopped
  by ``faulthandler`` a minute later, which dumps every thread's
  traceback and ends the process.
"""
import faulthandler
import os
import shutil
import signal
import sys
import tempfile
import time

import pytest

TIME_LIMIT_S = 300.0
# how long after its limit a test stuck where the alarm cannot raise is
# stopped, with its process
HARD_STOP_AFTER_S = 60.0

_cache_dir = pytest.StashKey[str]()
_stderr_fd = pytest.StashKey[int]()
_deadline = pytest.StashKey[float]()


def pytest_configure(config):
    # The tier-1 command deselects nothing (no ``-m``), so tests marked
    # slow (tests/test_dist_multidev.py) run in every tier-1 run.
    config.addinivalue_line(
        "markers", "slow: a test that takes minutes; still run by default")
    workerinput = getattr(config, "workerinput", None)
    if workerinput is not None:
        threads = str(max(1, len(os.sched_getaffinity(0))
                          // workerinput["workercount"]))
        os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = threads
    else:
        cache = tempfile.mkdtemp(prefix="jax-compile-cache-")
        config.stash[_cache_dir] = cache
        os.environ.update(JAX_COMPILATION_CACHE_DIR=cache,
                          JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
                          JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    # faulthandler writes to the real stderr, not to a test's capture
    config.stash[_stderr_fd] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])
    if _cache_dir in config.stash:
        shutil.rmtree(config.stash[_cache_dir], ignore_errors=True)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    item.stash[_deadline] = time.monotonic() + TIME_LIMIT_S
    faulthandler.dump_traceback_later(TIME_LIMIT_S + HARD_STOP_AFTER_S,
                                      exit=True,
                                      file=item.config.stash[_stderr_fd])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


def _alarmed(item):
    """Run one phase of ``item`` under an alarm at its deadline, which
    fails it by name."""
    def stop(signum, frame):
        pytest.fail(f"{item.nodeid} ran past its time limit of "
                    f"{TIME_LIMIT_S:g} s")
    old = signal.signal(signal.SIGALRM, stop)
    signal.setitimer(signal.ITIMER_REAL,
                     max(item.stash[_deadline] - time.monotonic(), 1e-3))
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


# The alarm covers set-up (fixtures) and the test itself.  Teardown runs
# even after a test ran out of time, so it is left to faulthandler.
@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _alarmed(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _alarmed(item))
