"""The settings the root ``conftest.py`` gives every test process: a CPU
thread budget per xdist worker, one JAX compilation cache per run, and a
time limit per test.  The in-process case reads this run's settings; the
others run the root ``conftest.py`` in a child pytest, over a throwaway
test file, with and without xdist, its time limit lowered to 2 s."""
import os
import subprocess
import sys
import tempfile
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# torch and jax are imported at collection, outside the 2 s limit that
# covers set-up and call
CHILD_TESTS = textwrap.dedent('''
    import os
    import time

    import jax
    import torch


    def test_threads(request):
        workerinput = getattr(request.config, "workerinput", None)
        if workerinput is None:
            assert "OMP_NUM_THREADS" not in os.environ
            assert "MKL_NUM_THREADS" not in os.environ
            return
        budget = max(1, len(os.sched_getaffinity(0))
                     // workerinput["workercount"])
        assert os.environ["OMP_NUM_THREADS"] == str(budget)
        assert os.environ["MKL_NUM_THREADS"] == str(budget)
        assert torch.get_num_threads() == budget


    def test_cache_dir():
        cache = os.environ["JAX_COMPILATION_CACHE_DIR"]
        assert jax.config.jax_compilation_cache_dir == cache
        assert os.path.isdir(cache)
        with open("cache_dir.txt", "a") as f:
            f.write(cache + "\\n")


    def test_sleeps_past_its_limit():
        time.sleep(30)
''')


def _child_pytest(tmp_path, *args):
    """pytest over CHILD_TESTS beside a copy of the root ``conftest.py``
    whose time limit is 2 s, from an environment without this run's
    settings; returns (output, cache directories the child's tests saw)."""
    limit = "\nTIME_LIMIT_S = 300.0\n"
    with open(os.path.join(ROOT, "conftest.py")) as f:
        conftest = f.read()
    assert conftest.count(limit) == 1
    (tmp_path / "conftest.py").write_text(
        conftest.replace(limit, "\nTIME_LIMIT_S = 2.0\n"))
    (tmp_path / "test_child.py").write_text(CHILD_TESTS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS")
           and not k.startswith(("JAX_COMPILATION_CACHE", "JAX_PERSISTENT",
                                 "PYTEST_"))}
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-rf", "-p", "no:cacheprovider",
         "-p", "no:randomly", *args, "test_child.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    text = out.stdout + out.stderr
    assert out.returncode == 1, text
    return text, (tmp_path / "cache_dir.txt").read_text().split()


@pytest.mark.parametrize("workers", [0, 2])
def test_child_run_sets_threads_cache_and_time_limit(tmp_path, workers):
    """Under xdist each worker's torch runs ``cores // workers`` threads;
    without it the thread settings are left alone.  The run's JAX cache is
    one fresh directory under the temp directory, seen by every worker and
    removed when the run ends.  A test that sleeps past the 2 s limit
    fails, and the failure names it."""
    args = ["-p", "xdist", "-n", str(workers)] if workers else []
    text, caches = _child_pytest(tmp_path, *args)
    assert "1 failed, 2 passed" in text, text
    assert ("test_child.py::test_sleeps_past_its_limit ran past its time "
            "limit of 2 s") in text, text
    assert len(set(caches)) == 1
    assert os.path.dirname(caches[0]) == tempfile.gettempdir()
    assert not os.path.exists(caches[0])


def test_this_runs_threads_and_jax_cache(request):
    """In this run: under xdist, torch runs the worker's thread budget; the
    JAX compilation cache is the directory the root ``conftest.py`` made
    for the run, outside the repository, and keeps every compile."""
    import jax
    import torch
    workerinput = getattr(request.config, "workerinput", None)
    if workerinput is not None:
        assert torch.get_num_threads() == max(
            1, len(os.sched_getaffinity(0)) // workerinput["workercount"])
    cache = os.environ["JAX_COMPILATION_CACHE_DIR"]
    assert jax.config.jax_compilation_cache_dir == cache
    assert os.path.isdir(cache)
    assert not os.path.realpath(cache).startswith(os.path.realpath(ROOT))
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == -1
