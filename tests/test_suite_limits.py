"""The test harness's CPU thread budget and per-phase time limit (the
repository's root ``conftest.py``)."""

import os
import types
from pathlib import Path

import pytest
import torch

pytest_plugins = ["pytester"]

CONFTEST = Path(__file__).parents[1] / "conftest.py"


@pytest.fixture
def limits(request):
    return request.config.pluginmanager.get_plugin(str(CONFTEST))


@pytest.mark.parametrize("cores, workers, threads", [(8, 1, 8), (8, 6, 1), (8, 3, 2), (2, 2, 1), (1, 6, 1)])
def test_each_worker_gets_its_share_of_the_cores(limits, monkeypatch, cores, workers, threads):
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    assert limits.thread_budget(workers) == threads


def test_the_workers_are_counted_in_the_controller_and_in_each_worker(limits):
    def config(**options):
        return types.SimpleNamespace(getoption=lambda name, default: options.get(name, default))

    assert limits.worker_count(config()) == limits.worker_count(config(numprocesses=None)) == 1
    assert limits.worker_count(config(numprocesses=6)) == 6
    worker = config(numprocesses=None)
    worker.workerinput = {"workercount": 4}
    assert limits.worker_count(worker) == 4


def test_this_process_runs_on_its_budget(limits, request):
    threads = limits.thread_budget(limits.worker_count(request.config))
    assert torch.get_num_threads() == threads
    assert ("--xla_cpu_multi_thread_eigen=false" in os.environ["XLA_FLAGS"]) == (threads == 1)


def test_a_test_past_the_limit_fails_and_the_next_one_runs(pytester, monkeypatch):
    """Run in a pytest of its own, which also exports its budget to
    subprocesses."""
    monkeypatch.setenv("PYTEST_DISABLE_PLUGIN_AUTOLOAD", "1")  # the inner run loads no plugin: seconds
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    pytester.makeconftest(CONFTEST.read_text() + "\nTIME_LIMIT_S = 1\n")
    pytester.makepyfile("""
        import os
        import time

        import torch

        def test_sleeps_past_the_limit():
            time.sleep(30)

        def test_runs_after_it():
            assert os.environ["OMP_NUM_THREADS"] == os.environ["MKL_NUM_THREADS"] == str(torch.get_num_threads())
    """)
    result = pytester.runpytest_subprocess()
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines(["*test_sleeps_past_the_limit took more than the 1 s limit*"])
    result.stderr.fnmatch_lines(["Timeout (0:00:01)!", "*in test_sleeps_past_the_limit"])
    assert result.duration < 30  # the sleep was cut
