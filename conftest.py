"""Limits for every pytest run of this repository.

Every test process gets an even share of the host's cores (all of them for
a run in one process, one each for ``-n 6`` on 8 cores), and every test
phase a time limit, past which it fails with a traceback of where it stood.
"""

import contextlib
import faulthandler
import os
import signal

import pytest

# Seconds each of a test's setup, call and teardown may take.
TIME_LIMIT_S = 720


def worker_count(config) -> int:
    """The test processes of this run: xdist's workers, else this one."""
    if hasattr(config, "workerinput"):  # an xdist worker
        return config.workerinput["workercount"]
    return config.getoption("numprocesses", None) or 1


def thread_budget(workers: int) -> int:
    """CPU threads for one of ``workers`` test processes."""
    return max(1, (os.cpu_count() or 1) // workers)


def pytest_configure(config):
    global _stderr
    _stderr = os.dup(2)  # the terminal's, for tracebacks past the limit
    # Set in xdist's controller too: its environment is what its workers
    # and their subprocesses inherit.
    threads = thread_budget(worker_count(config))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(threads))
    flags = os.environ.get("XLA_FLAGS", "")
    if threads == 1 and "xla_cpu_multi_thread_eigen" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_cpu_multi_thread_eigen=false"  # read when JAX first computes
    import torch

    torch.set_num_threads(threads)
    with contextlib.suppress(RuntimeError):  # once parallel work has run
        torch.set_num_interop_threads(threads)


@contextlib.contextmanager
def _time_limit(what: str):
    def expire(signum, frame):
        pytest.fail(f"{what} took more than the {TIME_LIMIT_S} s limit")

    # Every thread's stack at the limit, even one stuck in C; the test
    # fails a second later, once the main thread runs Python again.
    faulthandler.dump_traceback_later(TIME_LIMIT_S, file=_stderr)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TIME_LIMIT_S + 1)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _time_limit(f"setup of {item.nodeid}"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _time_limit(item.nodeid):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    with _time_limit(f"teardown of {item.nodeid}"):
        return (yield)
