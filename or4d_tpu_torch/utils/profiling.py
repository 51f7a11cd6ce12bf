"""Step timing and on-demand traces (port of ``or4d_tpu/utils/profiling.py``).

:class:`StepTimer` keeps a rolling window of step wall times, as the JAX
package's does; :func:`trace` records a ``torch.profiler`` trace (host ops,
and the card's kernels and copies where one is present) around a block and
writes it into ``log_dir`` as a Chrome trace (``chrome://tracing``,
Perfetto).

On the card, kernels launched right at the start of a ``torch.profiler``
window have been missing from its trace (2 of 30 traces of a Group-Free
forward lost its first FPS kernel; none of 30 did with the guard below), so
a window opens with a guard: the host waits for the card, then
``PROFILE_GUARD_S``, before the block's first launch.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import deque
from pathlib import Path

PROFILE_GUARD_S = 0.05  # host wait between a trace window's start and the block's first launch


class StepTimer:
    def __init__(self, window: int = 50):
        self.times = deque(maxlen=window)

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / len(self.times) if self.times else 0.0

    def summary(self) -> str:
        if not self.times:
            return "no steps"
        return f"{self.mean_ms:.1f} ms/step, {1e3 / self.mean_ms:.2f} steps/s"


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike | None = None):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when a card is present), written on exit to
    ``log_dir/trace_<pid>.json`` (default ``log_dir``: ``or4d_torch_trace``
    under the temp dir); yields that path. With a card, the window's first
    launch waits for the card and ``PROFILE_GUARD_S`` (see the module)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(tempfile.gettempdir()) / "or4d_torch_trace" if log_dir is None else Path(log_dir)
    path = log_dir / f"trace_{os.getpid()}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            time.sleep(PROFILE_GUARD_S)
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
