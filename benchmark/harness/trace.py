"""Host spans around the program's layers, and device traces.

``Spans`` wraps functions of the program (a module's function, a class's
method) with a host clock and a ``torch.profiler`` range named
``bench.<span>``, so the trace can name what the host was doing while the
card sat idle. ``profile`` is the guarded, retried profile of
``chip_smoke.py``'s ``profile_step`` / ``_profile_once`` (copied): the run is
made twice in the profiler, a warm-up whose trace is dropped and the
recorded one; the recorded window opens with the host waiting for the card
and 50 ms (kernels launched right at a window's start have been missing
from its trace), and a trace whose kernels of the program are fewer than
its launch counters rose is taken again. The Chrome trace is read back
into device operations and host ranges (``Trace``).
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import json
import os
import sys
import time
from pathlib import Path

GUARD_S = 0.05
WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host times (ms) of wrapped calls, by span name."""

    def __init__(self):
        self.ms: dict[str, list[float]] = collections.defaultdict(list)
        self._undo = []

    def wrap(self, owner, attr: str, span: str) -> None:
        from torch.profiler import record_function

        raw = inspect.getattr_static(owner, attr)
        fn = getattr(owner, attr)
        times = self.ms[span]

        def timed(*a, **k):
            t0 = time.perf_counter()
            with record_function(f"bench.{span}"):
                out = fn(*a, **k)
            times.append(1e3 * (time.perf_counter() - t0))
            return out

        # a classmethod's ``fn`` is already bound to its class; a method's
        # ``fn`` is the plain function, which ``timed`` takes self for
        setattr(owner, attr, staticmethod(timed) if isinstance(raw, classmethod) else timed)
        self._undo.append((owner, attr, raw))

    def restore(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()


@dataclasses.dataclass
class Trace:
    """One recorded window: device operations (name, start s, seconds) and
    host ranges of the harness (name, start s, seconds), on one clock."""

    ops: list
    ranges: list
    start: float
    end: float

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        """Seconds within the window in which some device operation ran."""
        busy, cur_s, cur_e = 0.0, None, None
        for _n, s, d in sorted(self.ops, key=lambda o: o[1]):
            s, e = max(s, self.start), min(s + d, self.end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.start
        for _n, s, d in sorted(self.ops, key=lambda o: o[1]):
            if s > t:
                out.append((t, min(s, self.end)))
            t = max(t, s + d)
            if t >= self.end:
                break
        if t < self.end:
            out.append((t, self.end))
        return [(a, b) for a, b in out if b > a]

    def host_at(self, t: float) -> str:
        """The innermost harness span open at ``t`` ("host" when none); a gap
        is named by the span open at its middle."""
        best, best_len = "host", float("inf")
        for name, s, d in self.ranges:
            if name != WINDOW and s <= t < s + d and d < best_len:
                best, best_len = name.removeprefix("bench."), d
        return best

    def idle_by_host(self) -> list[tuple[str, float]]:
        acc = collections.Counter()
        for a, b in self.gaps():
            acc[self.host_at(0.5 * (a + b))] += b - a
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def top_ops(self) -> list[tuple[str, float]]:
        acc = collections.Counter()
        for n, s, d in self.ops:
            acc[n] += max(0.0, min(s + d, self.end) - max(s, self.start))
        return sorted(acc.items(), key=lambda kv: -kv[1])

    def op_seconds(self, *fragments: str) -> float:
        return sum(d for n, _s, d in self.ops if any(f in n for f in fragments))

    def op_count(self, *fragments: str) -> int:
        return sum(1 for n, _s, _d in self.ops if any(f in n for f in fragments))


def read_chrome_trace(path: Path) -> Trace:
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    ops, ranges = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        s, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        if cat in _DEVICE_CATS:
            ops.append((e.get("name", "?"), s, d))
        elif cat == "user_annotation" and str(e.get("name", "")).startswith("bench."):
            ranges.append((e["name"], s, d))
    window = [r for r in ranges if r[0] == WINDOW]
    if not window:
        raise RuntimeError("the trace has no harness window range")
    _n, s, d = max(window, key=lambda r: r[2])
    return Trace(ops, ranges, s, s + d)


def profile(run, trace_dir: Path, kernel_counts=None, attempts: int = 3) -> Trace:
    """The trace of ``run()`` (its second run in the profiler, after a
    dropped warm-up), read back. ``kernel_counts`` (a function of a Trace
    and of a dict of launch-counter increases that says whether the trace
    holds every counted launch) makes a trace that lost kernels be taken
    again."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function, schedule

    from or4d_tpu_torch.ops import launch_counts

    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / f"trace_{os.getpid()}.json"
    for attempt in range(attempts):
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                      schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            run()
            torch.cuda.synchronize()
            prof.step()
            torch.cuda.synchronize()
            time.sleep(GUARD_S)
            before = launch_counts()
            with record_function(WINDOW):
                run()
                torch.cuda.synchronize()
            after = launch_counts()
            prof.step()
        prof.export_chrome_trace(str(path))
        trace = read_chrome_trace(path)
        path.unlink()
        rose = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
        if kernel_counts is None or kernel_counts(trace, rose):
            return trace
        print(f"profile attempt {attempt + 1}: the trace lost kernels the counters saw ({rose})",
              file=sys.stderr)
    raise RuntimeError(f"the trace lost kernels in {attempts} attempts in a row")
