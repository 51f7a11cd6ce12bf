"""What a driver is given (``Run``) and what it hands back (``Outcome``),
which the metric readers (``benchmark/metrics/<name>.py``, each a
``read(outcome) -> float | None``) read."""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path


@dataclasses.dataclass
class Run:
    seed: int
    seconds: float
    trace: bool
    cell: object  # harness.spec.Cell
    t0: float  # the host clock at the process's start of work: set-up runs from here
    device: str
    trace_dir: Path

    def sync(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        import torch

        return 0 if self.device == "cpu" else int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        import torch

        if self.device != "cpu":
            torch.cuda.empty_cache()

    def log(self, msg: str) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f} s] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    setup_s: float
    window_s: float  # from the window's start to the end of its last call
    calls: int  # entry calls completed in the window
    scenes: int  # scenes those calls covered (train: stepped on)
    call_ms: list  # host ms of each call
    attempted: int
    failed: int
    checks: dict  # name -> value, judged against the cell's limits
    memory_peak_bytes: int
    dtype: str
    flops_per_call: float
    spans: dict = dataclasses.field(default_factory=dict)  # span -> host ms of each call in the traced window
    trace: object = None  # harness.trace.Trace of the traced calls
    trace_calls: int = 0  # entry calls inside the traced window
    trace_batches: int = 0  # batches inside the traced window
    bounds_ms: dict = dataclasses.field(default_factory=dict)  # kernel family -> least ms of one call
    image_branch_ms: list = dataclasses.field(default_factory=list)


def read_metrics(outcome: Outcome, entries: list) -> dict:
    """{name: {"value", "unit"}} of every metric entry whose reader finds
    something to read."""
    from harness.spec import metric_reader

    out = {}
    for m in entries:
        v = metric_reader(m["name"])(outcome)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
