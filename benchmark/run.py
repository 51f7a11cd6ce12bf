"""Run one cell of the benchmark of ``or4d_tpu_torch`` once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of ``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the traffic mix's
``mode`` names the module (``benchmark/drivers/<mode>.py``) that makes the
inputs and weights from ``--seed``, warms up, measures for ``--seconds``
and checks the timed path's outputs against the plain reference
(``benchmark/reference``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics, each read
by ``benchmark/metrics/<name>.py``), ``device`` (with ``--trace 1`` also the
traced window's busy and total seconds), with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared, with its limit. The same
numbers end standard error.

Exits non-zero without a result when there is no card, fewer cards than
the cell asks for, or when the JAX package or JAX is loaded once the window
has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "or4d_tpu")
BREAKDOWN_ENTRIES = 10


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(run, outcome, correct: bool, rows) -> dict:
    import torch

    from harness.context import read_metrics

    cell = run.cell
    entries = cell.per_layer if run.trace else cell.end_to_end
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": read_metrics(outcome, entries), "device": device}
    if run.trace and outcome.trace is not None:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        line["breakdown"] = {"device_ops": [[n, s] for n, s in outcome.trace.top_ops()[:BREAKDOWN_ENTRIES]],
                             "idle_gaps": [[n, s] for n, s in outcome.trace.idle_by_host()[:BREAKDOWN_ENTRIES]]}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return line


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = parse(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    from harness import compare, spec
    from harness.context import Run

    cell = spec.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    run = Run(seed=args.seed, seconds=args.seconds, trace=bool(args.trace), cell=cell, t0=t0, device="cuda",
              trace_dir=ROOT / "build" / "benchmark")
    run.log(f"{cell.name}: torch {torch.__version__} on {torch.cuda.get_device_name(0)}")
    outcome = spec.driver(cell.traffic["mode"]).run(run)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the benchmark runs without JAX and the JAX package)",
              file=sys.stderr)
        return 3
    correct, rows = compare.judge(outcome.checks, cell.limits)
    line = result_line(run, outcome, correct, rows)
    for name, v, lim in rows:
        print(f"check {name}: {v!r} (limit {lim!r}){'' if v <= lim else ' FAILED'}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
