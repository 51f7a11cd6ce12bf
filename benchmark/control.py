"""The controls of the benchmark's correctness check, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--out FILE]

For each seed, the cell's inputs and weights are made as a run makes them,
and the reference computed in the precision one step below the cell's
(float8 e4m3 products for a bfloat16 cell, TF32 for a float32 one) is put
in the program's place: the numbers a run compares are printed for it, one
JSON line a seed. A training cell also reads the fault that leaves half of
each batch out. These readings set the upper end of each limit; the
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch

    from harness import spec
    from harness.context import Run

    if not torch.cuda.is_available():
        print("the controls run on the card", file=sys.stderr)
        return 2
    cell = spec.find_cell(ROOT, args.workload)
    mode = CONTROL[cell.traffic["dtype"]]
    drv = spec.driver(cell.traffic["mode"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = Run(seed=seed, seconds=0.0, trace=False, cell=cell, t0=t0, device="cuda",
                  trace_dir=ROOT / "build" / "benchmark")
        line = json.dumps({"workload": cell.name, "seed": seed, "control": mode,
                           "card": torch.cuda.get_device_name(0), "readings": drv.control(run, mode),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
