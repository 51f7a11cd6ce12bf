"""The benchmark's own tests (not collected by the repo's test run): run them
with ``python -m pytest benchmark/tests -q -p no:cacheprovider``. Tests
marked ``cuda`` need the card and skip without one.

``tiny_run`` builds a run of a cell at a small size on the CPU (the
program's plain versions), skipping the harness's look for a chip."""

from __future__ import annotations

import copy
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips inside the test without one")


def tiny_config(name: str) -> dict:
    """A cell's configuration with small encoder shapes and frames (the
    widths of the GCN, the heads and B5 as published)."""
    cfg = copy.deepcopy(json.loads((BENCH / "configs" / f"{name}.json").read_text()))
    cfg["dataset"].update(num_points_objects=96, num_points_relation=160)
    pn = cfg["pointnet2_msg"]
    pn["sa1"].update(npoint=24, nsamples=[4, 8])
    pn["sa2"].update(npoint=8, nsamples=[8, 8])
    if "image" in cfg:
        cfg["image"]["size"] = 32
    return cfg


def tiny_traffic(traffic: str) -> dict:
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    tr.update(objects_per_scene=4, points_per_object=60, max_objects=6, max_edges=30, trace_calls=1)
    tr["scenes_per_batch"] = 3
    return tr


@pytest.fixture
def tiny_run(tmp_path):
    from harness import spec
    from harness.context import Run

    def make(cell_name: str, seconds: float = 0.5, seed: int = 2**31 + 17, limits=None):
        full = spec.find_cell(ROOT, cell_name)
        cell = spec.Cell(name=full.name, config_name=full.config_name, traffic_name=full.traffic_name, chips=1,
                         config=tiny_config(full.config_name), traffic=tiny_traffic(full.traffic_name),
                         limits=limits or full.limits, end_to_end=full.end_to_end, per_layer=full.per_layer)
        return Run(seed=seed, seconds=seconds, trace=False, cell=cell, t0=time.perf_counter(), device="cpu",
                   trace_dir=tmp_path / "trace")

    return make
