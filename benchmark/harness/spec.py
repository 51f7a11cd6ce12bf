"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is found by its name alone: the configuration's file is the one
``configs`` gives, the traffic mix is ``benchmark/traffic/<traffic>.json``,
the cell's correctness limits are ``benchmark/workloads/<cell>.json`` and a
metric's reader is ``benchmark/metrics/<metric>.py``. The traffic mix names
its driver (``mode``: ``benchmark/drivers/<mode>.py``). So a later change
adds a cell, a configuration or a metric by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # the benchmark's folder


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict  # the configuration file as run
    traffic: dict  # the traffic mix's parameters
    limits: dict  # the cell's file: what decides ``correct``
    end_to_end: list  # the end-to-end metric entries this cell reports
    per_layer: list  # the per-layer metric entries this cell reports


def _load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_spec(root: Path) -> dict:
    return _load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def find_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name) and m["moves"] in e2e_names]
    return Cell(
        name=name, config_name=w["config"], traffic_name=w["traffic"], chips=int(w["chips"]),
        config=_load_json(root / cfg_entry["file"]),
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
    )


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: Path = HERE):
    """The ``read(ctx)`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    return load_module(path, f"bench_metric_{name.replace('.', '_').replace('-', '_')}").read


def driver(mode: str, bench_dir: Path = HERE):
    path = bench_dir / "drivers" / f"{mode}.py"
    if not path.exists():
        raise FileNotFoundError(f"traffic mode {mode!r} has no driver at {path}")
    return load_module(path, f"bench_driver_{mode}")
