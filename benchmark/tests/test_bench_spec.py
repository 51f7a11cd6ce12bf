"""BENCHMARK.json's format, names and limits, and every name in it found from its
files; a cell, a configuration and a metric added as files alone are
discovered."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(SPEC) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keys_names_units():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["source"].startswith("https://") and len(c["source"]) <= 200
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_every_cell_reports_what_it_must():
    from harness import spec

    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    used_configs = set()
    for w in SPEC["workloads"]:
        cell = spec.find_cell(ROOT, w["name"])
        used_configs.add(w["config"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert (BENCH / "drivers" / f"{cell.traffic['mode']}.py").is_file()
        assert cell.limits["checks"], w["name"]
    assert used_configs == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            moved = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_every_metric_has_a_reader():
    from harness.spec import metric_reader

    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(metric_reader(m["name"]))


def test_configs_hold_the_published_widths():
    """The configuration files as run: nothing reduced, the published
    PointNet++ MSG widths, the B5 image branch at 456."""
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["reduced"] == []
        pn = cfg["pointnet2_msg"]
        assert pn["sa1"] == {"npoint": 512, "radii": [0.1, 0.2], "nsamples": [16, 32], "mlps": [[64, 64], [64, 128]]}
        assert pn["sa2"] == {"npoint": 128, "radii": [0.2, 0.4], "nsamples": [32, 64],
                             "mlps": [[128, 128], [128, 128]]}
        assert pn["sa3"] == {"mlp": [256, 256]}
        assert cfg["dataset"]["num_points_objects"] == 4000 and cfg["dataset"]["num_points_relation"] == 8000
        if cfg.get("IMAGE_INPUT") == "full":
            assert cfg["image"]["size"] == 456 and cfg["MODEL"]["IMAGE_MODEL"] == "tf_efficientnet_b5_ns"


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    metric by adding files and entries: the harness finds each by name."""
    from harness import spec

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "sgpn-no_gt.json").read_text())
    (bench / "configs" / "sgpn-fixture.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "eval.s64.json").read_text())
    (bench / "traffic" / "eval.s8.json").write_text(json.dumps(dict(tr, scenes_per_batch=8)))
    (bench / "workloads" / "fixture.eval.s8.json").write_text(json.dumps({"checks": {"rel_logprob_gap": {"limit": 1}}}))
    (bench / "metrics" / "fixture_scenes.py").write_text("def read(o):\n    return o.scenes\n")
    spec_json = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "sgpn-fixture", "source": "https://example.org/fixture",
                                 "file": "benchmark/configs/sgpn-fixture.json", "reduced": [], "why": "fixture"})
    spec_json["workloads"].append({"name": "fixture.eval.s8", "config": "sgpn-fixture", "traffic": "eval.s8",
                                   "chips": 1, "why": "fixture"})
    spec_json["per_layer"].append({"name": "fixture_scenes", "unit": "scenes", "better": "higher",
                                   "source": "host_clock", "layer": "driver", "moves": "eval_scenes_per_s",
                                   "workloads": ["fixture.eval.s8"]})
    spec_json["end_to_end"][0]["workloads"].append("fixture.eval.s8")
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    cell = spec.find_cell(root, "fixture.eval.s8", bench_dir=bench)
    assert cell.traffic["scenes_per_batch"] == 8 and cell.config == cfg
    assert "fixture_scenes" in {m["name"] for m in cell.per_layer}
    assert {m["name"] for m in cell.end_to_end} == {"eval_scenes_per_s", "setup_s"}

    class O:
        scenes = 24

    assert spec.metric_reader("fixture_scenes", bench_dir=bench)(O) == 24
    assert spec.driver(cell.traffic["mode"], bench_dir=bench).run


def test_unknown_names_are_refused():
    from harness import spec

    with pytest.raises(KeyError):
        spec.find_cell(ROOT, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_metric")
