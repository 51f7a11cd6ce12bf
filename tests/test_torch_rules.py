"""Rules of the PyTorch port that are not numerics:

* no module of ``or4d_tpu_torch`` (the train and ops modules included) and
  not ``chip_smoke.py`` imports jax, flax, optax or the JAX package;
* entry points (``infer``, ``train``, ``serving``, and ``cli`` in every
  mode that uses a device, ``perception``'s detect tasks among them, with
  the L2 functions it calls) raise without a
  card unless they are given ``device="cpu"``; ``python -m or4d_tpu_torch.train
  --device cpu`` writes a finite history, and ``python -m
  or4d_tpu_torch.serving --device cpu`` prints a finite macro F1;
* a kernel build with no compiler raises (no plain-version fallback);
* the weight converter raises on a missing or an extra key.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from or4d_tpu_torch import resolve_device
from or4d_tpu_torch.convert import from_jax_variables
from or4d_tpu_torch.data.scene_batch import SlotPack
from or4d_tpu_torch.data.synthetic import make_scene_batch
from or4d_tpu_torch.config import DatasetConfig
from or4d_tpu_torch.models.heads import ObjectClsHead
from or4d_tpu_torch.models.sgpn import SGPN

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "or4d_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "or4d_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("ops/floyd_warshall", "models/graphormer", "pipeline/role_graphormer", "pipeline/role_dataset",
                   "train/graphormer_trainer", "utils/logging", "utils/visualize", "ops/box_geometry",
                   "ops/interpolate", "models/groupfree", "models/groupfree_loss", "data/groupfree_dataset",
                   "train/perception_trainers", "pipeline/perception_infer"):
        assert f"or4d_tpu_torch/{module}.py" in names, module
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from or4d_tpu_torch import infer

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SGPN(sa_npoints=(8, 4), sa_nsamples=((2, 2), (2, 2)))
    out = tmp_path / "rels.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.main(["--synthetic", "--scenes", "1", "--config", "tiny", "--output", str(out)])
    assert not out.exists()
    from or4d_tpu_torch.train.__main__ import main as train_main

    hist = tmp_path / "history.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--synthetic", "--config", "tiny", "--scenes", "1", "--steps", "1", "--output", str(hist)])
    assert not hist.exists()
    from or4d_tpu_torch.serving import main as serving_main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_main(["--synthetic", "--config", "tiny", "--scenes", "1", "--cache-dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("mode", ["train", "evaluate", "infer", "instance-labels", "graphormer-roles",
                                  "perception detect-train", "perception detect-infer"])
def test_cli_device_modes_raise_without_a_card(no_card, tmp_path, mode):
    from or4d_tpu_torch import cli

    root = Path(__file__).parent / "golden" / "real_data"
    out = tmp_path / "out"
    mode, *task = mode.split()
    args = [mode, "--config", "tiny", "--data-root", str(root), "--cache-dir", str(tmp_path / "c"),
            "--checkpoint-dir", str(tmp_path / "ck"), "--output", str(out), "--output-dir", str(out)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + (["--task", *task] if task else []))
    assert not out.exists() and not (tmp_path / "c").exists() and not (tmp_path / "ck").exists()
    assert not (root / "preprocessed_ret_dicts").exists()


def test_l2_functions_raise_without_a_card(no_card, tmp_path):
    from or4d_tpu_torch.pipeline import instance_labels as il

    root = Path(__file__).parent / "golden" / "real_data"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        il.compute_instance_labels_for_scan(np.zeros((10, 3), np.float32), human_poses={})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        il.process_take(root, 1, from_gt=True, out_root=tmp_path)
    assert not any(tmp_path.iterdir())


def test_train_cli_on_cpu_writes_a_finite_history(tmp_path):
    import json
    import math

    from or4d_tpu_torch.train import checkpoint
    from or4d_tpu_torch.train.__main__ import main as train_main

    out = tmp_path / "history.json"
    res = train_main(["--synthetic", "--config", "tiny", "--scenes", "2", "--steps", "2", "--device", "cpu",
                      "--checkpoint-dir", str(tmp_path / "ck"), "--output", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert [r["step"] for r in res["history"]] == [1, 2]
    assert all(math.isfinite(r[k]) for r in res["history"] for k in ("loss", "loss_obj", "loss_rel"))
    assert checkpoint.latest_step(tmp_path / "ck") == 2


def test_serving_cli_on_cpu_prints_a_finite_macro_f1(tmp_path, capsys):
    import json
    import math

    from or4d_tpu_torch.serving import main as serving_main

    args = ["--synthetic", "--config", "tiny", "--scenes", "5", "--device", "cpu", "--cache-dir", str(tmp_path)]
    rec = serving_main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["split"] == "synthetic" and math.isfinite(rec["relation_macro_f1"])
    assert len(list(tmp_path.glob("sa1_*.npz"))) == 2  # two batches of the config's 4 scenes
    assert serving_main(args) == rec  # from the persisted caches


def test_train_cli_serving_f1_matches_cold(tmp_path):
    from or4d_tpu_torch.train.__main__ import main as train_main

    base = ["--synthetic", "--config", "tiny", "--scenes", "2", "--steps", "1", "--device", "cpu"]
    cold = train_main(base + ["--output", str(tmp_path / "a.json")])
    fast = train_main(base + ["--serving", "--serving-cache-dir", str(tmp_path / "c"), "--output",
                              str(tmp_path / "b.json")])
    assert abs(fast["train_macro_f1"] - cold["train_macro_f1"]) < 1e-9
    assert len(list((tmp_path / "c").glob("sa1_*.npz"))) == 1


def test_infer_cli_on_cpu_writes_scan_relations(tmp_path):
    from or4d_tpu_torch import infer

    out = tmp_path / "rels.json"
    rels = infer.main(["--synthetic", "--scenes", "2", "--config", "tiny", "--output", str(out), "--device", "cpu"])
    import json

    assert json.loads(out.read_text()) == json.loads(json.dumps(rels))
    assert set(rels) == {"1_000000", "1_000001"}
    assert all(len(t) == 3 for v in rels.values() for t in v)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    from or4d_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


def _head_variables(seed=0):
    rng = np.random.default_rng(seed)
    p = {f"fc{i}": {"kernel": rng.standard_normal((a, b)).astype(np.float32), "bias": np.zeros(b, np.float32)}
         for i, (a, b) in enumerate([(32, 512), (512, 256), (256, 12)], start=1)}
    return {"params": p}


def test_converter_maps_and_transposes():
    head = ObjectClsHead(32, 12, device="cpu")
    v = _head_variables()
    sd = from_jax_variables(v, head)
    np.testing.assert_array_equal(sd["fc1.weight"].numpy(), v["params"]["fc1"]["kernel"].T)
    head.load_state_dict(sd)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_converter_raises(fault):
    head = ObjectClsHead(32, 12, device="cpu")
    v = _head_variables()
    if fault == "missing":
        del v["params"]["fc2"]["bias"]
    elif fault == "extra":
        v["params"]["fc4"] = {"bias": np.zeros(3, np.float32)}
    else:
        v["params"]["fc3"]["kernel"] = np.zeros((256, 11), np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        from_jax_variables(v, head)


def test_paired_pack_rejects_unshared_batch():
    ds = DatasetConfig(num_points_objects=64, num_points_relation=64, max_objects=5, max_edges=20)
    batch = make_scene_batch(1, seed=1, n_objects=4, ds=ds, points_per_obj=150)
    with pytest.raises(ValueError, match="pair"):
        SlotPack.build(batch, bucket=8, paired=True)
    pack = SlotPack.build(batch, bucket=8)
    assert pack.pair_idx is None and int(pack.edge_valid.sum()) == 12
