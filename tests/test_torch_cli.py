"""The port's command line (``python -m or4d_tpu_torch.cli``) on the CPU:

* ``infer`` writes the same ``scan_relations`` JSON as ``or4d_tpu.cli
  infer``: both load the same random reference-layout ``.pth`` through
  ``--torch-checkpoint``, in float32, on the fixture's val split
  (``tests/golden/real_data``; objects from the predicted labels), each
  with its own sample cache;
* ``train`` (with a checkpoint), ``evaluate`` (cold and ``--serving``) and
  ``infer`` run from the fixture in the release layout with
  ``--strict-data``, and from a data root written by
  ``or4d_tpu_torch.data.synthetic_root`` after the ``instance-labels``
  stage, followed by ``roles``, ``phases`` and ``phases-eval``: the whole
  chain ``chip_smoke.py``'s disk phase drives on the card, at a tiny size;
* the split defaults, the output name, the RANDOM INITIALIZATION warning,
  the vocabulary from the data root's classes.txt / relationships.txt, and
  that the perception tasks once refused (the pose tasks) now run.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_ckpt_import import reference_state_dict

from or4d_tpu_torch import cli

ROOT = Path(__file__).parent / "golden" / "real_data"
# the tiny config of tests/test_real_ingest.py in the reference JSON schema
TINY_JSON = {
    "LR": 1e-3, "USE_GT": False, "MAX_EPOCHES": 1,
    "dataset": {"num_points_objects": 96, "num_points_relation": 128, "data_augmentation": False},
    "MODEL": {"sa_npoints": [32, 16], "sa_nsamples": [[4, 8], [8, 8]]},
    "TPU": {"max_objects": 6, "max_edges": 30, "scene_batch": 2},
}


def write_config(path: Path, **tpu) -> str:
    cfg = json.loads(json.dumps(TINY_JSON))
    cfg["TPU"].update(tpu)
    path.write_text(json.dumps(cfg))
    return str(path)


def test_infer_json_equals_the_jax_cli(tmp_path):
    from or4d_tpu import cli as jcli

    config = write_config(tmp_path / "tiny.json")
    pth = tmp_path / "ref.pth"
    torch.save(reference_state_dict(seed=11, extras=False), pth)
    common = ["infer", "--config", config, "--data-root", str(ROOT), "--strict-data", "--torch-checkpoint", str(pth),
              "--split", "val"]
    assert jcli.main(common + ["--cache-dir", str(tmp_path / "jc"), "--output", str(tmp_path / "jax.json")]) == 0
    assert cli.main(common + ["--cache-dir", str(tmp_path / "tc"), "--output", str(tmp_path / "port.json"),
                              "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert list(got) == ["4_000000_1"] and len(got["4_000000_1"]) > 0
    assert got == want


def test_cli_runs_from_the_fixture_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    config = write_config(tmp_path / "tiny.json")
    base = ["--config", config, "--data-root", str(ROOT), "--strict-data", "--cache-dir", "cache", "--device", "cpu"]
    assert cli.main(["train", *base, "--checkpoint-dir", "ck", "--epochs", "1"]) == 0
    hist = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert hist["epoch"] == 0 and np.isfinite(hist["train_loss"]) and np.isfinite(hist["val_macro_f1"])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_00000001.pt"]

    for extra in ([], ["--serving", "--serving-cache-dir", "sc"]):
        assert cli.main(["evaluate", *base, "--checkpoint-dir", "ck", *extra]) == 0
        out = capsys.readouterr().out
        assert "restoring checkpoint step 1" in out and "RANDOM INITIALIZATION" not in out
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["split"] == "val" and np.isfinite(rec["relation_macro_f1"])
    assert len(list((tmp_path / "sc").glob("sa1_*.npz"))) == 1

    assert cli.main(["infer", *base, "--checkpoint-dir", "ck", "--split", "val"]) == 0
    rels = json.loads((tmp_path / "scan_relations_tiny_val.json").read_text())
    assert list(rels) == ["4_000000_1"] and all(len(t) == 3 for t in rels["4_000000_1"])

    # no checkpoint: the JAX CLI's warning; the default split of infer is
    # test, which the fixture does not have
    assert cli.main(["infer", *base, "--split", "val", "--output", "r.json"]) == 0
    assert "WARNING: no checkpoint found under (no --checkpoint-dir given); infer will run from RANDOM " \
           "INITIALIZATION" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="no scans for split test"):
        cli.main(["infer", *base])


@pytest.mark.parametrize("task,item", [("pose2d-train", "item 5b"), ("pose2d-infer", "item 5b"),
                                       ("pose3d-train", "item 5b"), ("pose3d-infer", "item 5b")])
def test_modes_not_ported_are_refused(task, item, tmp_path):
    """No perception task is refused any more: the pose tasks, once refused
    here until Queue 1 {item} ported them, run, and reach their dataset,
    which finds nothing under an empty root; ``--task`` is still required."""
    with pytest.raises(RuntimeError, match="no (annotated images|takes) for split train"):
        cli.main(["perception", "--task", task, "--device", "cpu", "--data-root", str(tmp_path)])
    with pytest.raises(SystemExit, match="perception mode requires --task"):
        cli.main(["perception", "--device", "cpu"])


def test_whole_chain_from_a_synthetic_root(tmp_path, monkeypatch, capsys):
    """instance-labels -> train -> evaluate -> infer -> roles -> phases ->
    phases-eval from a root written by synthetic_root (7 objects with
    points + the virtual instrument a scan, tiny widths)."""
    from or4d_tpu_torch.data.synthetic_root import write_data_root

    monkeypatch.chdir(tmp_path)
    info = write_data_root(tmp_path / "root", seed=1, scans_per_take=1, n_staff=2, points_per_object=150,
                           floor_points=200)
    assert info == {"scans": {"train": 6, "val": 2, "test": 2}, "points_per_scan": 1250, "compressed": 5}
    root = str(tmp_path / "root")
    assert cli.main(["instance-labels", "--data-root", root, "--device", "cpu"]) == 0
    pred = sorted(p.name for p in (tmp_path / "root" / "instance_labels_pred").glob("*.npz"))
    assert len(pred) == 10
    for name in pred:
        labels = np.load(tmp_path / "root" / "instance_labels_pred" / name)["arr_0"]
        assert labels.dtype == np.int8 and {1, 10, 11, 12} <= set(np.unique(labels).tolist())

    config = write_config(tmp_path / "tiny.json", max_objects=12, max_edges=132, scene_batch=4)
    base = ["--config", config, "--data-root", root, "--strict-data", "--cache-dir", "cache", "--device", "cpu"]
    assert cli.main(["train", *base, "--checkpoint-dir", "ck", "--epochs", "1"]) == 0
    assert cli.main(["evaluate", *base, "--checkpoint-dir", "ck"]) == 0
    assert cli.main(["evaluate", *base, "--checkpoint-dir", "ck", "--serving"]) == 0
    assert cli.main(["infer", *base, "--checkpoint-dir", "ck"]) == 0
    rels_path = tmp_path / "scan_relations_tiny_test.json"
    rels = json.loads(rels_path.read_text())
    assert sorted(rels) == ["2_000000_2", "6_000000_2"]
    capsys.readouterr()

    assert cli.main(["roles", "--relations", str(rels_path), "--output", "roles.json"]) == 0
    roles = json.loads((tmp_path / "roles.json").read_text())
    assert sorted(roles) == ["2_000000", "6_000000"]
    assert cli.main(["phases", "--relations", str(rels_path), "--roles", "roles.json", "--output-dir", "ph"]) == 0
    files = sorted(p.name for p in (tmp_path / "ph").iterdir())
    assert files == [f"scan_relations_tiny_test_phase_to_frames_{t}.json" for t in (2, 6)]
    gt = tmp_path / "gt"
    gt.mkdir()
    (gt / "phase_to_frames_2.json").write_text(json.dumps({"sterile": [0, 0]}))
    assert cli.main(["phases-eval", "--gt-dir", str(gt), "--pred-dir", "ph"]) == 0
    assert "Take 2" in capsys.readouterr().out


def test_vocabulary_comes_from_the_data_roots_files(tmp_path):
    """With classes.txt / relationships.txt in the data root, the CLI's
    model and JSON use that vocabulary (as or4d_tpu/cli.py:507-511)."""
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB

    root = tmp_path / "root"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("colorimage", "object_scans", "object_pose_results"))
    (root / "classes.txt").write_text("\n".join(DEFAULT_VOCAB.class_names) + "\n")
    relations = ["Assisting", "CloseTo", "LyingOn"]
    (root / "relationships.txt").write_text("\n".join(relations) + "\n")
    out = tmp_path / "rels.json"
    assert cli.main(["infer", "--config", write_config(tmp_path / "tiny.json"), "--data-root", str(root),
                     "--strict-data", "--cache-dir", str(tmp_path / "c"), "--split", "val", "--output", str(out),
                     "--device", "cpu"]) == 0
    rels = json.loads(out.read_text())["4_000000_1"]
    assert rels and {r for _s, r, _o in rels} <= set(relations)
