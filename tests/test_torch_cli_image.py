"""The port's CLI with the image branch, on the CPU: ``train``,
``evaluate`` and ``infer`` from the fixture root, whose takes carry the
camera frames, with a ``no_gt_image``-style JSON config at the tiny point
shapes (32 x 32 frames; ``IMAGE_INPUT: "full"``), single-label and with
``MULTI_REL_OUTPUTS``. The relations each mode writes come out finite and
well formed; the samples carry the decoded frames."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_cli import TINY_JSON

from or4d_tpu_torch import cli
from or4d_tpu_torch.config import load_config
from or4d_tpu_torch.data.dataset import ORDataset
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB

ROOT = Path(__file__).parent / "golden" / "real_data"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's CPU convolutions and steps,
    so the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(path: Path, multi_rel: bool) -> str:
    cfg = json.loads(json.dumps(TINY_JSON))
    cfg["IMAGE_INPUT"] = "full"
    cfg["MODEL"].update({"IMAGE_MODEL": "tf_efficientnet_b5_ns", "IMAGE_SIZE": 32, "MULTI_REL_OUTPUTS": multi_rel})
    path.write_text(json.dumps(cfg))
    return str(path)


def test_the_builtin_no_gt_image_config_is_the_paper_multimodal_one():
    cfg = load_config("no_gt_image")
    assert cfg.image_input == "full" and cfg.model.image_size == 456 and cfg.model.full_image_embedding_size == 768
    assert not cfg.model.multi_rel_outputs


@pytest.mark.parametrize("multi_rel", [False, True], ids=["single", "multi_rel"])
def test_cli_trains_evaluates_and_infers_with_images_on_the_cpu(tmp_path, monkeypatch, capsys, multi_rel):
    monkeypatch.chdir(tmp_path)
    config = _config(tmp_path / "image.json", multi_rel)
    cfg = load_config(config)
    assert cfg.image_input == "full" and cfg.model.multi_rel_outputs == multi_rel
    sample = ORDataset(cfg, "val", DEFAULT_VOCAB, data_root=ROOT, cache_dir=tmp_path / "ds").sample(0)
    assert sample.images.shape == (6, 32, 32, 3) and np.isfinite(sample.images).all()
    assert sample.gt_rels.ndim == (2 if multi_rel else 1)

    base = ["--config", config, "--data-root", str(ROOT), "--strict-data", "--cache-dir", "cache", "--device", "cpu"]
    assert cli.main(["train", *base, "--checkpoint-dir", "ck", "--epochs", "1"]) == 0
    hist = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(hist["train_loss"]) and np.isfinite(hist["val_macro_f1"])
    assert cli.main(["evaluate", *base, "--checkpoint-dir", "ck"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(rec["relation_macro_f1"])
    assert cli.main(["infer", *base, "--checkpoint-dir", "ck", "--split", "val", "--output", "rels.json"]) == 0
    rels = json.loads((tmp_path / "rels.json").read_text())
    assert list(rels) == ["4_000000_1"]
    assert all(len(t) == 3 and t[1] in DEFAULT_VOCAB.relation_names and t[1] != "none" for t in rels["4_000000_1"])
