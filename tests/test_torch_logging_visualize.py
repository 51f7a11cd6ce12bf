"""The port's metrics logger and L5 visualization against the JAX package:
``MetricsLogger`` records and report files, the files ``Trainer.fit(log_dir=...)``
writes beside the JAX ``fit``'s on ``tiny``, the scene-graph HTML (the same
bytes), the instance-label and confusion-matrix PNGs (matplotlib), and the
``visualize`` CLI mode."""

import json

import jax
import numpy as np
import pytest

from or4d_tpu import cli as jcli
from or4d_tpu.config import TINY as J_TINY
from or4d_tpu.data.synthetic import make_scene_batch as j_make_scene_batch
from or4d_tpu.data.vocab import DEFAULT_VOCAB as J_VOCAB
from or4d_tpu.parallel.mesh import make_mesh
from or4d_tpu.train.loop import Trainer as JTrainer
from or4d_tpu.train.metrics import classification_report as j_classification_report
from or4d_tpu.utils import logging as jlogging
from or4d_tpu.utils import visualize as jvis
from tests.test_torch_train import _port_batch

from or4d_tpu_torch import cli
from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
from or4d_tpu_torch.train.loop import Trainer
from or4d_tpu_torch.train.metrics import classification_report
from or4d_tpu_torch.utils import logging as tlogging
from or4d_tpu_torch.utils import visualize as tvis

RELS = [("human_0", "Holding", "instrument"), ("human_1", "CloseTo", "operating_table"),
        ("Patient", "LyingOn", "operating_table"), ("human_0", "Cutting", "Patient")]


def _records(path):
    """JSONL records without their wall-clock stamp."""
    return [{k: v for k, v in json.loads(line).items() if k != "ts"} for line in path.read_text().splitlines()]


def test_metrics_logger_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    names = ["CloseTo", "Holding", "LyingOn"]
    y, p = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
    for side, mod, report in (("jax", jlogging, j_classification_report), ("port", tlogging, classification_report)):
        log = mod.MetricsLogger(tmp_path / side, name="run")
        log.log(3, loss=np.float32(0.5), f1=0.25, note="x")
        log.log_per_take(3, "val", {1: report(y[:20], p[:20], names), 4: report(y[20:], p[20:], names)})
        log.log_report("val_report", 3, report(y, p, names).to_text())
        log.close()
    got, want = _records(tmp_path / "port" / "run.jsonl"), _records(tmp_path / "jax" / "run.jsonl")
    assert got == want and len(got) == 1 + 2 * 3
    assert list(got[1]) == ["step", "CloseTo/1_PR", "CloseTo/1_RE", "CloseTo/1_F1", "split"]
    assert sorted(f.name for f in (tmp_path / "port").iterdir()) == ["run.jsonl", "val_report_step3.txt"]
    assert (tmp_path / "port" / "val_report_step3.txt").read_text() == (
        tmp_path / "jax" / "val_report_step3.txt").read_text()


def test_fit_log_dir_writes_the_jax_files(tmp_path):
    """Two epochs on tiny with validation: the same files, and per line the
    same keys, steps and splits (the values come from each side's own
    random draws)."""
    jbatch = j_make_scene_batch(ds=J_TINY.dataset, num_scenes=2, seed=5, n_objects=4, points_per_obj=150)
    w_obj, w_rel = np.ones(12, np.float32), np.ones(15, np.float32)
    jt = JTrainer(J_TINY, J_VOCAB, w_obj, w_rel, mesh=make_mesh(dp=1, devices=jax.devices()[:1]))
    state = jt.init_state(jax.random.key(0), jbatch)
    jt.fit(state, [jbatch], val_batches=[jbatch], epochs=2, log_every=0, log_dir=str(tmp_path / "jax"))
    batch = _port_batch(jbatch)
    Trainer(TINY, DEFAULT_VOCAB, w_obj, w_rel, device="cpu").fit([batch], val_batches=[batch], epochs=2, log_every=0,
                                                                  log_dir=str(tmp_path / "port"))
    files = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert files == sorted(f.name for f in (tmp_path / "jax").iterdir())
    assert files == ["tiny.jsonl", "train_report_step0.txt", "train_report_step1.txt"]
    got, want = _records(tmp_path / "port" / "tiny.jsonl"), _records(tmp_path / "jax" / "tiny.jsonl")
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["step"], r.get("split")) for r in got] == [(r["step"], r.get("split")) for r in want]
    assert list(got[0]) == ["step", "epoch", "train_loss", "train_macro_f1", "val_macro_f1", "steps_per_sec"]
    assert got[0]["steps_per_sec"] > 0
    for name in files[1:]:
        lines = [(tmp_path / side / name).read_text().splitlines() for side in ("port", "jax")]
        assert [line.split()[:1] for line in lines[0]] == [line.split()[:1] for line in lines[1]]


@pytest.mark.parametrize("case", ["relations", "escaped names", "empty"])
def test_scene_graph_html_bytes_equal_jax(tmp_path, case):
    rels = {"relations": RELS, "escaped names": [("<b>", "A&B", "x\"y")], "empty": []}[case]
    tvis.scene_graph_to_html(rels, tmp_path / "port.html", title=f"scene graph <{case}>")
    jvis.scene_graph_to_html(rels, tmp_path / "jax.html", title=f"scene graph <{case}>")
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_pngs_are_written(tmp_path):
    """The instance-label render and the confusion matrix (matplotlib, which
    the module imports only when a PNG is asked for)."""
    rng = np.random.default_rng(1)
    points = rng.standard_normal((3000, 3)).astype(np.float32)
    labels = rng.integers(-1, 8, 3000)
    tvis.instance_labels_to_png(points, labels, tmp_path / "labels.png", max_points=2000, title="scan")
    tvis.confusion_matrix_png(rng.integers(0, 4, 50), rng.integers(0, 4, 50), list("abcd"), tmp_path / "cm.png")
    for name in ("labels.png", "cm.png"):
        data = (tmp_path / name).read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000


def test_visualize_cli_writes_the_jax_files(tmp_path, capsys):
    """``visualize --relations``: one HTML a non-empty scan, the same names
    and bytes as the JAX CLI's, and the same print."""
    rels = {"1_000000": [list(r) for r in RELS], "1_000001": [], "4_000002_test": [list(r) for r in RELS[:2]]}
    (tmp_path / "rels.json").write_text(json.dumps(rels))
    outs = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        argv = ["visualize", "--relations", str(tmp_path / "rels.json"), "--output-dir", str(tmp_path / side)]
        assert main(argv) == 0
        outs[side] = capsys.readouterr().out.replace(str(tmp_path / side), "OUT")
    assert outs["port"] == outs["jax"] == "wrote 2 visualizations to OUT\n"
    files = sorted(f.name for f in (tmp_path / "port").iterdir())
    assert files == sorted(f.name for f in (tmp_path / "jax").iterdir()) == ["sg_1_000000.html", "sg_4_000002.html"]
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
