"""The port's role dataset assembly and Graphormer trainer against the JAX
package (``tests/test_role_dataset.py`` on the port): track labelling, the
GT loader, the synthetic generators (the same arrays as the JAX package's),
a short training run whose loss falls, temperature-4 scoring and the LR
schedule."""

import json

import numpy as np
import pytest
import torch

from or4d_tpu.pipeline import role_dataset as jrd
from or4d_tpu.train.graphormer_trainer import polynomial_decay_lr as j_polynomial_decay_lr

from or4d_tpu_torch.pipeline.role_dataset import (build_tracks, label_track, load_gt_scene_graphs_in_prediction_format,
                                                  majority_role, make_synthetic_role_dataset, make_synthetic_role_take,
                                                  make_synthetic_track)
from or4d_tpu_torch.pipeline.role_graphormer import ROLE_TO_INDEX
from or4d_tpu_torch.train.graphormer_trainer import GraphormerTrainer, polynomial_decay_lr

FIELDS = ("x", "attn_bias", "spatial_pos", "in_degree", "out_degree", "edge_input", "is_target")


def _same_batch(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)


def _same_track(got, want):
    assert (got.take_idx, got.track_idx, got.role_label) == (want.take_idx, want.track_idx, want.role_label)
    assert list(got.timestamp_to_human_pose) == list(want.timestamp_to_human_pose)
    for f, (name, joints) in want.timestamp_to_human_pose.items():
        assert got.timestamp_to_human_pose[f][0] == name
        np.testing.assert_array_equal(got.timestamp_to_human_pose[f][1], joints)


class TestLabeling:
    def test_majority_role(self):
        assert majority_role(["Patient", "Patient", "head-surgeon", None]) == "Patient"
        assert majority_role([None, None]) is None

    def test_label_track_nearest_gt(self):
        joints_a = np.zeros((14, 3))
        joints_b = np.ones((14, 3)) * 10
        poses = {"000001": ("human_0", joints_a + 0.1)}
        gt = {"000001": {"1": ("head-surgeon", joints_a), "2": ("Patient", joints_b)}}
        assert label_track(poses, gt) == "head-surgeon" == jrd.label_track(poses, gt)

    def test_build_tracks_filters(self):
        t_ok = {"timestamp_to_human_pose": {"000001": ("human_0", np.zeros((14, 3)))}}
        t_empty = {"timestamp_to_human_pose": {"000009": ("human_1", np.zeros((14, 3)))}}
        t_none = {"timestamp_to_human_pose": {"000002": ("human_2", np.zeros((14, 3)))}}
        rels = {"000001": [("human_0", "LyingOn", "operating_table")], "000002": [("human_2", "CloseTo", "object")]}
        gt = {"000001": {"1": ("Patient", np.zeros((14, 3)))}, "000002": {"1": ("none", np.zeros((14, 3)))}}
        tracks = build_tracks(4, [t_ok, t_empty, t_none], rels, gt)
        assert len(tracks) == 1
        assert tracks[0].role_label == ROLE_TO_INDEX["Patient"]
        (want,) = jrd.build_tracks(4, [t_ok, t_empty, t_none], rels, gt)
        _same_track(tracks[0], want)
        assert build_tracks(4, [t_ok], rels, {}) == jrd.build_tracks(4, [t_ok], rels, {}) == []

    def test_gt_prediction_format_patient_rename(self, tmp_path):
        scans = {"scans": [
            {"take_idx": 4, "scan": "000000", "objects": {"1": "Patient", "2": "human_0", "3": "operating_table"},
             "relationships": [[1, 3, 8, "LyingOn"]], "human_idx_to_name": {}},
            {"take_idx": 1, "scan": "000003", "objects": {"1": "human_2", "2": "instrument"},
             "relationships": [[1, 2, 7, "Holding"]], "human_idx_to_name": {}},
        ]}
        (tmp_path / "relationships_validation.json").write_text(json.dumps(scans))
        (tmp_path / "relationships_train.json").write_text(json.dumps({"scans": scans["scans"][1:]}))
        out = load_gt_scene_graphs_in_prediction_format(tmp_path)
        assert out["4_000000"] == [("human_1", "LyingOn", "operating_table")]
        assert out == jrd.load_gt_scene_graphs_in_prediction_format(tmp_path)


class TestSyntheticAndTraining:
    def test_synthetic_dataset_shapes(self):
        data = make_synthetic_role_dataset(tracks_per_role=1, n_frames=3, max_graphs=3)
        assert len(data) == 5
        batch, label = data[0]
        assert batch.x.shape[0] == 3
        assert 0 <= label < 5

    @pytest.mark.parametrize("gen", ["track", "dataset", "take"])
    def test_synthetic_generators_equal_jax(self, gen):
        if gen == "track":
            for role in ("Patient", "head-surgeon", "anaesthetist"):
                (t, f2r), (jt, jf2r) = (make_synthetic_track(role, n_frames=3, seed=5),
                                        jrd.make_synthetic_track(role, n_frames=3, seed=5))
                _same_track(t, jt)
                assert f2r == jf2r
                _same_batch(t.to_batch(f2r, max_graphs=4), jt.to_batch(jf2r, max_graphs=4))
        elif gen == "dataset":
            got, want = (make_synthetic_role_dataset(tracks_per_role=2, n_frames=3, max_graphs=3),
                         jrd.make_synthetic_role_dataset(tracks_per_role=2, n_frames=3, max_graphs=3))
            assert [label for _, label in got] == [label for _, label in want]
            for (b, _), (jb, _) in zip(got, want):
                _same_batch(b, jb)
        else:
            (tracks, f2r, data), (jtracks, jf2r, jdata) = make_synthetic_role_take(3), jrd.make_synthetic_role_take(3)
            assert f2r == jf2r and len(tracks) == len(jtracks) == 5
            for t, jt in zip(tracks, jtracks):
                _same_track(t, jt)
            for (b, label), (jb, jlabel) in zip(data, jdata):
                assert label == jlabel
                _same_batch(b, jb)

    def test_trainer_loss_decreases(self):
        trainer = GraphormerTrainer(n_layers=2, hidden=16, ffn=16, heads=4, peak_lr=1e-3, warmup_updates=5,
                                    tot_updates=200, device="cpu")
        data = make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)
        losses = trainer.fit(data, epochs=6, balance=False)
        assert np.isfinite(losses).all()
        assert np.mean(losses[-5:]) < np.mean(losses[:5])

    def test_score_track_temperature(self):
        trainer = GraphormerTrainer(n_layers=1, hidden=16, ffn=16, heads=4, device="cpu", seed=1)
        batch, _ = make_synthetic_role_dataset(tracks_per_role=1, n_frames=2, max_graphs=2)[0]
        scores = trainer.score_track(batch)
        assert set(scores) == {"Patient", "head_surgeon", "assistant_surgeon", "circulating_nurse", "anaesthetist"}
        assert abs(sum(scores.values()) - 1.0) < 1e-5
        logits = trainer.model(batch).detach()
        np.testing.assert_allclose(list(scores.values()), torch.softmax(logits / 4.0, -1).numpy(), rtol=1e-6)

    def test_polynomial_decay_schedule(self):
        sched = polynomial_decay_lr(peak_lr=1.0, end_lr=0.1, warmup=10, total=100)
        assert sched(0) == pytest.approx(0.1)  # first update: 1/10 * 1.0
        assert sched(9) == pytest.approx(1.0)  # end of warmup
        assert sched(54) == pytest.approx(1.0 - (55 - 10) / 90 * 0.9, rel=1e-5)
        assert sched(200) == pytest.approx(0.1)
        want = j_polynomial_decay_lr(peak_lr=1.0, end_lr=0.1, warmup=10, total=100)
        assert [np.float32(sched(s)) for s in range(0, 201, 7)] == [np.float32(want(s)) for s in range(0, 201, 7)]


def test_trainer_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphormerTrainer(n_layers=1, hidden=16, ffn=16, heads=4)
    assert GraphormerTrainer(n_layers=1, hidden=16, ffn=16, heads=4, device="cpu").device == torch.device("cpu")
