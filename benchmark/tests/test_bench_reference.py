"""The plain reference against the program's CPU path at a small size: the
geometry exactly, the SGPN eval forward, three train steps, the B5
embedding, the relation F1; and the generators the benchmark makes its
inputs and weights with."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH, tiny_config
from harness import compare, program, relation_f1, scenes, weights
from harness.inputs import param_specs, to_device
from reference import efficientnet as ref_b5, geometry, sgpn as ref_sgpn, train as ref_train

SEED = 2**31 + 101


def _clouds(B=3, N=700, seed=0):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.randn(B, N, 3, generator=g) * 0.5
    xyz[:, 5:40] *= 1e-3  # points the FPS never takes
    xyz[:, 100:110] = xyz[:, 200:210]  # duplicates: distance ties
    return xyz.contiguous()


def test_fps_equals_the_programs():
    from or4d_tpu_torch.ops.fps import furthest_point_sample_plain

    xyz = _clouds()
    assert torch.equal(geometry.fps(xyz, 64), furthest_point_sample_plain(xyz, 64).long())


@pytest.mark.parametrize("radius,ns", [(0.1, 16), (0.4, 32), (2.0, 8)])
def test_ball_query_equals_the_programs(radius, ns):
    from or4d_tpu_torch.ops.ball_query import ball_query

    xyz = _clouds()
    q = geometry.gather_points(xyz, geometry.fps(xyz, 48))
    assert torch.equal(geometry.ball_query(xyz, q, radius, ns), ball_query(radius, ns, xyz, q).long())


def test_scenes_are_made_from_the_seed():
    sh = scenes.Shapes(5, 80, 6, 30, 96, 160, True)
    a = scenes.make_batch(SEED, range(3), sh)
    b = scenes.make_batch(SEED, range(3), sh)
    c = scenes.make_batch(SEED + 1, range(3), sh)
    for k in ("obj_points", "rel_points", "gt_rels", "edge_index", "rel_hand_points"):
        assert np.array_equal(a[k], b[k]), k
    assert not np.array_equal(a["rel_points"], c["rel_points"])
    assert a["obj_mask"].sum() == 15 and a["edge_mask"].sum() == 60
    # pair-shared: the reverse edge carries the forward crop with the masks swapped
    e_fwd = next(e for e in range(30) if tuple(a["edge_index"][0, e]) == (0, 1))
    e_rev = next(e for e in range(30) if tuple(a["edge_index"][0, e]) == (1, 0))
    f, r = a["rel_points"][0, e_fwd], a["rel_points"][0, e_rev]
    assert np.array_equal(f[:, :6], r[:, :6]) and np.array_equal(np.where(f[:, 6] > 0, 3 - f[:, 6], 0), r[:, 6])
    assert set(np.unique(f[:, 6])) <= {0.0, 1.0, 2.0}
    norms = np.linalg.norm(a["obj_points"][0, :5, :, :3], axis=-1).max(-1)
    assert np.allclose(norms, 1.0, atol=1e-5)


@pytest.mark.parametrize("config", ["sgpn-no_gt", "sgpn-no_gt_image"])
def test_weights_load_strictly_into_the_program_at_full_width(config):
    from or4d_tpu_torch.config import ExperimentConfig
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.models.sgpn import SGPN

    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    P = weights.make_params(param_specs(cfg), SEED, "cpu")
    assert all(torch.equal(P[k], v) for k, v in weights.make_params(param_specs(cfg), SEED, "cpu").items())
    model = SGPN.from_config(ExperimentConfig.from_reference_json(cfg), DEFAULT_VOCAB.num_classes,
                             DEFAULT_VOCAB.num_relations, device="cpu")
    model.load_state_dict(P, strict=True)
    assert all(torch.isfinite(v).all() for v in P.values())


def _tiny(tiny_run, cell, dtype="float32"):
    run = tiny_run(cell)
    run.cell.traffic["dtype"] = dtype
    return run


def test_eval_forward_follows_the_program(tiny_run):
    run = _tiny(tiny_run, "no_gt.eval.s64")
    cfg = run.cell.config
    arrays = scenes.make_batch(run.seed, range(3), scenes.Shapes(4, 60, 6, 30, 96, 160, True))
    P = weights.make_params(param_specs(cfg), run.seed, "cpu")
    tr = program.trainer(run.cell, P, torch.ones(12), torch.ones(15), "cpu")
    rel, obj = tr.eval_step(program.scene_batch(arrays))
    robj, rrel = ref_sgpn.forward(P, cfg, to_device(arrays, "cpu"))
    assert compare.logprob_gap(rel, rrel, torch.as_tensor(arrays["edge_mask"])) < 1e-4
    assert compare.logprob_gap(obj, robj, torch.as_tensor(arrays["obj_mask"])) < 1e-4


def test_train_steps_follow_the_program(tiny_run):
    from harness.spec import driver

    WARM_STEPS, checks, first_steps = (getattr(driver("train"), n) for n in ("WARM_STEPS", "checks", "first_steps"))
    run = _tiny(tiny_run, "no_gt.train.s8")
    cfg = run.cell.config
    sh = scenes.Shapes(4, 60, 6, 30, 96, 160, False)
    arrays = [scenes.make_batch(run.seed, range(3 * i, 3 * i + 3), sh) for i in range(WARM_STEPS)]
    P0 = weights.make_params(param_specs(cfg), run.seed, "cpu")
    w_obj, w_rel = torch.rand(12) + 0.5, torch.rand(15) + 0.5
    tr = program.trainer(run.cell, P0, w_obj, w_rel, "cpu")
    prog = first_steps(tr, [program.scene_batch(a) for a in arrays], torch.Generator().manual_seed(7), P0)
    ref = ref_train.train_steps(P0, cfg, [to_device(a, "cpu") for a in arrays], 7, w_obj, w_rel,
                                scenes.CONTACT_IDS, WARM_STEPS)
    got = checks(prog, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_norm_gap"] < 1e-4 and got["change_norm_gap"] < 1e-2, got


def test_augmentation_equals_the_programs():
    from or4d_tpu_torch.data.augment import augment_batch_with, draw_augment

    sh = scenes.Shapes(4, 60, 6, 30, 96, 160, False)
    arrays = scenes.make_batch(SEED, range(2), sh)
    arrays["gt_rels"][0, :4] = scenes.CONTACT_IDS[0]  # hand zeroing on some edges
    b = to_device(arrays, "cpu")
    d = ref_train.draw_step(2, 6, 30, torch.Generator().manual_seed(3), True)
    mine = ref_train.augment_batch(b, d, scenes.CONTACT_IDS)
    theirs = augment_batch_with(program.scene_batch(arrays).to("cpu"), draw_augment(2, 6, 30, torch.Generator()
                                                                                      .manual_seed(3)))
    assert torch.equal(mine["obj_points"], theirs.obj_points) and torch.equal(mine["rel_points"], theirs.rel_points)


def test_image_embedding_follows_the_program():
    from or4d_tpu_torch.models.efficientnet import ImageBranch

    cfg = tiny_config("sgpn-no_gt_image")
    P = weights.make_params(ref_b5.param_specs(cfg), SEED, "cpu")
    branch = ImageBranch(768, device="cpu")
    branch.load_state_dict({k.removeprefix("image_branch."): v for k, v in P.items()}, strict=True)
    frames = torch.randn(2, 6, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = branch(frames)
    want = ref_b5.embedding(P, cfg, frames)
    assert got.shape == want.shape == (2, 768)
    assert compare.relative_gap(got, want) < 1e-5


def test_relation_f1_equals_the_programs():
    from or4d_tpu_torch.train.metrics import RelationMetricAccumulator

    rng = np.random.default_rng(0)
    lps = [rng.standard_normal((3, 30, 15)).astype(np.float32) for _ in range(2)]
    gts = [rng.integers(0, 15, (3, 30)) for _ in range(2)]
    masks = [rng.random((3, 30)) < 0.7 for _ in range(2)]
    acc = RelationMetricAccumulator(list(scenes.RELATIONS))

    class B:
        take_idxs = (1, 3, 5)

    for lp, gt, m in zip(lps, gts, masks):
        B.gt_rels, B.edge_mask = gt, m
        acc.update_batch(B, lp)
    assert relation_f1.batches_f1(lps, gts, masks, 15) == acc.macro_f1
