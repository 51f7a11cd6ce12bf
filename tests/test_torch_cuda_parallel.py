"""The port's data parallelism on the card (``parallel.launch.spawn``, each
rank a process on the one H100): an NCCL world of one rank, whose mesh step
and eval must equal the plain ``Trainer``'s bit for bit (every collective is
the identity), and two gloo ranks on the one card (NCCL takes one rank a
GPU), whose step must equal one process's (loss rtol 2e-4, gradients 1e-2
of the largest: a 1e-5 forward difference can flip a max-pool's slot) with
the same parameters on both ranks, and whose dp = 2 serving F1 must equal
dp = 1's within 1e-6. ``chip_smoke.py``'s ``dp`` phase does the same at
full width; these run the ``tiny`` config. And a block of scenes augmented
alone on the card equals that block of the batch augmented, bit for bit.
And ``utils.profiling.trace`` loses no kernel: in 30 traces of the
Group-Free B = 1 eval forward, whose first launch is FPS, each trace holds
as many of the port's FPS and ball-query kernels as the launch counters
rose in its window.

Every test carries the ``cuda`` marker and skips inside the test when no
card is present. This file imports no JAX:

    python -m pytest tests/test_torch_cuda_parallel.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from or4d_tpu_torch.config import TINY
from or4d_tpu_torch.data.scene_batch import SceneBatch
from or4d_tpu_torch.data.synthetic import make_scene_samples
from or4d_tpu_torch.parallel.launch import spawn, trainer_jobs

pytestmark = pytest.mark.cuda

CFG = dataclasses.replace(TINY, dataset=dataclasses.replace(TINY.dataset, data_augmentation=True))
WEIGHTS = (np.ones(12, np.float32), np.ones(15, np.float32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _batch(S: int, seed: int, pair_shared: bool = False) -> SceneBatch:
    return SceneBatch.stack(make_scene_samples(S, seed=seed, n_objects=5, ds=CFG.dataset, points_per_obj=150,
                                               pair_shared=pair_shared))


def test_nccl_world_of_one_equals_the_plain_trainer(card):
    b, e = _batch(4, 1), _batch(4, 2, pair_shared=True)
    job = dict(cfg=CFG, weights=WEIGHTS, seed=3, train=[dict(batch=b, seed=1), dict(batch=b, seed=2)], eval=[e])
    mesh, plain = spawn(trainer_jobs, 1, ([job, dict(job, plain=True)], "cuda"), backend="nccl", device="cuda")[0]
    assert mesh["mesh"] == {"dp": 1, "mp": 1} and mesh["parts"] == plain["parts"]
    for k, v in plain["grads"].items():
        assert torch.equal(mesh["grads"][k], v), k
    for k, v in plain["state"].items():
        assert torch.equal(mesh["state"][k], v), k
    for m, p in zip(mesh["eval"], plain["eval"]):
        assert all(torch.equal(x, y) for x, y in zip(m, p))
    assert mesh["launches"]["group.fwd"] > 0 and mesh["eval_launches"]["sa_group_mlp.plane"] > 0


def test_two_gloo_ranks_on_one_card_equal_one_process(card):
    b, s = _batch(4, 4), _batch(6, 5)
    job = dict(cfg=CFG, weights=WEIGHTS, seed=3, train=[dict(batch=b, seed=1)])
    serve = dict(cfg=CFG, weights=WEIGHTS, seed=3, serving=[s])
    ranks = spawn(trainer_jobs, 2, ([job, serve], "cuda"), backend="gloo", device="cuda")
    one = trainer_jobs([job, serve], "cuda")
    got, want = ranks[0][0], one[0]
    assert got["mesh"] == {"dp": 2, "mp": 1}
    np.testing.assert_allclose(got["parts"][0]["loss"], want["parts"][0]["loss"], rtol=2e-4)
    scale = max(float(v.abs().max()) for v in want["grads"].values())
    assert max(float((got["grads"][k] - v).abs().max()) for k, v in want["grads"].items()) <= 1e-2 * scale
    for k, v in got["state"].items():
        assert torch.equal(ranks[1][0]["state"][k], v), k
    assert all(abs(r[1]["f1"] - one[1]["f1"]) <= 1e-6 for r in ranks)
    assert got["launches"]["group.fwd"] > 0 and ranks[0][1]["serving_launches"]["serving_sa1.mlp"] > 0


def test_a_block_augments_on_the_card_as_in_the_whole_batch(card):
    """A rank's block of scenes augmented alone on the card equals those
    scenes of the whole batch augmented, bit for bit (the augmentation's
    arithmetic does not depend on the batch's shape), so each rank augments
    only its block."""
    import dataclasses as dc

    from or4d_tpu_torch.config import DatasetConfig
    from or4d_tpu_torch.data.augment import augment_batch_with, draw_augment

    batch = SceneBatch.stack(make_scene_samples(4, seed=6, n_objects=9, ds=DatasetConfig(), points_per_obj=2000))
    batch = batch.to("cuda")
    S, O, E = 4, batch.obj_points.shape[1], batch.rel_points.shape[1]
    draws = draw_augment(S, O, E, torch.Generator().manual_seed(2))
    whole = augment_batch_with(batch, draws.to("cuda"))
    for lo, hi in ((0, 2), (2, 4), (1, 2)):
        block = dc.replace(batch, **{f: getattr(batch, f)[lo:hi] for f in (
            "obj_points", "rel_points", "rel_hand_points", "gt_rels")})
        got = augment_batch_with(block, draws.scenes(slice(lo, hi)).to("cuda"))
        assert torch.equal(got.obj_points, whole.obj_points[lo:hi]), (lo, hi)
        assert torch.equal(got.rel_points, whole.rel_points[lo:hi]), (lo, hi)


def test_trace_keeps_every_kernel_of_its_window(card, tmp_path):
    import json

    from or4d_tpu_torch.ops import launch_counts
    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer
    from or4d_tpu_torch.utils.profiling import trace

    model = GroupFreeTrainer(device="cuda", seed=0).model.eval()
    rng = np.random.default_rng(14)
    xyz = rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5], (1, 20000, 3))
    pc = torch.from_numpy(np.concatenate([xyz, rng.uniform(-0.5, 0.5, (1, 20000, 3))], -1).astype(np.float32))
    pc = pc.cuda()
    msa = torch.tensor(((0.6, 1.0, 0.5), (2.0, 0.8, 0.7), (1.2, 0.9, 0.6), (0.8, 0.8, 0.6)), device="cuda")

    def forward():
        with torch.no_grad():
            model(pc, msa, train=False)

    forward()
    torch.cuda.synchronize()
    groups = {"fps": ("fps",), "ball_query": ("ball_query", "multiscale")}  # kernel names -> counter prefixes
    lost = []
    for i in range(30):
        before = launch_counts()
        with trace(tmp_path / str(i)) as path:
            forward()
        after = launch_counts()
        kernels = [e["name"].lower() for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "kernel"]
        for g, names in groups.items():
            traced = sum(any(k in name for k in names) for name in kernels)
            rose = sum(n - before.get(c, 0) for c, n in after.items() if c.startswith(g + "."))
            assert rose > 0, (g, after)
            if traced != rose:
                lost.append({"trace": i, "group": g, "traced": traced, "launched": rose})
    assert not lost, lost
