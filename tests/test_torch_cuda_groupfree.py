"""On the card: the Group-Free detector's two kernels at its own shapes, and
its eval forward against the CPU's.

* TPU row 2 (FPS: ``fps_cluster.cu`` for SA1's 20,000-point clouds,
  ``fps.cu`` for SA2-SA4) and row 8 (the one-scale index ball query,
  ``ball_query_multiscale.cu``; SA1's cloud is too large to stage, so its
  plan reads global memory) against their plain versions, bit for bit, on
  the inputs a B = 2 forward hands them, recorded; both counters rise;
* the eval forward at full width (20,000 points x 6 channels, 128
  proposals, 6 decoder layers) from one set of random weights on the card
  and on the CPU: ``seed_inds`` equal, the set of ``sample_inds`` equal
  where the gap between the 128th and 129th seed logits is above twice
  their largest difference (the gap is asserted), the last head's outputs
  within 1e-4 of their largest value candidate by candidate (float32, TF32
  off).

Every test carries the ``cuda`` marker and skips inside the test when no
card is present. This file imports no JAX:

    python -m pytest tests/test_torch_cuda_groupfree.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from or4d_tpu_torch.models import groupfree
from or4d_tpu_torch.ops import ball_query_multiscale as bqm
from or4d_tpu_torch.ops import fps, launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda
SA_SHAPES = ((20000, 2048, 0.2, 64), (2048, 1024, 0.4, 32), (1024, 512, 0.8, 16), (512, 256, 1.2, 16))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scan(seed: int, B: int, N: int = 20000) -> torch.Tensor:
    """A room-sized random cloud, xyz in metres and centred colours."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5], (B, N, 3))
    return torch.from_numpy(np.concatenate([xyz, rng.uniform(-0.5, 0.5, (B, N, 3))], -1).astype(np.float32))


def mean_sizes() -> torch.Tensor:
    return torch.tensor([[0.6, 1.0, 0.5], [2.0, 0.8, 0.7], [1.2, 0.9, 0.6], [0.8, 0.8, 0.6]])


def test_rows_2_and_8_exact_at_the_detector_shapes(card, monkeypatch):
    calls = []
    f, b = groupfree.furthest_point_sample, groupfree.ball_query_multiscale
    monkeypatch.setattr(groupfree, "furthest_point_sample",
                        lambda xyz, n: calls.append(("fps", xyz.clone(), n)) or f(xyz, n))
    monkeypatch.setattr(groupfree, "ball_query_multiscale",
                        lambda sc, xyz, new: calls.append(("bq", xyz.clone(), new.clone(), sc)) or b(sc, xyz, new))
    model = groupfree.GroupFreeDetector(device=card, seed=0).eval()
    reset_launch_counts()
    with torch.no_grad():
        model(scan(1, 2).to(card), mean_sizes().to(card))
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fps.fps_large"] == 1 and counts["fps.fps"] == 3 and counts["ball_query.multiscale"] == 4
    fps_calls = [c for c in calls if c[0] == "fps"]
    bq_calls = [c for c in calls if c[0] == "bq"]
    assert [(c[1].shape[1], c[2]) for c in fps_calls] == [(N, M) for N, M, _r, _ns in SA_SHAPES]
    for _k, xyz, n in fps_calls:
        torch.testing.assert_close(fps.furthest_point_sample(xyz, n).cpu(),
                                   fps.furthest_point_sample_plain(xyz, n).cpu(), rtol=0, atol=0)
    for (N, M, r, ns), (_k, xyz, new, sc) in zip(SA_SHAPES, bq_calls):
        assert sc == ((r, ns),) and xyz.shape[1] == N and new.shape[1] == M
        plan = bqm.multiscale_plan(2, N, M, sc)
        assert plan.stage_xyz == (N != 20000)  # SA1's 240 KB cloud is read from global memory
        (got,) = bqm.ball_query_multiscale(sc, xyz, new)
        (want,) = bqm.ball_query_multiscale_plain(sc, xyz, new)
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0)


def test_detector_forward_on_the_card_equals_the_cpu(card):
    gpu = groupfree.GroupFreeDetector(device=card, seed=3).eval()
    cpu = groupfree.GroupFreeDetector(device="cpu", seed=3).eval()
    pc, msa = scan(2, 1), mean_sizes()
    with torch.no_grad():
        got = gpu(pc.to(card), msa.to(card))
        want = cpu(pc, msa)
    assert torch.equal(got["seed_inds"].cpu(), want["seed_inds"])
    logits = want["seeds_obj_cls_logits"]
    d = float((got["seeds_obj_cls_logits"].cpu() - logits).abs().max())
    ranked = torch.sort(logits, dim=1, descending=True).values
    gap = float(ranked[0, 127] - ranked[0, 128])
    assert gap > 2 * d, f"rank-128 gap {gap} within twice the logit difference {d}: not this input"
    # the gap decides the candidate set; two candidates whose logits are
    # closer than the sides differ may swap order, so heads are compared
    # candidate by candidate
    g_inds, w_inds = got["sample_inds"][0].cpu(), want["sample_inds"][0]
    assert torch.equal(g_inds.sort().values, w_inds.sort().values)
    perm = torch.argsort(g_inds)[torch.argsort(torch.argsort(w_inds))]
    for key, w in want["last"].items():
        diff = float((got["last"][key].cpu()[:, perm] - w).abs().max())
        assert diff <= 1e-4 * float(w.abs().max()), (key, diff)
