"""FPS over 8192 points (TPU row 2's function, and row 1's counts and
bounds, on clouds that ``csrc/fps_cluster.cu`` takes), on the CPU.

The port's plain version is what a CPU tensor runs and what chip_smoke and
the card tests hold the cluster kernel to, bit for bit. Here it is held:

* on tied clouds (grids, where many points sit at equal distances) against
  a numpy model of the TPU kernel's arithmetic: XLA on the CPU contracts
  ``dx*dx + dy*dy + dz*dz`` into FMAs, so the JAX package's CPU FPS breaks
  exact ties apart from the TPU kernel and is no reference there;
* on random clouds (no exact ties) against ``furthest_point_sample_pallas``
  and ``furthest_point_sample_with_counts`` in interpret mode, and the bound
  against the JAX package's ``_counts_to_bounds`` of those counts.

Indices, counts and bounds must be equal. The cluster plan (CTAs a cloud,
chunks a CTA) is checked against the kernel source's constants.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu.ops.pallas_ball_query import _counts_to_bounds
from or4d_tpu.ops.pallas_fps import furthest_point_sample_pallas, furthest_point_sample_with_counts as j_counts

from or4d_tpu_torch.ops import _build, fps

SCALES = ((0.1, 16), (0.2, 32))


def tpu_fps(points: np.ndarray, n: int) -> np.ndarray:
    """FPS indices in the TPU kernel's float32 arithmetic: each product and
    sum rounded, ``(dx*dx + dy*dy) + dz*dz``; ties to the lowest index."""
    x = np.asarray(points, np.float32)
    mag = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    mind = np.where(mag > np.float32(1e-3), np.float32(np.inf), np.float32(-1.0)).astype(np.float32)
    idx, sel = [0], 0
    for _ in range(1, n):
        d = x - x[sel]
        mind = np.minimum(mind, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])
        sel = int(np.argmax(mind))
        idx.append(sel)
    return np.asarray(idx)


def _grid(N: int, spacing: float = 0.05) -> np.ndarray:
    """N points of a regular 3D grid (exact distance ties everywhere), the
    first one off the origin and a few within |p|^2 <= 1e-3."""
    side = int(np.ceil(N ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:N]
    pts = ((g - side // 2) * spacing).astype(np.float32)
    pts[[0, side * side // 2]] = pts[[side * side // 2, 0]]  # index 0 off the origin
    return pts


def _random(seed: int, B: int, N: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    xyz[:, 5:9] = rng.uniform(-0.01, 0.01, (B, 4, 3))  # |p|^2 <= 1e-3: never selected
    return xyz


@pytest.mark.parametrize("N", [8193, 20000])
def test_plain_fps_equals_the_tpu_arithmetic_on_tied_grids(N):
    pts = _grid(N)
    got = fps.furthest_point_sample(torch.from_numpy(pts)[None], 256)[0].numpy()
    np.testing.assert_array_equal(got, tpu_fps(pts, 256))
    assert len(set(got.tolist())) == 256


@pytest.mark.parametrize("N,npoint", [(8193, 64), (20000, 48)])
def test_plain_fps_equals_pallas_on_random_clouds(N, npoint):
    xyz = _random(N, 2, N)
    want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), npoint, True))
    got = fps.furthest_point_sample(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(np.arange(5, 9), got.numpy()).any()


def test_counts_and_bounds_equal_pallas_at_20000_points():
    xyz = _random(3, 2, 20000)
    radii = tuple(r for r, _ in SCALES)
    widx, wcounts = j_counts(jnp.asarray(xyz), 32, radii, True)
    idx, counts = fps.furthest_point_sample_with_counts(torch.from_numpy(xyz), 32, radii)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    for c, w in zip(counts, wcounts):
        assert c.shape == (2, 32, 40)
        np.testing.assert_array_equal(c.numpy(), np.asarray(w))
    want = _counts_to_bounds(SCALES, tuple(wcounts))
    bidx, need = fps.furthest_point_sample_with_bounds(torch.from_numpy(xyz), 32, SCALES)
    np.testing.assert_array_equal(bidx.numpy(), np.asarray(widx))
    for n, (wn, _wt) in zip(need, want):
        np.testing.assert_array_equal(n.numpy(), np.asarray(wn))


def _source_constants() -> dict:
    src = (_build.CSRC / "fps_cluster.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_cluster_plan_constants_match_the_kernel_source():
    c = _source_constants()
    assert (c["kChunk"], c["kWarps"], c["kMaxCluster"]) == (fps.CHUNK, fps._WARPS, fps._MAX_CLUSTER)
    assert "fps_cluster" in _build.SOURCES


@pytest.mark.parametrize("N", [8193, 8704, 20000, 65536, 65537, 200000, 2_000_000])
def test_cluster_plan_covers_every_chunk_once(N):
    plan = fps.cluster_plan(N)
    nch = -(-N // fps.CHUNK)
    assert 2 <= plan.ctas <= 8 and plan.ctas * plan.share >= nch and (plan.ctas - 1) * plan.share < nch
    if plan.streamed:
        assert N > 65536 and plan.warps == 16
    else:
        assert plan.warps == plan.share <= 16 and plan.share * fps.CHUNK * 12 <= 98304


def test_cluster_plan_refuses_clouds_the_single_block_kernel_takes():
    with pytest.raises(ValueError, match="N > 8192"):
        fps.cluster_plan(8192)
