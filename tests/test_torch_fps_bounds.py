"""The FPS kernel's search bounds (``furthest_point_sample_with_bounds``,
TPU row 1's function on the model paths) against the JAX package, on the
CPU.

The same numpy clouds go through ``furthest_point_sample_with_counts`` in
interpret mode followed by ``_counts_to_bounds`` (the JAX package's own
route to the bound) and through the port with CPU tensors, its plain
version. Indices and ``need`` must agree exactly. The clouds are built so
that a query's nsample-th hit is the last point of a chunk, a query has
fewer hits than nsample (one far point, and a clustered cloud with
duplicate points), N is not a multiple of 512, and some points lie within
|p|^2 <= 1e-3 (never selected).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from or4d_tpu.ops.pallas_ball_query import _counts_to_bounds
from or4d_tpu.ops.pallas_fps import furthest_point_sample_with_counts as j_fps_counts

from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops.fps import (furthest_point_sample, furthest_point_sample_with_bounds,
                                    furthest_point_sample_with_bounds_plain, furthest_point_sample_with_counts)
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

SA1_SCALES = ((0.1, 16), (0.2, 32))


def _chunk_edge_cloud(seed, B=2, N=1100):
    """Point 0 (FPS's first query) has its 16th hit at radius 0.1 on point
    511, the last point of chunk 0: 14 hits among points 1..510, every other
    point of chunk 0 beyond 0.2; chunk 1 holds more hits. Point N-1 is far
    from the rest (one hit: itself); points 5..8 lie near the origin."""
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    c = np.array([0.6, 0.6, 0.6], np.float32)
    xyz[:, 0] = c
    d = np.linalg.norm(xyz[:, 1:512] - c, axis=-1)
    far = xyz[:, 1:512] + (0.5 * (xyz[:, 1:512] - c) / np.maximum(d, 1e-6)[..., None])
    xyz[:, 1:512] = np.where((d < 0.25)[..., None], far, xyz[:, 1:512])
    near = rng.uniform(-0.04, 0.04, (B, 14, 3)).astype(np.float32)
    xyz[:, 20:34] = c + near
    xyz[:, 511] = c + np.float32(0.03)
    xyz[:, 600:610] = c + rng.uniform(-0.04, 0.04, (B, 10, 3)).astype(np.float32)
    xyz[:, 5:9] = rng.uniform(-0.01, 0.01, (B, 4, 3))  # |p|^2 <= 1e-3
    xyz[:, N - 1] = 6.0
    return xyz


def _clustered_cloud(seed, B=2, N=700):
    """Few distinct positions, each repeated: FPS ties everywhere, and most
    queries have fewer than nsample hits at 0.1."""
    rng = np.random.default_rng(seed)
    sites = (rng.standard_normal((B, 40, 3)) * 0.8).astype(np.float32)
    pick = rng.integers(0, 40, (B, N))
    xyz = np.take_along_axis(sites, pick[..., None].repeat(3, -1), axis=1)
    xyz[:, 10:14] = 0.0  # duplicates at the origin, never selected
    return np.ascontiguousarray(xyz)


def _jax_bounds(xyz, npoint, scales):
    idx, counts = j_fps_counts(jnp.asarray(xyz), npoint, tuple(r for r, _ in scales), True)
    bounds = _counts_to_bounds(scales, counts)
    return np.asarray(idx), [np.asarray(need) for need, _thr in bounds], [np.asarray(c) for c in counts]


CASES = {
    "chunk_edge_n1100": (lambda: _chunk_edge_cloud(0), 128, SA1_SCALES),
    "random_n1537": (lambda: (np.random.default_rng(1).standard_normal((2, 1537, 3)) * 0.4).astype(np.float32),
                     96, SA1_SCALES),
    "one_chunk_n300": (lambda: (np.random.default_rng(2).standard_normal((3, 300, 3)) * 0.3).astype(np.float32),
                       64, ((0.15, 8),)),
    "clustered_n700": (lambda: _clustered_cloud(3), 64, ((0.1, 16), (0.3, 32), (0.05, 4))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bounds_match_jax_counts_to_bounds_exactly(case):
    make, npoint, scales = CASES[case]
    xyz = make()
    want_idx, want_need, _counts = _jax_bounds(xyz, npoint, scales)
    reset_launch_counts()
    idx, needs = furthest_point_sample_with_bounds(torch.from_numpy(xyz), npoint, scales)
    assert sum(launch_counts().values()) == 0  # CPU tensors: the plain version, no launch
    assert idx.dtype == torch.int32 and idx.shape == (xyz.shape[0], npoint)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert len(needs) == len(scales)
    for need, want in zip(needs, want_need):
        assert need.dtype == torch.int32 and need.shape == (xyz.shape[0], npoint) and need.is_contiguous()
        np.testing.assert_array_equal(need.numpy(), want.astype(np.int32))


def test_chunk_edge_cloud_reaches_the_cases_it_is_built_for():
    """Query 0's 16th hit is point 511 (need 1 at ns 16, where one more
    point would make it 2), the far point is selected with a single hit
    (total < ns), and the near-origin points are never selected."""
    xyz = _chunk_edge_cloud(0)
    idx, needs = furthest_point_sample_with_bounds(torch.from_numpy(xyz), 128, SA1_SCALES)
    _idx, counts = furthest_point_sample_with_counts(torch.from_numpy(xyz), 128, tuple(r for r, _ in SA1_SCALES))
    assert counts[0][0, 0, 0] == 16 and counts[0][0, 0].sum() > 16 and needs[0][0, 0] == 1
    far_query = (idx[0] == xyz.shape[1] - 1).nonzero()[0, 0]
    assert counts[1][0, far_query].sum() == 1 and needs[1][0, far_query] == 3  # its hit is in chunk 2
    assert not np.isin(np.arange(5, 9), idx.numpy()).any()
    moved = xyz.copy()
    moved[:, 511] = 6.0  # chunk 0 then holds 15 hits: the 16th lies in chunk 1
    _i, needs_moved = furthest_point_sample_with_bounds(torch.from_numpy(moved), 128, SA1_SCALES)
    assert needs_moved[0][0, 0] == 2


def test_bounds_plain_is_counts_to_bounds_of_the_plain_counts():
    xyz = torch.from_numpy(_clustered_cloud(4, N=1300))
    idx, needs = furthest_point_sample_with_bounds_plain(xyz, 80, SA1_SCALES)
    cidx, counts = furthest_point_sample_with_counts(xyz, 80, tuple(r for r, _ in SA1_SCALES))
    torch.testing.assert_close(idx, cidx, rtol=0, atol=0)
    torch.testing.assert_close(idx, furthest_point_sample(xyz, 80), rtol=0, atol=0)
    for need, (want, _thr) in zip(needs, counts_to_bounds(SA1_SCALES, counts)):
        torch.testing.assert_close(need, want.int(), rtol=0, atol=0)


def test_bounds_wrapper_rejects_bad_inputs():
    xyz = torch.from_numpy(_clustered_cloud(5))
    with pytest.raises(ValueError):
        furthest_point_sample_with_bounds(xyz, 8, ())
    with pytest.raises(ValueError):
        furthest_point_sample_with_bounds(xyz, 8, ((0.1, 0),))
    with pytest.raises(ValueError):
        furthest_point_sample_with_bounds(xyz, 8, ((0.1, 4),) * 5)
    with pytest.raises(TypeError):
        furthest_point_sample_with_bounds(xyz.double(), 8, SA1_SCALES)
