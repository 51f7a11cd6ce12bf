"""Port ops vs the JAX package: FPS (with and without hit counts), the
counts-to-bounds step, the index ball query, and the fused eval SA stage in
raw, paired-raw and plane modes.

The same numpy inputs go through the Pallas kernels in interpret mode and
through the port with CPU tensors (its plain versions). FPS indices, counts
and ball-query indices must agree exactly; SA outputs to 1e-4 in float32
(summation order) and 2e-2 in bfloat16 (one bf16 ulp at these magnitudes,
from a different f32 summation order before a rounding).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from or4d_tpu.ops.pallas_ball_query import (
    _counts_to_bounds,
    ball_query_group_mlp_pallas,
    ball_query_group_mlp_pallas_v4,
)
from or4d_tpu.ops.pallas_fps import furthest_point_sample_pallas, furthest_point_sample_with_counts
from tests.reference_impls import ball_query_np, fps_np

from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops.ball_query import ball_query
from or4d_tpu_torch.ops.fps import furthest_point_sample, furthest_point_sample_with_counts as fps_counts_t
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds, sa_group_mlp

B, N, M = 2, 1100, 128
SCALES = ((0.15, 4), (0.3, 6))
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _cloud(seed=0):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    xyz[:, 5:9] = rng.uniform(-0.01, 0.01, (B, 4, 3))  # |p|^2 <= 1e-3: never selected
    return xyz


def _jax_fps_counts(xyz):
    idx, counts = furthest_point_sample_with_counts(jnp.asarray(xyz), M, tuple(r for r, _ in SCALES), True)
    return np.asarray(idx), [np.asarray(c) for c in counts]


def _params(rng, C0, C1, C2, dtype):
    """(W0 or None, Bq, a0, b0, W1, a1, b1) as numpy float32, sized so the
    outputs stay O(1)."""
    W0 = (rng.standard_normal((C0, C1)) / np.sqrt(C0)).astype(np.float32)
    Bq = (rng.standard_normal((B, M, C1)) * 0.5).astype(np.float32)
    a0 = rng.uniform(0.5, 1.5, C1).astype(np.float32)
    b0 = (rng.standard_normal(C1) * 0.2).astype(np.float32)
    W1 = (rng.standard_normal((C1, C2)) / np.sqrt(C1)).astype(np.float32)
    a1 = rng.uniform(0.5, 1.5, C2).astype(np.float32)
    b1 = (rng.standard_normal(C2) * 0.2).astype(np.float32)
    return W0, Bq, a0, b0, W1, a1, b1


def _jx(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _tt(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) else x.float().numpy()


class TestFPS:
    def test_matches_pallas_and_numpy_exactly(self):
        xyz = _cloud(0)
        want = np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), M, True))
        got = furthest_point_sample(torch.from_numpy(xyz), M)
        assert got.dtype == torch.int32 and got.shape == (B, M)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), fps_np(xyz, M))
        assert not np.isin(np.arange(5, 9), got.numpy()).any()

    def test_counts_match_pallas_exactly(self):
        xyz = _cloud(1)
        want_idx, want_counts = _jax_fps_counts(xyz)
        idx, counts = fps_counts_t(torch.from_numpy(xyz), M, tuple(r for r, _ in SCALES))
        np.testing.assert_array_equal(idx.numpy(), want_idx)
        assert len(counts) == len(SCALES)
        for c, w in zip(counts, want_counts):
            assert c.shape == w.shape == (B, M, 3)
            np.testing.assert_array_equal(c.numpy(), w)

    def test_counts_to_bounds_parity(self):
        xyz = _cloud(2)
        _, counts = _jax_fps_counts(xyz)
        want = _counts_to_bounds(SCALES, tuple(jnp.asarray(c) for c in counts))
        got = counts_to_bounds(SCALES, tuple(torch.from_numpy(c) for c in counts))
        for (gn, gt), (wn, wt) in zip(got, want):
            np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))

    def test_wrapper_rejects_bad_inputs(self):
        xyz = torch.from_numpy(_cloud(0))
        with pytest.raises(TypeError):
            furthest_point_sample(xyz.double(), 8)
        with pytest.raises(ValueError):
            furthest_point_sample(xyz[..., :2].contiguous(), 8)
        with pytest.raises(ValueError):
            furthest_point_sample(xyz.transpose(0, 1), 8)
        with pytest.raises(ValueError):
            fps_counts_t(xyz, 8, ())


class TestBallQuery:
    @pytest.mark.parametrize("radius,nsample", SCALES)
    def test_matches_numpy_reference_exactly(self, radius, nsample):
        xyz = _cloud(3)
        new_xyz = xyz[:, :M].copy()
        got = ball_query(radius, nsample, torch.from_numpy(xyz), torch.from_numpy(new_xyz))
        np.testing.assert_array_equal(got.numpy(), ball_query_np(radius, nsample, xyz, new_xyz))


def _queries(xyz):
    idx, counts = _jax_fps_counts(xyz)
    new_xyz = np.take_along_axis(xyz, idx[..., None].astype(np.int64), axis=1)
    return new_xyz, counts


class TestSAStage:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_raw_mode_matches_v4(self, dtype):
        rng = np.random.default_rng(4)
        xyz = _cloud(4)
        new_xyz, counts = _queries(xyz)
        C0 = 6
        raw = rng.standard_normal((B, C0, N)).astype(np.float32)
        params = [_params(rng, C0, 16, c2, dtype) for c2 in (24, 16)]
        bounds = _counts_to_bounds(SCALES, tuple(jnp.asarray(c) for c in counts))
        jparams = tuple(
            (_jx(W0, dtype), _jx(Bq, dtype), jnp.asarray(a0), jnp.asarray(b0), _jx(W1, dtype), jnp.asarray(a1),
             jnp.asarray(b1)) for W0, Bq, a0, b0, W1, a1, b1 in params)
        want = ball_query_group_mlp_pallas_v4(SCALES, jnp.asarray(xyz), jnp.asarray(new_xyz), jparams, bounds,
                                              True, None, 32, True, _jx(raw, dtype))
        needs = counts_to_bounds(SCALES, tuple(torch.from_numpy(c) for c in counts))
        for s, ((r, ns), (W0, Bq, a0, b0, W1, a1, b1)) in enumerate(zip(SCALES, params)):
            got = sa_group_mlp(torch.from_numpy(xyz), torch.from_numpy(new_xyz), r, ns, _tt(Bq, dtype),
                               _tt(a0), _tt(b0), _tt(W1, dtype), _tt(a1), _tt(b1), raw=_tt(raw, dtype),
                               W0=_tt(W0, dtype), need=needs[s][0].int())
            assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
            np.testing.assert_allclose(_f32(got), _f32(want[s]), rtol=TOL[dtype], atol=TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paired_raw_mode_matches_v4_blockdiag(self, dtype):
        """Two halves sharing one search equal the JAX package's paired
        operands: W0p (C0+1, 2*C1), [Bq | Bq] and blockdiag(W1, W1)."""
        rng = np.random.default_rng(5)
        xyz = _cloud(5)
        new_xyz, counts = _queries(xyz)
        C0 = 7
        raw = rng.standard_normal((B, C0 + 1, N)).astype(np.float32)
        raw[:, 6] = rng.integers(0, 3, (B, N))
        raw[:, 7] = np.where(raw[:, 6] > 0, 3.0 - raw[:, 6], 0.0)
        params = [_params(rng, C0, 16, c2, dtype) for c2 in (24, 16)]
        jparams = []
        for W0, Bq, a0, b0, W1, a1, b1 in params:
            C1, C2 = W1.shape
            z = np.zeros((1, C1), np.float32)
            W0p = np.concatenate([np.concatenate([W0[:-1], W0[:-1]], 1), np.concatenate([W0[-1:], z], 1),
                                  np.concatenate([z, W0[-1:]], 1)], 0)
            W1b = np.zeros((2 * C1, 2 * C2), np.float32)
            W1b[:C1, :C2] = W1
            W1b[C1:, C2:] = W1
            two = lambda v: jnp.asarray(np.concatenate([v, v], -1))
            jparams.append((_jx(W0p, dtype), _jx(np.concatenate([Bq, Bq], -1), dtype), two(a0), two(b0),
                            _jx(W1b, dtype), two(a1), two(b1)))
        bounds = _counts_to_bounds(SCALES, tuple(jnp.asarray(c) for c in counts))
        want = ball_query_group_mlp_pallas_v4(SCALES, jnp.asarray(xyz), jnp.asarray(new_xyz), tuple(jparams),
                                              bounds, True, None, 32, True, _jx(raw, dtype))
        needs = counts_to_bounds(SCALES, tuple(torch.from_numpy(c) for c in counts))
        for s, ((r, ns), (W0, Bq, a0, b0, W1, a1, b1)) in enumerate(zip(SCALES, params)):
            got = sa_group_mlp(torch.from_numpy(xyz), torch.from_numpy(new_xyz), r, ns, _tt(Bq, dtype),
                               _tt(a0), _tt(b0), _tt(W1, dtype), _tt(a1), _tt(b1), raw=_tt(raw, dtype),
                               W0=_tt(W0, dtype), paired=True, need=needs[s][0].int())
            assert got.shape == (B, M, 2 * W1.shape[1])
            np.testing.assert_allclose(_f32(got), _f32(want[s]), rtol=TOL[dtype], atol=TOL[dtype])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_plane_mode_matches_ungated_kernel(self, dtype):
        rng = np.random.default_rng(6)
        xyz = _cloud(6)
        new_xyz = xyz[:, :M].copy()
        new_xyz[0, 3] = 50.0  # no hit: both sides use a zero layer-1 row
        C1 = 16
        A = rng.standard_normal((B, N, C1)).astype(np.float32)
        params = [_params(rng, 3, C1, c2, dtype) for c2 in (24, 16)]
        jparams = tuple(
            (_jx(A, dtype), _jx(Bq, dtype), jnp.asarray(a0), jnp.asarray(b0), _jx(W1, dtype), jnp.asarray(a1),
             jnp.asarray(b1)) for _W0, Bq, a0, b0, W1, a1, b1 in params)
        want = ball_query_group_mlp_pallas(SCALES, jnp.asarray(xyz), jnp.asarray(new_xyz), jparams, True,
                                           None, False, 32)
        for s, ((r, ns), (_W0, Bq, a0, b0, W1, a1, b1)) in enumerate(zip(SCALES, params)):
            got = sa_group_mlp(torch.from_numpy(xyz), torch.from_numpy(new_xyz), r, ns, _tt(Bq, dtype),
                               _tt(a0), _tt(b0), _tt(W1, dtype), _tt(a1), _tt(b1), A=_tt(A, dtype))
            np.testing.assert_allclose(_f32(got), _f32(want[s]), rtol=TOL[dtype], atol=TOL[dtype])

    def test_wrapper_rejects_bad_inputs_and_counts_no_cpu_launch(self):
        rng = np.random.default_rng(7)
        xyz = torch.from_numpy(_cloud(7))
        q = xyz[:, :M].contiguous()
        W0, Bq, a0, b0, W1, a1, b1 = (_tt(a) for a in _params(rng, 6, 16, 24, "float32"))
        raw = torch.from_numpy(rng.standard_normal((B, 6, N)).astype(np.float32))
        reset_launch_counts()
        sa_group_mlp(xyz, q, 0.2, 4, Bq, a0, b0, W1, a1, b1, raw=raw, W0=W0)
        assert all(v == 0 for v in launch_counts().values())  # the plain version launches nothing
        with pytest.raises(ValueError):  # both modes at once
            sa_group_mlp(xyz, q, 0.2, 4, Bq, a0, b0, W1, a1, b1, raw=raw, W0=W0, A=raw)
        with pytest.raises(ValueError):  # mixed dtypes
            sa_group_mlp(xyz, q, 0.2, 4, Bq, a0, b0, W1.bfloat16(), a1, b1, raw=raw, W0=W0)
        with pytest.raises(ValueError):  # raw missing the paired channel
            sa_group_mlp(xyz, q, 0.2, 4, Bq, a0, b0, W1, a1, b1, raw=raw, W0=W0, paired=True)
        with pytest.raises(ValueError):  # non-contiguous
            sa_group_mlp(xyz, q, 0.2, 4, Bq.transpose(0, 1).contiguous().transpose(0, 1), a0, b0, W1, a1, b1,
                         raw=raw, W0=W0)
