"""The bounds pre-pass kernel's launch plan (``bounds_plan``) and a Python
model of the kernel's arithmetic (``csrc/ball_query_bounds.cu``), on the CPU.

The plan must fill 132 SMs in one balanced wave on the S=8 train step's two
SA1 calls (96 object clouds of 4000 points and 640 relation clouds of 8000,
512 queries each), keep its shared memory within a block's and an SM's
budget, take every shape the wrapper takes, and raise before any launch
where it cannot. The model replays the kernel's windows, its +inf padding,
its sign-bit hit test and its online ``need`` rule in float32 and must give
the plain version's bounds bit for bit, at the plan's own windows.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from or4d_tpu_torch.ops import ball_query_bounds as bqb, launch_counts, reset_launch_counts
from or4d_tpu_torch.ops._card import BLOCK_RESERVED, MAX_SMEM, SM_SMEM
from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds, ball_query_bounds_plain, bounds_plan
from or4d_tpu_torch.ops.ball_query_group import r2_of
from or4d_tpu_torch.ops.fps import CHUNK

SA1 = ((0.1, 16), (0.2, 32))
SOURCE = Path(bqb.__file__).parent / "csrc" / "ball_query_bounds.cu"


def _check_fits(plan, B, N, M, S):
    assert plan.queries in ((1, 2, 4) if S <= 2 else (1, 2))
    assert plan.block_queries == bqb.THREADS * plan.queries
    assert plan.blocks == B * -(-M // plan.block_queries)
    assert plan.window % CHUNK == 0 and plan.buffers == (1 if plan.window >= N else 2)
    assert plan.smem_bytes == plan.buffers * 12 * plan.window <= MAX_SMEM
    assert plan.blocks_per_sm >= 1 and plan.blocks_per_sm * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SMEM


@pytest.mark.parametrize("B,N", [(640, 8000), (96, 4000)])
def test_sa1_calls_fill_the_card_in_one_even_wave(B, N):
    plan = bounds_plan(B, N, 512, 2, sms=132)
    _check_fits(plan, B, N, 512, 2)
    share = -(-plan.blocks // 132)
    assert plan.blocks / (132 * share) >= 0.95  # no ragged last wave
    assert plan.blocks <= 132 * plan.blocks_per_sm  # every block resident at once
    assert plan.blocks * bqb.THREADS // 32 >= 132 * 4  # a warp on every SM sub-partition
    if B == 640:  # every cloud staged once, through a ring of windows
        assert (plan.block_queries, plan.buffers) == (512, 2) and plan.queries == 4
    else:  # the whole cloud staged
        assert plan.buffers == 1


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("N,M", [(1100, 512), (4000, 300), (8000, 512), (20000, 512), (1, 1), (513, 1000)])
def test_plan_fits_every_shape(N, M, S):
    for B in (1, 3, 96, 640):
        plan = bounds_plan(B, N, M, S, sms=132)
        _check_fits(plan, B, N, M, S)
        if N > 8192 and B <= 3:
            assert plan.buffers == 2 and plan.window < N  # a cloud over one window


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_queries_a_thread_keep_16_warps_an_sm(S):
    """The most queries a thread (4 for at most two scales, else 2; then 2)
    that leaves each of 132 SMs 16 warps, else 1: the relation call takes
    4, the object call 1."""
    top = 4 if S <= 2 else 2
    for B, M in ((640, 512), (96, 512), (264, 768), (1, 1), (2112, 1000)):
        warps = {q: B * M / q / 32 / 132 for q in (1, 2, 4)}
        want = next((q for q in (4, 2) if q <= top and warps[q] >= 16), 1)
        assert bounds_plan(B, 8000, M, S, sms=132).queries == want
    assert bounds_plan(640, 8000, 512, S, sms=132).queries == top
    assert bounds_plan(96, 4000, 512, S, sms=132).queries == 1
    assert bounds_plan(264, 1100, 768, S, sms=132).queries == 2


def test_plan_refuses_before_any_launch(monkeypatch):
    for args in ((0, 100, 10, 1), (1, 0, 10, 1), (1, 100, 0, 1), (1, 100, 10, 0), (1, 100, 10, 5)):
        with pytest.raises(ValueError):
            bounds_plan(*args)
    with pytest.raises(ValueError):  # more blocks than a grid holds
        bounds_plan(1 << 30, 100, 1 << 10, 1)
    monkeypatch.setattr(bqb, "MAX_SMEM", 4000)  # not even one chunk fits
    reset_launch_counts()
    with pytest.raises(ValueError):
        bounds_plan(2, 1100, 64, 2)
    assert launch_counts()["bounds.prepass"] == 0


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}
    assert const["kChunk"] == CHUNK and const["kMaxScales"] == bqb.MAX_SCALES
    assert const["kThreads"] == bqb.THREADS and const["kMinBlocks"] == bqb._MIN_BLOCKS
    assert const["kMaxSmem"] == MAX_SMEM
    assert "(window >= N ? 1 : 2) * 12 * (size_t)window" in src  # window_smem, as _window_smem


def _kernel_model(scales, xyz, q, plan):
    """The kernel's arithmetic in float32: windows of ``plan.window``
    points, the last 4-point group padded with +inf, per chunk the sign bits
    of fsub(d2, r2) summed, and at each chunk's end need = chunk + 1 for a
    scale whose count was below ns and rose."""
    xyz, q = xyz.numpy(), q.numpy()
    B, N, _ = xyz.shape
    M = q.shape[1]
    n4 = -(-N // 4) * 4
    pts = np.full((B, n4, 3), np.inf, np.float32)
    pts[:, :N] = xyz
    r2 = [np.float32(r2_of(r)) for r, _ns in scales]
    cnt = [np.zeros((B, M), np.int64) for _ in scales]
    need = [np.ones((B, M), np.int64) for _ in scales]
    for n0 in range(0, N, plan.window):
        lim = min(plan.window, N - n0)
        for j in range(0, lim, CHUNK):
            p = pts[:, n0 + j: n0 + min(j + CHUNK, -(-lim // 4) * 4)]
            d = q[:, :, None, :] - p[:, None, :, :]
            d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
            for s, (_r, ns) in enumerate(scales):
                with np.errstate(invalid="ignore"):
                    c = np.signbit(d2 - r2[s]).sum(-1)
                need[s] = np.where((cnt[s] < ns) & (c > 0), (n0 + j) // CHUNK + 1, need[s])
                cnt[s] = cnt[s] + c
    return tuple((torch.from_numpy(n.astype(np.float32)), torch.from_numpy(c.astype(np.float32)))
                 for n, c in zip(need, cnt))


MODEL_CASES = {
    "sa1_N1100": (1100, 40, SA1),
    "three_descending_N1537": (1537, 24, ((0.4, 64), (0.2, 32), (0.1, 16))),
    "four_unordered_N2047": (2047, 16, ((0.2, 32), (0.05, 4), (0.4, 64), (0.1, 16))),
    "ring_N4097": (4097, 16, SA1),
    "ring_N20000": (20000, 8, SA1),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_kernel_model_equals_plain(case):
    """At the windows the card's plan takes for the relation call's shape
    (a ring of windows from 4097 points, whose last chunk is a single point); a
    query with no hit, a point exactly on a radius (d2 == r2: no hit, a +0
    difference) where a scale has room, and a query whose ns-th hit at the
    first scale is the last point of chunk 0."""
    N, M, scales = MODEL_CASES[case]
    if len(scales) < 4:
        scales = scales + ((0.5, 4),)
    rng = np.random.default_rng(N)
    xyz = (rng.standard_normal((2, N, 3)) * 0.3).astype(np.float32)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[1, 3] = 30.0  # no hit
    q[0, 0] = 0.0
    xyz[0, 7] = (0.5, 0.0, 0.0)  # d2 == 0.25 == the f32 r2 of radius 0.5
    ns0 = scales[0][1]
    xyz[1, :CHUNK] = 50.0  # cloud 1's chunk 0 far from every query, but its last ns0 points
    xyz[1, CHUNK - ns0: CHUNK] = 5.0 + 1e-3 * rng.standard_normal((ns0, 3)).astype(np.float32)
    q[1, 1] = 5.0
    xt, qt = torch.from_numpy(xyz), torch.from_numpy(q)
    plan = bounds_plan(640, N, 512, len(scales), sms=132)
    assert (plan.window < N) == case.startswith("ring")
    want = ball_query_bounds_plain(scales, xt, qt)
    got = _kernel_model(scales, xt, qt, plan)
    for (gn, gt), (wn, wt) in zip(got, want):
        torch.testing.assert_close(gn, wn, rtol=0, atol=0)
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
        assert gn[1, 3] == 1.0 and gt[1, 3] == 0.0
    assert float(((xt[0, 7] - qt[0, 0]) ** 2).sum()) == r2_of(0.5)
    need0, tot0 = want[0]
    assert need0[1, 1] == 1.0 and tot0[1, 1] == ns0  # the ns-th hit closes chunk 0
    reset_launch_counts()
    assert ball_query_bounds(scales, xt, qt)[0][0].equal(need0) and launch_counts()["bounds.prepass"] == 0
