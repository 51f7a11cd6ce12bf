"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test carries the ``cuda`` marker and skips inside the test when no
card is present. This file imports no JAX, so it also runs on a machine that
has PyTorch and no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
from or4d_tpu_torch.ops import ball_query_group as bqg, ball_query_group_raw as bqgr
from or4d_tpu_torch.ops.fps import (furthest_point_sample, furthest_point_sample_with_bounds,
                                    furthest_point_sample_with_bounds_plain, furthest_point_sample_with_counts)
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds, sa_group_mlp
from or4d_tpu_torch.ops import ball_query_bounds as bqb
from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds, ball_query_bounds_plain
from or4d_tpu_torch.ops import ball_query_multiscale as bqm
from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale, ball_query_multiscale_plain
from or4d_tpu_torch.ops.serving_sa1_mlp import serving_sa1_mlp, serving_sa1_mlp_plain

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, B, N):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    xyz[:, 3:6] = 0.0  # |p|^2 <= 1e-3: never selected
    return torch.from_numpy(xyz)


@pytest.mark.parametrize("N,npoint", [(1, 1), (300, 64), (512, 128), (1100, 128), (4000, 512), (8000, 512)])
def test_fps_kernel_exact(card, N, npoint):
    xyz = _cloud(N, 3, N)
    reset_launch_counts()
    got = furthest_point_sample(xyz.to(card), npoint)
    want = furthest_point_sample(xyz, npoint)
    assert launch_counts()["fps.fps"] == 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("N,radii", [(700, (0.1,)), (1100, (0.15, 0.3)), (8000, (0.1, 0.2))])
def test_fps_counts_kernel_exact(card, N, radii):
    xyz = _cloud(N + 1, 2, N)
    idx, counts = furthest_point_sample_with_counts(xyz.to(card), 128, radii)
    widx, wcounts = furthest_point_sample_with_counts(xyz, 128, radii)
    torch.testing.assert_close(idx.cpu(), widx, rtol=0, atol=0)
    for c, w in zip(counts, wcounts):
        torch.testing.assert_close(c.cpu(), w, rtol=0, atol=0)


def _clustered(seed, B, N):
    """Duplicate points at a few sites, near-origin points and one far
    point: FPS ties, queries with fewer hits than nsample."""
    rng = np.random.default_rng(seed)
    sites = (rng.standard_normal((B, 60, 3)) * 0.8).astype(np.float32)
    xyz = np.take_along_axis(sites, rng.integers(0, 60, (B, N))[..., None].repeat(3, -1), axis=1)
    xyz[:, 7:12] = rng.uniform(-0.01, 0.01, (B, 5, 3))
    xyz[:, N - 3] = 5.0
    return torch.from_numpy(np.ascontiguousarray(xyz))


@pytest.mark.parametrize("case", ["n1100", "n4000", "n8000", "clustered_n8000"])
def test_fps_bounds_kernel_exact(card, case):
    """The kernel's idx and need against the plain FPS counts followed by
    counts_to_bounds, bit for bit, with SA1's scales."""
    N = int(case.split("n")[-1])
    xyz = _clustered(N, 2, N) if case.startswith("clustered") else _cloud(N + 11, 2, N)
    scales = ((0.1, 16), (0.2, 32))
    want_idx, want_need = furthest_point_sample_with_bounds_plain(xyz, 512, scales)
    reset_launch_counts()
    idx, need = furthest_point_sample_with_bounds(xyz.to(card), 512, scales)
    assert launch_counts()["fps.fps_bounds"] == 1 and launch_counts()["fps.fps_counts"] == 0
    torch.testing.assert_close(idx.cpu(), want_idx, rtol=0, atol=0)
    for g, w in zip(need, want_need):
        assert g.dtype == torch.int32 and g.is_contiguous()
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    # the counts variant of the same kernel agrees with the same plain counts
    cidx, counts = furthest_point_sample_with_counts(xyz.to(card), 512, (0.1, 0.2))
    torch.testing.assert_close(cidx.cpu(), want_idx, rtol=0, atol=0)
    for g, (w, _thr) in zip(need, counts_to_bounds(scales, counts)):
        torch.testing.assert_close(g, w.int(), rtol=0, atol=0)


def _sa_inputs(seed, B, N, M, C0, C1, C2, paired, dtype, raw_mode=True, radius=0.2, ns=32):
    g = torch.Generator().manual_seed(seed)
    xyz = _cloud(seed, B, N)
    new_xyz = xyz[:, torch.randperm(N, generator=g)[:M]].contiguous()
    new_xyz[0, 1] = 40.0  # far from every point: no hit, a zero A row
    args = [xyz, new_xyz, radius, ns, (torch.randn(B, M, C1, generator=g) * 0.5).to(dtype),
            torch.rand(C1, generator=g) + 0.5, torch.randn(C1, generator=g) * 0.2,
            (torch.randn(C1, C2, generator=g) / C1 ** 0.5).to(dtype),
            torch.randn(C2, generator=g), torch.randn(C2, generator=g) * 0.2]  # a1 of both signs
    if raw_mode:
        kw = dict(raw=torch.randn(B, C0 + int(paired), N, generator=g).to(dtype),
                  W0=(torch.randn(C0, C1, generator=g) / C0 ** 0.5).to(dtype), paired=paired)
    else:
        kw = dict(A=torch.randn(B, N, C1, generator=g).to(dtype))
    return args, kw


def _on(x, dev):
    return x.to(dev) if isinstance(x, torch.Tensor) else x


# (B, N, M, C0, C1, C2, mode, radius, ns): the main path's widths (SA1
# objects and paired relations, SA2 on staged planes), ns 128 over eight
# tiles, a plane too large to stage, odd widths padded to the tiles (an odd
# C1 reads plane rows one value at a time); M is
# not a multiple of a block's queries, and many queries have fewer than ns
# hits
SA_CASES = {
    "raw_c06_ns16": (2, 4000, 300, 6, 64, 64, "raw", 0.1, 16),
    "paired_c07_ns32": (2, 8000, 300, 7, 64, 128, "paired", 0.2, 32),
    "plane_ns32": (5, 512, 128, 0, 128, 128, "plane", 0.2, 32),
    "plane_ns64": (5, 512, 100, 0, 128, 128, "plane", 0.4, 64),
    "raw_ns128_tiles": (2, 1100, 70, 6, 64, 128, "raw", 0.6, 128),
    "plane_unstaged_n1100": (3, 1100, 130, 0, 128, 128, "plane", 0.2, 32),
    "plane_c1_63_c2_256": (3, 512, 64, 0, 63, 256, "plane", 0.3, 48),
    "odd_widths": (2, 700, 90, 3, 39, 20, "paired", 0.25, 5),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SA_CASES))
def test_sa_kernel_matches_plain(card, dtype, case):
    from or4d_tpu_torch.ops import sa_group_mlp as sgm

    B, N, M, C0, C1, C2, mode, radius, ns = SA_CASES[case]
    args, kw = _sa_inputs(len(case), B, N, M, C0, C1, C2, mode == "paired", dtype, mode != "plane", radius, ns)
    want = sa_group_mlp(*args, **kw)
    reset_launch_counts()
    bodies = dict(sgm.BODY_LAUNCHES)
    got = sa_group_mlp(*[_on(a, card) for a in args], **{k: _on(v, card) for k, v in kw.items()})
    assert launch_counts()["sa_group_mlp." + ("plane" if mode == "plane" else "raw")] == 1
    body = "mma" if dtype == torch.bfloat16 else "fp32"
    assert sgm.BODY_LAUNCHES[body] == bodies[body] + 1 and sum(sgm.BODY_LAUNCHES.values()) == sum(bodies.values()) + 1
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [16, 32])
def test_sa_kernel_need_bound_changes_nothing(card, ns, dtype):
    r = {16: 0.1, 32: 0.2}[ns]
    xyz = _cloud(5, 2, 4000).to(card)
    idx, counts = furthest_point_sample_with_counts(xyz, 512, (r,))
    new_xyz = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    need = counts_to_bounds(((r, ns),), counts)[0][0].int().contiguous()
    args, kw = _sa_inputs(6, 2, 4000, 512, 6, 64, 64, False, dtype, radius=r, ns=ns)
    args[0], args[1] = xyz, new_xyz
    args = [_on(a, card) for a in args]
    kw = {k: _on(v, card) for k, v in kw.items()}
    torch.testing.assert_close(sa_group_mlp(*args, **kw, need=need), sa_group_mlp(*args, **kw), rtol=0, atol=0)


def test_sa_kernel_refuses_a_plan_over_shared_memory(card, monkeypatch):
    from or4d_tpu_torch.ops import sa_group_mlp as sgm

    args, kw = _sa_inputs(8, 1, 512, 64, 0, 128, 128, False, torch.bfloat16, False)
    args = [_on(a, card) for a in args]
    kw = {k: _on(v, card) for k, v in kw.items()}
    monkeypatch.setattr(sgm, "MAX_SMEM", 20000)
    reset_launch_counts()
    with pytest.raises(ValueError):
        sa_group_mlp(*args, **kw)
    assert launch_counts()["sa_group_mlp.plane"] == 0


def test_kernel_wrappers_raise_outside_limits(card):
    """FPS takes clouds of any size (over 8192 points the cluster kernel,
    ``tests/test_torch_cuda_fps_image.py``); it refuses more radii than the
    kernels carry."""
    with pytest.raises(ValueError, match="at most 4 radii"):
        furthest_point_sample_with_counts(_cloud(0, 1, 9000).to(card), 16, (0.1, 0.2, 0.3, 0.4, 0.5))
    args, kw = _sa_inputs(7, 1, 600, 32, 6, 160, 64, False, torch.float32)
    with pytest.raises(ValueError):
        sa_group_mlp(*[_on(a, card) for a in args], **{k: _on(v, card) for k, v in kw.items()})


# train-path grouping (TPU rows 5 and 6): forwards exact; backward sums in
# another order than the plain version (dA: 1e-5 of max|dA| in float32;
# dW0: 1e-4 of max|dW0|), one bf16 ulp in bfloat16
BWD_TOL = {"dA": 1e-5, "dW0": 1e-4}


def _close_bwd(got, want, kind):
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    got, want = got.float().cpu(), want.float().cpu()
    torch.testing.assert_close(got, want, rtol=rtol, atol=BWD_TOL[kind] * float(want.abs().max()))


def _group_inputs(seed, B, N, M, C, dtype):
    g = torch.Generator().manual_seed(seed)
    xyz = _cloud(seed, B, N)
    q = xyz[:, torch.randperm(N, generator=g)[:M]].contiguous()
    q[0, 1] = 40.0  # no hit: zero rows, no gradient
    return xyz, q, torch.randn(B, N, C, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [32, 64])
def test_group_kernels_match_plain(card, dtype, ns):
    xyz, q, A = _group_inputs(ns, 6, 512, 128, 128, dtype)
    want, widx = bqg.group_fwd(xyz, q, 0.3, ns, A)
    reset_launch_counts()
    got, idx = bqg.group_fwd(xyz.to(card), q.to(card), 0.3, ns, A.to(card))
    torch.testing.assert_close(idx.cpu(), widx, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    g = torch.randn(got.shape).to(dtype)
    dA = bqg.group_bwd(idx, g.to(card), 512)
    assert launch_counts()["group.fwd"] == 1 and launch_counts()["group.bwd"] == 1
    _close_bwd(dA, bqg.group_bwd_plain(idx, g.to(card), 512), "dA")
    assert not dA.cpu()[0][~torch.isin(torch.arange(512), widx[0][widx[0] >= 0])].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C0", [6, 7])
def test_group_raw_kernels_match_plain(card, dtype, C0):
    xyz = _cloud(C0, 3, 1100).to(card)
    idx, counts = furthest_point_sample_with_counts(xyz, 128, (0.1, 0.2))
    q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    bounds = counts_to_bounds(((0.1, 16), (0.2, 32)), counts)
    gen = torch.Generator().manual_seed(C0)
    raw = torch.randn(3, C0, 1100, generator=gen).to(dtype).to(card)
    W0 = (torch.randn(C0, 64, generator=gen) / C0 ** 0.5).to(dtype).to(card)
    for (r, ns), (need, _thr) in zip(((0.1, 16), (0.2, 32)), bounds):
        need = need.int().contiguous()
        reset_launch_counts()
        got, gidx = bqgr.group_raw_fwd(xyz, q, r, ns, W0, raw, need)
        want, widx = bqgr.group_raw_fwd_plain(xyz, q, r, ns, W0, raw)
        torch.testing.assert_close(gidx, widx, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        g = torch.randn(got.shape, generator=gen).to(dtype).to(card)
        dW0 = bqgr.group_raw_bwd(gidx, g, raw)
        assert launch_counts()["group_raw.fwd"] == 1 and launch_counts()["group_raw.bwd"] == 1
        _close_bwd(dW0, bqgr.group_raw_bwd_plain(gidx, g, raw), "dW0")


def test_group_functions_match_autograd_through_plain(card):
    """The autograd Functions' gradients against autograd through the plain
    gathers (no custom backward), float32 on the card."""
    xyz, q, A = _group_inputs(3, 4, 400, 96, 64, torch.float32)
    xyz, q, A = xyz.to(card), q.to(card), A.to(card)
    g = torch.randn(4, 96, 32, 64, device=card)
    a1 = A.clone().requires_grad_(True)
    (bqg.ball_query_group(xyz, q, 0.3, 32, a1) * g).sum().backward()
    a2 = A.clone().requires_grad_(True)
    (bqg.gather_rows(a2, bqg.group_indices_plain(xyz, q, 0.3, 32)) * g).sum().backward()
    _close_bwd(a1.grad, a2.grad, "dA")
    raw = torch.randn(4, 7, 400, device=card)
    w1 = torch.randn(7, 64, device=card, requires_grad=True)
    (bqgr.ball_query_group_raw(xyz, q, 0.3, 32, w1, raw) * g).sum().backward()
    w2 = w1.detach().clone().requires_grad_(True)
    A2 = raw.transpose(1, 2) @ w2
    (bqg.gather_rows(A2, bqg.group_indices_plain(xyz, q, 0.3, 32)) * g).sum().backward()
    _close_bwd(w1.grad, w2.grad, "dW0")


def test_group_wrappers_raise_on_bad_inputs(card):
    xyz, q, A = _group_inputs(4, 2, 300, 32, 16, torch.float32)
    xyz, q, A = xyz.to(card), q.to(card), A.to(card)
    with pytest.raises(ValueError):  # dtype the kernel does not take
        bqg.group_fwd(xyz, q, 0.3, 8, A.double())
    with pytest.raises(ValueError):  # non-contiguous plane
        bqg.group_fwd(xyz, q, 0.3, 8, A.transpose(0, 1).contiguous().transpose(0, 1))
    raw = torch.randn(2, 6, 300, device=card)
    with pytest.raises(ValueError):  # non-contiguous raw plane
        bqgr.group_raw_fwd(xyz, q, 0.3, 8, torch.randn(6, 16, device=card), raw.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError):  # C above the raw kernel's limit
        bqgr.group_raw_fwd(xyz, q, 0.3, 8, torch.randn(6, 160, device=card), raw)
    with pytest.raises(ValueError):  # idx of the wrong dtype
        bqg.group_bwd(torch.zeros(2, 32, 8, dtype=torch.int64, device=card), torch.randn(2, 32, 8, 16, device=card), 300)
    with pytest.raises(ValueError):  # one cloud's counts (4 * N bytes) do not fit in shared memory
        bqg.group_bwd(torch.zeros(1, 64, 8, dtype=torch.int32, device=card),
                      torch.randn(1, 64, 8, 16, device=card), 60000)


# row 5 at the S=8 train step's widths: relation crops (N 8000, C0 7) and
# the object call's shape (96 clouds of 4000 points, C0 6); M 512, C 64
ROW5_FULL = {"relations": (16, 8000, 7, 9), "objects": (96, 4000, 6, 10)}


def _row5_full(case, dtype, card):
    B, N, C0, seed = ROW5_FULL[case]
    xyz = _cloud(seed, B, N).to(card)
    idx, need = furthest_point_sample_with_bounds(xyz, 512, ((0.1, 16), (0.2, 32)))
    q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    q[0, 5] = 40.0  # no hit
    gen = torch.Generator().manual_seed(seed)
    raw = torch.randn(B, C0, N, generator=gen).to(dtype).to(card)
    W0 = (torch.randn(C0, 64, generator=gen) / C0 ** 0.5).to(dtype).to(card)
    return xyz, q, need, raw, W0, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ROW5_FULL))
def test_row5_forward_at_step_widths_bit_equal(card, case, dtype):
    """Rows bit-equal to the plain version (the f32 fmaf chain over C0 in
    order), indices exact, the FPS bound changing nothing, -1 and zero rows
    for a query with no hit."""
    xyz, q, need, raw, W0, _gen = _row5_full(case, dtype, card)
    for (r, ns), nd in zip(((0.1, 16), (0.2, 32)), need):
        want, widx = bqgr.group_raw_fwd_plain(xyz, q, r, ns, W0, raw)
        reset_launch_counts()
        got, gidx = bqgr.group_raw_fwd(xyz, q, r, ns, W0, raw, nd)
        assert launch_counts()["group_raw.fwd"] == 1
        torch.testing.assert_close(gidx, widx, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert (gidx[0, 5] == -1).all() and not got[0, 5].any()
        unbounded, uidx = bqgr.group_raw_fwd(xyz, q, r, ns, W0, raw)  # need changes nothing
        torch.testing.assert_close(uidx, gidx, rtol=0, atol=0)
        torch.testing.assert_close(unbounded, got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ROW5_FULL))
def test_row5_backward_at_step_widths_deterministic(card, case, dtype):
    xyz, q, need, raw, W0, gen = _row5_full(case, dtype, card)
    _out, idx = bqgr.group_raw_fwd(xyz, q, 0.2, 32, W0, raw, need[1])
    g = torch.randn(_out.shape, generator=gen).to(dtype).to(card)
    reset_launch_counts()
    dW0 = bqgr.group_raw_bwd(idx, g, raw)
    assert launch_counts()["group_raw.bwd"] == 1
    torch.testing.assert_close(bqgr.group_raw_bwd(idx, g, raw), dW0, rtol=0, atol=0)  # bit-identical
    _close_bwd(dW0, bqgr.group_raw_bwd_plain(idx, g, raw), "dW0")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["160_clouds", "5_partials"])
def test_row5_backward_with_several_tiles_a_block(card, monkeypatch, case, dtype):
    """Blocks that sum several tiles of 32 queries, running from one cloud
    into the next, as the step's 640-cloud relation call does (5 tiles a
    block): 160 clouds of 512 queries give 2 tiles a block; 7 clouds of 100
    queries cut into 5 partials give 6, a cloud's short last tile inside a
    block. Bit-identical across two calls and within BWD_TOL of plain."""
    if case == "5_partials":
        monkeypatch.setattr(bqgr, "_MAX_PARTIALS", 5)
    B, M, per_block = (160, 512, 2) if case == "160_clouds" else (7, 100, 6)
    assert bqgr.raw_bwd_plan(B, M, 32, 7, 64).tiles_per_block == per_block
    xyz, q, _A = _group_inputs(21, B, 2000, M, 1, dtype)
    xyz, q = xyz.to(card), q.to(card)
    gen = torch.Generator(card).manual_seed(21)
    raw = torch.randn(B, 7, 2000, generator=gen, device=card).to(dtype)
    W0 = (torch.randn(7, 64, generator=gen, device=card) / 7 ** 0.5).to(dtype)
    _out, idx = bqgr.group_raw_fwd(xyz, q, 0.2, 32, W0, raw)
    assert (idx[0, 1] == -1).all()
    g = torch.randn(_out.shape, generator=gen, device=card).to(dtype)
    reset_launch_counts()
    dW0 = bqgr.group_raw_bwd(idx, g, raw)
    assert launch_counts()["group_raw.bwd"] == 1
    torch.testing.assert_close(bqgr.group_raw_bwd(idx, g, raw), dW0, rtol=0, atol=0)  # bit-identical
    _close_bwd(dW0, bqgr.group_raw_bwd_plain(idx, g, raw), "dW0")


def _search_pair_library(tmp_path):
    """tests/csrc/ball_search_pair.cu built with the kernels' nvcc flags."""
    import ctypes
    import subprocess
    from pathlib import Path

    from or4d_tpu_torch.ops import _build

    src = Path(__file__).resolve().parent / "csrc" / "ball_search_pair.cu"
    out = tmp_path / "libball_search_pair.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).or4d_search_pair
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, P, I, I, I, P, F, I, I, P, P, P, P, P]
    fn.restype = I
    return fn


@pytest.mark.parametrize("N", [8000, 1101])
def test_both_scan_order_searches_select_the_same_hits(card, tmp_path, N):
    """ball_search.cuh holds two searches with one selection: ``search``
    (rows 3 and 4) and ``search_x4`` (rows 5, 6 and 9; the one-scale
    instance of row 8's ``search_multi_x4``). On the same clouds
    and queries they give the same hit lists and, where a query has fewer
    hits than nsample, the same count: with and without a scan limit, with
    the 16-byte loads (N 8000; N 1101 leaves odd clouds unaligned and a
    ragged tail) and without them."""
    from or4d_tpu_torch.ops.ball_query_group import r2_of

    fn = _search_pair_library(tmp_path)
    B, M = 6, 256
    xyz, q, _A = _group_inputs(N, B, N, M, 1, torch.float32)
    xyz, q = xyz.to(card), q.to(card)
    gen = torch.Generator(card).manual_seed(N)
    limits = (None, torch.randint(1, N + 1, (B * M,), generator=gen, device=card, dtype=torch.int32))
    stream = torch.cuda.current_stream(card).cuda_stream
    seen = set()  # queries with no hit, with a few, with nsample or more
    for radius, ns in ((0.1, 16), (0.2, 32), (0.4, 64)):
        for limit in limits:
            for vec in (1, 0):
                ia, ib = (torch.full((B * M, ns), -1, dtype=torch.int32, device=card) for _ in range(2))
                ca, cb = (torch.empty(B * M, dtype=torch.int32, device=card) for _ in range(2))
                assert fn(xyz.data_ptr(), q.data_ptr(), B, N, M, None if limit is None else limit.data_ptr(),
                          r2_of(radius), ns, vec, ia.data_ptr(), ca.data_ptr(), ib.data_ptr(), cb.data_ptr(),
                          stream) == 0
                torch.cuda.synchronize()
                torch.testing.assert_close(ca.clamp(max=ns), cb.clamp(max=ns), rtol=0, atol=0)
                torch.testing.assert_close(ib, ia, rtol=0, atol=0)
                seen |= {k for k, m in (("none", ca == 0), ("few", (ca > 0) & (ca < ns)), ("full", ca >= ns))
                         if m.any()}
    assert seen == {"none", "few", "full"}


def _search_multi_library(tmp_path):
    """``or4d_search_multi`` of tests/csrc/ball_search_pair.cu."""
    import ctypes

    _search_pair_library(tmp_path)  # builds the library
    fn = ctypes.CDLL(str(tmp_path / "libball_search_pair.so")).or4d_search_multi
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, I, I, P, P, I, P, P, P, P, P]
    fn.restype = I
    return fn


@pytest.mark.parametrize("N,scales", [(8000, ((0.1, 16), (0.2, 32))), (8000, ((0.4, 64), (0.1, 16), (0.2, 32))),
                                      (1101, ((0.2, 32), (0.05, 4), (0.4, 64), (0.1, 1))), (1101, ((0.3, 40),))],
                         ids=["sa1", "three_descending_first", "four_unordered_ragged", "one_scale_ragged"])
def test_multiscale_search_selects_each_scales_hits_as_search_x4(card, tmp_path, N, scales):
    """``search_multi_x4`` (row 8: every scale at once, one vote over the
    union of the open scales' hits) against its one-scale instance
    ``search_x4`` once per scale on the same queries: the same hit list and, where a query has fewer hits
    than nsample, the same count, for radii in any order, with the 16-byte
    loads and without (N 1101: odd clouds unaligned, a ragged tail)."""
    import ctypes

    from or4d_tpu_torch.ops.ball_query_group import r2_of

    fn = _search_multi_library(tmp_path)
    B, M = 6, 256
    xyz, q, _A = _group_inputs(N + len(scales), B, N, M, 1, torch.float32)
    xyz, q = xyz.to(card), q.to(card)
    S = len(scales)
    stream = torch.cuda.current_stream(card).cuda_stream
    seen = set()
    for vec in (1, 0):
        new = lambda shape: torch.full(shape, -1, dtype=torch.int32, device=card)
        im, ix = ([new((B * M, ns)) for _r, ns in scales] for _ in range(2))
        cm, cx = ([new((B * M,)) for _ in scales] for _ in range(2))
        ptrs = lambda ts: (ctypes.c_void_p * S)(*[t.data_ptr() for t in ts])
        assert fn(xyz.data_ptr(), q.data_ptr(), B, N, M, S, (ctypes.c_float * S)(*[r2_of(r) for r, _ns in scales]),
                  (ctypes.c_int * S)(*[ns for _r, ns in scales]), vec, ptrs(im), ptrs(cm), ptrs(ix), ptrs(cx),
                  stream) == 0
        torch.cuda.synchronize()
        for (_r, ns), a, b, ca, cb in zip(scales, im, ix, cm, cx):
            torch.testing.assert_close(ca.clamp(max=ns), cb.clamp(max=ns), rtol=0, atol=0)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
            seen |= {k for k, m in (("none", cb == 0), ("few", (cb > 0) & (cb < ns)), ("full", cb >= ns))
                     if m.any()}
    assert seen == {"none", "few", "full"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plane_forward_at_step_widths_bit_equal(card, dtype):
    """Rows 9 (SA1 plane within the FPS bound) and 6 (SA2's 512-point
    clouds, C 128) through the shared search."""
    xyz, q, need, _raw, _W0, gen = _row5_full("relations", dtype, card)
    A = torch.randn(xyz.shape[0], xyz.shape[1], 64, generator=gen).to(dtype).to(card)
    got, gidx = bqg.group_fwd(xyz, q, 0.2, 32, A, need[1], bqg.LAUNCHES_GATED)
    want, widx = bqg.group_fwd_plain(xyz, q, 0.2, 32, A)
    torch.testing.assert_close(gidx, widx, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    xyz2, q2, A2 = (t.to(card) for t in _group_inputs(12, 40, 512, 128, 128, dtype))
    for r, ns in ((0.2, 32), (0.4, 64)):
        got, gidx = bqg.group_fwd(xyz2, q2, r, ns, A2)
        want, widx = bqg.group_fwd_plain(xyz2, q2, r, ns, A2)
        torch.testing.assert_close(gidx, widx, rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert (gidx[0, 1] == -1).all() and not got[0, 1].any()


def test_group_wrappers_raise_when_a_plan_is_refused(card, monkeypatch):
    """A plan over the shared-memory budget raises before any launch; no
    wrapper falls back to its plain version."""
    xyz, q, need, raw, W0, gen = _row5_full("objects", torch.float32, card)
    _out, idx = bqgr.group_raw_fwd(xyz, q, 0.1, 16, W0, raw, need[0])
    g = torch.randn(_out.shape, generator=gen, device="cpu").to(card)
    A = torch.randn(xyz.shape[0], xyz.shape[1], 64, device=card)
    reset_launch_counts()
    monkeypatch.setattr(bqg, "MAX_SMEM", 1000)
    with pytest.raises(ValueError):
        bqgr.group_raw_fwd(xyz, q, 0.1, 16, W0, raw, need[0])
    with pytest.raises(ValueError):
        bqg.group_fwd(xyz, q, 0.1, 16, A)
    monkeypatch.setattr(bqgr, "MAX_SMEM", 1000)
    with pytest.raises(ValueError):
        bqgr.group_raw_bwd(idx, g, raw)
    assert all(v == 0 for v in launch_counts().values())


# SA1's train grouping with train_raw false (TPU row 9) at the relation
# crops' widths, and the bounds pre-pass (row 10) on SA1 geometry
SA1_SCALES = ((0.1, 16), (0.2, 32))


def _sa1_geometry(seed, B, N, card):
    xyz = _cloud(seed, B, N).to(card)
    idx, counts = furthest_point_sample_with_counts(xyz, 512, tuple(r for r, _ in SA1_SCALES))
    q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
    return xyz, q, counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_group_kernels_match_plain(card, dtype):
    xyz, q, counts = _sa1_geometry(9, 2, 8000, card)
    need = counts_to_bounds(SA1_SCALES, counts)[1][0].int().contiguous()
    A = torch.randn(2, 8000, 64, generator=torch.Generator().manual_seed(9)).to(dtype).to(card)
    reset_launch_counts()
    got, gidx = bqg.group_fwd(xyz, q, 0.2, 32, A, need, bqg.LAUNCHES_GATED)
    want, widx = bqg.group_fwd_plain(xyz, q, 0.2, 32, A, need)
    torch.testing.assert_close(gidx, widx, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(bqg.group_fwd_plain(xyz, q, 0.2, 32, A)[1], widx, rtol=0, atol=0)  # exact bound
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(10)).to(dtype).to(card)
    dA = bqg.group_bwd(gidx, g, 8000, bqg.LAUNCHES_GATED)
    counts_now = launch_counts()
    assert counts_now["group_gated.fwd"] == 1 and counts_now["group_gated.bwd"] == 1
    assert counts_now["group.fwd"] == 0 and counts_now["group.bwd"] == 0
    _close_bwd(dA, bqg.group_bwd_plain(gidx, g, 8000), "dA")
    a1 = A.clone().requires_grad_(True)
    (bqg.ball_query_group_gated(xyz, q, 0.2, 32, a1, need) * g).sum().backward()
    _close_bwd(a1.grad, dA, "dA")
    assert launch_counts()["group_gated.fwd"] == 2


@pytest.mark.parametrize("case", ["N1100_ns16", "N8000_ns64", "N8000_C128", "clustered", "N512_ns64"])
def test_plane_backward_on_wide_supports_matches_plain(card, case):
    """The per-cloud list backward at SA1's and SA2's (N512_ns64) widths; a
    query with no hit, and in the clustered case every query sharing its
    first hits (lists of M entries)."""
    N, M, ns, C = {"N1100_ns16": (1100, 128, 16, 64), "N8000_ns64": (8000, 512, 64, 64),
                   "N8000_C128": (8000, 512, 32, 128), "clustered": (1100, 512, 32, 64),
                   "N512_ns64": (512, 128, 64, 128)}[case]
    xyz, q, A = _group_inputs(N + ns, 3, N, M, C, torch.float32)
    if case == "clustered":
        xyz = xyz * 0.01
        q = q * 0.01
        q[0, 1] = 40.0
    xyz, q, A = xyz.to(card), q.to(card), A.to(card)
    _out, idx = bqg.group_fwd(xyz, q, 0.3, ns, A)
    assert (idx[0, 1] == -1).all()
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.randn(3, M, ns, C, generator=torch.Generator().manual_seed(N)).to(dtype).to(card)
        dA = bqg.group_bwd(idx, g, N)
        _close_bwd(dA, bqg.group_bwd_plain(idx, g, N), "dA")
        torch.testing.assert_close(bqg.group_bwd(idx, g, N), dA, rtol=0, atol=0)  # deterministic


# row 10's layouts: SA1's scales on FPS centroids (M = 512) at the train
# step's widths and an unaligned N, 1 to 4 scales in any order, M not a
# multiple of the block's queries, a cloud over one window (a ring of
# windows, the last chunk ragged); every case has a query with no hit
BOUNDS_CASES = {
    "N1100": (1100, 512, SA1_SCALES), "N4000": (4000, 512, SA1_SCALES), "N8000": (8000, 512, SA1_SCALES),
    "N4097_M300": (4097, 300, SA1_SCALES), "N20001": (20001, 512, SA1_SCALES),
    "three_descending": (1537, 512, ((0.4, 64), (0.2, 32), (0.1, 16))),
    "four_unordered_M77": (2047, 77, ((0.2, 32), (0.05, 4), (0.4, 64), (0.1, 16))),
    "one_scale": (8000, 512, ((0.1, 16),)),
}


@pytest.mark.parametrize("case", sorted(BOUNDS_CASES))
def test_bounds_kernel_exact(card, case):
    """Bit-equal to the plain version and, on FPS centroids (clouds the FPS
    kernel takes), to counts_to_bounds of the FPS kernel's counts; one
    launch a call."""
    N, M, scales = BOUNDS_CASES[case]
    xyz = _cloud(N + M, 3, N).to(card)
    if N <= 8192:
        idx, counts = furthest_point_sample_with_counts(xyz, M, tuple(r for r, _ in scales))
        q = torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)).contiguous()
        reset_launch_counts()
        got = ball_query_bounds(scales, xyz, q)
        assert launch_counts()["bounds.prepass"] == 1
        for (gn, gt), (need, _thr), c in zip(got, counts_to_bounds(scales, counts), counts):
            torch.testing.assert_close(gn, need, rtol=0, atol=0)
            torch.testing.assert_close(gt, c.sum(-1), rtol=0, atol=0)
    else:
        q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(N))[:M]].contiguous()
    q[1, 5] = 40.0  # no hit: need 1, total 0
    reset_launch_counts()
    got = ball_query_bounds(scales, xyz, q)
    assert launch_counts()["bounds.prepass"] == 1
    for (gn, gt), (wn, wt) in zip(got, ball_query_bounds_plain(scales, xyz, q)):
        torch.testing.assert_close(gn, wn, rtol=0, atol=0)
        torch.testing.assert_close(gt, wt, rtol=0, atol=0)
        assert gn[1, 5] == 1.0 and gt[1, 5] == 0.0
    assert (bqb.bounds_plan(3, N, M, len(scales)).window < N) == (N > 8192)
    with pytest.raises(ValueError):  # five scales
        ball_query_bounds(((0.1, 4),) * 5, xyz, q)


@pytest.mark.parametrize("scales", [SA1_SCALES, ((0.2, 32), (0.05, 4), (0.4, 64), (0.1, 16))])
def test_bounds_kernel_every_block_shape_exact(card, monkeypatch, scales):
    """Every queries a thread the plan may pick (1/2/4, 4 for at most two
    scales), each over a ring of 1536-point windows and over the whole
    cloud, on a ragged cloud (N 4097: the last chunk one point) and a ragged
    query tile (M 300): bit-equal to the plain version."""
    N, M = 4097, 300
    xyz = _cloud(N + len(scales), 3, N).to(card)
    q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(N))[:M]].contiguous()
    q[1, 5] = 40.0
    want = ball_query_bounds_plain(scales, xyz, q)
    base = bqb.bounds_plan(3, N, M, len(scales))
    for queries in ((1, 2, 4) if len(scales) <= 2 else (1, 2)):
        for window in (1536, 4608):
            plan = dataclasses.replace(base, queries=queries, block_queries=bqb.THREADS * queries, window=window,
                                       smem_bytes=bqb._window_smem(N, window))
            monkeypatch.setattr(bqb, "bounds_plan", lambda *a, plan=plan: plan)
            for (gn, gt), (wn, wt) in zip(ball_query_bounds(scales, xyz, q), want):
                torch.testing.assert_close(gn, wn, rtol=0, atol=0, msg=str(plan))
                torch.testing.assert_close(gt, wt, rtol=0, atol=0, msg=str(plan))


def test_bounds_kernel_raises_when_a_plan_is_refused(card, monkeypatch):
    """A plan over the shared-memory budget raises before any launch, and a
    plan whose bytes disagree with the kernel's own is refused by the
    launch; nothing falls back to the plain version."""
    xyz = _cloud(4, 2, 4000).to(card)
    q = xyz[:, :512].contiguous()
    reset_launch_counts()
    monkeypatch.setattr(bqb, "MAX_SMEM", 4000)
    with pytest.raises(ValueError):
        ball_query_bounds(SA1_SCALES, xyz, q)
    monkeypatch.undo()
    plan = bqb.bounds_plan(2, 4000, 512, 2)
    monkeypatch.setattr(bqb, "bounds_plan", lambda *a: dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16))
    with pytest.raises(RuntimeError):
        ball_query_bounds(SA1_SCALES, xyz, q)
    assert launch_counts()["bounds.prepass"] == 0


# serving path (TPU rows 8 and 7): the multi-scale ball query exactly; the
# serving SA1 MLP within the SA tolerance (another summation order in the
# plain version's matmuls)


@pytest.mark.parametrize("N,scales", [(4000, ((0.1, 16), (0.2, 32))), (8000, ((0.1, 16), (0.2, 32))),
                                      (8000, ((0.2, 64),)), (600, ((0.05, 4), (0.4, 64), (0.8, 700)))])
def test_multiscale_ball_query_kernel_exact(card, N, scales):
    xyz = _cloud(N + 7, 3, N)
    q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(N))[:512]].contiguous()
    q[1, 5] = 40.0  # no hit: index 0 in every slot
    want = ball_query_multiscale_plain(scales, xyz, q)
    reset_launch_counts()
    got = ball_query_multiscale(scales, xyz.to(card), q.to(card))
    assert launch_counts()["ball_query.multiscale"] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
        assert not g[1, 5].any()


# row 8's layouts: scales in any order and 1 to 4 of them, ns 1 and 1024 (8
# warps a block), a cloud too large to stage, a cloud not a multiple of 4 or
# 128 points (unaligned clouds, a ragged tail); every case has a query with
# no hit
MULTISCALE_CASES = {
    "three_descending": (8000, ((0.4, 64), (0.2, 32), (0.1, 16))),
    "four_unordered": (4000, ((0.2, 32), (0.05, 4), (0.4, 64), (0.1, 16))),
    "one_scale_ns1": (8000, ((0.1, 1),)),
    "ns1024": (8000, ((0.8, 1024),)),
    "four_scales_ns1024": (1101, ((0.8, 1024), (0.1, 16), (0.4, 1024), (0.2, 1024))),
    "unstaged_N20000": (20000, ((0.1, 16), (0.2, 32))),
    "N1101": (1101, ((0.1, 16), (0.2, 32))),
}


@pytest.mark.parametrize("case", sorted(MULTISCALE_CASES))
def test_multiscale_kernel_layouts_bit_exact(card, case):
    N, scales = MULTISCALE_CASES[case]
    xyz = _cloud(N + len(scales), 3, N).to(card)
    q = xyz[:, torch.randperm(N, generator=torch.Generator().manual_seed(N))[:512]].contiguous()
    q[1, 5] = 40.0  # no hit: index 0 in every slot
    plan = bqm.multiscale_plan(3, N, 512, scales)
    assert plan.stage_xyz == (case != "unstaged_N20000")
    assert plan.warps == (8 if case == "four_scales_ns1024" else 16)
    want = ball_query_multiscale_plain(scales, xyz, q)
    reset_launch_counts()
    got = ball_query_multiscale(scales, xyz, q)
    assert launch_counts()["ball_query.multiscale"] == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert not g[1, 5].any()


def test_multiscale_and_plane_backward_raise_when_a_plan_is_refused(card, monkeypatch):
    """A plan over the shared-memory budget raises before any launch, and a
    plan whose bytes disagree with the kernel's own is refused by the
    launch; nothing falls back to a plain version."""
    xyz, q, A = (t.to(card) for t in _group_inputs(5, 2, 4000, 128, 64, torch.float32))
    _out, idx = bqg.group_fwd(xyz, q, 0.2, 32, A)
    g = torch.randn(_out.shape, device=card)
    reset_launch_counts()
    monkeypatch.setattr(bqm, "MAX_SMEM", 1000)
    with pytest.raises(ValueError):
        ball_query_multiscale(((0.1, 16), (0.2, 32)), xyz, q)
    monkeypatch.setattr(bqg, "MAX_SMEM", 1000)
    with pytest.raises(ValueError):
        bqg.group_bwd(idx, g, 4000)
    assert all(v == 0 for v in launch_counts().values())
    monkeypatch.undo()
    plan = bqm.multiscale_plan(2, 4000, 128, ((0.1, 16),))
    monkeypatch.setattr(bqm, "multiscale_plan", lambda *a: dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 16))
    with pytest.raises(RuntimeError):
        ball_query_multiscale(((0.1, 16),), xyz, q)
    bplan = bqg.bwd_plan(2, 4000, 128, 32, 64)
    monkeypatch.setattr(bqg, "bwd_plan", lambda *a: dataclasses.replace(bplan, sum_blocks=bplan.sum_blocks + 1))
    with pytest.raises(RuntimeError):
        bqg.group_bwd(idx, g, 4000)
    assert all(v == 0 for v in launch_counts().values())


# the plane backward (rows 6 and 9) at the S=8 step's widths: SA1's relation
# and object calls and SA2's relation call, queries from FPS as on the path
PLANE_BWD_FULL = {"sa1_relations": (640, 8000, 512, 32, 64, 0.2), "sa1_objects": (96, 4000, 512, 16, 64, 0.1),
                  "sa2_relations": (640, 512, 128, 64, 128, 0.4)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(PLANE_BWD_FULL))
def test_plane_backward_at_step_widths_deterministic(card, case, dtype):
    B, N, M, ns, C, r = PLANE_BWD_FULL[case]
    xyz = _cloud(N + ns, B, N).to(card)
    q = torch.gather(xyz, 1, furthest_point_sample(xyz, M).long()[..., None].expand(-1, -1, 3)).contiguous()
    q[0, 5] = 40.0  # no hit: passes nothing
    gen = torch.Generator().manual_seed(N + ns)
    A = torch.randn(B, N, C, generator=gen).to(dtype).to(card)
    _out, idx = bqg.group_fwd(xyz, q, r, ns, A)
    del _out
    g = torch.randn(B, M, ns, C, generator=gen).to(dtype).to(card)
    reset_launch_counts()
    dA = bqg.group_bwd(idx, g, N)
    assert launch_counts()["group.bwd"] == 1
    torch.testing.assert_close(bqg.group_bwd(idx, g, N), dA, rtol=0, atol=0)  # bit-identical
    _close_bwd(dA, bqg.group_bwd_plain(idx, g, N), "dA")
    # each point's rows summed in flattened slot order, as the CPU's sequential scatter does
    torch.testing.assert_close(dA.cpu(), bqg.group_bwd_plain(idx.cpu(), g.cpu(), N), rtol=0, atol=0)
    hits = torch.bincount((torch.arange(B, device=card)[:, None, None] * N + idx.long())[idx >= 0], minlength=B * N)
    if case == "sa2_relations":
        assert int(hits.max()) > 32  # lists longer than a warp
    assert (idx[0, 5] == -1).all() and (hits == 0).any()  # points on no list get zero rows


def _serving_inputs(seed, R, M, ns, C0, C1, C2, dtype):
    g = torch.Generator().manual_seed(seed)
    planes = torch.zeros(R, M, ns, 8)
    planes[..., :C0] = torch.randn(R, M, ns, C0, generator=g)
    return [planes.to(dtype), (torch.randn(R, M, C1, generator=g) * 0.5).to(dtype),
            (torch.randn(C0, C1, generator=g) / C0 ** 0.5).to(dtype), torch.rand(C1, generator=g) + 0.5,
            torch.randn(C1, generator=g) * 0.2, (torch.randn(C1, C2, generator=g) / C1 ** 0.5).to(dtype),
            torch.rand(C2, generator=g) + 0.5, torch.randn(C2, generator=g) * 0.2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns,C0,C2,M", [(16, 6, 64, 512), (32, 7, 128, 512), (64, 7, 128, 100), (5, 3, 40, 70)])
def test_serving_mlp_kernel_matches_plain(card, dtype, ns, C0, C2, M):
    args = _serving_inputs(ns + C2, 3, M, ns, C0, 64, C2, dtype)
    want = serving_sa1_mlp_plain(*args)
    reset_launch_counts()
    got = serving_sa1_mlp(*[a.to(card) for a in args])
    assert launch_counts()["serving_sa1.mlp"] == 1
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_serving_wrappers_raise_outside_limits(card):
    xyz = _cloud(1, 1, 300).to(card)
    with pytest.raises(ValueError):  # nsample above the kernel's limit
        ball_query_multiscale(((0.2, 2000),), xyz, xyz[:, :16].contiguous())
    with pytest.raises(ValueError):  # five scales
        ball_query_multiscale(((0.2, 4),) * 5, xyz, xyz[:, :16].contiguous())
    args = [a.to(card) for a in _serving_inputs(1, 2, 16, 8, 6, 64, 256, torch.float32)]
    with pytest.raises(ValueError):  # C2 above the kernel's limit
        serving_sa1_mlp(*args)
    args = [a.to(card) for a in _serving_inputs(1, 2, 16, 160, 6, 64, 64, torch.float32)]
    with pytest.raises(ValueError):  # ns above the kernel's limit
        serving_sa1_mlp(*args)
    args = [a.to(card) for a in _serving_inputs(1, 2, 16, 8, 6, 64, 64, torch.float32)]
    with pytest.raises(ValueError):  # more than 8 channels in the cache
        serving_sa1_mlp(torch.zeros(2, 16, 8, 9, device=card), *args[1:])
    with pytest.raises(ValueError):  # planes off a 16-byte boundary
        serving_sa1_mlp(torch.zeros(2 * 16 * 8 * 8 + 1, device=card)[1:].view(2, 16, 8, 8), *args[1:])


# serving against cold: the serving SA1 kernel (row 7) on the cache of a
# cloud against the cold fused SA kernel in raw mode (row 3) on the cloud,
# unpaired, with the same FPS centroids and weights: bit for bit in bfloat16
# (one tile code, sa_mma_tile.cuh)


def _sa1_weights(seed, C0, C1, C2, M, B, dtype):
    g = torch.Generator().manual_seed(seed)
    return dict(Bq=(torch.randn(B, M, C1, generator=g) * 0.5).to(dtype),
                W0=(torch.randn(C0, C1, generator=g) / C0 ** 0.5).to(dtype), a0=torch.rand(C1, generator=g) + 0.5,
                b0=torch.randn(C1, generator=g) * 0.2, W1=(torch.randn(C1, C2, generator=g) / C1 ** 0.5).to(dtype),
                a1=torch.randn(C2, generator=g), b1=torch.randn(C2, generator=g) * 0.2)  # a1 of both signs


def _serving_vs_cold(card, N, C0, dtype, B=3):
    from or4d_tpu_torch.serving import build_sa1_cache

    scales = ((0.1, 16, 64), (0.2, 32, 128))  # SA1: (radius, nsample, C2), C1 64
    rng = np.random.default_rng(N + C0)
    pc = (rng.standard_normal((B, N, C0)) * 0.5).astype(np.float32)
    pc[:, :, 3:] = rng.uniform(0, 1, (B, N, C0 - 3))
    pc = torch.from_numpy(pc).to(card)
    cache = build_sa1_cache(pc, 512, tuple((r, ns) for r, ns, _c2 in scales), dtype)
    xyz = pc[..., :3].contiguous()
    _idx, needs = furthest_point_sample_with_bounds(xyz, 512, tuple((r, ns) for r, ns, _c2 in scales))
    raw = pc.to(dtype).transpose(1, 2).contiguous()  # (B, C0, N), as the cold SA stage builds it
    diffs = []
    for si, (r, ns, C2) in enumerate(scales):
        w = {k: v.to(card) for k, v in _sa1_weights(si, C0, 64, C2, 512, B, dtype).items()}
        reset_launch_counts()
        served = serving_sa1_mlp(cache.grouped[si], w["Bq"], w["W0"], w["a0"], w["b0"], w["W1"], w["a1"], w["b1"])
        cold = sa_group_mlp(xyz, cache.new_xyz, r, ns, w["Bq"], w["a0"], w["b0"], w["W1"], w["a1"], w["b1"],
                            raw=raw, W0=w["W0"], need=needs[si])
        counts = launch_counts()
        assert counts["serving_sa1.mlp"] == 1 and counts["sa_group_mlp.raw"] == 1
        assert float(served.float().abs().max()) > 0
        diffs.append(float((served.float() - cold.float()).abs().max()))
    return diffs


@pytest.mark.parametrize("N,C0", [(4000, 6), (8000, 7)])
def test_serving_sa1_equals_cold_sa1_in_bf16(card, N, C0):
    """Object crops (N 4000, C0 6) and relation crops (N 8000, C0 7), both
    SA1 scales: max |diff| 0."""
    assert _serving_vs_cold(card, N, C0, torch.bfloat16) == [0.0, 0.0]


@pytest.mark.parametrize("N,C0", [(4000, 6), (8000, 7)])
def test_serving_sa1_against_cold_sa1_in_f32(card, N, C0):
    """The same in float32 (the FP32-pipe bodies): reported, within 1e-5."""
    diffs = _serving_vs_cold(card, N, C0, torch.float32)
    print(f"f32 serving vs cold SA1, N {N}, C0 {C0}: max |diff| per scale {diffs}")
    assert max(diffs) <= 1e-5


def test_serving_matches_cold_forward_in_bf16(card):
    """End to end: SGPN log-probs in bfloat16, serving (cached SA1) against
    the cold unpaired forward, within 1e-4."""
    from or4d_tpu_torch.config import DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.serving import _strip_points, build_sgpn_sa1_caches

    batch = SceneBatch.stack(make_scene_samples(2, seed=3, n_objects=5, ds=DatasetConfig(), points_per_obj=2000))
    pack = SlotPack.build(batch).to(card)
    model = SGPN(compute_dtype=torch.bfloat16, device=card, seed=4)
    with torch.no_grad():
        caches = build_sgpn_sa1_caches(model, batch.to(card), pack)
        served = model(_strip_points(batch).to(card), pack, sa1_caches=caches)
        cold = model(batch.to(card), pack)
    for name in ("rel_logprobs", "obj_logprobs"):
        s, c = getattr(served, name).float(), getattr(cold, name).float()
        assert torch.isfinite(s).all()
        assert float((s - c).abs().max()) <= 1e-4, name


def eval_stages(model, batch, pack=None, sa1_caches=None) -> dict:
    """One eval forward of an SGPN (cold, or serving with ``sa1_caches``),
    its outputs stage by stage: per encoder ("obj", "rel") SA1's centroids
    and features and SA2's and SA3's features; the GCN's node and edge
    inputs and outputs; both heads' log-probs (forward hooks; as
    ``chip_smoke.py``'s)."""
    out, hooks = {}, []

    def keep(name, pick):
        return lambda _m, args, res: out.__setitem__(name, pick(args, res).detach())

    for key, enc in (("obj", model.obj_encoder), ("rel", model.rel_encoder)):
        hooks += [enc.sa1.register_forward_hook(keep(f"{key}_sa1_xyz", lambda a, r: r[0])),
                  enc.sa1.register_forward_hook(keep(f"{key}_sa1", lambda a, r: r[1])),
                  enc.sa2.register_forward_hook(keep(f"{key}_sa2", lambda a, r: r[1])),
                  enc.sa3.register_forward_hook(keep(f"{key}_sa3", lambda a, r: r))]
    for i, part in enumerate(("obj", "rel")):
        hooks += [model.gcn.register_forward_hook(keep(f"gcn_in_{part}", lambda a, r, i=i: a[i])),
                  model.gcn.register_forward_hook(keep(f"gcn_out_{part}", lambda a, r, i=i: r[i]))]
    hooks += [model.obj_predictor.register_forward_hook(keep("obj_head", lambda a, r: r)),
              model.rel_predictor.register_forward_hook(keep("rel_head", lambda a, r: r))]
    try:
        with torch.no_grad():
            model(batch, pack, sa1_caches=sa1_caches)
    finally:
        for h in hooks:
            h.remove()
    return out


def test_serving_equals_cold_forward_in_f32_stage_by_stage(card):
    """Float32 SGPN at the paper's widths on one scene: the serving forward
    equals the cold unpaired one bit for bit at every stage (``eval_stages``:
    both encoders' SA1-SA3, the GCN's inputs and outputs, both heads), and
    so does a second cold forward: the GCN sums each node's messages in one
    order on every run."""
    from or4d_tpu_torch.config import DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.serving import _strip_points, build_sgpn_sa1_caches

    batch = SceneBatch.stack(make_scene_samples(1, seed=5, n_objects=9, ds=DatasetConfig(), points_per_obj=2000))
    pack = SlotPack.build(batch, bucket=8).to(card)
    model = SGPN(device=card, seed=6)
    with torch.no_grad():
        caches = build_sgpn_sa1_caches(model, batch.to(card), pack)
    served = eval_stages(model, _strip_points(batch).to(card), pack, caches)
    cold = [eval_stages(model, batch.to(card), pack) for _ in range(2)]
    assert float(served["rel_head"].abs().max()) > 0 and torch.isfinite(served["rel_head"]).all()
    for name, want in cold[0].items():
        assert torch.equal(served[name], want), name
        assert torch.equal(cold[1][name], want), name


def _l2_clouds():
    """L2's two cloud kinds: 20^3 box grids (exact distance ties) and a
    limb-cylinder skeleton cloud (~1.4k points), both in millimetres."""
    from or4d_tpu_torch.data.synthetic_root import _POSE
    from or4d_tpu_torch.pipeline.instance_labels import oriented_box_to_grid, skeleton_to_limb_points

    grids = np.stack([oriented_box_to_grid(np.array([c, 500.0, -c, 1200.0, 800.0, 700.0, h]))
                      for c, h in ((0.0, 0.0), (900.0, 0.21), (-700.0, -0.13))]).astype(np.float32)
    limbs = skeleton_to_limb_points(_POSE + np.array([300.0, 0.0, -200.0]))[None].astype(np.float32)
    return torch.from_numpy(grids), torch.from_numpy(np.ascontiguousarray(limbs))


def test_l2_fps_kernel_exact(card):
    """Row 2 at L2's shapes: (1, 8000, 3) and (3, 8000, 3) box grids and a
    limb cloud -> 200, against the plain version, exactly."""
    grids, limbs = _l2_clouds()
    assert 1000 < limbs.shape[1] < 8192
    for xyz in (grids[:1], grids, limbs):
        reset_launch_counts()
        got = furthest_point_sample(xyz.to(card), 200)
        assert launch_counts()["fps.fps"] == 1
        torch.testing.assert_close(got.cpu(), furthest_point_sample(xyz, 200), rtol=0, atol=0)


TINY_REAL_JSON = {
    "LR": 1e-3, "USE_GT": False, "MAX_EPOCHES": 1,
    "dataset": {"num_points_objects": 96, "num_points_relation": 128, "data_augmentation": False},
    "MODEL": {"sa_npoints": [32, 16], "sa_nsamples": [[4, 8], [8, 8]]},
    "TPU": {"max_objects": 6, "max_edges": 30, "scene_batch": 2},
}


def test_cli_infer_on_the_card_equals_cpu(card, tmp_path):
    """``cli infer`` from the fixture (``tests/golden/real_data``, val split)
    with one random reference-layout .pth, in float32: the card writes the
    same scan_relations JSON as ``--device cpu``, and its log-probs are
    within 1e-3 of the CPU's on the same samples."""
    import json
    from pathlib import Path

    from or4d_tpu_torch import cli
    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.dataset import ORDataset
    from or4d_tpu_torch.data.scene_batch import SlotPack, is_pair_shared
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.utils.torch_import import export_reference_state_dict, load_reference_checkpoint

    root = Path(__file__).parent / "golden" / "real_data"
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TINY_REAL_JSON))
    cfg = load_config(str(config))
    pth = tmp_path / "ref.pth"
    torch.save(export_reference_state_dict(SGPN.from_config(cfg, 12, 15, device="cpu", seed=3)), pth)
    base = ["infer", "--config", str(config), "--data-root", str(root), "--strict-data", "--split", "val",
            "--torch-checkpoint", str(pth), "--cache-dir", str(tmp_path / "c")]
    reset_launch_counts()
    assert cli.main(base + ["--output", str(tmp_path / "card.json")]) == 0
    assert launch_counts()["sa_group_mlp.raw"] > 0
    assert cli.main(base + ["--output", str(tmp_path / "cpu.json"), "--device", "cpu"]) == 0
    card_rels = json.loads((tmp_path / "card.json").read_text())
    assert card_rels == json.loads((tmp_path / "cpu.json").read_text()) and len(card_rels["4_000000_1"]) > 0

    batch = next(ORDataset(cfg, "val", DEFAULT_VOCAB, data_root=root, cache_dir=tmp_path / "c", for_eval=True,
                           synthetic_fallback=False).batches(2))
    pack = SlotPack.build(batch, paired=is_pair_shared(batch))
    out = {}
    for dev in (card, torch.device("cpu")):
        model = SGPN.from_config(cfg, 12, 15, device=dev, seed=0)
        load_reference_checkpoint(pth, model)
        with torch.no_grad():
            out[dev.type] = model(batch.to(dev), pack.to(dev))
    em, om = torch.from_numpy(batch.edge_mask), torch.from_numpy(batch.obj_mask)
    for name, mask in (("rel_logprobs", em), ("obj_logprobs", om)):
        got, want = getattr(out["cuda"], name).cpu()[mask], getattr(out["cpu"], name)[mask]
        assert float((got - want).abs().max()) <= 1e-3, name


def _pair_shared_batches(card):
    """Two different pair-shared batches at the paper's point counts, each
    with its host plan (equal capacities), and an f32 SGPN on the card."""
    from or4d_tpu_torch.config import DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.models import SGPN

    out = []
    for seed in (11, 23):
        batch = SceneBatch.stack(make_scene_samples(3, seed=seed, n_objects=6, ds=DatasetConfig(),
                                                    points_per_obj=2000, pair_shared=True))
        out.append((batch, SlotPack.build(batch, bucket=8, paired=True)))
    return out, SGPN(device=card, seed=6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paired", [True, False])
def test_packed_upload_on_the_card_gives_the_full_uploads_logprobs_bit_for_bit(card, paired, dtype):
    """On the card as on the CPU: the pack's crop rows uploaded alone give
    the log-probs of the full padded upload bit for bit, in f32 and bf16."""
    from or4d_tpu_torch.data.scene_batch import SlotPack
    from or4d_tpu_torch.models import SGPN

    pairs, _ = _pair_shared_batches(card)
    batch = pairs[0][0]
    plan = SlotPack.build(batch, bucket=8, paired=paired)
    model = SGPN(device=card, seed=6, compute_dtype=dtype)
    with torch.no_grad():
        full = model(batch.to(card), plan.to(card))
        packed = model(batch.to(card, pack=plan), plan.to(card))
    assert torch.equal(packed.rel_logprobs, full.rel_logprobs)
    assert torch.equal(packed.obj_logprobs, full.obj_logprobs)


def test_packed_upload_stages_every_array_in_pinned_memory(card, monkeypatch):
    """Every host buffer the packed upload stages through is pinned: the two
    crops' gathered rows, the seven padded arrays and the images."""
    import dataclasses

    from or4d_tpu_torch.data import scene_batch

    buffers, make = [], scene_batch._host_buffer
    monkeypatch.setattr(scene_batch, "_host_buffer", lambda *a: buffers.append(make(*a)) or buffers[-1])
    ((batch, plan), _), _ = _pair_shared_batches(card)
    batch = dataclasses.replace(batch, images=np.random.default_rng(0).standard_normal((3, 6, 16, 16, 3),
                                                                                       dtype=np.float32))
    up = batch.to(card, pack=plan)
    torch.cuda.synchronize()
    assert len(buffers) == 10 and all(b.is_pinned() for b in buffers)
    flat = torch.from_numpy(batch.rel_points).flatten(0, 1)
    assert torch.equal(up.rel_points.cpu(), flat[torch.from_numpy(plan.pair_idx).long()])
    assert torch.equal(up.images.cpu(), torch.from_numpy(batch.images))


def test_packed_uploads_back_to_back_keep_their_own_rows(card):
    """Batches A B A B uploaded without a synchronisation between them, while
    the stream is held busy so every copy is still pending when the next
    gather writes: each upload's crops and log-probs equal those of the same
    batch uploaded alone. A pinned buffer reused before its copy completed
    would carry the next batch's rows."""
    pairs, model = _pair_shared_batches(card)
    alone = []
    with torch.no_grad():
        for batch, plan in pairs:
            up = batch.to(card, pack=plan)
            out = model(up, plan.to(card))
            torch.cuda.synchronize()
            alone.append((up.obj_points.cpu(), up.rel_points.cpu(), out.rel_logprobs.cpu(), out.obj_logprobs.cpu()))
        order = [0, 1, 0, 1]
        torch.cuda._sleep(500_000_000)
        ups = [pairs[i][0].to(card, pack=pairs[i][1]) for i in order]
        outs = [model(up, pairs[i][1].to(card)) for up, i in zip(ups, order)]
        torch.cuda.synchronize()
    for up, out, i in zip(ups, outs, order):
        got = (up.obj_points.cpu(), up.rel_points.cpu(), out.rel_logprobs.cpu(), out.obj_logprobs.cpu())
        for g, w in zip(got, alone[i]):
            assert torch.equal(g, w), i


def test_s64_paired_eval_upload_sends_the_packs_rows_only(card):
    """An S = 64 pair-shared batch at the paper's slots (12 x 4000 and 132 x
    8000) with 9 objects a scene: 2304 pair rows and 640 object rows, 578 MB
    of the 1.97 GB of padded crops, and no more on the card."""
    from or4d_tpu_torch.data import scene_batch
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack

    S, O, E, n = 64, 12, 132, 9
    edges = [(a, b) for a in range(n) for b in range(n) if a != b]
    edge_index = np.zeros((S, E, 2), np.int32)
    edge_index[:, : len(edges)] = edges
    edge_mask = np.zeros((S, E), bool)
    edge_mask[:, : len(edges)] = True
    obj_mask = np.zeros((S, O), bool)
    obj_mask[:, :n] = True
    batch = SceneBatch(obj_points=np.zeros((S, O, 4000, 6), np.float32),
                       rel_points=np.zeros((S, E, 8000, 7), np.float32), edge_index=edge_index,
                       rel_onehot=np.zeros((S, E, 12), np.float32), gt_class=np.zeros((S, O), np.int32),
                       gt_rels=np.zeros((S, E), np.int32), obj_mask=obj_mask, edge_mask=edge_mask,
                       rel_hand_points=np.zeros((S, E, 2, 3), np.float32))
    plan = SlotPack.build(batch, paired=True)
    assert (len(plan.pair_idx), len(plan.obj_idx)) == (2304, 640)
    torch.cuda.synchronize()
    before, held = dict(scene_batch.UPLOAD), torch.cuda.memory_allocated()
    up = batch.to(card, pack=plan)
    torch.cuda.synchronize()
    sent = scene_batch.UPLOAD["bytes_sent"] - before["bytes_sent"]
    assert sent == 2304 * 8000 * 7 * 4 + 640 * 4000 * 6 * 4 == 577_536_000
    assert scene_batch.UPLOAD["bytes_skipped"] - before["bytes_skipped"] == (
        batch.obj_points.nbytes + batch.rel_points.nbytes - sent) == 1_388_544_000
    assert up.rel_points.shape == (2304, 8000, 7) and up.obj_points.shape == (640, 4000, 6)
    assert torch.cuda.memory_allocated() - held < 600e6
