"""The train grouping kernels' plans on the CPU, and TPU row 5 against the
JAX VJP on queries with no hit and with fewer hits than ``nsample``.

The plans (``or4d_tpu_torch/ops/ball_query_group.py`` ``group_plan``, the
forward of rows 5, 6 and 9; ``ops/ball_query_group_raw.py``
``raw_bwd_plan``, row 5's dW0) are pure Python: queries per block, what is
staged in shared memory and how many bytes, how the backward's tiles fall
into partials, at the S=8 train step's shapes and at the kernels' limits,
and the constants they assume against the kernel source. The backward's
tiles are replayed here to show that they take every query once; the order
of the kernels' sums, and that every call keeps it, is checked on the card
(``tests/test_torch_cuda.py``).

Row 5: the same numpy inputs and cotangents go through ``jax.vjp`` of
``ball_query_group_pallas_gated_raw`` in interpret mode (bounds from per-chunk
hit counts computed here, as the FPS kernel counts them) and through the
port's autograd Function on CPU tensors. Forward exactly; dW0 to 1e-4 of its
largest value in float32 and one bf16 ulp more in bfloat16.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from or4d_tpu.ops.pallas_ball_query import _counts_to_bounds, ball_query_group_pallas_gated_raw

from or4d_tpu_torch.ops import ball_query_group as bqg, ball_query_group_raw as bqgr
from or4d_tpu_torch.ops.ball_query_group import MAX_SMEM, group_plan
from or4d_tpu_torch.ops.ball_query_group_raw import ball_query_group_raw, raw_bwd_plan
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

# (B, N, M, ns, C, C0) of one S=8 f32 train step's grouping calls (C0 0:
# plane mode) -> (block_queries, stage_xyz, shared-memory bytes)
FWD_MAIN_PATH = {
    "row5_relations_ns16": ((640, 8000, 512, 16, 64, 7), (64, True, 107024)),
    "row5_relations_ns32": ((640, 8000, 512, 32, 64, 7), (64, True, 108048)),
    "row5_objects_ns16": ((96, 4000, 512, 16, 64, 6), (64, True, 58768)),
    "row5_objects_ns32": ((96, 4000, 512, 32, 64, 6), (64, True, 59792)),
    "row9_relations_ns32": ((640, 8000, 512, 32, 64, 0), (64, True, 98064)),
    "row6_relations_ns32": ((640, 512, 128, 32, 128, 0), (64, True, 8208)),
    "row6_relations_ns64": ((640, 512, 128, 64, 128, 0), (64, True, 10256)),
    "row6_objects_ns64": ((96, 512, 128, 64, 128, 0), (32, True, 10256)),
}


def _blocks_cover_every_query_once(B, M, qb):
    """The forward's grid: block k takes cloud k // ceil(M/qb), queries
    [(k % ceil(M/qb)) * qb, + qb) clipped to M."""
    per_cloud = -(-M // qb)
    seen = np.zeros((B, M), np.int64)
    for k in range(B * per_cloud):
        b, q0 = divmod(k, per_cloud)
        seen[b, q0 * qb:min(M, (q0 + 1) * qb)] += 1
    return (seen == 1).all()


@pytest.mark.parametrize("case", sorted(FWD_MAIN_PATH))
def test_forward_plan_at_main_path_shapes(case):
    shape, (qb, stage_xyz, smem) = FWD_MAIN_PATH[case]
    plan = group_plan(*shape)
    assert (plan.block_queries, plan.stage_xyz, plan.smem_bytes) == (qb, stage_xyz, smem)
    assert plan.smem_bytes <= MAX_SMEM
    B, N, M = shape[:3]
    assert _blocks_cover_every_query_once(B, M, plan.block_queries)
    # two waves of two resident blocks on each of 132 SMs at least, unless
    # already at 32 queries a block; two such blocks fit in an SM's 228 KB
    assert B * -(-M // plan.block_queries) >= 2 * 132 * 2 or plan.block_queries == 32
    assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024


def test_forward_plan_counts_the_cards_sms():
    """32 queries a block only where 64 would fill under two waves of the
    given card's SMs: the 96-cloud SA2 call's 192 blocks of 64 fill two
    waves of two blocks on 44 SMs, not on 132."""
    assert group_plan(96, 512, 128, 64, 128).block_queries == 32
    assert group_plan(96, 512, 128, 64, 128, sms=44).block_queries == 64


def test_plan_constants_match_the_kernel_source():
    """The constants the plans assume are the kernel source's own. The
    launch refuses a plan whose bytes or blocks disagree; this also holds
    the forward's resident blocks an SM, which only the plan's choice of
    block size reads."""
    src = (Path(bqg.__file__).parent / "csrc" / "ball_query_group.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    assert (const["kFwdWarps"], const["kFwdMinBlocks"], const["kRawBwdWarps"], const["kRawBwdTile"]) == (
        bqg._FWD_WARPS, bqg._FWD_BLOCKS_PER_SM, bqg._RAW_BWD_WARPS, bqg._RAW_BWD_TILE)
    assert (const["kMaxNs"], const["kMaxC0"], const["kMaxRawC"], const["kMaxSmem"]) == (
        bqg.MAX_NS, bqg._MAX_RAW_C0, bqg._MAX_RAW_C, MAX_SMEM)
    assert "__launch_bounds__(kFwdWarps * 32, kFwdMinBlocks) group_fwd_kernel" in src


@pytest.mark.parametrize("B,M", [(1, 1), (3, 100), (5, 512), (2000, 512), (7, 33)])
def test_forward_plan_covers_every_query_once(B, M):
    plan = group_plan(B, 4000, M, 32, 64, 6)
    assert 1 <= plan.block_queries <= min(M, 64)
    assert _blocks_cover_every_query_once(B, M, plan.block_queries)


def test_forward_plan_stages_xyz_only_where_it_fits():
    # 12 bytes a point beside 16 warps' hit lists of 127 slots (raw mode:
    # and their 16 slots' raw columns), the control word and raw mode's W0
    warps = 16 * (512 + 512) + 16 + 7 * 64 * 4
    big = group_plan(8, 17000, 512, 127, 64, 7)
    assert big.stage_xyz and big.smem_bytes == warps + 204000 <= MAX_SMEM
    over = group_plan(8, 18000, 512, 127, 64, 7)
    assert not over.stage_xyz and over.smem_bytes == warps
    plane = group_plan(8, 18000, 512, 127, 64)
    assert plane.stage_xyz and plane.smem_bytes == 16 * 512 + 16 + 216000


@pytest.mark.parametrize("shape", [(8, 4000, 512, 128, 64, 7), (8, 4000, 512, 0, 64, 7), (8, 4000, 512, 32, 129, 7),
                                   (8, 4000, 512, 32, 257, 0), (8, 4000, 512, 32, 64, 9), (8, 4000, 0, 32, 64, 7)])
def test_forward_plan_refuses_shapes_outside_the_limits(shape):
    with pytest.raises(ValueError):
        group_plan(*shape)


def test_forward_plan_refuses_over_the_shared_memory_budget(monkeypatch):
    shape = (640, 8000, 512, 32, 64, 7)
    staged = group_plan(*shape)
    monkeypatch.setattr(bqg, "MAX_SMEM", staged.smem_bytes - 1)
    smaller = group_plan(*shape)
    assert not smaller.stage_xyz and smaller.smem_bytes == staged.smem_bytes - 96000
    monkeypatch.setattr(bqg, "MAX_SMEM", smaller.smem_bytes - 1)
    with pytest.raises(ValueError):
        group_plan(*shape)


# (B, M, ns, C0, C) of row 5's backward calls at S=8 -> (tiles, tiles per
# block, blocks, shared-memory bytes)
BWD_MAIN_PATH = {
    "relations_ns16": ((640, 512, 16, 7, 64), (10240, 5, 2048, 22528)),
    "relations_ns32": ((640, 512, 32, 7, 64), (10240, 5, 2048, 22528)),
    "objects_ns16": ((96, 512, 16, 6, 64), (1536, 1, 1536, 20480)),
    "objects_ns32": ((96, 512, 32, 6, 64), (1536, 1, 1536, 20480)),
    "c128": ((96, 512, 64, 8, 128), (1536, 1, 1536, 40960)),
}


def _tiles_of_blocks(plan):
    return [list(range(k * plan.tiles_per_block, min(plan.tiles, (k + 1) * plan.tiles_per_block)))
            for k in range(plan.blocks)]


@pytest.mark.parametrize("case", sorted(BWD_MAIN_PATH))
def test_backward_plan_at_main_path_shapes(case):
    shape, (tiles, per_block, blocks, smem) = BWD_MAIN_PATH[case]
    plan = raw_bwd_plan(*shape)
    assert (plan.tiles, plan.tiles_per_block, plan.blocks, plan.smem_bytes) == (tiles, per_block, blocks, smem)
    assert plan.smem_bytes <= MAX_SMEM and plan.blocks <= 2048
    assert plan.blocks >= 132 * 8 or plan.tiles_per_block == 1  # even the 96-cloud object call fills the card
    covered = [t for ts in _tiles_of_blocks(plan) for t in ts]
    assert covered == list(range(plan.tiles)) and all(_tiles_of_blocks(plan))
    assert raw_bwd_plan(*shape) == plan  # the shapes alone fix layout and order


@pytest.mark.parametrize("shape", [(8, 512, 128, 7, 64), (8, 512, 32, 9, 64), (8, 512, 32, 7, 129), (8, 512, 32, 0, 64),
                                   (0, 512, 32, 7, 64)])
def test_backward_plan_refuses_shapes_outside_the_limits(shape):
    with pytest.raises(ValueError):
        raw_bwd_plan(*shape)


def test_backward_plan_refuses_over_the_shared_memory_budget(monkeypatch):
    monkeypatch.setattr(bqgr, "MAX_SMEM", raw_bwd_plan(640, 512, 32, 7, 64).smem_bytes - 1)
    with pytest.raises(ValueError):
        raw_bwd_plan(640, 512, 32, 7, 64)


def _raw_inputs(seed, B, N, M, ns, C0, C, radius=0.2):
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy((rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32))
    q = xyz[:, rng.permutation(N)[:M]].clone()
    q[0, 2] = 40.0  # no hit
    raw = torch.from_numpy(rng.standard_normal((B, C0, N)).astype(np.float32))
    W0 = torch.from_numpy((rng.standard_normal((C0, C)) / C0 ** 0.5).astype(np.float32))
    _out, idx = bqgr.group_raw_fwd_plain(xyz, q.contiguous(), radius, ns, W0, raw)
    g = torch.from_numpy(rng.standard_normal((B, M, ns, C)).astype(np.float32))
    return idx, g, raw


def _replay_partials(idx, g, raw, plan):
    """Per block of the plan, the (C0, C) sum over the slots of the queries
    its tiles hold (cloud-major tiles of 32 queries), and how often each
    (cloud, query) was taken."""
    B, M, ns, C = g.shape
    per_cloud = -(-M // 32)
    picked = raw.transpose(1, 2)[torch.arange(B)[:, None, None], idx.long().clamp(min=0)]  # (B, M, ns, C0)
    picked = picked * (idx >= 0)[..., None]
    taken = torch.zeros(B, M, dtype=torch.int64)
    partials = []
    for tiles in _tiles_of_blocks(plan):
        acc = torch.zeros(raw.shape[1], C)
        for t in tiles:
            b, q0 = divmod(t, per_cloud)
            sl = slice(q0 * 32, (q0 + 1) * 32)
            taken[b, sl] += 1
            acc = acc + torch.einsum("msi,msc->ic", picked[b, sl], g[b, sl])
        partials.append(acc)
    return torch.stack(partials), taken


@pytest.mark.parametrize("max_partials", [2048, 5])
def test_backward_tiles_cover_every_query_once(monkeypatch, max_partials):
    """Every query of every cloud lies in one tile of one block, also where
    a block's tiles run from one cloud into the next (few partials) and a
    cloud's last tile is short: the partials add up to the plain dW0, a
    query with no hit adding nothing."""
    monkeypatch.setattr(bqgr, "_MAX_PARTIALS", max_partials)
    idx, g, raw = _raw_inputs(5, 3, 600, 100, 16, 7, 24)
    assert (idx[0, 2] == -1).all()
    plan = raw_bwd_plan(3, 100, 16, 7, 24)
    assert plan.tiles == 12 and (plan.tiles_per_block, plan.blocks) == ((1, 12) if max_partials == 2048 else (3, 4))
    partials, taken = _replay_partials(idx, g, raw, plan)
    assert (taken == 1).all()
    want = bqgr.group_raw_bwd_plain(idx, g, raw)
    torch.testing.assert_close(partials.sum(0), want, rtol=0, atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------------- row 5 vs JAX

def _chunk_counts(xyz, q, radius):
    """Per 512-point chunk hit counts (B, M, nch) float32 with the kernels'
    f32 distance (each operation rounded, no FMA) and r2 = f32(r*r)."""
    B, N, _ = xyz.shape
    d = q[:, :, None, :] - xyz[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    hit = d2 < np.float32(radius * radius)
    nch = -(-N // 512)
    hit = np.pad(hit, ((0, 0), (0, 0), (0, nch * 512 - N)))
    return hit.reshape(B, q.shape[1], nch, 512).sum(-1).astype(np.float32)


ROW5_CASES = {  # (radius, nsample): "fill" keeps most queries below nsample hits
    "no_hit": (0.2, 16),
    "fill": (0.06, 16),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C0", [6, 7])
@pytest.mark.parametrize("case", sorted(ROW5_CASES))
def test_row5_matches_pallas_vjp_on_no_hit_and_filled_queries(case, C0, dtype):
    jdt, tdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    radius, ns = ROW5_CASES[case]
    rng = np.random.default_rng(C0 * 10 + len(case))
    B, N, M, C = 2, 1100, 40, 16
    xyz = (rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[0, 3] = q[1, 7] = 50.0  # no hit: zero rows, no gradient
    counts = _chunk_counts(xyz, q, radius)
    total = counts.sum(-1)
    assert (total == 0).sum() == 2
    if case == "fill":
        assert ((total > 0) & (total < ns)).mean() > 0.5
    scales = ((radius, ns),)
    bounds = _counts_to_bounds(scales, (jnp.asarray(counts),))
    raw = rng.standard_normal((B, C0, N)).astype(np.float32)
    w0 = (rng.standard_normal((C0, C)) / np.sqrt(C0)).astype(np.float32)
    import jax

    outs, vjp = jax.vjp(
        lambda ws, rw: ball_query_group_pallas_gated_raw(scales, jnp.asarray(xyz), jnp.asarray(q), ws, rw, bounds,
                                                         True, False),
        (jnp.asarray(w0).astype(jdt),), jnp.asarray(raw).astype(jdt))
    gs = rng.standard_normal(outs[0].shape).astype(np.float32)  # slot-major (B, ns, M, C)
    (dw,), _draw = vjp((jnp.asarray(gs).astype(jdt),))

    need = counts_to_bounds(scales, (torch.from_numpy(counts),))[0][0].int()
    W = torch.from_numpy(w0).to(tdt).requires_grad_(True)
    out = ball_query_group_raw(torch.from_numpy(xyz), torch.from_numpy(q), radius, ns, W,
                               torch.from_numpy(raw).to(tdt), need)
    out.backward(torch.from_numpy(np.ascontiguousarray(gs.transpose(0, 2, 1, 3))).to(tdt))
    want = np.asarray(outs[0].astype(jnp.float32)).transpose(0, 2, 1, 3)
    np.testing.assert_array_equal(out.detach().float().numpy(), want)
    assert not out[0, 3].any() and not out[1, 7].any()
    dw = np.asarray(dw.astype(jnp.float32))
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(W.grad.float().numpy(), dw, rtol=rtol, atol=1e-4 * float(np.abs(dw).max()))


# the plane backward (rows 6 and 9): (B, N, M, ns, C) of the S=8 step's calls
# -> (placing warps, runs of 32 entries a cloud, sum blocks, the CSR
# build's shared-memory bytes)
PLANE_BWD_MAIN_PATH = {
    "row9_relations_ns32": ((640, 8000, 512, 32, 64), (1, 512, 640 * 512 // 8, 32000)),
    "row9_relations_ns16": ((640, 8000, 512, 16, 64), (1, 256, 640 * 256 // 8, 32000)),
    "row9_objects_ns32": ((96, 4000, 512, 32, 64), (8, 512, 96 * 512 // 8, 128000)),
    "row6_relations_ns64": ((640, 512, 128, 64, 128), (8, 256, 640 * 256 // 8, 16384)),
    "row6_objects_ns32": ((96, 512, 128, 32, 128), (8, 128, 96 * 128 // 8, 16384)),
}


@pytest.mark.parametrize("case", sorted(PLANE_BWD_MAIN_PATH))
def test_plane_backward_plan_at_main_path_shapes(case):
    shape, want = PLANE_BWD_MAIN_PATH[case]
    plan = bqg.bwd_plan(*shape)
    assert (plan.segs, plan.runs, plan.sum_blocks, plan.build_smem_bytes) == want
    B, N, M, ns, _C = shape
    # the runs cover the cloud's M * ns slots, the blocks of 8 warps every run once
    assert (plan.runs - 1) * 32 < M * ns <= plan.runs * 32
    assert (plan.sum_blocks - 1) * 8 < B * plan.runs <= plan.sum_blocks * 8
    assert plan.build_smem_bytes == 4 * N * plan.segs  # N a multiple of 4 here


def test_plane_backward_plan_splits_a_cloud_only_for_few_clouds():
    """640 relation crops run 640 builds side by side, one placing warp
    each; 96 object crops fill the card only with each cloud's slots split
    over 8 placing warps (and 8 counts a point: 128 KB at 4000 points)."""
    assert bqg.bwd_plan(640, 8000, 512, 32, 64).segs == 1
    assert bqg.bwd_plan(96, 4000, 512, 32, 64).segs == 8
    assert bqg.bwd_plan(96, 8000, 512, 32, 64).segs == 4  # 8 counts a point would pass 227 KB
    # on 8 SMs: two waves of 48 clouds with one placing warp or with two (7
    # blocks of 32 KB an SM), and two halve each cloud's walk
    assert bqg.bwd_plan(96, 4000, 512, 32, 64, sms=8).segs == 2


@pytest.mark.parametrize("shape", [(8, 4000, 512, 128, 64), (8, 4000, 512, 32, 257), (8, 58105, 512, 32, 64),
                                   (0, 4000, 512, 32, 64)])
def test_plane_backward_plan_refuses_shapes_outside_the_limits(shape):
    """nsample over 127 or C over 256, or a cloud whose counts (4 bytes a
    point) and the build's 32 static bytes pass 227 KB of shared memory;
    58104 points still fit."""
    assert bqg.bwd_plan(8, 58104, 512, 32, 64).build_smem_bytes + 32 == MAX_SMEM
    with pytest.raises(ValueError):
        bqg.bwd_plan(*shape)


def test_plane_backward_constants_match_the_kernel_source():
    """The sum's warps a block and the CSR build's threads and bytes (4 a
    point and placing warp, 16-byte aligned) are the source's own; the
    launch refuses a plan whose runs, blocks or bytes disagree."""
    src = (Path(bqg.__file__).parent / "csrc" / "ball_query_group.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    assert (const["kBwdSumWarps"], const["kBwdRun"], const["kMaxC"]) == (bqg._BWD_SUM_WARPS, bqg._BWD_RUN, bqg._MAX_C)
    assert const["kBwdBuildThreads"] == 32 * 8 and const["kBwdBuildThreads"] // 32 * 4 == bqg._BWD_BUILD_STATIC
    assert "inline size_t bwd_build_smem(int N, int segs) { return align16((size_t)N * segs * 4); }" in src
    assert "(Mns + kBwdRun - 1) / kBwdRun != R" in src
    assert "kBwdSumWarps - 1) / kBwdSumWarps != sum_blocks" in src


def plane_bwd_csr(idx: torch.Tensor, N: int, segs: int = 1):
    """A model of the CSR ``group_bwd_build`` writes for one call: per cloud
    the slots' targets (their saved indices; -1 is none) counted per run of
    slots and point, an exclusive scan of the points' totals into list
    starts, each run's cursor at a point after the earlier runs' entries;
    then each run's slots placed 32 at a time in order, lanes with the same
    target ranked among themselves and the target's cursor advanced by
    their count. -> (off (B, N + 1), ent (B, M * ns)) int64."""
    B = idx.shape[0]
    I = idx.reshape(B, -1).long()
    Mns = I.shape[1]
    seg_len = -(-(-(-Mns // segs)) // 32) * 32
    off = torch.zeros(B, N + 1, dtype=torch.int64)
    ent = torch.full((B, Mns), -1, dtype=torch.int64)
    for b in range(B):
        counts = torch.stack([torch.bincount(I[b, s * seg_len:(s + 1) * seg_len][I[b, s * seg_len:(s + 1) * seg_len] >= 0],
                                             minlength=N) for s in range(segs)])
        off[b, 1:] = torch.cumsum(counts.sum(0), 0)
        cursors = off[b, :N] + torch.cumsum(counts, 0) - counts
        for s in range(segs):
            cur = cursors[s]
            for e0 in range(s * seg_len, min(Mns, (s + 1) * seg_len), 32):
                p = I[b, e0:min(e0 + 32, (s + 1) * seg_len)]
                for key in p[p >= 0].unique():
                    lanes = (p == key).nonzero()[:, 0]  # the group, in lane order
                    ent[b, cur[key] + torch.arange(len(lanes))] = e0 + lanes
                    cur[key] += len(lanes)
    return off, ent


def run_points(off: torch.Tensor, E: int = 32):
    """The points each run of E CSR entries takes in ``group_bwd_sum``:
    run k, the points whose lists start in [k * E, (k + 1) * E) (``rfirst``
    of the build), the last run also those after it. -> per cloud, per run,
    a range of points."""
    B, N1 = off.shape
    Mns = int(off[:, -1].max()) if off.numel() else 0
    R = max(1, -(-Mns // E))
    out = []
    for b in range(B):
        first = [int(torch.searchsorted(off[b, :-1], k * E)) for k in range(R)]  # first point with start >= k * E
        out.append([range(first[k], first[k + 1] if k + 1 < R else N1 - 1) for k in range(R)])
    return out


@pytest.mark.parametrize("segs", [1, 8])
def test_plane_backward_csr_order_is_the_flattened_slot_order(segs):
    """The CSR's lists, in place order, are exactly the slots
    ``scatter_rows`` adds to each point in its flattened-slot order (filled
    slots to the first hit, nothing from a query with no hit), whether one
    warp or eight place a cloud's slots; the sum's runs take every point
    once; and each list summed in order in f32 gives the plain version bit
    for bit."""
    rng = np.random.default_rng(21)
    B, N, M, ns, C = 3, 300, 40, 16, 8
    xyz = torch.from_numpy((rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32))
    q = xyz[:, rng.permutation(N)[:M]].contiguous()
    q[0, 2] = 40.0  # no hit
    idx = bqg.group_indices_plain(xyz, q, 0.15, ns)
    flat = idx.reshape(B, -1)
    filled = (flat.view(B, M, ns)[..., 1:] == flat.view(B, M, ns)[..., :1]).any(-1)
    assert (idx[0, 2] == -1).all() and filled.any()  # no-hit and filled queries both present
    off, ent = plane_bwd_csr(idx, N, segs)
    assert int(off[:, -1].sum()) == int((idx >= 0).sum())  # every slot of a query with a hit, once
    g = torch.from_numpy(rng.standard_normal((B, M, ns, C)).astype(np.float32))
    want = bqg.scatter_rows(idx, g, N)
    for b in range(B):
        for n in range(N):
            lst = ent[b, off[b, n]:off[b, n + 1]]
            assert lst.tolist() == (flat[b] == n).nonzero()[:, 0].tolist()
    runs = run_points(off)
    assert all(sorted(n for r in cloud for n in r) == list(range(N)) for cloud in runs)
    assert any(off[b, r.stop] - off[b, r.start] > 32 for b, cloud in enumerate(runs) for r in cloud if len(r))
    dA = torch.zeros(B, N, C)
    rows = g.reshape(B, M * ns, C)
    for b, cloud in enumerate(runs):
        for r in cloud:
            for n in r:
                for e in ent[b, off[b, n]:off[b, n + 1]].tolist():
                    dA[b, n] += rows[b, e]
    torch.testing.assert_close(dA, want, rtol=0, atol=0)
