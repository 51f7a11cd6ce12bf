"""The fused eval SA kernel's tile plan and the identities its tensor-core
body relies on, on the CPU (``or4d_tpu_torch/ops/sa_group_mlp.py``,
``csrc/sa_group_mlp.cu``), and the serving SA1 kernel's plan, which runs the
same tile (``ops/serving_sa1_mlp.py``, ``csrc/serving_sa1_mlp.cu``).

The plan is pure Python: queries per tile, tile passes per query, what is
staged in shared memory and how many bytes, at the main path's shapes and at
the kernel's limits. The identities are checked on the plain version, in
float32 and bfloat16: rows past a query's hits repeat its first hit (16-row
tiles padded so), the max over a query's rows may be taken tile by tile, a
query with no hit takes a zero A row, and the paired halves are one product
with [W0 | W0 with row C0-1 moved to C0].
"""

import numpy as np
import pytest
import torch

from or4d_tpu_torch.ops import sa_group_mlp as sgm
from or4d_tpu_torch.ops.ball_query import ball_query_with_counts
from or4d_tpu_torch.ops.sa_group_mlp import MAX_SMEM, sa_group_mlp_plain, tile_plan
from or4d_tpu_torch.ops.serving_sa1_mlp import serving_plan, serving_sa1_mlp_plain

BF16 = torch.bfloat16

# (N, ns, C0, C1, C2, paired, raw) -> (tile passes per query, block queries,
# stage xyz, stage plane, shared-memory bytes) of the bfloat16 body
MAIN_PATH = {
    "sa1_objects_ns16": ((4000, 16, 6, 64, 64, False, True), (1, 256, True, False, 70544)),
    "sa1_objects_ns32": ((4000, 32, 6, 64, 128, False, True), (2, 256, True, False, 85392)),
    "sa1_relations_ns16": ((8000, 16, 7, 64, 64, True, True), (2, 256, True, False, 125712)),
    "sa1_relations_ns32": ((8000, 32, 7, 64, 128, True, True), (4, 256, True, False, 144656)),
    "sa2_ns32": ((512, 32, 0, 128, 128, False, False), (2, 0, True, True, 192528)),
    "sa2_ns64": ((512, 64, 0, 128, 128, False, False), (4, 0, True, True, 194576)),
}


@pytest.mark.parametrize("case", sorted(MAIN_PATH))
def test_tile_plan_at_main_path_shapes(case):
    shape, (tiles, block_queries, stage_xyz, stage_plane, smem) = MAIN_PATH[case]
    plan = tile_plan(*shape, BF16)
    assert (plan.body, plan.rows_per_tile, plan.queries_per_tile) == ("mma", 16, 1)
    assert (plan.tiles_per_query, plan.block_queries, plan.stage_xyz, plan.stage_plane, plan.smem_bytes) == (
        tiles, block_queries, stage_xyz, stage_plane, smem)
    assert plan.smem_bytes <= MAX_SMEM
    f32 = tile_plan(*shape, torch.float32)  # the card-vs-CPU checks' body
    assert (f32.body, f32.block_queries, f32.stage_xyz, f32.stage_plane) == ("fp32", 32, False, False)
    assert f32.smem_bytes <= MAX_SMEM


def test_tile_plan_at_the_limits():
    for raw, C0, paired in ((False, 0, False), (True, 16, False), (True, 15, True), (True, 16, True)):
        for dtype in (BF16, torch.float32):
            plan = tile_plan(8000, 128, C0, 128, 256, paired, raw, dtype)
            assert plan.smem_bytes <= MAX_SMEM
            if dtype == BF16:
                assert plan.tiles_per_query == 8 * (2 if paired else 1)
                assert not plan.stage_plane
    # ns 128 spans eight 16-row tiles; C2 256 fits beside a staged SA2 plane
    # only at C1 below 128
    assert tile_plan(512, 128, 0, 128, 128, False, False, BF16).stage_plane
    assert not tile_plan(512, 128, 0, 128, 256, False, False, BF16).stage_plane
    assert tile_plan(512, 32, 0, 64, 256, False, False, BF16).stage_plane


@pytest.mark.parametrize("N,staged", [(512, True), (640, True), (700, False), (1100, False), (8000, False)])
def test_tile_plan_stages_the_plane_only_where_it_fits(N, staged):
    plan = tile_plan(N, 32, 0, 128, 128, False, False, BF16)
    assert plan.stage_plane == staged
    assert plan.block_queries == (0 if staged else 256)  # a staged plane: one block per cloud
    assert plan.stage_xyz  # 12 bytes a point fit up to ~10k points beside the weights
    assert plan.smem_bytes <= MAX_SMEM
    if not staged:
        assert plan.smem_bytes + N * 128 * 2 > MAX_SMEM


@pytest.mark.parametrize("shape", [(512, 129, 0, 128, 128, False, False), (512, 32, 0, 129, 128, False, False),
                                   (512, 32, 0, 128, 257, False, False), (4000, 16, 17, 64, 64, False, True),
                                   (512, 32, 0, 128, 128, True, False), (4000, 0, 6, 64, 64, False, True)])
def test_tile_plan_refuses_shapes_outside_the_limits(shape):
    for dtype in (BF16, torch.float32):
        with pytest.raises(ValueError):
            tile_plan(*shape, dtype)
    with pytest.raises(ValueError):
        tile_plan(512, 32, 0, 128, 128, False, False, torch.float64)


def test_tile_plan_refuses_over_the_shared_memory_budget(monkeypatch):
    shape = (4000, 32, 6, 64, 128, False, True)
    need = tile_plan(*shape, BF16)
    assert need.stage_xyz
    # with less room the cloud is no longer staged; with less still, refused
    monkeypatch.setattr(sgm, "MAX_SMEM", need.smem_bytes - 1)
    smaller = tile_plan(*shape, BF16)
    assert not smaller.stage_xyz and smaller.smem_bytes == need.smem_bytes - 48000
    monkeypatch.setattr(sgm, "MAX_SMEM", smaller.smem_bytes - 1)
    for dtype in (BF16, torch.float32):
        with pytest.raises(ValueError):
            tile_plan(*(shape if dtype == BF16 else (4000, 128, 16, 128, 256, False, True)), dtype)


# ------------------------------------------------------------- identities

def _inputs(seed, B, N, M, C0, C1, C2, dtype, radius, paired=False):
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy((rng.standard_normal((B, N, 3)) * 0.5).astype(np.float32))
    q = xyz[:, rng.permutation(N)[:M]].clone()
    q[0, 1] = 40.0  # no hit
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    args = [xyz, q.contiguous(), radius, None, (f(B, M, C1) * 0.5).to(dtype), f(C1).abs() + 0.5, f(C1) * 0.2,
            (f(C1, C2) / C1 ** 0.5).to(dtype), f(C2), f(C2) * 0.2]  # a1 of both signs
    raw = f(B, C0 + int(paired), N).to(dtype)
    W0 = (f(C0, C1) / C0 ** 0.5).to(dtype)
    return args, raw, W0


def _rows_mlp(Af, idx, Bq, a0, b0, W1, a1, b1):
    """Per row of ``idx`` (B, M, R) the slot value relu(a1*(hmid@W1)+b1),
    as the plain version computes it: (B, M, R, C2) float32."""
    b, M, R = idx.shape
    C1 = Af.shape[-1]
    g = torch.gather(Af, 1, idx.reshape(b, M * R, 1).expand(-1, -1, C1)).view(b, M, R, C1)
    h = torch.relu((g - Bq.float()[:, :, None, :]) * a0 + b0).to(W1.dtype).float()
    return torch.relu((h @ W1.float()) * a1 + b1)


def _plane(raw, W0, T):
    return (raw[:, : W0.shape[0]].float().transpose(1, 2) @ W0.float()).to(T).float()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_tiles_padded_with_the_first_hit_change_nothing(dtype):
    """The kernel's rows: 16-row tiles of one query's slots, rows past its
    real hits repeating the first hit; per-tile maxima, then their max. The
    same as the plain version's max over its ns first-hit-filled slots, and
    as the max over the real hits alone."""
    ns, r = 20, 0.25
    args, raw, W0 = _inputs(1, 2, 700, 48, 6, 40, 24, dtype, r)
    args[3] = ns
    xyz, q, _r, _ns, Bq, a0, b0, W1, a1, b1 = args
    want = sa_group_mlp_plain(*args, raw=raw, W0=W0)
    Af = _plane(raw, W0, dtype)
    idx, total = ball_query_with_counts(r, ns, xyz, q)
    nreal = total.clamp(max=ns)
    assert (nreal < ns).any() and (nreal == ns).any() and (nreal == 0).any()
    keep = (total > 0).float()[..., None, None]
    ntiles = -(-ns // 16)
    rows = torch.arange(ntiles * 16)
    tile_idx = torch.where(rows < nreal[..., None], idx[..., rows.clamp(max=ns - 1)], idx[..., :1])
    per_tile = _rows_mlp(Af, tile_idx, Bq, a0, b0, W1, a1, b1).view(2, 48, ntiles, 16, -1)
    # a zero A row for no hit: rows gathered from a zeroed plane copy
    zero_idx = _rows_mlp(torch.zeros_like(Af), tile_idx, Bq, a0, b0, W1, a1, b1).view(2, 48, ntiles, 16, -1)
    per_tile = torch.where(keep[..., None].bool(), per_tile, zero_idx)
    tiled = per_tile.amax(3).amax(2).to(dtype)
    torch.testing.assert_close(tiled, want, rtol=0, atol=0)
    real = _rows_mlp(Af, idx, Bq, a0, b0, W1, a1, b1)
    real = real.masked_fill((torch.arange(ns) >= nreal[..., None])[..., None], float("-inf")).amax(2)
    has = total > 0
    torch.testing.assert_close(real[has].to(dtype), want[has], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_no_hit_query_takes_a_zero_a_row(dtype):
    args, raw, W0 = _inputs(2, 2, 500, 32, 6, 32, 16, dtype, 0.2)
    args[3] = 8
    xyz, q, _r, ns, Bq, a0, b0, W1, a1, b1 = args
    got = sa_group_mlp_plain(*args, raw=raw, W0=W0)
    idx, total = ball_query_with_counts(0.2, ns, xyz, q)
    assert total[0, 1] == 0 and (idx[0, 1] == 0).all()
    zero_rows = _rows_mlp(torch.zeros(2, 500, 32), idx, Bq, a0, b0, W1, a1, b1)  # every slot the zero row
    want = zero_rows[0, 1].amax(0).to(dtype)
    torch.testing.assert_close(got[0, 1], want, rtol=0, atol=0)
    A = _plane(raw, W0, dtype).to(dtype).contiguous()
    torch.testing.assert_close(sa_group_mlp_plain(*args, A=A)[0, 1], want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_paired_halves_are_one_product_with_the_w0_pair(dtype):
    """The raw K vector [channels 0..C0] times [W0 | W0 with row C0-1 moved
    to row C0] (zero rows elsewhere, K padded to 16) gives both halves'
    layer-1 sums: the forward half from channels [0, C0), the reverse half
    with channel C0 in place of C0-1."""
    C0, C1 = 7, 64
    _args, raw, W0 = _inputs(3, 2, 300, 8, C0, C1, 8, dtype, 0.2, paired=True)
    pair = torch.zeros(16, 2 * C1, dtype=torch.float64)
    pair[:C0, :C1] = W0.double()
    pair[: C0 - 1, C1:] = W0[: C0 - 1].double()
    pair[C0, C1:] = W0[C0 - 1].double()
    rawk = torch.zeros(2, 16, 300, dtype=torch.float64)
    rawk[:, : C0 + 1] = raw.double()

    def dot(x, w, chans):  # sum over k in order (adding an exact zero changes nothing)
        acc = torch.zeros(x.shape[0], x.shape[2], w.shape[1], dtype=torch.float64)
        for i, k in enumerate(chans):
            acc = acc + x[:, k, :, None] * w[i]
        return acc

    both = dot(rawk, pair, range(16))
    fwd = dot(raw.double(), W0.double(), range(C0))
    rev = dot(raw.double(), W0.double(), list(range(C0 - 1)) + [C0])
    torch.testing.assert_close(both[..., :C1], fwd, rtol=0, atol=0)
    torch.testing.assert_close(both[..., C1:], rev, rtol=0, atol=0)


# ------------------------------------------------------------- serving plan

# (ns, C0, C1, C2) of the serving path's SA1 scales -> (tiles per query,
# queries per warp pass, shared-memory bytes) of the bfloat16 body
SERVING_MAIN_PATH = {
    "objects_ns16": ((16, 6, 64, 64), (1, 2, 21504)),
    "objects_ns32": ((32, 6, 64, 128), (2, 1, 35328)),
    "relations_ns16": ((16, 7, 64, 64), (1, 2, 21504)),
    "relations_ns32": ((32, 7, 64, 128), (2, 1, 35328)),
}


@pytest.mark.parametrize("case", sorted(SERVING_MAIN_PATH))
def test_serving_plan_at_main_path_shapes(case):
    shape, (tiles, qpu, smem) = SERVING_MAIN_PATH[case]
    plan = serving_plan(*shape, BF16)
    assert (plan.body, plan.tiles_per_query, plan.queries_per_unit, plan.smem_bytes) == ("mma", tiles, qpu, smem)
    f32 = serving_plan(*shape, torch.float32)
    assert f32.body == "fp32" and f32.smem_bytes <= MAX_SMEM


def test_serving_plan_limits():
    for dtype in (BF16, torch.float32):
        plan = serving_plan(128, 8, 128, 128, dtype)
        assert plan.smem_bytes <= MAX_SMEM
        if dtype == BF16:
            assert (plan.tiles_per_query, plan.queries_per_unit) == (8, 1)
        for shape in ((129, 6, 64, 64), (16, 9, 64, 64), (16, 6, 129, 64), (16, 6, 64, 129), (0, 6, 64, 64)):
            with pytest.raises(ValueError):
                serving_plan(*shape, dtype)
    with pytest.raises(ValueError):
        serving_plan(16, 6, 64, 64, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("ns", [5, 16, 20])
def test_serving_tiles_padded_with_slot_zero_change_nothing(dtype, ns):
    """The serving kernel's rows: ceil(ns/16) 16-row tiles per query, rows
    past ns repeating slot 0, and channels >= C0 of a slot masked: the
    plain version on planes padded so equals it on the planes as cached."""
    g = torch.Generator().manual_seed(ns)
    R, M, C0, C1, C2 = 2, 9, 6, 32, 24
    planes = torch.zeros(R, M, ns, 8)
    planes[..., :C0] = torch.randn(R, M, ns, C0, generator=g)
    args = [(torch.randn(R, M, C1, generator=g) * 0.5).to(dtype), (torch.randn(C0, C1, generator=g) / 3).to(dtype),
            torch.rand(C1, generator=g) + 0.5, torch.randn(C1, generator=g) * 0.2,
            (torch.randn(C1, C2, generator=g) / 6).to(dtype), torch.randn(C2, generator=g),
            torch.randn(C2, generator=g) * 0.2]  # a1 of both signs
    want = serving_sa1_mlp_plain(planes.to(dtype), *args)
    rows = torch.arange(-(-ns // 16) * 16)
    tiled = planes[:, :, torch.where(rows < ns, rows, torch.zeros_like(rows))].clone()
    tiled[..., C0:] = torch.randn(tiled[..., C0:].shape, generator=g)  # masked by the kernel, sliced here
    torch.testing.assert_close(serving_sa1_mlp_plain(tiled.to(dtype).contiguous(), *args), want, rtol=0, atol=0)
