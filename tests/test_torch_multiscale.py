"""TPU row 8 (the multi-scale index ball query) on the CPU: the kernel's plan
and its plain version against the JAX package's Pallas kernel.

The plan (``or4d_tpu_torch/ops/ball_query_multiscale.py``
``multiscale_plan``) is pure Python: warps and queries per block, whether
the cloud's xyz is staged in shared memory and how many bytes the block
takes, at the serving cache build's shapes and at the kernel's limits, with
the constants and the byte formula it shares with
``csrc/ball_query_multiscale.cu`` read from the source. The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).

Parity: the same numpy clouds and queries go through
``ball_query_multiscale_pallas`` in interpret mode and through the port's
wrapper on CPU tensors (its plain version), with radii given in descending
order and with three scales; indices exactly.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from or4d_tpu.ops.pallas_ball_query import ball_query_multiscale_pallas

from or4d_tpu_torch.ops import ball_query_multiscale as bqm
from or4d_tpu_torch.ops.ball_query_multiscale import MAX_SMEM, ball_query_multiscale, multiscale_plan

SA1 = ((0.1, 16), (0.2, 32))

# (B, N, M, scales) of the serving cache build's calls (S=64: 640 object and
# 4608 relation crops; S=8 and chip_smoke's 64-cloud check) -> (warps,
# block_queries, stage_xyz, shared-memory bytes)
PLANS = {
    "relations_s64": ((4608, 8000, 512, SA1), (16, 128, True, 16 * 192 + 16 + 96000)),
    "objects_s64": ((640, 4000, 512, SA1), (16, 128, True, 16 * 192 + 16 + 48000)),
    "relations_64_clouds": ((64, 8000, 512, SA1), (16, 32, True, 16 * 192 + 16 + 96000)),
    "whole_scene_20000": ((3, 20000, 512, SA1), (16, 16, False, 16 * 192 + 16)),
    "four_scales_ns1024": ((3, 8000, 512, ((0.1, 1024),) * 4), (8, 8, True, 8 * 16384 + 16 + 96000)),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_at_serving_shapes(case):
    shape, (warps, qb, stage, smem) = PLANS[case]
    plan = multiscale_plan(*shape)
    assert (plan.warps, plan.block_queries, plan.stage_xyz, plan.smem_bytes) == (warps, qb, stage, smem)
    assert plan.smem_bytes <= MAX_SMEM
    B, _N, M, _sc = shape
    # every query in one block: blocks of block_queries consecutive queries of one cloud
    per_cloud = -(-M // plan.block_queries)
    assert per_cloud * plan.block_queries >= M > (per_cloud - 1) * plan.block_queries
    # two waves of two resident blocks on each of 132 SMs at least, unless
    # already down to one query a warp
    assert B * per_cloud >= 2 * 132 * 2 or plan.block_queries == plan.warps


def test_plan_stages_the_cloud_only_where_it_fits():
    assert multiscale_plan(8, 4000, 512, SA1).stage_xyz
    assert multiscale_plan(8, 8000, 512, SA1).stage_xyz
    assert not multiscale_plan(8, 20000, 512, SA1).stage_xyz
    # 16 warps' lists of 48 ints, the control word, then 12 bytes a point
    assert multiscale_plan(8, 19113, 512, SA1).stage_xyz
    assert not multiscale_plan(8, 19114, 512, SA1).stage_xyz


def test_plan_counts_the_cards_sms():
    """Fewer queries a block only where the call would fill under two
    waves of the given card's SMs."""
    assert multiscale_plan(64, 8000, 512, SA1).block_queries == 32
    assert multiscale_plan(64, 8000, 512, SA1, sms=32).block_queries == 128


@pytest.mark.parametrize("scales", [(), ((0.1, 16),) * 5, ((0.1, 0),), ((0.1, 1025),)])
def test_plan_refuses_shapes_outside_the_limits(scales):
    with pytest.raises(ValueError):
        multiscale_plan(8, 4000, 512, scales)


def test_plan_refuses_over_the_shared_memory_budget(monkeypatch):
    monkeypatch.setattr(bqm, "MAX_SMEM", 16 * 192)
    with pytest.raises(ValueError):
        multiscale_plan(8, 4000, 512, SA1)


def test_plan_constants_and_bytes_match_the_kernel_source():
    """The constants the plan assumes are the kernel's own, and the source
    computes the block's bytes as the plan does: per warp every scale's ns
    ints (16-byte aligned), a 16-byte control word, 12 bytes a staged point
    (16-byte aligned). The launch refuses a plan whose bytes disagree."""
    src = (Path(bqm.__file__).parent / "csrc" / "ball_query_multiscale.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}
    assert (const["kMaxWarps"], const["kMinBlocks"], const["kMaxScales"], const["kMaxNs"], const["kMaxSmem"]) == (
        bqm._WARPS, bqm._BLOCKS_PER_SM, bqm._MAX_SCALES, bqm._MAX_NS, MAX_SMEM)
    assert "__launch_bounds__(kMaxWarps * 32, kMinBlocks) ball_query_multiscale_kernel" in src
    assert "return align16(4 * n);" in src
    assert "return (size_t)warps * warp_bytes + 16 + (stage_xyz ? align16((size_t)N * 12) : 0);" in src
    assert "(warps != 8 && warps != kMaxWarps)" in src


def _query_set(seed, B=2, N=200, M=40):
    rng = np.random.default_rng(seed)
    xyz = (rng.standard_normal((B, N, 3)) * 0.4).astype(np.float32)
    q = xyz[:, rng.permutation(N)[:M]].copy()
    q[0, 3] = 50.0  # no hit at any radius: index 0 in every slot
    return xyz, q


@pytest.mark.parametrize("scales", [((0.3, 32), (0.15, 16), (0.05, 8)), ((0.1, 4), (0.4, 48), (0.2, 12))],
                         ids=["three_descending", "three_unordered"])
def test_plain_matches_pallas_for_any_radius_order(scales):
    """The multi-scale contract holds per scale whatever the radius order:
    the first nsample hits in scan order, the first hit repeated, index 0
    for a query with no hit."""
    xyz, q = _query_set(7, N=300, M=24)
    want = ball_query_multiscale_pallas(scales, jnp.asarray(xyz), jnp.asarray(q), True)
    got = ball_query_multiscale(scales, torch.from_numpy(xyz), torch.from_numpy(q))
    assert len(got) == len(want) == 3
    for (_r, ns), g, w in zip(scales, got, want):
        assert g.shape == (2, 24, ns) and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g[0, 3] == 0).all()
