"""Multi-scale index ball query: the CUDA kernel
``csrc/ball_query_multiscale.cu`` and its plain PyTorch version.

Replaces ``ball_query_multiscale_pallas`` (or4d_tpu/ops/pallas_ball_query.py:139),
which builds the serving cache's neighbourhoods. What bounds the kernel on
the H100 and what its design does about it is in the header of the CUDA
source.

Per (radius, nsample) scale and query: the first ``nsample`` support indices
in scan order with squared distance < radius^2; empty slots repeat the first
hit, and a query with no hit gets index 0 in every slot (the serving path's
fill, unlike the cold SA kernels' zero row). The plain version is
:func:`or4d_tpu_torch.ops.ball_query.ball_query`, once per scale.

On the card the kernel is planned by :func:`multiscale_plan`: warps and
queries per block, and the cloud's xyz staged in shared memory where it fits
in 227 KB; the kernel recomputes the plan's bytes and refuses a plan that
disagrees. The wrapper takes the plain version for CPU tensors only; a CUDA
tensor always launches the kernel, and a shape the plan refuses or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from or4d_tpu_torch.ops._card import H100_SMS, MAX_SMEM, align16
from or4d_tpu_torch.ops.ball_query import ball_query

# kernel launches (one per call, every scale at once)
LAUNCHES = {"multiscale": 0}

_MAX_SCALES = 4
_MAX_NS = 1024
# the kernel's constants the plan assumes (kMaxWarps and kMinBlocks in the
# source: a test holds them equal)
_WARPS = 16
_BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__ minimum: 64 registers a thread
_MAX_LIST_BYTES = 64 * 1024  # 16 warps' hit lists at most; 8 warps above


@dataclass(frozen=True)
class MultiscalePlan:
    """How ``csrc/ball_query_multiscale.cu`` runs one call: blocks of
    ``warps`` warps over ``block_queries`` queries of one cloud;
    ``stage_xyz``: the cloud's xyz is copied to shared memory, else the
    search reads global memory; ``smem_bytes``: the block's dynamic shared
    memory, which the kernel recomputes and checks."""

    warps: int
    block_queries: int
    stage_xyz: bool
    smem_bytes: int


def _smem_bytes(N: int, ns_total: int, warps: int, stage_xyz: bool) -> int:
    """The kernel's shared memory (``ms_smem`` in the source): per warp its
    hit lists (every scale's ns ints), a 16-byte control word, then the
    staged xyz."""
    return warps * align16(4 * ns_total) + 16 + (align16(12 * N) if stage_xyz else 0)


def multiscale_plan(B: int, N: int, M: int, scales, sms: int = H100_SMS) -> MultiscalePlan:
    """The kernel's plan for one call; ``ValueError`` outside its limits (1
    to 4 scales, nsample 1 to 1024). 16 warps a block, 8 where 16 warps'
    hit lists would pass 64 KB; the cloud's xyz staged where it fits in 227
    KB. Queries per block: 128, halved (to no fewer than one a warp) while
    the call would fill under two waves of resident blocks on the card's
    ``sms`` SMs."""
    if min(B, N, M) < 1 or not 1 <= len(scales) <= _MAX_SCALES or not all(1 <= ns <= _MAX_NS for _r, ns in scales):
        raise ValueError(f"ball_query_multiscale kernel limits: 1 to {_MAX_SCALES} scales of nsample in "
                         f"[1, {_MAX_NS}]; got B={B}, N={N}, M={M}, scales={tuple(scales)}")
    ns_total = sum(ns for _r, ns in scales)
    warps = _WARPS if _WARPS * align16(4 * ns_total) <= _MAX_LIST_BYTES else _WARPS // 2
    stage_xyz = _smem_bytes(N, ns_total, warps, True) <= MAX_SMEM
    smem = _smem_bytes(N, ns_total, warps, stage_xyz)
    if smem > MAX_SMEM:
        raise ValueError(f"ball_query_multiscale: {smem} bytes of shared memory, over {MAX_SMEM}")
    qb = 128
    while qb > warps and B * -(-M // qb) < 2 * sms * _BLOCKS_PER_SM:
        qb //= 2
    return MultiscalePlan(warps, min(qb, M), stage_xyz, smem)


def _check(scales, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, *, 3) float32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xyz.shape[0] != new_xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz disagree on B or device")
    if not 1 <= len(scales) <= _MAX_SCALES:
        raise ValueError(f"1 to {_MAX_SCALES} scales, got {len(scales)}")
    for _r, ns in scales:
        if not 1 <= ns <= _MAX_NS:
            raise ValueError(f"nsample must be in [1, {_MAX_NS}], got {ns}")


def ball_query_multiscale_plain(scales, xyz: torch.Tensor, new_xyz: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The plain version: the index ball query once per scale."""
    return tuple(ball_query(r, ns, xyz, new_xyz) for r, ns in scales)


def _launch(scales, xyz: torch.Tensor, new_xyz: torch.Tensor) -> tuple[torch.Tensor, ...]:
    from or4d_tpu_torch.ops._build import library

    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    dev = xyz.device
    outs = tuple(torch.empty(B, M, ns, dtype=torch.int32, device=dev) for _r, ns in scales)
    if B == 0 or M == 0:
        return outs
    if N == 0:
        raise ValueError("ball_query_multiscale needs at least one support point")
    plan = multiscale_plan(B, N, M, scales, torch.cuda.get_device_properties(dev).multi_processor_count)
    fn = library("ball_query_multiscale").or4d_ball_query_multiscale
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, I, I, I, I, P, P, P, I, I, I, L, P]
    fn.restype = I
    S = len(scales)
    r2 = (ctypes.c_float * S)(*[float(np.float32(r * r)) for r, _ns in scales])
    ns = (ctypes.c_int * S)(*[int(n) for _r, n in scales])
    ptrs = (ctypes.c_void_p * S)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        err = fn(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, S, ctypes.cast(r2, P), ctypes.cast(ns, P),
                 ctypes.cast(ptrs, P), plan.warps, plan.block_queries, int(plan.stage_xyz), plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query_multiscale kernel launch failed: CUDA error {err}")
    LAUNCHES["multiscale"] += 1
    return outs


def ball_query_multiscale(scales, xyz: torch.Tensor, new_xyz: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``scales`` ((radius, nsample), ...), ``xyz`` (B, N, 3) and
    ``new_xyz`` (B, M, 3) float32 -> one (B, M, nsample) int32 index tensor
    per scale."""
    scales = tuple((float(r), int(ns)) for r, ns in scales)
    _check(scales, xyz, new_xyz)
    if xyz.device.type == "cpu":
        return ball_query_multiscale_plain(scales, xyz, new_xyz)
    if xyz.device.type != "cuda":
        raise ValueError(f"ball_query_multiscale: unsupported device {xyz.device}")
    return _launch(scales, xyz, new_xyz)
