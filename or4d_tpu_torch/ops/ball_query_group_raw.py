"""Train-path grouping in raw mode: the CUDA kernels of
``csrc/ball_query_group.cu`` (raw mode) and their plain PyTorch versions.

Replaces ``ball_query_group_pallas_gated_raw``
(or4d_tpu/ops/pallas_ball_query.py:1743) and its custom VJP (:1901-1924),
one (radius, nsample) scale per call. What bounds the kernels on the H100
and what their design does about it is in the header of
``csrc/ball_query_group.cu``.

Forward: the same selection as :mod:`ball_query_group` (scan order,
first-hit fill, zero rows for a query with no hit; ``need`` (B, M), the
chunk bound from the FPS kernel's counts, stops the search early and never
changes results), but each grouped row is built from the channel-major raw
[xyz|features] plane (B, C0, N) as A = round_T(f32 sum of raw * W0), so no
(B, N, C) plane exists. Backward: dW0 = sum over the slots of
raw[:, hit] (x) g[slot] in f32 (filled slots count at the first hit, a
query with no hit counts nothing), rounded to W0's dtype. raw, xyz and
new_xyz get no gradient: exact only because raw holds model inputs, which
the wrapper checks.

On the card the forward is :mod:`ball_query_group`'s kernel in raw mode
(planned by ``group_plan``) and the backward two kernels planned by
:func:`raw_bwd_plan`: partial sums over tiles of 32 queries, then a reduce
in a fixed order, so every call gives the same bits. The wrappers take the
plain versions for CPU tensors only; a CUDA tensor always launches a
kernel, and a shape a plan refuses or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from or4d_tpu_torch.ops.ball_query_group import (
    _MAX_RAW_C as _MAX_C,
    _MAX_RAW_C0 as _MAX_C0,
    _RAW_BWD_TILE as _BWD_TILE,
    _RAW_BWD_WARPS as _BWD_WARPS,
    DTYPES,
    MAX_NS,
    MAX_SMEM,
    _align16,
    _check,
    _check_geometry,
    _device_type,
    fwd_launch,
    gather_rows,
    group_indices_plain,
)

# kernel launches: "fwd" (search + grouped rows from raw) and "bwd" (dW0)
LAUNCHES = {"fwd": 0, "bwd": 0}

_MAX_PARTIALS = 2048  # partial tiles of dW0 at most: a few MB of f32 scratch


@dataclass(frozen=True)
class RawBwdPlan:
    """How the raw backward of ``csrc/ball_query_group.cu`` runs one call.

    The queries of each cloud are cut into tiles of 32 (``tiles`` in all,
    cloud-major); block ``k`` of ``blocks`` sums the slots of tiles
    [k * tiles_per_block, (k + 1) * tiles_per_block) into partial k,
    (C0, C) f32, with ``smem_bytes`` of shared memory; a second kernel sums
    the partials in a fixed order. Fixed by the shapes alone, so every call
    sums in the same order."""

    tiles: int
    tiles_per_block: int
    blocks: int
    smem_bytes: int


def raw_bwd_plan(B: int, M: int, ns: int, C0: int, C: int) -> RawBwdPlan:
    """The raw backward's plan (see ``RawBwdPlan``): as many blocks as
    tiles, up to 2048 partials; ``ValueError`` outside the kernel's limits
    or over 227 KB of shared memory."""
    if min(B, M) < 1 or not 1 <= ns <= MAX_NS or not 1 <= C0 <= _MAX_C0 or not 1 <= C <= _MAX_C:
        raise ValueError(f"ball_query_group_raw backward kernel limits: nsample in [1, {MAX_NS}], "
                         f"C0 <= {_MAX_C0}, C <= {_MAX_C}; got B={B}, M={M}, nsample={ns}, C0={C0}, C={C}")
    tiles = B * -(-M // _BWD_TILE)
    per_block = -(-tiles // _MAX_PARTIALS)
    # per warp a (C0, C) f32 tile, then per warp 32 slots' raw columns of 8 floats
    smem = _align16(_BWD_WARPS * C0 * C * 4) + _BWD_WARPS * 32 * 8 * 4
    if smem > MAX_SMEM:
        raise ValueError(f"ball_query_group_raw backward: {smem} bytes of shared memory, over {MAX_SMEM}")
    return RawBwdPlan(tiles, per_block, -(-tiles // per_block), smem)


def group_raw_fwd_plain(xyz, new_xyz, radius: float, nsample: int, W0, raw, need=None):
    """The plain forward: (out (B, M, nsample, C) in W0's dtype, idx).
    ``need`` is accepted and unused: it never changes results."""
    idx = group_indices_plain(xyz, new_xyz, radius, nsample)
    A = (raw.float().transpose(1, 2) @ W0.float()).to(W0.dtype)  # (B, N, C)
    return gather_rows(A, idx), idx


def group_raw_bwd_plain(idx, g, raw) -> torch.Tensor:
    """The plain backward: dW0 (C0, C) in raw's dtype."""
    rows = torch.arange(raw.shape[0], device=raw.device)[:, None, None]
    idx = idx.long()
    picked = raw.float().transpose(1, 2)[rows, idx.clamp(min=0)]  # (B, M, ns, C0)
    picked = picked * (idx >= 0)[..., None]
    return torch.einsum("bmsi,bmsc->ic", picked, g.float()).to(raw.dtype)


def _check_raw(xyz, W0, raw):
    B, N, _ = xyz.shape
    if W0.dtype not in DTYPES or W0.dim() != 2:
        raise ValueError(f"W0 must be (C0, C) float32 or bfloat16, got {tuple(W0.shape)} {W0.dtype}")
    C0, C = W0.shape
    _check(W0, "W0", (C0, C), W0.dtype, xyz.device)
    _check(raw, "raw", (B, C0, N), W0.dtype, xyz.device)
    if raw.requires_grad:
        raise ValueError("ball_query_group_raw gives raw no gradient; raw must hold model inputs "
                         "(requires_grad=False)")
    return C0, C


def group_raw_fwd(xyz, new_xyz, radius: float, nsample: int, W0, raw, need=None):
    """(out, idx): the kernel for CUDA tensors, the plain version on the CPU."""
    _check_geometry(xyz, new_xyz, nsample)
    C0, C = _check_raw(xyz, W0, raw)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if need is not None:
        _check(need, "need", (B, M), torch.int32, xyz.device)
    if _device_type(xyz, "ball_query_group_raw") == "cpu":
        return group_raw_fwd_plain(xyz, new_xyz, radius, nsample, W0, raw, need)
    if B == 0 or M == 0:
        return (torch.empty(B, M, nsample, C, dtype=W0.dtype, device=W0.device),
                torch.empty(B, M, nsample, dtype=torch.int32, device=W0.device))
    out, idx = fwd_launch(xyz, new_xyz, radius, nsample, need, None, raw, W0, C0, C, W0.dtype)
    LAUNCHES["fwd"] += 1
    return out, idx


def group_raw_bwd(idx, g, raw) -> torch.Tensor:
    """dW0 (C0, C) in raw's dtype: the kernel for CUDA tensors, the plain
    version on the CPU."""
    if g.dtype not in DTYPES or g.dim() != 4 or raw.dim() != 3:
        raise ValueError(f"g must be (B, M, ns, C) float32 or bfloat16, got {tuple(g.shape)} {g.dtype}")
    B, M, ns, C = g.shape
    C0, N = raw.shape[1], raw.shape[2]
    _check(g, "g", (B, M, ns, C), raw.dtype, raw.device)
    _check(raw, "raw", (B, C0, N), raw.dtype, raw.device)
    _check(idx, "idx", (B, M, ns), torch.int32, raw.device)
    if _device_type(raw, "ball_query_group_raw backward") == "cpu":
        return group_raw_bwd_plain(idx, g, raw)
    dW0 = torch.empty(C0, C, dtype=raw.dtype, device=raw.device)
    if B == 0 or M == 0:
        return dW0.zero_()
    plan = raw_bwd_plan(B, M, ns, C0, C)  # raises before any launch
    from or4d_tpu_torch.ops._build import library

    fn = library("ball_query_group").or4d_group_raw_bwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, P, I, I, I, I, I, I, I, I, L, P, P, P]
    fn.restype = I
    partial = torch.empty(plan.blocks, C0, C, dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        err = fn(DTYPES[raw.dtype], idx.data_ptr(), g.data_ptr(), raw.data_ptr(), B, N, M, ns, C0, C,
                 plan.tiles_per_block, plan.blocks, plan.smem_bytes, partial.data_ptr(), dW0.data_ptr(),
                 torch.cuda.current_stream(raw.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query_group_raw backward kernel launch failed: CUDA error {err}")
    LAUNCHES["bwd"] += 1
    return dW0


class _GroupRawFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, W0, xyz, new_xyz, raw, need, radius, nsample):
        out, idx = group_raw_fwd(xyz, new_xyz, radius, nsample, W0, raw, need)
        ctx.save_for_backward(idx, raw)
        return out

    @staticmethod
    def backward(ctx, g):
        idx, raw = ctx.saved_tensors
        return group_raw_bwd(idx, g.contiguous(), raw), None, None, None, None, None, None


def ball_query_group_raw(xyz, new_xyz, radius: float, nsample: int, W0, raw, need=None) -> torch.Tensor:
    """Grouped layer-1 rows (B, M, nsample, C) in W0's dtype built from raw
    (B, C0, N) and W0 (C0, C); differentiable in ``W0`` only. ``need``
    (B, M) int32 chunk bounds or None; raw must not require grad."""
    return _GroupRawFunction.apply(W0, xyz, new_xyz, raw, need, float(radius), int(nsample))
