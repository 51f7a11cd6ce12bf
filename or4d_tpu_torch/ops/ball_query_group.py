"""Train-path grouping on a layer-1 plane: the CUDA kernels of
``csrc/ball_query_group.cu`` (plane mode) and their plain PyTorch versions.

Replaces, one (radius, nsample) scale per call:
  * ``ball_query_group_pallas`` (or4d_tpu/ops/pallas_ball_query.py:295) and
    its custom VJP (:408-422): :func:`ball_query_group`, SA2's grouping;
  * ``ball_query_group_pallas_gated`` (pallas_ball_query.py:1563; forward
    :1591, backward :1656, VJP :1717-1739): :func:`ball_query_group_gated`,
    SA1's grouping when ``TPUConfig.train_raw`` is false. It takes the FPS
    counts' chunk bound ``need`` (B, M), which stops each query's search at
    need*512 points and never changes results, and counts its launches
    apart (``LAUNCHES_GATED``). The TPU function's slot-major and slot-pair
    packed outputs and its query sort are TPU layout: its outputs here are
    query-major like the other grouping functions'.
What bounds the kernels on the H100 and what their design does about it is
in the header of ``csrc/ball_query_group.cu``.

Forward: for each query, the first ``nsample`` support points within
``radius`` in scan order (first-hit fill), their rows of A (B, N, C) copied
as they are into (B, M, nsample, C); a query with no hit gets zero rows.
Backward: the cotangent of every slot is added, in f32 and in flattened
slot order, to the A row it came from (filled slots to the first hit;
nothing from a query with no hit), then rounded to the cotangent's dtype.
Geometry gets no gradient.

The forward saves the hit indices (B, M, nsample) int32, filled, with -1 in
every slot of a query with no hit; the backward is a scatter by them.

On the card the forward of both modes (and of raw mode,
:mod:`ball_query_group_raw`) runs one kernel, planned by :func:`group_plan`:
queries per block and the cloud's xyz staged in shared memory where it fits
in 227 KB; the kernel recomputes the plan's bytes and refuses a plan that
disagrees. The plane backward runs two kernels planned by :func:`bwd_plan`:
a CSR of the saved indices (int32 scratch, freed on return), then each
point's list summed in order, a warp taking the lists that start in one run
of the CSR. The wrappers take the plain versions for CPU tensors only; a CUDA
tensor always launches a kernel, and a shape a plan refuses or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from or4d_tpu_torch.ops._card import BLOCK_RESERVED, H100_SMS, MAX_SMEM, SM_SMEM, align16
from or4d_tpu_torch.ops.ball_query import ball_query_with_counts
from or4d_tpu_torch.ops.fps import CHUNK

# kernel launches: "fwd" (search + grouped rows) and "bwd" (dA), for
# ball_query_group (TPU row 6) and for ball_query_group_gated (row 9)
LAUNCHES = {"fwd": 0, "bwd": 0}
LAUNCHES_GATED = {"fwd": 0, "bwd": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_NS = 127
_MAX_C = 256
_MAX_RAW_C0, _MAX_RAW_C = 8, 128
# the kernels' constants the plans assume (kFwdWarps, kFwdMinBlocks,
# kRawBwdWarps, kRawBwdTile, kBwdSumWarps, kBwdRun and kBwdBuildThreads in
# the source: a test holds them equal)
_FWD_WARPS = 16
_FWD_BLOCKS_PER_SM = 2  # the forward's __launch_bounds__ minimum: 64 registers a thread
_RAW_BWD_WARPS, _RAW_BWD_TILE = 8, 32
# the plane backward: its sum's warps a block (kBwdSumWarps), each a run of
# kBwdRun entries of the CSR; the CSR build's blocks of 256 threads (8 an
# SM at most) and their static shared memory, a scan word per warp
_BWD_SUM_WARPS, _BWD_RUN = 8, 32
_BWD_BUILD_BLOCKS_PER_SM, _BWD_BUILD_STATIC = 8, 32


@dataclass(frozen=True)
class GroupPlan:
    """How the forward kernel of ``csrc/ball_query_group.cu`` runs one call
    (both modes): blocks of 16 warps over ``block_queries`` queries of one
    cloud; ``stage_xyz``: the cloud's xyz (up to the block's largest
    search bound) is copied to shared memory, else the search reads global
    memory; ``smem_bytes``: the block's dynamic shared memory, which the
    kernel recomputes and checks."""

    block_queries: int
    stage_xyz: bool
    smem_bytes: int


def _fwd_smem_bytes(N: int, ns: int, C0: int, C: int, stage_xyz: bool) -> int:
    """The forward's shared memory (``fwd_smem`` in the source): per warp
    its hit list (in raw mode, C0 > 0, then 16 slots' raw columns of 8
    floats), a 16-byte control word, in raw mode W0 as f32 with rows of an
    even width, then the staged xyz."""
    warp = align16(4 * ns) + (16 * 8 * 4 if C0 else 0)
    return _FWD_WARPS * warp + 16 + align16(4 * C0 * (C + C % 2)) + (align16(12 * N) if stage_xyz else 0)


def group_plan(B: int, N: int, M: int, ns: int, C: int, C0: int = 0, sms: int = H100_SMS) -> GroupPlan:
    """The forward kernel's plan for one call: raw mode with ``C0`` > 0
    (C <= 128, C0 <= 8), plane mode with ``C0`` 0 (C <= 256); ``ValueError``
    outside the kernel's limits or over 227 KB of shared memory. The cloud's
    xyz is staged where it fits. Queries per block: 64 (larger blocks end
    in longer tails of slow searches and fill fewer waves; 32 stages the
    cloud twice as often), halved to 32 where the call would have fewer
    than two waves of resident blocks on the card's ``sms`` SMs."""
    raw = C0 > 0
    max_c = _MAX_RAW_C if raw else _MAX_C
    if min(B, N, M) < 1 or not 1 <= ns <= MAX_NS or not 1 <= C <= max_c or C0 > _MAX_RAW_C0 or C0 < 0:
        raise ValueError(f"ball_query_group kernel limits: nsample in [1, {MAX_NS}], C <= {max_c}, "
                         f"C0 <= {_MAX_RAW_C0}; got B={B}, N={N}, M={M}, nsample={ns}, C={C}, C0={C0}")
    stage_xyz = _fwd_smem_bytes(N, ns, C0, C, True) <= MAX_SMEM
    smem = _fwd_smem_bytes(N, ns, C0, C, stage_xyz)
    if smem > MAX_SMEM:
        raise ValueError(f"ball_query_group: {smem} bytes of shared memory, over {MAX_SMEM}")
    per_sm = min(_FWD_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED))
    qb = 64
    if B * -(-M // qb) < 2 * sms * per_sm:
        qb //= 2
    return GroupPlan(min(qb, M), stage_xyz, smem)


def fwd_launch(xyz, new_xyz, radius: float, nsample: int, need, A, raw, W0, C0: int, C: int, dtype):
    """Plans and launches the forward kernel (plane mode with ``A``, raw
    mode with ``raw`` and ``W0``) on CUDA tensors -> (out, idx); raises on a
    shape the plan refuses (before any launch) or a failed launch."""
    from or4d_tpu_torch.ops._build import library

    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    dev = xyz.device
    plan = group_plan(B, N, M, nsample, C, C0, torch.cuda.get_device_properties(dev).multi_processor_count)
    fn = library("ball_query_group").or4d_group_fwd
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [I, P, P, I, I, I, F, I, P, P, P, P, I, I, P, P, I, I, L, P]
    fn.restype = I
    out = torch.empty(B, M, nsample, C, dtype=dtype, device=dev)
    idx = torch.empty(B, M, nsample, dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(DTYPES[dtype], xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, r2_of(radius), nsample, ptr(need),
                 ptr(A), ptr(raw), ptr(W0), C0, C, out.data_ptr(), idx.data_ptr(), plan.block_queries,
                 int(plan.stage_xyz), plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query_group forward kernel launch failed: CUDA error {err}")
    return out, idx


@dataclass(frozen=True)
class BwdPlan:
    """How the plane backward of ``csrc/ball_query_group.cu`` runs one call.
    The CSR build takes one block per cloud, with ``segs`` placing warps
    (each a run of the cloud's slots) and ``build_smem_bytes`` of shared
    memory (a count per placing warp and point). The sum cuts each cloud's
    CSR into ``runs`` runs of 32 entries, a warp summing the lists that
    start in one, in ``sum_blocks`` blocks of 8 warps.
    The kernel recomputes the runs, blocks and bytes and refuses a plan that
    disagrees."""

    segs: int
    runs: int
    sum_blocks: int
    build_smem_bytes: int


def bwd_plan(B: int, N: int, M: int, ns: int, C: int, sms: int = H100_SMS) -> BwdPlan:
    """The plane backward's plan for one call; ``ValueError`` outside the
    kernel's limits (C <= 256, nsample <= 127) or where a cloud's counts
    and the build's 32 static bytes pass 227 KB (N over 58104).

    Placing warps: of 1, 2, 4 and 8, the fewest that minimise the build's
    waves of resident blocks times the chunks of 32 slots each placing warp
    walks in order (a call of many clouds runs them side by side; a call of
    few, such as 96 object crops, splits each cloud's slots). Runs of the
    CSR: 32 entries, a warp each (short runs fill the card even on the
    96-cloud calls)."""
    if min(B, N, M) < 1 or not 1 <= ns <= MAX_NS or not 1 <= C <= _MAX_C:
        raise ValueError(f"ball_query_group backward kernel limits: nsample in [1, {MAX_NS}], C <= {_MAX_C}; "
                         f"got B={B}, N={N}, M={M}, nsample={ns}, C={C}")
    Mns = M * ns
    if align16(4 * N) + _BWD_BUILD_STATIC > MAX_SMEM:
        raise ValueError(f"ball_query_group backward: {align16(4 * N)} bytes of shared memory (4 * N) and "
                         f"{_BWD_BUILD_STATIC} static, over {MAX_SMEM}")
    best = None
    for segs in (1, 2, 4, 8):
        smem = align16(4 * N * segs)
        if smem + _BWD_BUILD_STATIC > MAX_SMEM:
            break
        resident = min(_BWD_BUILD_BLOCKS_PER_SM, SM_SMEM // (smem + _BWD_BUILD_STATIC + BLOCK_RESERVED))
        chunks = -(-(-(-Mns // segs)) // 32)  # a placing warp's chunks of 32 slots
        cost = -(-B // (sms * resident)) * chunks
        if best is None or cost < best[0]:
            best = (cost, segs, smem)
    _cost, segs, smem = best
    runs = -(-Mns // _BWD_RUN)
    return BwdPlan(segs, runs, -(-(B * runs) // _BWD_SUM_WARPS), smem)


def r2_of(radius: float) -> float:
    """r*r in Python double, rounded to f32: the reference's value."""
    return float(np.float32(radius * radius))


def group_indices_plain(xyz, new_xyz, radius: float, nsample: int, need=None) -> torch.Tensor:
    """(B, M, nsample) int32 hit indices in scan order, filled with the
    first hit; -1 in every slot of a query with no hit. ``need`` (B, M):
    each query scans only its first need*512 points."""
    limit = None if need is None else need.long() * CHUNK
    idx, total = ball_query_with_counts(radius, nsample, xyz, new_xyz, limit)
    return torch.where((total > 0)[..., None], idx, -1).int()


def gather_rows(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A (B, N, C) rows at idx (B, M, ns) -> (B, M, ns, C); zero rows at -1."""
    rows = torch.arange(A.shape[0], device=A.device)[:, None, None]
    idx = idx.long()
    out = A[rows, idx.clamp(min=0)]
    return torch.where((idx >= 0)[..., None], out, torch.zeros((), dtype=A.dtype, device=A.device))


def scatter_rows(idx: torch.Tensor, g: torch.Tensor, N: int) -> torch.Tensor:
    """The transpose of :func:`gather_rows`: g (B, M, ns, C) summed in f32,
    in flattened slot order, into (B, N, C) f32."""
    B, M, ns, C = g.shape
    idx = idx.long().reshape(B, M * ns)
    valid = idx >= 0
    flat = (torch.arange(B, device=g.device)[:, None] * N + idx.clamp(min=0))[valid]
    dA = torch.zeros(B * N, C, dtype=torch.float32, device=g.device)
    dA.index_add_(0, flat, g.reshape(B, M * ns, C)[valid].float())
    return dA.view(B, N, C)


def _check_geometry(xyz, new_xyz, nsample):
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be a (B, *, 3) float32 tensor, got {getattr(t, 'shape', t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if new_xyz.shape[0] != xyz.shape[0] or new_xyz.device != xyz.device:
        raise ValueError("xyz and new_xyz disagree on B or device")
    if not 1 <= nsample <= MAX_NS:
        raise ValueError(f"nsample must be in [1, {MAX_NS}], got {nsample}")


def _check(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_type(xyz: torch.Tensor, name: str) -> str:
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {xyz.device}")
    return xyz.device.type


def group_fwd_plain(xyz, new_xyz, radius: float, nsample: int, A, need=None):
    """The plain forward: (out (B, M, nsample, C) in A's dtype, idx)."""
    idx = group_indices_plain(xyz, new_xyz, radius, nsample, need)
    return gather_rows(A, idx), idx


def group_bwd_plain(idx, g, N: int) -> torch.Tensor:
    """The plain backward: dA (B, N, C) in g's dtype."""
    return scatter_rows(idx, g, N).to(g.dtype)


def group_fwd(xyz, new_xyz, radius: float, nsample: int, A, need=None, launches=LAUNCHES):
    """(out, idx): the kernel for CUDA tensors, the plain version on the CPU.
    ``need`` (B, M) int32 chunk bounds or None; a launch counts in
    ``launches``."""
    _check_geometry(xyz, new_xyz, nsample)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if A.dtype not in DTYPES or A.dim() != 3:
        raise ValueError(f"A must be (B, N, C) float32 or bfloat16, got {tuple(A.shape)} {A.dtype}")
    C = A.shape[-1]
    _check(A, "A", (B, N, C), A.dtype, xyz.device)
    if need is not None:
        _check(need, "need", (B, M), torch.int32, xyz.device)
    if _device_type(xyz, "ball_query_group") == "cpu":
        return group_fwd_plain(xyz, new_xyz, radius, nsample, A, need)
    if B == 0 or M == 0:
        return (torch.empty(B, M, nsample, C, dtype=A.dtype, device=A.device),
                torch.empty(B, M, nsample, dtype=torch.int32, device=A.device))
    out, idx = fwd_launch(xyz, new_xyz, radius, nsample, need, A, None, None, 0, C, A.dtype)
    launches["fwd"] += 1
    return out, idx


def group_bwd(idx, g, N: int, launches=LAUNCHES) -> torch.Tensor:
    """dA (B, N, C) in g's dtype: the kernel for CUDA tensors, the plain
    version on the CPU; a launch counts in ``launches``."""
    if g.dtype not in DTYPES or g.dim() != 4:
        raise ValueError(f"g must be (B, M, ns, C) float32 or bfloat16, got {tuple(g.shape)} {g.dtype}")
    B, M, ns, C = g.shape
    _check(g, "g", (B, M, ns, C), g.dtype, g.device)
    _check(idx, "idx", (B, M, ns), torch.int32, g.device)
    if _device_type(g, "ball_query_group backward") == "cpu":
        return group_bwd_plain(idx, g, N)
    dA = torch.empty(B, N, C, dtype=g.dtype, device=g.device)
    if B == 0 or N == 0:
        return dA
    if M == 0:
        return dA.zero_()
    plan = bwd_plan(B, N, M, ns, C, torch.cuda.get_device_properties(g.device).multi_processor_count)
    from or4d_tpu_torch.ops._build import library

    fn = library("ball_query_group").or4d_group_bwd
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [I, P, P, I, I, I, I, I, I, I, L, L, P, P, P, P, P]
    fn.restype = I
    # scratch, freed on return: the CSR of the saved indices (list starts,
    # slot numbers) and each run's first point
    dev = g.device
    off = torch.empty(B, N + 1, dtype=torch.int32, device=dev)
    ent = torch.empty(B, M * ns, dtype=torch.int32, device=dev)
    rfirst = torch.empty(B, plan.runs, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(DTYPES[g.dtype], idx.data_ptr(), g.data_ptr(), B, N, M, ns, C, plan.segs, plan.runs,
                 plan.sum_blocks, plan.build_smem_bytes, off.data_ptr(), ent.data_ptr(), rfirst.data_ptr(),
                 dA.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ball_query_group backward kernel launch failed: CUDA error {err}")
    launches["bwd"] += 1
    return dA


class _GroupFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, xyz, new_xyz, radius, nsample, need, launches):
        out, idx = group_fwd(xyz, new_xyz, radius, nsample, A, need, launches)
        ctx.save_for_backward(idx)
        ctx.N, ctx.launches = A.shape[1], launches
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return group_bwd(idx, g.contiguous(), ctx.N, ctx.launches), None, None, None, None, None, None


def ball_query_group(xyz, new_xyz, radius: float, nsample: int, A) -> torch.Tensor:
    """Grouped layer-1 rows (B, M, nsample, C) in A's dtype, differentiable
    in ``A`` (B, N, C). ``xyz`` (B, N, 3) and ``new_xyz`` (B, M, 3) are
    float32 geometry."""
    return _GroupFunction.apply(A, xyz, new_xyz, float(radius), int(nsample), None, LAUNCHES)


def ball_query_group_gated(xyz, new_xyz, radius: float, nsample: int, A, need) -> torch.Tensor:
    """:func:`ball_query_group` with the chunk bound ``need`` (B, M) int32
    from the FPS kernel (``furthest_point_sample_with_bounds``): the same rows and
    the same dA, the search of each query cut at need*512 points. SA1's
    train grouping when ``train_raw`` is false (TPU row 9)."""
    return _GroupFunction.apply(A, xyz, new_xyz, float(radius), int(nsample), need, LAUNCHES_GATED)
