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
Backward: the cotangent of every slot is added, in f32, to the A row it came
from (filled slots to the first hit; nothing from a query with no hit),
then rounded to the cotangent's dtype. Geometry gets no gradient.

The forward saves the hit indices (B, M, nsample) int32, filled, with -1 in
every slot of a query with no hit; the backward is a scatter by them.

On the card the forward of both modes (and of raw mode,
:mod:`ball_query_group_raw`) runs one kernel, planned by :func:`group_plan`:
queries per block and the cloud's xyz staged in shared memory where it fits
in 227 KB; the kernel recomputes the plan's bytes and refuses a plan that
disagrees. The wrappers take the plain versions for CPU tensors only; a CUDA
tensor always launches a kernel, and a shape the plan refuses or a failed
launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

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
MAX_SMEM = 232448  # 227 KB: the dynamic shared memory one block can have on an H100
# the backward keeps one cloud's inverse in shared memory: at most the
# H100's 227 KB per block, less the kernel's 64 static bytes
_MAX_BWD_SMEM = 227 * 1024 - 64
# the kernels' constants the plans assume (kFwdWarps, kFwdMinBlocks,
# kRawBwdWarps and kRawBwdTile in the source: a test holds them equal)
_FWD_WARPS = 16
_FWD_BLOCKS_PER_SM = 2  # the forward's __launch_bounds__ minimum: 64 registers a thread
_RAW_BWD_WARPS, _RAW_BWD_TILE = 8, 32
H100_SMS = 132  # the planning default off the card; a launch plans with its device's count
_SM_SMEM, _BLOCK_RESERVED = 233472, 1024  # shared memory per SM (228 KB), and reserved per block


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


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _fwd_smem_bytes(N: int, ns: int, C0: int, C: int, stage_xyz: bool) -> int:
    """The forward's shared memory (``fwd_smem`` in the source): per warp
    its hit list (in raw mode, C0 > 0, then 16 slots' raw columns of 8
    floats), a 16-byte control word, in raw mode W0 as f32 with rows of an
    even width, then the staged xyz."""
    warp = _align16(4 * ns) + (16 * 8 * 4 if C0 else 0)
    return _FWD_WARPS * warp + 16 + _align16(4 * C0 * (C + C % 2)) + (_align16(12 * N) if stage_xyz else 0)


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
    per_sm = min(_FWD_BLOCKS_PER_SM, _SM_SMEM // (smem + _BLOCK_RESERVED))
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


def bwd_smem_bytes(N: int, M: int, nsample: int) -> int:
    """Shared memory of the backward kernel's per-cloud inverse: per point a
    count and a list start (+1), per query its real slots, one entry per
    slot (4 bytes each)."""
    return 4 * (2 * N + 1 + M + M * nsample)


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
    if C > _MAX_C or ns > MAX_NS or bwd_smem_bytes(N, M, ns) > _MAX_BWD_SMEM:
        raise ValueError(f"ball_query_group backward kernel takes C <= {_MAX_C}, ns <= {MAX_NS} and "
                         f"4 * (2N + 1 + M + M*ns) <= {_MAX_BWD_SMEM} bytes; got C={C}, N={N}, M={M}, ns={ns}")
    from or4d_tpu_torch.ops._build import library

    fn = library("ball_query_group").or4d_group_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, I, I, I, I, I, P, P]
    fn.restype = I
    dA = torch.empty(B, N, C, dtype=g.dtype, device=g.device)
    if B > 0 and M > 0 and N > 0:
        with torch.cuda.device(g.device):
            err = fn(DTYPES[g.dtype], idx.data_ptr(), g.data_ptr(), B, N, M, ns, C, dA.data_ptr(),
                     torch.cuda.current_stream(g.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball_query_group backward kernel launch failed: CUDA error {err}")
        launches["bwd"] += 1
    elif N > 0:
        dA.zero_()
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
