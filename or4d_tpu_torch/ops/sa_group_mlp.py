"""Fused eval set-abstraction stage: the CUDA kernel ``csrc/sa_group_mlp.cu``
and its plain PyTorch version.

Replaces ``ball_query_group_mlp_pallas_v4`` in raw mode
(or4d_tpu/ops/pallas_ball_query.py:1928) and ``ball_query_group_mlp_pallas``
(pallas_ball_query.py:1064), one (radius, nsample) scale per call. What
bounds the kernel on the H100 and what its design does about it is in the
header of ``csrc/sa_group_mlp.cu``.

For each query: the first ``nsample`` support points within ``radius`` in
scan order (first-hit fill), their layer-1 rows A (raw mode: the A-dtype
rounding of raw·W0, accumulated in f32; plane mode: rows of a precomputed
plane), then ``max_k relu(a1 * (round_W1(relu((A_k - Bq) * a0 + b0)) @ W1) + b1)``
stored in the A dtype. A query with no hit uses a zero A row, as the TPU
kernels' one-hot selection does. Paired raw mode (the relation encoder's
pair sharing) computes the forward half from raw channels [0, C0) and the
reverse half with raw channel C0 in place of channel C0-1, sharing the hit
search and W1: out (B, M, 2*C2) = [fwd | rev].

The TPU kernels' query sort, sub-tile gates, chunk-major layouts and
padding only change speed on a TPU and are not carried over; ``need`` (the
exact chunk bound from the FPS counts) stops the kernel's search early and
never changes results.

On the card the dtype picks the body (:func:`tile_plan`): bfloat16 runs the
tensor-core body, float32 the FP32-pipe body; both count in ``LAUNCHES``.
The wrapper takes the plain version for CPU tensors only; a CUDA tensor
always launches a kernel, and a shape the plan refuses or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from or4d_tpu_torch.ops._card import MAX_SMEM, align16
from or4d_tpu_torch.ops.ball_query import ball_query_with_counts

# kernel launches, per mode: "raw" (A rows from raw·W0) and "plane"; and
# per body: "mma" (bfloat16, tensor cores) and "fp32" (float32)
LAUNCHES = {"raw": 0, "plane": 0}
BODY_LAUNCHES = {"mma": 0, "fp32": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C0, _MAX_C1, _MAX_C2, _MAX_NS = 16, 128, 256, 128
_PLAIN_ELEMS = 1 << 26  # bound on the plain version's per-chunk temporaries
_MMA_WARPS, _MMA_ROWS, _MMA_BLOCK_QUERIES = 16, 16, 256
_FP32_WARPS, _FP32_BLOCK_QUERIES = 8, 32


@dataclass(frozen=True)
class TilePlan:
    """How ``csrc/sa_group_mlp.cu`` runs one call.

    ``body`` "mma" (bfloat16: ``mma.sync.m16n8k16`` tiles of ``rows_per_tile``
    slots of one query, ``tiles_per_query`` tile passes at most, the paired
    halves counted apart) or "fp32" (float32: one slot at a time on the FP32
    pipes). ``block_queries`` queries per block (0: every query of the
    block's cloud, so the staged A plane is read once). ``stage_xyz`` /
    ``stage_plane``: the cloud's xyz / A plane is copied to shared memory
    (else the search / the gathers read global memory). ``smem_bytes``: the
    block's dynamic shared memory, which the kernel recomputes and checks."""

    body: str
    rows_per_tile: int
    queries_per_tile: int
    tiles_per_query: int
    block_queries: int
    stage_xyz: bool
    stage_plane: bool
    smem_bytes: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mma_smem_bytes(N, ns, craw, C1, C2, halves, raw, stage_xyz, stage_plane) -> int:
    """The bf16 body's shared memory (``mma_layout`` in the source): W1^T and
    the W0 pair with K-contiguous rows padded by 8, the affines, per warp its
    hit list, Bq row and running max, a 16-byte control word, then the
    staged xyz and A plane."""
    C1p, C2p = _round_up(C1, 16), _round_up(C2, 8)
    KT = -(-craw // 16) if raw else 0
    per_warp = align16(ns * 4) + align16(C1p * 4) + align16(halves * C2p * 4)
    return (align16(C2p * (C1p + 8) * 2) + (align16(halves * C1p * (KT * 16 + 8) * 2) if raw else 0)
            + align16((2 * C1p + 2 * C2p) * 4) + _MMA_WARPS * per_warp + 16
            + (align16(N * 12) if stage_xyz else 0) + (align16(N * C1 * 2) if stage_plane else 0))


def tile_plan(N: int, ns: int, C0: int, C1: int, C2: int, paired: bool, raw: bool, dtype) -> TilePlan:
    """The kernel's tiling and shared memory for one call (see ``TilePlan``);
    ``ValueError`` for a shape outside the kernel's limits or over 227 KB.
    The cloud's xyz is staged where it fits beside the weights, and in plane
    mode the A plane where it fits beside both."""
    if dtype not in _DTYPES:
        raise ValueError(f"sa_group_mlp kernel dtypes: float32, bfloat16; got {dtype}")
    C0 = C0 if raw else 0
    if C1 > _MAX_C1 or C2 > _MAX_C2 or ns > _MAX_NS or C0 > _MAX_C0 or min(N, ns, C1, C2) < 1 or (raw and C0 < 1):
        raise ValueError(
            f"sa_group_mlp kernel limits: C1<={_MAX_C1}, C2<={_MAX_C2}, nsample<={_MAX_NS}, C0<={_MAX_C0}; "
            f"got C1={C1}, C2={C2}, nsample={ns}, C0={C0}"
        )
    if paired and not raw:
        raise ValueError("paired mode is a raw-mode option")
    halves = 2 if paired else 1
    if dtype == torch.float32:
        smem = (align16(4 * C1 * C2) + (align16(4 * C0 * C1) if raw else 0) + align16(4 * 2 * C2)
                + _FP32_WARPS * (_MAX_NS + _MAX_C1) * 4)
        plan = TilePlan("fp32", 1, 1, ns * halves, _FP32_BLOCK_QUERIES, False, False, smem)
    else:
        craw = C0 + (1 if paired else 0)
        size = lambda sx, sp: _mma_smem_bytes(N, ns, craw, C1, C2, halves, raw, sx, sp)
        stage_xyz = size(True, False) <= MAX_SMEM
        stage_plane = not raw and stage_xyz and size(True, True) <= MAX_SMEM
        plan = TilePlan("mma", _MMA_ROWS, 1, -(-ns // _MMA_ROWS) * halves,
                        0 if stage_plane else _MMA_BLOCK_QUERIES, stage_xyz, stage_plane,
                        size(stage_xyz, stage_plane))
    if plan.smem_bytes > MAX_SMEM:
        raise ValueError(f"sa_group_mlp: {plan.smem_bytes} bytes of shared memory, over {MAX_SMEM}")
    return plan


def counts_to_bounds(scales: tuple[tuple[float, int], ...], counts: tuple[torch.Tensor, ...]):
    """Per-chunk hit counts (B, M, nch) -> per scale (need, thr): thr =
    min(nsample, total) and need = the number of chunks covering the
    thr-th hit (or4d_tpu/ops/pallas_ball_query.py:587-602). ``need`` is the
    kernel's search bound; it is exact because the counts come from the
    same f32 distances."""
    out = []
    for (_r, ns), c in zip(scales, counts):
        cum = torch.cumsum(c, dim=-1)
        thr = torch.clamp(cum[..., -1], max=float(ns))
        need = (cum < thr[..., None]).float().sum(-1) + 1.0
        out.append((need, thr))
    return tuple(out)


def _check(xyz, new_xyz, Bq, a0, b0, W1, a1, b1, A, raw, W0, paired, need, nsample):
    dev = xyz.device
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
            raise ValueError(f"{name} must be (B, *, 3) float32, got {tuple(t.shape)} {t.dtype}")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    if new_xyz.shape[0] != B:
        raise ValueError("xyz and new_xyz disagree on B")
    if (A is None) == (raw is None):
        raise ValueError("pass exactly one of A (plane mode) or raw (raw mode)")
    if raw is not None and W0 is None:
        raise ValueError("raw mode needs W0")
    if paired and raw is None:
        raise ValueError("paired mode is a raw-mode option")
    T = (A if A is not None else raw).dtype
    if T not in _DTYPES:
        raise TypeError(f"A/raw dtype must be float32 or bfloat16, got {T}")
    C1, C2 = W1.shape[0], W1.shape[1]
    shapes = {"Bq": (Bq, (B, M, C1), T), "W1": (W1, (C1, C2), T),
              "a0": (a0, (C1,), torch.float32), "b0": (b0, (C1,), torch.float32),
              "a1": (a1, (C2,), torch.float32), "b1": (b1, (C2,), torch.float32)}
    if A is not None:
        shapes["A"] = (A, (B, N, C1), T)
    else:
        C0 = W0.shape[0]
        shapes["W0"] = (W0, (C0, C1), T)
        shapes["raw"] = (raw, (B, C0 + (1 if paired else 0), N), T)
    if need is not None:
        shapes["need"] = (need, (B, M), torch.int32)
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz), *((n, v[0]) for n, v in shapes.items())):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xyz on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nsample < 1:
        raise ValueError("nsample must be >= 1")
    return B, N, M, C1, C2, T


def sa_group_mlp_plain(xyz, new_xyz, radius, nsample, Bq, a0, b0, W1, a1, b1,
                       A=None, raw=None, W0=None, paired=False, need=None):
    """The plain PyTorch version (``need`` is accepted and unused: it never
    changes results). Works in chunks of clouds on any device."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    T = (A if A is not None else raw).dtype
    C1, C2 = W1.shape
    W1f = W1.float()
    if raw is not None:
        C0 = W0.shape[0]
        chans = [list(range(C0))] + ([list(range(C0 - 1)) + [C0]] if paired else [])
    else:
        chans = [None]
    per_cloud = max(M * N, M * nsample * max(C1, C2))
    step = max(1, min(B, _PLAIN_ELEMS // max(per_cloud, 1)))
    outs = []
    for s0 in range(0, B, step):
        sl = slice(s0, s0 + step)
        idx, total = ball_query_with_counts(radius, nsample, xyz[sl], new_xyz[sl])
        b = idx.shape[0]
        halves = []
        for ch in chans:
            if ch is None:
                Af = A[sl].float()
            else:
                Af = (raw[sl][:, ch].float().transpose(1, 2) @ W0.float()).to(T).float()  # (b, N, C1)
            g = torch.gather(Af, 1, idx.reshape(b, M * nsample, 1).expand(-1, -1, C1)).view(b, M, nsample, C1)
            g = g * (total > 0).view(b, M, 1, 1).float()  # no hit: zero row
            h = torch.relu((g - Bq[sl].float()[:, :, None, :]) * a0 + b0).to(W1.dtype).float()
            o = torch.relu((h @ W1f) * a1 + b1)
            halves.append(o.amax(dim=2))
        outs.append(torch.cat(halves, dim=-1).to(T))
    return torch.cat(outs)


def _launch(xyz, new_xyz, radius, nsample, Bq, a0, b0, W1, a1, b1, A, raw, W0, paired, need, dims):
    from or4d_tpu_torch.ops._build import library

    B, N, M, C1, C2, T = dims
    C0 = W0.shape[0] if raw is not None else 0
    plan = tile_plan(N, nsample, C0, C1, C2, paired, raw is not None, T)  # raises before any launch
    fn = library("sa_group_mlp").or4d_sa_group_mlp
    P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    fn.argtypes = [I, P, P, I, I, I, F, I, P, P, P, I, I, P, P, P, P, P, P, P, I, I, P, I, I, I, L, P]
    fn.restype = I
    dev = xyz.device
    out = torch.empty(B, M, C2 * (2 if paired else 1), dtype=T, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    if B > 0:
        with torch.cuda.device(dev):
            err = fn(_DTYPES[T], ptr(xyz), ptr(new_xyz), B, N, M, float(np.float32(radius * radius)), nsample,
                     ptr(need), ptr(raw), ptr(W0), C0, 1 if paired else 0, ptr(A), ptr(Bq), ptr(a0), ptr(b0),
                     ptr(W1), ptr(a1), ptr(b1), C1, C2, ptr(out), plan.block_queries or M, int(plan.stage_xyz),
                     int(plan.stage_plane), plan.smem_bytes, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sa_group_mlp kernel launch failed: CUDA error {err}")
        LAUNCHES["raw" if raw is not None else "plane"] += 1
        BODY_LAUNCHES[plan.body] += 1
    return out


def sa_group_mlp(xyz, new_xyz, radius: float, nsample: int, Bq, a0, b0, W1, a1, b1, *,
                 A=None, raw=None, W0=None, paired: bool = False, need=None) -> torch.Tensor:
    """One fused eval SA scale -> (B, M, C2) (paired: (B, M, 2*C2)) in the
    A dtype.

    xyz (B, N, 3), new_xyz (B, M, 3): float32 geometry. Raw mode: raw
    (B, C0 [+1 when paired], N) channel-major [xyz|features], W0 (C0, C1).
    Plane mode: A (B, N, C1). Bq (B, M, C1) and W1 (C1, C2) in the A dtype
    (float32 or bfloat16); a0, b0 (C1,), a1, b1 (C2,) float32 folded-BN
    affines; need (B, M) int32 chunk bounds or None."""
    dims = _check(xyz, new_xyz, Bq, a0, b0, W1, a1, b1, A, raw, W0, paired, need, nsample)
    if xyz.device.type == "cpu":
        return sa_group_mlp_plain(xyz, new_xyz, radius, nsample, Bq, a0, b0, W1, a1, b1,
                                  A=A, raw=raw, W0=W0, paired=paired, need=need)
    if xyz.device.type != "cuda":
        raise ValueError(f"sa_group_mlp: unsupported device {xyz.device}")
    return _launch(xyz, new_xyz, radius, nsample, Bq, a0, b0, W1, a1, b1, A, raw, W0, paired, need, dims)
