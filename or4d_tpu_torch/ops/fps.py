"""Furthest point sampling: the CUDA kernels ``csrc/fps.cu`` (clouds of at
most 8192 points, one block a cloud) and ``csrc/fps_cluster.cu`` (larger
clouds, one thread-block cluster a cloud; :func:`cluster_plan`), and their
plain PyTorch version.

Replaces ``furthest_point_sample_pallas`` (or4d_tpu/ops/pallas_fps.py:200)
and ``furthest_point_sample_with_counts`` (pallas_fps.py:156). What bounds
the kernel on the H100 and what its design does about it is in the header of
``csrc/fps.cu``. :func:`furthest_point_sample_with_bounds` is the model
paths' variant: the same kernel turns the counts into the fused SA and
grouping kernels' search bound ``need`` itself, so the counts never reach
device memory.

Semantics (reference sampling_gpu.cu:69-173): index 0 first; a running
min-distance over all points; the point with the largest running distance is
selected next, ties to the lowest index; points with |p|^2 <= 1e-3 are never
selected and never lower the running distance below -1. With ``radii`` the
per-radius hit counts of every selected query over 512-point scan-order
chunks come out as well (the bounds the fused SA kernel consumes).

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
always launches the kernel, and a failed launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

CHUNK = 512  # scan-order chunk width of the hit counts
_MAG_EPS = float(np.float32(1e-3))
_MAX_RADII = 4
_MAX_N = 8192  # fps.cu: 512 threads x 16 points in registers; larger clouds run fps_cluster.cu
_WARPS, _MAX_CLUSTER = 16, 8  # fps_cluster.cu: warps a CTA, CTAs a (portable) cluster

# kernel launches, per variant: "fps" (no counts), "fps_counts" and
# "fps_bounds" (the search bounds from the counts) of fps.cu, and the same
# three of fps_cluster.cu as "fps_large", "fps_large_counts" and
# "fps_large_bounds"
LAUNCHES = {"fps": 0, "fps_counts": 0, "fps_bounds": 0, "fps_large": 0, "fps_large_counts": 0, "fps_large_bounds": 0}


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """``fps_cluster.cu``'s launch for N > 8192 points: ``ctas`` CTAs a
    cloud (one cluster), each owning ``share`` 512-point chunks with
    ``warps`` warps; ``streamed`` clouds (N > 65,536) are read from device
    memory every step, with the running minima in a (B, N) scratch."""

    ctas: int
    share: int
    warps: int
    streamed: bool


def cluster_plan(N: int) -> ClusterPlan:
    """The cluster kernel's plan (its ``plan_for``, which refuses another)."""
    if N <= _MAX_N:
        raise ValueError(f"the cluster FPS kernel takes N > {_MAX_N}, got {N}")
    nch = -(-N // CHUNK)
    if N <= CHUNK * _WARPS * _MAX_CLUSTER:
        ctas = -(-nch // _WARPS)
        share = -(-nch // ctas)
        return ClusterPlan(ctas, share, share, False)
    return ClusterPlan(_MAX_CLUSTER, -(-nch // _MAX_CLUSTER), _WARPS, True)


def _r2(radius: float) -> float:
    """r*r in Python double, then rounded to f32 — the reference's value."""
    return float(np.float32(radius * radius))


def _check(xyz: torch.Tensor, npoint: int, radii: tuple) -> None:
    if not isinstance(xyz, torch.Tensor) or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample expects a (B, N, 3) tensor, got {getattr(xyz, 'shape', xyz)}")
    if xyz.dtype != torch.float32:
        raise TypeError(f"furthest_point_sample expects float32 coordinates, got {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample expects a contiguous tensor")
    if npoint < 1 or xyz.shape[1] < 1:
        raise ValueError(f"npoint={npoint} and N={xyz.shape[1]} must be >= 1")
    if len(radii) > _MAX_RADII:
        raise ValueError(f"at most {_MAX_RADII} radii, got {len(radii)}")


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int, radii: tuple[float, ...] = ()):
    """The plain PyTorch version: idx (B, npoint) int32, plus a tuple of
    per-radius counts (B, npoint, ceil(N/512)) float32 when ``radii``."""
    B, N, _ = xyz.shape
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    mag = x * x + y * y + z * z
    mind = torch.where(mag > _MAG_EPS, torch.full_like(mag, float("inf")), torch.full_like(mag, -1.0))
    idx = torch.zeros(B, npoint, dtype=torch.int32, device=xyz.device)
    nch = -(-N // CHUNK)
    counts = [torch.zeros(B, npoint, nch, dtype=torch.float32, device=xyz.device) for _ in radii]
    r2s = [_r2(r) for r in radii]
    rows = torch.arange(B, device=xyz.device)
    sel = torch.zeros(B, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint + (1 if radii else 0)):
        dx = x - x[rows, sel][:, None]
        dy = y - y[rows, sel][:, None]
        dz = z - z[rows, sel][:, None]
        d2 = dx * dx + dy * dy + dz * dz
        for s, r2 in enumerate(r2s):
            hits = torch.nn.functional.pad((d2 < r2).float(), (0, nch * CHUNK - N))
            counts[s][:, j - 1] = hits.view(B, nch, CHUNK).sum(-1)
        if j == npoint:
            break
        mind = torch.minimum(mind, d2)
        sel = torch.argmax(mind, dim=1)  # first maximal index
        idx[:, j] = sel.int()
    return (idx, tuple(counts)) if radii else idx


def _launch(xyz: torch.Tensor, npoint: int, radii: tuple[float, ...], nsamples: tuple[int, ...] | None = None):
    """The kernel (``fps.cu``, or ``fps_cluster.cu`` over 8192 points): idx,
    plus per radius the counts, or with ``nsamples`` the bounds need
    (B, npoint) int32."""
    from or4d_tpu_torch.ops._build import library

    B, N, _ = xyz.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    large = N > _MAX_N
    if large:
        fn = library("fps_cluster").or4d_fps_cluster
        fn.argtypes = [P, I, I, I, I, P, P, P, P, P, I, I, I, P, P, P]
    else:
        fn = library("fps").or4d_fps
        fn.argtypes = [P, I, I, I, I, P, P, P, P, P, P]
    fn.restype = I
    dev = xyz.device
    idx = torch.empty(B, npoint, dtype=torch.int32, device=dev)
    nch = -(-N // CHUNK)
    bounds = nsamples is not None
    counts = torch.empty(len(radii), B, npoint, nch, dtype=torch.float32, device=dev) if radii and not bounds else None
    # one tensor per scale, so a caller that keeps one scale's bound keeps no other
    need = tuple(torch.empty(B, npoint, dtype=torch.int32, device=dev) for _ in radii) if bounds else None
    r2 = (ctypes.c_float * _MAX_RADII)(*[_r2(r) for r in radii])
    ns = (ctypes.c_int * _MAX_RADII)(*(nsamples or ()))
    need_ptrs = (P * _MAX_RADII)(*[n.data_ptr() for n in need]) if bounds else None
    args = [xyz.data_ptr(), B, N, npoint, len(radii), ctypes.cast(r2, P), ctypes.cast(ns, P), idx.data_ptr(),
            None if counts is None else counts.data_ptr(), None if need_ptrs is None else ctypes.cast(need_ptrs, P)]
    if large:
        plan = cluster_plan(N)
        # the streamed running minima and the bounds' chunk counts by step parity
        md = torch.empty(B, N, dtype=torch.float32, device=dev) if plan.streamed else None
        cnt = torch.empty(B, 2, len(radii), nch, dtype=torch.int32, device=dev) if bounds else None
        args += [plan.ctas, plan.share, int(plan.streamed), None if md is None else md.data_ptr(),
                 None if cnt is None else cnt.data_ptr()]
    if B > 0:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{'fps_cluster' if large else 'fps'} kernel launch failed: CUDA error {err}")
        variant = "fps_bounds" if bounds else "fps_counts" if radii else "fps"
        LAUNCHES[variant.replace("fps", "fps_large", 1) if large else variant] += 1
    if bounds:
        return idx, need
    return (idx, tuple(counts.unbind(0))) if radii else idx


def _fps(xyz: torch.Tensor, npoint: int, radii: tuple[float, ...], nsamples: tuple[int, ...] | None = None):
    radii = tuple(float(r) for r in radii)
    _check(xyz, npoint, radii)
    if xyz.device.type == "cpu":
        if nsamples is not None:
            return furthest_point_sample_with_bounds_plain(xyz, npoint, tuple(zip(radii, nsamples)))
        return furthest_point_sample_plain(xyz, npoint, radii)
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: unsupported device {xyz.device}")
    return _launch(xyz, npoint, radii, nsamples)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32 FPS indices."""
    return _fps(xyz, npoint, ())


def furthest_point_sample_with_counts(xyz: torch.Tensor, npoint: int, radii: tuple[float, ...]):
    """FPS indices and, per radius, (B, npoint, ceil(N/512)) float32 hit
    counts of each selected query over 512-point scan-order chunks."""
    if not radii:
        raise ValueError("furthest_point_sample_with_counts needs at least one radius")
    return _fps(xyz, npoint, tuple(radii))


def furthest_point_sample_with_bounds_plain(xyz: torch.Tensor, npoint: int, scales: tuple[tuple[float, int], ...]):
    """The plain version: the plain FPS counts, then ``counts_to_bounds``."""
    idx, counts = furthest_point_sample_plain(xyz, npoint, tuple(r for r, _ns in scales))
    return idx, tuple(need.int() for need, _thr in counts_to_bounds(scales, counts))


def furthest_point_sample_with_bounds(xyz: torch.Tensor, npoint: int, scales: tuple[tuple[float, int], ...]):
    """FPS indices and, per (radius, nsample) scale, the search bound need
    (B, npoint) int32 of each selected query: the number of 512-point
    scan-order chunks that hold its first min(nsample, hits) hits (1 when it
    has none), as ``counts_to_bounds`` of the counts gives it."""
    if not scales:
        raise ValueError("furthest_point_sample_with_bounds needs at least one scale")
    nsamples = tuple(int(ns) for _r, ns in scales)
    if min(nsamples) < 1:
        raise ValueError(f"nsample must be >= 1, got {scales}")
    return _fps(xyz, npoint, tuple(r for r, _ns in scales), nsamples)
