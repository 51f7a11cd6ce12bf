"""Bounds pre-pass: the CUDA kernel ``csrc/ball_query_bounds.cu`` and its
plain PyTorch version.

Replaces ``ball_query_bounds_pallas`` (or4d_tpu/ops/pallas_ball_query.py:498;
kernel :425, call :534) with its signature and return layout: per
(radius, nsample) scale, ``need`` (B, M) — the number of 512-point
scan-order chunks that hold a query's first min(nsample, total) hits, 1 for
a query with no hit — and ``total`` (B, M), the query's hit count, both
float32. What bounds the kernel on the H100 and what its design does about
it is in the header of ``csrc/ball_query_bounds.cu``.

Distances are the direct difference of every kernel of the port, so on FPS
centroids ``need`` equals the need :func:`counts_to_bounds` derives from the
FPS kernel's per-chunk counts and ``total`` is their sum. (The TPU kernel
takes its distances from an MXU norm expansion, which may flip a hit within
about 1e-6 of a radius.)

In both packages only the sub-tile gate's query sort of the fused eval
kernel calls this function, and no model path takes that route: the FPS
kernel's counts give the same bounds for free. ``chip_smoke.py`` drives it
on the train step's SA1 geometry.

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
always launches the kernel, and a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from or4d_tpu_torch.ops.ball_query_group import _check_geometry, _device_type, r2_of
from or4d_tpu_torch.ops.fps import CHUNK
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

# kernel launches: one per call, every scale at once
LAUNCHES = {"prepass": 0}

MAX_SCALES = 4
_PLAIN_ELEMS = 1 << 26  # bound on the plain version's (clouds, M, CHUNK) temporaries


def chunk_counts_plain(scales, xyz, new_xyz) -> tuple[torch.Tensor, ...]:
    """Per scale, (B, M, ceil(N/512)) float32 hit counts of every query over
    512-point scan-order chunks (the FPS kernel's counts on its own
    centroids)."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    nch = -(-N // CHUNK)
    r2s = [r2_of(r) for r, _ns in scales]
    counts = [torch.zeros(B, M, nch, dtype=torch.float32, device=xyz.device) for _ in scales]
    step = max(1, min(B, _PLAIN_ELEMS // max(M * CHUNK, 1)))
    for b0 in range(0, B, step):
        q = new_xyz[b0 : b0 + step, :, None, :]
        for ch in range(nch):
            p = xyz[b0 : b0 + step, None, ch * CHUNK : (ch + 1) * CHUNK, :]
            dx, dy, dz = q[..., 0] - p[..., 0], q[..., 1] - p[..., 1], q[..., 2] - p[..., 2]
            d2 = dx * dx + dy * dy + dz * dz
            for s, r2 in enumerate(r2s):
                counts[s][b0 : b0 + step, :, ch] = (d2 < r2).float().sum(-1)
    return tuple(counts)


def ball_query_bounds_plain(scales, xyz, new_xyz):
    """The plain version: per scale (need (B, M), total (B, M)) float32."""
    counts = chunk_counts_plain(scales, xyz, new_xyz)
    return tuple((need, c.sum(-1)) for (need, _thr), c in zip(counts_to_bounds(scales, counts), counts))


def ball_query_bounds(scales, xyz, new_xyz):
    """``scales`` ((radius, nsample), ...), ``xyz`` (B, N, 3), ``new_xyz``
    (B, M, 3) float32 -> per scale (need (B, M), total (B, M)) float32: the
    kernel for CUDA tensors, the plain version on the CPU."""
    scales = tuple((float(r), int(ns)) for r, ns in scales)
    if not 1 <= len(scales) <= MAX_SCALES:
        raise ValueError(f"ball_query_bounds takes 1 to {MAX_SCALES} scales, got {len(scales)}")
    if any(ns < 1 for _r, ns in scales):
        raise ValueError(f"every nsample must be >= 1, got {scales}")
    _check_geometry(xyz, new_xyz, 1)
    if _device_type(xyz, "ball_query_bounds") == "cpu":
        return ball_query_bounds_plain(scales, xyz, new_xyz)
    from or4d_tpu_torch.ops._build import library

    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    S = len(scales)
    fn = library("ball_query_bounds").or4d_ball_query_bounds
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, I, I, P, P, P, P]
    fn.restype = I
    out = torch.empty(S, 2, B, M, dtype=torch.float32, device=xyz.device)
    if B > 0 and M > 0 and N > 0:
        r2 = (ctypes.c_float * S)(*[r2_of(r) for r, _ns in scales])
        nss = (ctypes.c_int * S)(*[ns for _r, ns in scales])
        with torch.cuda.device(xyz.device):
            err = fn(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, S, ctypes.cast(r2, P), ctypes.cast(nss, P),
                     out.data_ptr(), torch.cuda.current_stream(xyz.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball_query_bounds kernel launch failed: CUDA error {err}")
        LAUNCHES["prepass"] += 1
    else:
        out[:, 0].fill_(1.0)
        out[:, 1].zero_()
    return tuple((out[s, 0], out[s, 1]) for s in range(S))
