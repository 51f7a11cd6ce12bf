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

The wrapper takes the plain version for CPU tensors only; a CUDA tensor
always launches the kernel, and a failed launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from or4d_tpu_torch.ops.ball_query import ball_query

# kernel launches (one per call, every scale at once)
LAUNCHES = {"multiscale": 0}

_MAX_SCALES = 4
_MAX_NS = 1024


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
    fn = library("ball_query_multiscale").or4d_ball_query_multiscale
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, I, I, I, I, P, P, P, P]
    fn.restype = I
    S = len(scales)
    r2 = (ctypes.c_float * S)(*[float(np.float32(r * r)) for r, _ns in scales])
    ns = (ctypes.c_int * S)(*[int(n) for _r, n in scales])
    ptrs = (ctypes.c_void_p * S)(*[o.data_ptr() for o in outs])
    with torch.cuda.device(dev):
        err = fn(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, S, ctypes.cast(r2, P), ctypes.cast(ns, P),
                 ctypes.cast(ptrs, P), torch.cuda.current_stream(dev).cuda_stream)
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
