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

The wrappers take the plain versions for CPU tensors only; a CUDA tensor
always launches a kernel, and a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from or4d_tpu_torch.ops.ball_query_group import (
    DTYPES,
    _check,
    _check_geometry,
    _device_type,
    gather_rows,
    group_indices_plain,
    r2_of,
)

# kernel launches: "fwd" (search + grouped rows from raw) and "bwd" (dW0)
LAUNCHES = {"fwd": 0, "bwd": 0}

_MAX_C0, _MAX_C = 8, 128


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
    if C0 > _MAX_C0 or C > _MAX_C:
        raise ValueError(f"ball_query_group_raw kernel takes C0 <= {_MAX_C0}, C <= {_MAX_C}; got {C0}, {C}")
    from or4d_tpu_torch.ops._build import library

    fn = library("ball_query_group").or4d_group_fwd
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [I, P, P, I, I, I, F, I, P, P, P, P, I, I, P, P, P]
    fn.restype = I
    out = torch.empty(B, M, nsample, C, dtype=W0.dtype, device=W0.device)
    idx = torch.empty(B, M, nsample, dtype=torch.int32, device=W0.device)
    if B > 0 and M > 0:
        with torch.cuda.device(W0.device):
            err = fn(DTYPES[W0.dtype], xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, r2_of(radius), nsample,
                     None if need is None else need.data_ptr(), None, raw.data_ptr(), W0.data_ptr(), C0, C,
                     out.data_ptr(), idx.data_ptr(), torch.cuda.current_stream(W0.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball_query_group_raw forward kernel launch failed: CUDA error {err}")
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
    if C0 > _MAX_C0 or C > _MAX_C or ns > 127:
        raise ValueError(f"ball_query_group_raw backward kernel takes C0 <= {_MAX_C0}, C <= {_MAX_C}, ns <= 127")
    from or4d_tpu_torch.ops._build import library

    fn = library("ball_query_group").or4d_group_raw_bwd
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, I, I, I, I, I, I, P, P, P]
    fn.restype = I
    dW0 = torch.empty(C0, C, dtype=raw.dtype, device=raw.device)
    if B == 0 or M == 0:
        return dW0.zero_()
    partial = torch.empty(B, C0, C, dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        err = fn(DTYPES[raw.dtype], idx.data_ptr(), g.data_ptr(), raw.data_ptr(), B, N, M, ns, C0, C,
                 partial.data_ptr(), dW0.data_ptr(), torch.cuda.current_stream(raw.device).cuda_stream)
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
