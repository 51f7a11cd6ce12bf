"""Serving SA1 MLP on cached planes: the CUDA kernel
``csrc/serving_sa1_mlp.cu`` and its plain PyTorch version.

Replaces ``serving_sa1_mlp_pallas`` (or4d_tpu/ops/pallas_serving_mlp.py:128).
What bounds the kernel on the H100 and what its design does about it is in
the header of the CUDA source.

For each row r and query m of one SA1 scale:
``out[r, m] = max_s relu(a1 * (round_W1(relu((A_s - Bq) * a0 + b0)) @ W1) + b1)``
with ``A_s = round(planes[r, m, s, :C0] @ W0)`` accumulated in f32, over
the ``ns`` cached slots; the output in the planes' dtype. ``planes`` is the
port's cache layout (R, M, ns, 8): the grouped [p_abs | f] rows of each
(query, slot), channels zero-padded to 8 (:mod:`or4d_tpu_torch.serving`).

On the card the dtype picks the body (:func:`serving_plan`): bfloat16 runs
the tensor-core body, which shares its tile code with the fused eval SA
kernel's raw mode, so serving agrees bit for bit with the cold bf16 path;
float32 runs the FP32-pipe body. The wrapper takes the plain version for CPU
tensors only; a CUDA tensor always launches the kernel, and a shape outside
the kernel's limits or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from or4d_tpu_torch.ops._card import align16
from or4d_tpu_torch.ops.sa_group_mlp import _round_up

# kernel launches (one per SA1 scale)
LAUNCHES = {"mlp": 0}

C0P = 8  # plane channels (zero-padded)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C1, _MAX_C2, _MAX_NS = 128, 128, 128
_PLAIN_ELEMS = 1 << 26  # bound on the plain version's per-chunk temporaries
_MMA_WARPS, _FP32_WARPS, _GROUP = 8, 8, 16


@dataclass(frozen=True)
class ServingPlan:
    """How ``csrc/serving_sa1_mlp.cu`` runs one call.

    ``body`` "mma" (bfloat16: 16-slot tiles of one query on the tensor
    cores, ``tiles_per_query`` of them, ``queries_per_unit`` queries per
    warp pass so that two tiles share each W1^T fragment load) or "fp32"
    (float32: the FP32 pipes, 16 slots per layer-2 pass). ``smem_bytes``:
    the block's dynamic shared memory, which the kernel recomputes and
    checks."""

    body: str
    tiles_per_query: int
    queries_per_unit: int
    smem_bytes: int


def serving_plan(ns: int, C0: int, C1: int, C2: int, dtype) -> ServingPlan:
    """The kernel's body, tiling and shared memory for one call;
    ``ValueError`` outside its limits (C0 <= 8; C1, C2, ns <= 128)."""
    if dtype not in _DTYPES:
        raise ValueError(f"serving_sa1_mlp kernel dtypes: float32, bfloat16; got {dtype}")
    if not (1 <= C0 <= C0P and 1 <= C1 <= _MAX_C1 and 1 <= C2 <= _MAX_C2 and 1 <= ns <= _MAX_NS):
        raise ValueError(f"serving_sa1_mlp kernel limits: C0<={C0P}, C1<={_MAX_C1}, C2<={_MAX_C2}, ns<={_MAX_NS}; "
                         f"got C0={C0}, C1={C1}, C2={C2}, ns={ns}")
    if dtype == torch.float32:
        smem = (align16(4 * C1 * C2) + align16(4 * C0 * C1) + align16(4 * 2 * C1) + align16(4 * 2 * C2)
                + _FP32_WARPS * (align16(4 * ns * C0P) + 4 * C1 * _GROUP))
        return ServingPlan("fp32", -(-ns // _GROUP), 1, smem)
    # the staged weights (W1^T and the W0 pair with rows padded by 8 bf16, the
    # affines), then per warp two Bq rows and two running-max rows
    C1p, C2p = _round_up(C1, 16), _round_up(C2, 8)
    smem = (align16(C2p * (C1p + 8) * 2) + align16(C1p * (16 + 8) * 2) + align16((2 * C1p + 2 * C2p) * 4)
            + _MMA_WARPS * (align16(2 * C1p * 4) + align16(2 * C2p * 4)))
    tiles = -(-ns // 16)
    return ServingPlan("mma", tiles, 2 if tiles == 1 else 1, smem)


def _check(planes, Bq, W0, a0, b0, W1, a1, b1):
    if planes.dim() != 4 or planes.shape[-1] != C0P:
        raise ValueError(f"planes must be (R, M, ns, {C0P}), got {tuple(planes.shape)}")
    T = planes.dtype
    if T not in _DTYPES:
        raise TypeError(f"planes dtype must be float32 or bfloat16, got {T}")
    R, M, ns, _ = planes.shape
    C0, C1 = W0.shape
    C2 = W1.shape[1]
    if not 1 <= C0 <= C0P:
        raise ValueError(f"W0 must have 1 to {C0P} rows (the plane channels), got {C0}")
    shapes = {"Bq": (Bq, (R, M, C1), T), "W0": (W0, (C0, C1), T), "W1": (W1, (C1, C2), T),
              "a0": (a0, (C1,), torch.float32), "b0": (b0, (C1,), torch.float32),
              "a1": (a1, (C2,), torch.float32), "b1": (b1, (C2,), torch.float32)}
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
    for name, t in (("planes", planes), *((n, v[0]) for n, v in shapes.items())):
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, planes on {planes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ns < 1:
        raise ValueError("the planes need at least one slot")
    return R, M, ns, C0, C1, C2, T


def serving_sa1_mlp_plain(planes, Bq, W0, a0, b0, W1, a1, b1):
    """The plain PyTorch version, rounding at the kernel's points. Works in
    chunks of rows on any device."""
    R, M, ns, _ = planes.shape
    C0, C1 = W0.shape
    C2 = W1.shape[1]
    T = planes.dtype
    W0f, W1f = W0.float(), W1.float()
    step = max(1, min(R, _PLAIN_ELEMS // max(M * ns * max(C1, C2), 1)))
    outs = []
    for r0 in range(0, R, step):
        sl = slice(r0, r0 + step)
        A = (planes[sl, ..., :C0].float() @ W0f).to(T).float()  # (b, M, ns, C1)
        h = torch.relu((A - Bq[sl].float()[:, :, None, :]) * a0 + b0).to(W1.dtype).float()
        o = torch.relu((h @ W1f) * a1 + b1)
        outs.append(o.amax(dim=2).to(T))
    return torch.cat(outs) if outs else planes.new_empty(0, M, C2)


def _launch(planes, Bq, W0, a0, b0, W1, a1, b1, dims):
    from or4d_tpu_torch.ops._build import library

    R, M, ns, C0, C1, C2, T = dims
    plan = serving_plan(ns, C0, C1, C2, T)  # raises before any launch
    if planes.data_ptr() % 16:
        raise ValueError("serving_sa1_mlp: the planes must start on a 16-byte boundary")
    out = torch.empty(R, M, C2, dtype=T, device=planes.device)
    if R == 0 or M == 0:
        return out
    fn = library("serving_sa1_mlp").or4d_serving_sa1_mlp
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, P, P, P, P, P, P, P, I, I, I, I, I, I, P, ctypes.c_longlong, P]
    fn.restype = I
    dev = planes.device
    with torch.cuda.device(dev):
        err = fn(_DTYPES[T], planes.data_ptr(), Bq.data_ptr(), W0.data_ptr(), a0.data_ptr(), b0.data_ptr(),
                 W1.data_ptr(), a1.data_ptr(), b1.data_ptr(), R, M, ns, C0, C1, C2, out.data_ptr(), plan.smem_bytes,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"serving_sa1_mlp kernel launch failed: CUDA error {err}")
    LAUNCHES["mlp"] += 1
    return out


def serving_sa1_mlp(planes, Bq, W0, a0, b0, W1, a1, b1) -> torch.Tensor:
    """One serving SA1 scale -> (R, M, C2) in the planes' dtype.

    planes (R, M, ns, 8), Bq (R, M, C1), W0 (C0, C1) and W1 (C1, C2) in one
    dtype (float32 or bfloat16); a0, b0 (C1,) and a1, b1 (C2,) float32
    folded-BN affines."""
    dims = _check(planes, Bq, W0, a0, b0, W1, a1, b1)
    if planes.device.type == "cpu":
        return serving_sa1_mlp_plain(planes, Bq, W0, a0, b0, W1, a1, b1)
    if planes.device.type != "cuda":
        raise ValueError(f"serving_sa1_mlp: unsupported device {planes.device}")
    return _launch(planes, Bq, W0, a0, b0, W1, a1, b1, dims)
