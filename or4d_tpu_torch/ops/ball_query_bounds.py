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

On the card the kernel is planned by :func:`bounds_plan`: queries a thread
and the window of the cloud staged in shared memory; the kernel recomputes
the plan's bytes and refuses a plan that disagrees. The wrapper takes the
plain version for CPU tensors only; a CUDA tensor always launches the
kernel, and a refused plan or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from or4d_tpu_torch.ops._card import BLOCK_RESERVED, H100_SMS, MAX_SMEM, SM_SMEM
from or4d_tpu_torch.ops.ball_query_group import _check_geometry, _device_type, r2_of
from or4d_tpu_torch.ops.fps import CHUNK
from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

# kernel launches: one per call, every scale at once
LAUNCHES = {"prepass": 0}

MAX_SCALES = 4
_PLAIN_ELEMS = 1 << 26  # bound on the plain version's (clouds, M, CHUNK) temporaries
# the kernel's constants the plan assumes (kThreads and kMinBlocks in the
# source: a test holds them equal): blocks of 128 threads, registers for 5 of
# them an SM
THREADS = 128
_MIN_BLOCKS = 5
_GOOD_WARPS = 16  # warps an SM (4 a sub-partition) that keep its FP32 pipes issuing


@dataclass(frozen=True)
class BoundsPlan:
    """How ``csrc/ball_query_bounds.cu`` runs one call: ``blocks`` blocks
    of 128 threads, each over ``block_queries`` (128 x ``queries``) queries
    of one cloud; the cloud staged ``window`` points (whole 512-point
    chunks) at a time in ``buffers`` (1: the whole cloud; 2: a ring) of
    ``smem_bytes`` together, which the kernel recomputes and checks;
    ``blocks_per_sm``: the blocks an SM holds at once."""

    queries: int
    block_queries: int
    window: int
    buffers: int
    smem_bytes: int
    blocks: int
    blocks_per_sm: int


def _window_smem(N: int, window: int) -> int:
    """The kernel's shared memory (``window_smem`` in the source)."""
    return (1 if window >= N else 2) * 12 * window


def bounds_plan(B: int, N: int, M: int, S: int, sms: int = H100_SMS) -> BoundsPlan:
    """The kernel's plan for one call; ``ValueError`` outside its limits.

    A thread takes the most queries (4 for at most two scales, else 2; then
    2) at which the call still gives each of the card's ``sms`` SMs 16
    warps, 4 a sub-partition to cover the latency of a warp's dependent
    FP32 chain; 1 where none does (more queries a thread would leave
    sub-partitions idle). Every block an SM receives fits in it at once
    where registers allow (5 blocks); the window is the whole cloud where
    that many blocks' copies fit in an SM's shared memory, else the most
    whole chunks two windows of which do (at least one chunk)."""
    if min(B, N, M) < 1 or not 1 <= S <= MAX_SCALES:
        raise ValueError(f"ball_query_bounds kernel limits: 1 to {MAX_SCALES} scales and B, N, M >= 1; got "
                         f"B={B}, N={N}, M={M}, S={S}")
    queries = next((q for q in ((4, 2) if S <= 2 else (2,)) if B * M / q / 32 / sms >= _GOOD_WARPS), 1)
    blocks = B * -(-M // (THREADS * queries))
    if blocks > 0x7FFFFFFF:
        raise ValueError(f"ball_query_bounds: {blocks} blocks, over the grid's limit")
    resident = min(-(-blocks // sms), _MIN_BLOCKS)
    budget = min(MAX_SMEM, SM_SMEM // resident - BLOCK_RESERVED)
    nch = -(-N // CHUNK)
    window = nch * CHUNK
    if _window_smem(N, window) > budget:
        window = max(1, min(nch - 1, budget // (2 * 12 * CHUNK))) * CHUNK
    smem = _window_smem(N, window)
    if smem > MAX_SMEM:
        raise ValueError(f"ball_query_bounds: {smem} bytes of shared memory, over {MAX_SMEM}")
    per_sm = min(resident, SM_SMEM // (smem + BLOCK_RESERVED))
    return BoundsPlan(queries, THREADS * queries, window, 1 if window >= N else 2, smem, blocks, per_sm)


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
    out = torch.empty(S, 2, B, M, dtype=torch.float32, device=xyz.device)
    if B > 0 and M > 0 and N > 0:
        plan = bounds_plan(B, N, M, S, torch.cuda.get_device_properties(xyz.device).multi_processor_count)
        fn = library("ball_query_bounds").or4d_ball_query_bounds
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, I, I, I, I, P, P, P, I, I, L, P]
        fn.restype = I
        r2 = (ctypes.c_float * S)(*[r2_of(r) for r, _ns in scales])
        nss = (ctypes.c_int * S)(*[ns for _r, ns in scales])
        with torch.cuda.device(xyz.device):
            err = fn(xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, S, ctypes.cast(r2, P), ctypes.cast(nss, P),
                     out.data_ptr(), plan.queries, plan.window, plan.smem_bytes,
                     torch.cuda.current_stream(xyz.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ball_query_bounds kernel launch failed: CUDA error {err}")
        LAUNCHES["prepass"] += 1
    else:
        out[:, 0].fill_(1.0)
        out[:, 1].zero_()
    return tuple((out[s, 0], out[s, 1]) for s in range(S))
