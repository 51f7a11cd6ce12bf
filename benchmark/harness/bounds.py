"""The least time a kernel call could take on these inputs: the larger of
its bytes over the HBM rate (every input read once, every output written
once) and its operations over the peak of their type, with the work that
depends on the data (searches that end early, real slots) counted on the
call's own inputs.

Copied from ``chip_smoke.py`` (``bound``, ``search_work``, ``rows_read``,
``serving_bound``, the grouping bounds of ``group_jobs``, ``as_bound``), with
the ball query behind them replaced by the reference's
(``reference.geometry.ball_query``), so that a change to the program cannot
move the yardstick. Each function takes a recorded call's arguments and
returns (least ms, "bytes" or "operations").
"""

from __future__ import annotations

import torch

from harness.peaks import PEAK_BF16, PEAK_BYTES, PEAK_F32
from reference.geometry import ball_query

_ROWS = 1 << 26  # (clouds x M x N) elements a search-work block holds


def _ms(nbytes: float, t_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def as_bound(nbytes: float, f32_ops: float) -> tuple[float, str]:
    return _ms(nbytes, f32_ops / PEAK_F32)


def _hits(xyz, new_xyz, radius, ns):
    """(hit indices (B, M, ns) with -1 past the hits, total hits (B, M))."""
    idx, total = ball_query(xyz, new_xyz, radius, ns, with_total=True)
    slot = torch.arange(ns, device=idx.device)
    return torch.where(slot < total.clamp(max=ns)[..., None], idx, torch.full_like(idx, -1)), total


def search_work(xyz, new_xyz, radius, ns, need) -> tuple[int, int, int, torch.Tensor]:
    """(real slots, points scanned, points read, hit indices) of one search:
    a search ends at its ns-th hit; with counts (``need``) at the last hit it
    needs, without them a query short of ns hits scans all N points. A query
    with no hit counts one slot. Points read: per cloud, the furthest point
    any of its searches reaches."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    real, scanned, read, idxs = 0, 0, 0, []
    step = max(1, _ROWS // (M * N))
    for s in range(0, B, step):
        idx, total = _hits(xyz[s:s + step], new_xyz[s:s + step], radius, ns)
        thr = total.clamp(max=ns)
        real += int(thr.clamp(min=1).sum())
        last = torch.gather(idx, 2, (thr - 1).clamp(min=0)[..., None])[..., 0] + 1
        full = thr < ns if need is None else torch.zeros_like(thr, dtype=torch.bool)
        ends = torch.where(full | (thr == 0), torch.full_like(last, N), last)
        scanned += int(ends.sum())
        read += int(ends.amax(1).sum())
        idxs.append(idx)
    return real, scanned, read, torch.cat(idxs)


def rows_read(idx, N: int) -> int:
    """Distinct support points the hit indices (B, M, ns) point at."""
    flat = (torch.arange(idx.shape[0], device=idx.device)[:, None, None] * N + idx.long())[idx >= 0]
    seen = torch.zeros(idx.shape[0] * N, dtype=torch.bool, device=idx.device)
    seen[flat] = True
    return int(seen.sum())


def fps_bound(xyz, npoint: int, scales=()) -> tuple[float, str]:
    """FPS (with the per-scale search bound ``need`` when ``scales``): per
    point and step 3 subtractions, 3 products, 2 sums, a min and an argmax
    compare, plus a compare per radius; the points read once, the indices
    and bounds written once."""
    B, N, _ = xyz.shape
    nr = len(scales)
    nbytes = B * N * 12 + B * npoint * 4 + nr * B * npoint * 4
    steps = npoint - 1 + (1 if nr else 0)
    return as_bound(nbytes, B * steps * N * (10 + nr))


def sa_group_mlp_bound(args, kw) -> tuple[float, str]:
    """The fused eval SA stage (rows 3 and 4): its inputs, weights and output
    once, against the two products of every real slot (tensor cores in
    bfloat16) and the distances and affine/ReLU/max work on the FP32 pipes."""
    xyz, new_xyz, radius, ns, Bq, _a0, _b0, W1 = args[:8]
    raw, W0, A, need = kw.get("raw"), kw.get("W0"), kw.get("A"), kw.get("need")
    halves = 2 if kw.get("paired") else 1
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    C1, C2 = W1.shape
    es = W1.element_size()
    main = raw if raw is not None else A
    nbytes = (xyz.numel() * 4 + new_xyz.numel() * 4 + main.numel() * es + Bq.numel() * es + W1.numel() * es
              + (W0.numel() * es if W0 is not None else 0) + 4 * (C1 + C2) * 4
              + (need.numel() * 4 if need is not None else 0) + B * M * C2 * halves * es)
    real, scanned, _read, _idx = search_work(xyz, new_xyz, radius, ns, need)
    mm = real * halves * 2 * ((W0.shape[0] * C1 if W0 is not None else 0) + C1 * C2)
    f32_ops = scanned * 9 + real * halves * (4 * C1 + 3 * C2)
    if W1.dtype == torch.bfloat16:
        t_ops = max(mm / PEAK_BF16, f32_ops / PEAK_F32)
    else:
        t_ops = (mm + f32_ops) / PEAK_F32
    return _ms(nbytes, t_ops)


def serving_sa1_bound(args) -> tuple[float, str]:
    """The serving SA1 MLP (row 7) on cached planes: planes, Bq, weights and
    output once, against the W0 and W1 products and the f32 affine/ReLU/max
    work."""
    planes, Bq, W0, _a0, _b0, W1 = args[:6]
    R, M, ns, _ = planes.shape
    C0, C1 = W0.shape
    C2 = W1.shape[1]
    es = planes.element_size()
    nbytes = (planes.numel() + Bq.numel() + W0.numel() + W1.numel() + R * M * C2) * es + 4 * (2 * C1 + 2 * C2)
    slots = R * M * ns
    mm = slots * 2 * (C0 * C1 + C1 * C2)
    f32_ops = slots * (4 * C1 + 3 * C2)
    t_ops = max(mm / PEAK_BF16, f32_ops / PEAK_F32) if W1.dtype == torch.bfloat16 else (mm + f32_ops) / PEAK_F32
    return _ms(nbytes, t_ops)


def grouping_bounds(name: str, args) -> tuple[tuple[float, str], tuple[float, str]]:
    """(forward, backward) bounds of a train grouping call (rows 5, 6, 9):
    the points its searches read, the queries, the plane rows (raw columns)
    of the points hit and the slots written, against the distances over the
    scanned points (raw mode also builds each real slot's row); the backward
    reads the slots' cotangents and indices and writes dW0 (raw) or dA."""
    if name == "ball_query_group_raw":
        xyz, q, r, ns, W0, raw, need = args
        C0, C = W0.shape
        es = W0.element_size()
        row_bytes, other = C0 * es, W0.numel() * es + (need.numel() * 4 if need is not None else 0)
        bwd_out = C0 * C * es
    else:
        xyz, q, r, ns, A = args[:5]
        need = args[5] if name == "ball_query_group_gated" else None
        C0, C = 0, A.shape[-1]
        es = A.element_size()
        row_bytes, other = C * es, (need.numel() * 4 if need is not None else 0)
        bwd_out = xyz.shape[0] * xyz.shape[1] * C * es
    B, N, _ = xyz.shape
    M = q.shape[1]
    slots = B * M * ns
    real, scanned, read, idx = search_work(xyz, q, r, ns, need)
    rows = rows_read(idx, N)
    fwd_bytes = 12 * (read + B * M) + rows * row_bytes + other + slots * (C * es + 4)
    fwd = as_bound(fwd_bytes, scanned * 9 + real * 2 * C0 * C)
    valid = int((idx >= 0).sum())
    bwd_bytes = slots * (4 + C * es) + (rows * row_bytes if C0 else 0) + bwd_out
    bwd = as_bound(bwd_bytes, valid * (2 * C0 * C if C0 else C))
    return fwd, bwd
