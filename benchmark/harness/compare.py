"""The numbers that decide ``correct``, and the judgement against the cell's
limits (``benchmark/workloads/<cell>.json``: ``{"checks": {name: {"limit":
x}}}``). A run is correct when every check the cell names has a finite
value at or under its limit; a value that is missing, not finite or over
its limit fails it."""

from __future__ import annotations

import math

import torch


def logprob_gap(got: torch.Tensor, want: torch.Tensor, mask: torch.Tensor) -> float:
    """Largest |got - want| over the valid slots (mask (S, n)) and classes."""
    d = (got.float() - want.float()).abs().amax(-1)
    return float(torch.where(mask.bool(), d, torch.zeros_like(d)).amax())


def relative_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().amax() / want.float().abs().amax().clamp(min=1e-30))


def leaf_norm_gaps(got: dict, want: dict, keep) -> dict[str, float]:
    """Per leaf, |‖got‖ - ‖want‖| over the larger of ‖want‖ and the median
    leaf's ‖want‖ (over the leaves in ``keep``)."""
    wn = {n: float(want[n].double().norm()) for n in keep}
    med = sorted(wn.values())[len(wn) // 2] if wn else 0.0
    return {n: abs(float(got[n].double().norm()) - wn[n]) / max(wn[n], med, 1e-30) for n in keep}


def moved_leaves(ref_grad: dict, rel: float = 1e-3) -> list[str]:
    """The leaves whose reference gradient is not nought to rounding: norm at
    least ``rel`` of the median leaf's (a bias in front of a BN has a zero
    gradient in exact arithmetic and moves under Adam by round-off alone)."""
    norms = {n: float(g.double().norm()) for n, g in ref_grad.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [n for n, v in norms.items() if v >= rel * med]


def judge(values: dict, limits: dict) -> tuple[bool, list[tuple[str, float, float]]]:
    """(correct, [(check, value, limit)]) over the cell's checks."""
    rows, ok = [], True
    for name, spec in limits["checks"].items():
        v = values.get(name)
        v = float("nan") if v is None else float(v)
        lim = float(spec["limit"])
        good = math.isfinite(v) and v <= lim
        ok &= good
        rows.append((name, v, lim))
    return ok, rows
