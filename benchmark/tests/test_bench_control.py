"""``correct`` comes out false when it should: the control (the reference
one precision step below the cell's, in the program's place) and the faults
a cell can have, planted under a run driven on the CPU at a small size
with the harness's look for a chip skipped; and true for the program as it
is. The card tests run the control at each cell's own size."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from harness import compare
from harness.spec import driver

CELLS = ("no_gt.eval.s64", "no_gt_image.eval.s16", "no_gt.train.s8", "no_gt.serve.s64")
CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def _outcome(run):
    return driver(run.cell.traffic["mode"]).run(run)


def _correct(run) -> bool:
    return compare.judge(_outcome(run).checks, run.cell.limits)[0]


def _alter_output(monkeypatch, how):
    """Wrap the model's forward so that its outputs are changed by ``how``
    where they are produced."""
    from or4d_tpu_torch.models.sgpn import SGPN

    forward = SGPN.forward

    def broken(self, *a, **k):
        out = forward(self, *a, **k)
        return dataclasses.replace(out, **how(out))

    monkeypatch.setattr(SGPN, "forward", broken)


def _one_answer_altered(out):
    rel = out.rel_logprobs.clone()
    rel[0, 0] = rel[0, 0].flip(-1)
    return {"rel_logprobs": rel}


def _half_left_out(out):
    S = out.rel_logprobs.shape[0]
    h = S // 2
    rel, obj = out.rel_logprobs.clone(), out.obj_logprobs.clone()
    rel[h:], obj[h:] = rel[:S - h].clone(), obj[:S - h].clone()
    return {"rel_logprobs": rel, "obj_logprobs": obj}


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_is_correct(tiny_run, cell):
    assert _correct(tiny_run(cell))


@pytest.mark.parametrize("cell", ["no_gt.eval.s64", "no_gt_image.eval.s16", "no_gt.serve.s64"])
@pytest.mark.parametrize("fault", [_one_answer_altered, _half_left_out])
def test_an_eval_fault_is_not_correct(tiny_run, monkeypatch, cell, fault):
    _alter_output(monkeypatch, fault)
    assert not _correct(tiny_run(cell))


def test_a_served_f1_altered_is_not_correct(tiny_run, monkeypatch):
    from or4d_tpu_torch.train.metrics import RelationMetricAccumulator

    f1 = RelationMetricAccumulator.macro_f1
    monkeypatch.setattr(RelationMetricAccumulator, "macro_f1", property(lambda self: f1.fget(self) + 1e-3))
    assert not _correct(tiny_run("no_gt.serve.s64"))


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(tiny_run, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    run = tiny_run("no_gt.train.s8")
    checks = _outcome(run).checks
    assert checks["change_norm_gap"] == pytest.approx(1.0)
    assert not compare.judge(checks, run.cell.limits)[0]


def _train_loss(monkeypatch, how):
    from or4d_tpu_torch.train import loop

    loss = loop.sgpn_loss
    monkeypatch.setattr(loop, "sgpn_loss", lambda out, b, *a, **k: how(loss, out, b, *a, **k))


def test_a_step_on_half_the_batch_is_not_correct(tiny_run, monkeypatch):
    def half(loss, out, b, *a, **k):
        keep = torch.arange(b.obj_mask.shape[0], device=b.obj_mask.device) < b.obj_mask.shape[0] // 2
        b = dataclasses.replace(b, obj_mask=b.obj_mask & keep[:, None], edge_mask=b.edge_mask & keep[:, None])
        return loss(out, b, *a, **k)

    _train_loss(monkeypatch, half)
    assert not _correct(tiny_run("no_gt.train.s8"))


def test_a_step_whose_loss_is_altered_is_not_correct(tiny_run, monkeypatch):
    def altered(loss, out, b, *a, **k):
        total, parts = loss(out, b, *a, **k)
        return total * 1.01, {**parts, "loss": parts["loss"] * 1.01}

    _train_loss(monkeypatch, altered)
    assert not _correct(tiny_run("no_gt.train.s8"))


@pytest.mark.parametrize("cell", ["no_gt.eval.s64", "no_gt.serve.s64"])
def test_the_control_is_not_correct(tiny_run, cell):
    """float8 products in the program's place (the bfloat16 cells' control);
    the float32 cells' TF32 control needs the card."""
    run = tiny_run(cell)
    assert not compare.judge(driver(run.cell.traffic["mode"]).control(run, "fp8"), run.cell.limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    """On the card, at the cell's own size, on one seed (``control.py``
    reads three or more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import time

    from conftest import ROOT
    from harness import spec
    from harness.context import Run

    c = spec.find_cell(ROOT, cell)
    run = Run(seed=2**31 + 4242, seconds=0.0, trace=False, cell=c, t0=time.perf_counter(), device="cuda",
              trace_dir=ROOT / "build" / "benchmark")
    readings = driver(c.traffic["mode"]).control(run, CONTROL[c.traffic["dtype"]])
    control = {k.removeprefix("control."): v for k, v in readings.items() if not k.startswith("half_batch.")}
    assert not compare.judge(control, c.limits)[0]
