"""Traffic mode ``train``: ``Trainer.train_step`` in a closed loop, as
``Trainer.fit`` runs it (the loss read back every step).

Set-up makes ``distinct_batches`` batches of ``scenes_per_batch`` scenes
(every directed edge its own crop), the weights and the trainer, and takes
the first three steps on three different batches with a CPU generator
seeded from the seed (the augmentation's and dropout's draws): they are
the warm-up, and their losses, the first step's gradient (read from the
optimizer's first moment) and the parameters' change after the third are
kept. The window goes on stepping the same trainer over the batches in
turn with the same generator until ``--seconds`` have passed. After the
window the reference follows the first three steps from the same weights,
batches and seed: each step's loss, each leaf's first gradient and each
leaf's change are compared by their norms (``harness.compare``).

Traced run: host spans around the draws, the pack build, the upload, the
augmentation and the step, then a profile of ``trace_calls`` steps and one
recorded step for the kernels' least times.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from harness import compare, flops, kernels, program, weights
from harness.context import Outcome
from harness.inputs import make_inputs, param_specs, to_device, valid_counts
from harness.scenes import CONTACT_IDS
from harness.trace import Spans, profile
from reference import train as ref_train
from reference.precision import Precision

WARM_STEPS = 3


def train_spans() -> Spans:
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.train import loop

    spans = Spans()
    spans.wrap(loop, "draw_augment", "draws")
    spans.wrap(SlotPack, "build", "pack")
    spans.wrap(SceneBatch, "to", "upload")
    spans.wrap(loop, "augment_batch_with", "augment")
    spans.wrap(loop.Trainer, "train_step", "train_step")
    return spans


def first_steps(tr, host, gen, P0: dict):
    """The warm-up steps: (losses, first gradient by leaf, change by leaf)."""
    names = {p: n for n, p in tr.model.named_parameters()}
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    losses, grad = [], None
    for t in range(WARM_STEPS):
        losses.append(float(tr.train_step(host[t], gen)["loss"]))
        if t == 0:  # an optimizer that kept no moment got no gradient
            grad = {names[p]: tr.optimizer.state[p]["exp_avg"].detach() / (1.0 - beta1)
                    if "exp_avg" in tr.optimizer.state.get(p, {}) else torch.zeros_like(p)
                    for p in tr.optimizer.param_groups[0]["params"]}
    change = {names[p]: p.detach() - P0[names[p]] for p in tr.optimizer.param_groups[0]["params"]}
    return losses, grad, change


def checks(prog, ref) -> dict:
    """Loss gap per step over the reference's loss, and the worst leaf's
    gradient and change norm gaps (``compare.leaf_norm_gaps``) over the
    leaves the reference moves."""
    losses, grad, change = prog
    keep = compare.moved_leaves(ref["grad"])
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])),
           "grad_norm_gap": max(compare.leaf_norm_gaps(grad, ref["grad"], keep).values()),
           "change_norm_gap": max(compare.leaf_norm_gaps(change, ref["change"], keep).values())}
    return out


def run(run) -> Outcome:
    tr_cfg = run.cell.traffic
    cfg = run.cell.config
    S, n = tr_cfg["scenes_per_batch"], tr_cfg["distinct_batches"]
    arrays_list, _ = make_inputs(run, n, S)
    host = [program.scene_batch(a) for a in arrays_list]
    run.log(f"{n} batches of {S} scenes made")
    P0 = weights.make_params(param_specs(cfg), run.seed, run.device)
    w_obj = weights.class_weights(run.seed, cfg["classes"], "w_obj", run.device)
    w_rel = weights.class_weights(run.seed, cfg["relations"], "w_rel", run.device)
    tr = program.trainer(run.cell, P0, w_obj, w_rel, run.device)
    run.log("trainer made")
    draw_seed = weights.sub_seed(run.seed, "draws")
    gen = torch.Generator().manual_seed(draw_seed)
    spans = train_spans() if run.trace else None
    prog = first_steps(tr, host, gen, P0)
    del P0
    run.sync()
    if spans is not None:
        for v in spans.ms.values():
            v.clear()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.2f} s; losses {prog[0]}")

    call_ms, failed, i = [], 0, WARM_STEPS
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < run.seconds:
        t = time.perf_counter()
        loss = float(tr.train_step(host[i % n], gen)["loss"])
        t_end = time.perf_counter()
        call_ms.append(1e3 * (t_end - t))
        failed += not math.isfinite(loss)
        i += 1
    steps = i - WARM_STEPS
    window_s = t_end - t_start
    peak = run.peak_bytes()
    run.log(f"window: {steps} steps in {window_s:.2f} s")

    n_obj, n_edge = valid_counts(arrays_list[0])
    out = Outcome(setup_s=setup_s, window_s=window_s, calls=steps, scenes=steps * S, call_ms=call_ms,
                  attempted=steps, failed=failed, checks={}, memory_peak_bytes=peak, dtype=tr_cfg["dtype"],
                  flops_per_call=flops.step_flops(cfg, n_obj, n_edge, S, train=True))
    if run.trace:
        out.spans = {k: list(v) for k, v in spans.ms.items()}
        k = tr_cfg["trace_calls"]
        out.trace = profile(lambda: [tr.train_step(host[j % n], gen)["loss"].item() for j in range(k)],
                            run.trace_dir, kernels.trace_holds_counted)
        spans.restore()
        out.trace_calls = out.trace_batches = k
        out.bounds_ms = kernels.bounds_ms(kernels.Recorder().record(
            lambda: tr.train_step(host[0], gen)["loss"].item()))
        run.log(f"traced {k} steps; bounds {out.bounds_ms}")

    del tr, host
    gc.collect()
    run.free()
    P0 = weights.make_params(param_specs(cfg), run.seed, run.device)
    ref = ref_train.train_steps(P0, cfg, [to_device(a, run.device) for a in arrays_list[:WARM_STEPS]], draw_seed,
                                w_obj, w_rel, CONTACT_IDS, steps=WARM_STEPS, prec=Precision("f32"))
    out.checks = checks(prog, ref)
    run.log(f"reference followed {WARM_STEPS} steps: losses {ref['losses']}")
    return out


def control(run, mode: str) -> dict:
    """The checks with the reference in ``mode`` put in the program's place,
    and with the fault that leaves half of each batch out (the loss's mean
    taken over the rest) put there, as ``control.*`` and ``half_batch.*``."""
    cfg, tr_cfg = run.cell.config, run.cell.traffic
    S = tr_cfg["scenes_per_batch"]
    arrays_list, _ = make_inputs(run, WARM_STEPS, S)
    batches = [to_device(a, run.device) for a in arrays_list]
    P0 = weights.make_params(param_specs(cfg), run.seed, run.device)
    w_obj = weights.class_weights(run.seed, cfg["classes"], "w_obj", run.device)
    w_rel = weights.class_weights(run.seed, cfg["relations"], "w_rel", run.device)
    draw_seed = weights.sub_seed(run.seed, "draws")

    def steps(prec, scenes=None):
        r = ref_train.train_steps(P0, cfg, batches, draw_seed, w_obj, w_rel, CONTACT_IDS, WARM_STEPS, prec, scenes)
        return r["losses"], r["grad"], r["change"]

    ref = ref_train.train_steps(P0, cfg, batches, draw_seed, w_obj, w_rel, CONTACT_IDS, WARM_STEPS,
                                Precision("f32"))
    out = {f"control.{k}": v for k, v in checks(steps(Precision(mode)), ref).items()}
    out.update({f"half_batch.{k}": v for k, v in checks(steps(Precision("f32"), slice(0, S // 2)), ref).items()})
    return out
