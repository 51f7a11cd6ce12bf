"""Traffic mode ``serve``: repeated validation over a fixed set through
``ServingEvaluator(trainer, batches)`` with its defaults, as
``Trainer.fit(..., serving_val=True)`` builds it for per-epoch validation.

Set-up makes a pool of ``scenes_per_batch`` scenes and ``batches``
permutations of it (seeded), builds the weights, the trainer and the
evaluator (which builds every batch's SA1 caches, and offloads them to host
memory past its 4 GB budget), and evaluates once. The window calls
``evaluate()`` until ``--seconds`` have passed; a call serves every batch.
After the window the reference computes the pool's encoder features from
the points (not from the caches), runs the GCN and heads on every permuted
batch and holds each served batch's log-probs against them; each returned
F1 must be the relation macro F1 of the log-probs it served.

Traced run: host spans around the evaluation, each batch's cache upload,
the model's forward and the metric's update, then a profile of one
``evaluate()`` and one recorded evaluation for the kernels' least times.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import compare, flops, kernels, program, relation_f1, scenes, weights
from harness.context import Outcome
from harness.inputs import make_trainer, param_specs, shapes, to_device, valid_counts
from harness.trace import Spans, profile
from reference import sgpn as ref_sgpn
from reference.precision import Precision


def make_pool(run):
    tr_cfg = run.cell.traffic
    S, nb = tr_cfg["scenes_per_batch"], tr_cfg["batches"]
    pool = scenes.make_batch(run.seed, range(S), shapes(run.cell), run.device)
    rng = np.random.default_rng(weights.sub_seed(run.seed, "permutations"))
    perms = [rng.permutation(S) for _ in range(nb)]
    return pool, perms, [scenes.take(pool, p) for p in perms]


def reference_batches(run, pool, perms, prec: Precision):
    """Per permuted batch, the reference's (obj log-probs, rel log-probs)."""
    cfg = run.cell.config
    P = weights.make_params(param_specs(cfg), run.seed, run.device)
    out = []
    with torch.no_grad(), prec.flags():
        b = to_device(pool, run.device)
        fo, fr = ref_sgpn.features(P, cfg, b, False, prec)
        for p in perms:
            idx = torch.as_tensor(p, device=run.device)
            bp = {k: v[idx] for k, v in b.items()}
            out.append(ref_sgpn.from_features(P, cfg, bp, fo[idx], fr[idx], prec))
    return out


def gaps(calls, refs, batches) -> dict:
    vals = {"rel_logprob_gap": 0.0, "obj_logprob_gap": 0.0}
    for c in calls:
        obj, rel = refs[c["tag"]]
        a = batches[c["tag"]]
        vals["rel_logprob_gap"] = max(vals["rel_logprob_gap"], compare.logprob_gap(
            c["rel"], rel, torch.as_tensor(a["edge_mask"], device=rel.device)))
        vals["obj_logprob_gap"] = max(vals["obj_logprob_gap"], compare.logprob_gap(
            c["obj"], obj, torch.as_tensor(a["obj_mask"], device=obj.device)))
    return vals if calls else {}


def run(run) -> Outcome:
    from or4d_tpu_torch import serving

    tr_cfg = run.cell.traffic
    S, nb = tr_cfg["scenes_per_batch"], tr_cfg["batches"]
    pool, perms, batches = make_pool(run)
    host = [program.scene_batch(a) for a in batches]
    run.log(f"{nb} batches of {S} scenes made")
    tr = make_trainer(run)
    cap = program.Capture(tr.model)
    spans = None
    if run.trace:
        from or4d_tpu_torch.models.sgpn import SGPN

        spans = Spans()
        spans.wrap(serving, "lookahead", "evaluate")
        spans.wrap(serving.SA1Cache, "to", "cache_upload")
        spans.wrap(SGPN, "forward", "forward")
        spans.wrap(serving.RelationMetricAccumulator, "update_batch", "metrics")
    run.log("trainer made")
    server = serving.ServingEvaluator(tr, host)
    run.log("evaluator built")
    server.evaluate()
    run.sync()
    cap.calls.clear()
    if spans is not None:
        for v in spans.ms.values():
            v.clear()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.2f} s; offloaded {[e[3] for e in server.batches]}")

    call_ms, f1s, i = [], [], 0
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < run.seconds:
        t = time.perf_counter()
        f1s.append(server.evaluate())
        t_end = time.perf_counter()
        call_ms.append(1e3 * (t_end - t))
        i += 1
    window_s = t_end - t_start
    peak = run.peak_bytes()
    cap.close()
    run.log(f"window: {i} evaluations in {window_s:.2f} s")

    for j, c in enumerate(cap.calls):
        c["tag"] = j % nb
    calls = cap.calls
    failed = sum(1 for f in f1s if not np.isfinite(f)) + (len(calls) != i * nb)
    n_obj, n_edge = valid_counts(pool)
    out = Outcome(setup_s=setup_s, window_s=window_s, calls=i, scenes=i * nb * S, call_ms=call_ms,
                  attempted=i, failed=failed, checks={}, memory_peak_bytes=peak, dtype=tr_cfg["dtype"],
                  flops_per_call=nb * flops.step_flops(run.cell.config, n_obj, n_edge, S))
    if run.trace:
        out.spans = {k: list(v) for k, v in spans.ms.items()}
        out.trace = profile(server.evaluate, run.trace_dir, kernels.trace_holds_counted)
        spans.restore()
        out.trace_calls, out.trace_batches = 1, nb
        out.bounds_ms = kernels.bounds_ms(kernels.Recorder().record(server.evaluate))
        run.log(f"traced one evaluation; bounds {out.bounds_ms}")

    # each evaluation's F1, worked out again from the log-probs it served
    n_rel = run.cell.config["relations"]
    f1_gap = 0.0
    for e, f in enumerate(f1s):
        served = calls[e * nb:(e + 1) * nb]
        mine = relation_f1.batches_f1([c["rel"].cpu().numpy() for c in served],
                                      [batches[c["tag"]]["gt_rels"] for c in served],
                                      [batches[c["tag"]]["edge_mask"] for c in served], n_rel)
        f1_gap = max(f1_gap, abs(mine - f))
    del tr, cap, server, host
    gc.collect()
    run.free()
    refs = reference_batches(run, pool, perms, Precision("f32"))
    out.checks = {**gaps(calls, refs, batches), "served_f1_gap": f1_gap}
    run.log(f"reference checked {len(calls)} served batches")
    return out


def control(run, mode: str) -> dict:
    """The log-prob checks with the reference in ``mode`` put in the
    program's place."""
    pool, perms, batches = make_pool(run)
    refs = reference_batches(run, pool, perms, Precision("f32"))
    lower = reference_batches(run, pool, perms, Precision(mode))
    return gaps([{"tag": i, "obj": o, "rel": r} for i, (o, r) in enumerate(lower)], refs, batches)
