"""Traffic mode ``eval``: cold inference through the entry ``cli.py infer``
calls, ``Trainer.predict_relations``, one batch a call, in a closed loop.

Set-up makes ``distinct_batches`` batches of ``scenes_per_batch`` scenes
(with the configuration's camera frames where it has an image branch),
the weights, and the program's trainer, then calls the entry once on each
batch. The window calls it on the batches in turn until ``--seconds`` have
passed; each call's host time is one sample of the batch latency. After the
window the reference computes every batch's log-probs (and embeddings) from
the points and frames, and every call's outputs are held against their
batch's.

Traced run: the same window with host spans around the pack build, the
upload, the relation emission and the eval step, and CUDA events around
the image branch; then a profile of ``trace_calls`` calls and one recorded
call for the kernels' least times.
"""

from __future__ import annotations

import gc
import time

import torch

from harness import compare, flops, kernels, program, weights
from harness.inputs import make_inputs, make_trainer, param_specs, to_device, valid_counts
from harness.context import Outcome
from harness.trace import Spans, profile
from reference import efficientnet as ref_b5, sgpn as ref_sgpn
from reference.precision import Precision

def eval_spans(tr) -> Spans:
    from or4d_tpu_torch import infer
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.train import loop

    spans = Spans()
    spans.wrap(SlotPack, "build", "pack")
    spans.wrap(loop, "is_pair_shared", "pack_check")
    spans.wrap(SceneBatch, "to", "upload")
    spans.wrap(infer, "relations_of", "relations")
    spans.wrap(loop.Trainer, "eval_step", "eval_step")
    return spans


def image_events(model) -> list:
    """CUDA event pairs around every image-branch call."""
    pairs = []
    if not getattr(model, "use_image", False):
        return pairs

    def pre(_m, _a):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        pairs.append([e, None])

    def post(_m, _a, _o):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        pairs[-1][1] = e

    model.image_branch.register_forward_pre_hook(pre)
    model.image_branch.register_forward_hook(post)
    return pairs


def reference_outputs(run, arrays_list, images_list, prec: Precision):
    """Per batch, the reference's (obj log-probs, rel log-probs, embedding)."""
    cfg = run.cell.config
    P = weights.make_params(param_specs(cfg), run.seed, run.device)
    out = []
    with torch.no_grad(), prec.flags():
        for arrays, images in zip(arrays_list, images_list):
            b = to_device(arrays, run.device)
            emb = None
            if images is not None:
                emb = ref_b5.embedding(P, cfg, torch.as_tensor(images).to(run.device), prec)
            obj, rel = ref_sgpn.forward(P, cfg, b, image_emb=emb, prec=prec)
            out.append((obj, rel, emb))
            del b
    return out


def gaps(calls, refs, arrays_list) -> dict:
    """The largest gaps of the captured calls against their batch's reference."""
    vals = {"rel_logprob_gap": 0.0, "obj_logprob_gap": 0.0}
    masks = [(torch.as_tensor(a["edge_mask"]), torch.as_tensor(a["obj_mask"])) for a in arrays_list]
    for c in calls:
        obj, rel, emb = refs[c["tag"]]
        em, om = (m.to(rel.device) for m in masks[c["tag"]])
        vals["rel_logprob_gap"] = max(vals["rel_logprob_gap"], compare.logprob_gap(c["rel"], rel, em))
        vals["obj_logprob_gap"] = max(vals["obj_logprob_gap"], compare.logprob_gap(c["obj"], obj, om))
        if emb is not None:
            g = compare.relative_gap(c["emb"], emb) if c["emb"] is not None else float("inf")
            vals["image_embedding_gap"] = max(vals.get("image_embedding_gap", 0.0), g)
    if not calls:
        return {}
    return vals


def run(run) -> Outcome:
    tr_cfg = run.cell.traffic
    S, n = tr_cfg["scenes_per_batch"], tr_cfg["distinct_batches"]
    arrays_list, images_list = make_inputs(run, n, S)
    host = [program.scene_batch(a, im) for a, im in zip(arrays_list, images_list)]
    run.log(f"{n} batches of {S} scenes made")
    tr = make_trainer(run)
    run.log("trainer made")
    cap = program.Capture(tr.model)
    spans = eval_spans(tr) if run.trace else None
    img_pairs = image_events(tr.model) if run.trace else []
    for b in host:  # every shape of the window, once
        tr.predict_relations([b])
        run.log("warm-up call")
    run.sync()
    cap.calls.clear()
    img_pairs.clear()
    if spans is not None:
        for v in spans.ms.values():
            v.clear()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.2f} s")

    call_ms, failed, i = [], 0, 0
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < run.seconds:
        cap.tag = i % n
        t = time.perf_counter()
        res = tr.predict_relations([host[i % n]])
        t_end = time.perf_counter()
        call_ms.append(1e3 * (t_end - t))
        failed += set(res) != set(host[i % n].scan_ids)
        i += 1
    window_s = t_end - t_start
    peak = run.peak_bytes()
    cap.close()
    run.log(f"window: {i} calls in {window_s:.2f} s")

    n_obj, n_edge = valid_counts(arrays_list[0])
    out = Outcome(setup_s=setup_s, window_s=window_s, calls=i, scenes=i * S, call_ms=call_ms, attempted=i,
                  failed=failed, checks={}, memory_peak_bytes=peak, dtype=tr_cfg["dtype"],
                  flops_per_call=flops.step_flops(run.cell.config, n_obj, n_edge, S))
    if run.trace:
        out.spans = {k: list(v) for k, v in spans.ms.items()}
        out.image_branch_ms = [a.elapsed_time(b) for a, b in img_pairs if b is not None]
        k = tr_cfg["trace_calls"]
        out.trace = profile(lambda: [tr.predict_relations([host[j % n]]) for j in range(k)], run.trace_dir,
                            kernels.trace_holds_counted)
        spans.restore()
        out.trace_calls = out.trace_batches = k
        out.bounds_ms = kernels.bounds_ms(kernels.Recorder().record(lambda: tr.predict_relations([host[0]])))
        run.log(f"traced {k} calls; bounds {out.bounds_ms}")

    calls = cap.calls
    del tr, cap, host
    gc.collect()
    run.free()
    refs = reference_outputs(run, arrays_list, images_list, Precision("f32"))
    out.checks = gaps(calls, refs, arrays_list)
    run.log(f"reference checked {len(calls)} calls")
    return out


def control(run, mode: str) -> dict:
    """The checks with the reference in ``mode`` put in the program's place."""
    tr_cfg = run.cell.traffic
    arrays_list, images_list = make_inputs(run, tr_cfg["distinct_batches"], tr_cfg["scenes_per_batch"])
    refs = reference_outputs(run, arrays_list, images_list, Precision("f32"))
    lower = reference_outputs(run, arrays_list, images_list, Precision(mode))
    calls = [{"tag": i, "obj": o, "rel": r, "emb": e} for i, (o, r, e) in enumerate(lower)]
    return gaps(calls, refs, arrays_list)
