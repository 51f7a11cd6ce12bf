"""Group-Free on the card: whether a train step is reproducible, what its
gathers cost, whether a torch.profiler trace keeps a window's first
kernels, and why ``detect-infer``'s boxes on the card and the CPU part.

    python3 tools/groupfree_card_study.py [--out chiprun_out/groupfree_study]
        [--seeds 12] [--profiles 30] [--rounds 4] [--parts gathers,steps,profile,gap]

Needs one CUDA card; imports nothing of JAX. Each part prints one JSON line
and all of them are written to ``<out>/study.json``:

* ``gathers``: a feature gather with repeated indices (SA2's ball-query
  groups of a B = 16 batch) by ``torch.gather``, by indexing, and by
  ``ops.interpolate.gather_rows`` (indexing forward, a stable sort of the
  indices and ``segment_reduce`` backward): three backwards of one
  cotangent bit-equal or not, and the forward + backward ms (CUDA events,
  median of 10).
* ``steps``: the full-width B = 16 train step (chip_smoke's ``groupfree``
  batch) with three variants of the detector's gathers (``before``: the
  SA and candidate gathers by indexing, ``three_interpolate`` by
  ``torch.gather``; ``index``: all by indexing; ``package``: all by
  ``gather_rows``, the package as it stands): two loss + backward
  passes from one state and dropout seed, gradients bit-equal or not
  (tensors that differ, the largest difference over the largest gradient),
  then host-clock ms of synchronised full steps (the median of 10 a
  round, ``--rounds`` rounds, the variants interleaved).
* ``profile``: chip_smoke's ``_profile_once`` of the B = 1 eval forward
  with its FPS and ball-query launches held against the launch counters,
  ``--profiles`` times with the guard (the host waits before the window's
  first launch) and as many without, interleaved: traces that lost kernels.
* ``gap``: a data root as chip_smoke's disk phase writes it (seed 0), its
  instance labels, then for each of ``--seeds`` train seeds ``perception
  --task detect-train`` (one epoch, batches of 2) and that checkpoint's
  eval forward of every test scan on the card and on the CPU: the gate's
  difference before it knew NMS ties (every list matched, ``match_rows``,
  infinite where the NMS kept a different number) and the disk phase's
  ``detect_gate`` (1e-4), and, for a scan over 1e-4, the first
  decision that differs between the two devices: the seed indices, the
  candidate set (the rank-128 gap of the objectness logits against their
  largest difference), a candidate's heading bin, size cluster or class
  (the argmax margin against the scores' difference), the score filter at
  0.05, or the NMS keep set. The seed-0 training runs twice: whether the
  two checkpoints are equal.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def gather_torch(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    B, _, C = x.shape
    return torch.gather(x, 1, idx.long().reshape(B, -1, 1).expand(-1, -1, C)).reshape(*idx.shape, C)


def gather_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    rows = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[rows, idx.long()]


def interp_with(gather):
    def three_interpolate(features, idx, weight):
        return (gather(features, idx) * weight[..., None]).sum(2)
    return three_interpolate


def cuda_ms(fn, n: int = 10) -> float:
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def part_gathers() -> dict:
    from or4d_tpu_torch.ops.interpolate import gather_rows

    g = torch.Generator(device="cuda").manual_seed(0)
    B, N, M, K, C = 16, 2048, 1024, 64, 128
    x = torch.randn(B, N, C, device="cuda", generator=g, requires_grad=True)
    idx = torch.randint(0, N, (B, M, K), device="cuda", generator=g)
    cot = torch.randn(B, M, K, C, device="cuda", generator=g)
    out = {"shape": {"features": [B, N, C], "idx": [B, M, K]}}
    for name, fn in (("torch_gather", gather_torch), ("index", gather_index), ("sorted", gather_rows)):
        grads = []
        for _ in range(3):
            x.grad = None
            fn(x, idx).backward(cot)
            grads.append(x.grad.clone())

        def fb():
            x.grad = None
            fn(x, idx).backward(cot)

        out[name] = {"bit_equal": all(torch.equal(grads[0], h) for h in grads[1:]),
                     "max_abs_diff": max(float((grads[0] - h).abs().max()) for h in grads[1:]),
                     "fwd_bwd_ms": cuda_ms(fb)}
    return out


def groupfree_variant(name: str):
    """Patch the detector's gathers for variant ``name``; returns the undo."""
    from or4d_tpu_torch.models import groupfree

    saved = (groupfree._gather, groupfree.three_interpolate)
    if name == "before":
        groupfree._gather = gather_index
        groupfree.three_interpolate = interp_with(gather_torch)
    elif name == "index":
        groupfree._gather = gather_index
        groupfree.three_interpolate = interp_with(gather_index)

    def undo():
        groupfree._gather, groupfree.three_interpolate = saved
    return undo


def part_steps(rounds: int) -> dict:
    from chip_smoke import GROUPFREE_MEAN_SIZES, groupfree_batch

    from or4d_tpu_torch.models.groupfree import mean_sizes
    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer

    batch = groupfree_batch(13, 16)
    tr = GroupFreeTrainer(device="cuda", seed=0)
    dev = tr.device
    pc = torch.as_tensor(batch["point_clouds"], device=dev)
    msa = mean_sizes(GROUPFREE_MEAN_SIZES, dev)
    label = torch.as_tensor(batch["point_instance_label"], device=dev)
    gt = {k: torch.as_tensor(v, device=dev) for k, v in batch["gt"].items()}
    gt = {k: v.float() if v.is_floating_point() else v for k, v in gt.items()}
    state0 = copy.deepcopy(tr.model.state_dict())
    opt0 = copy.deepcopy(tr.optimizer.state_dict())
    variants = ("before", "index", "package")
    out = {}
    for v in variants:
        undo = groupfree_variant(v)
        try:
            grads = []
            for _ in range(2):
                tr.model.load_state_dict(state0)
                tr.model.train()
                total, _parts = tr.loss(pc, msa, label, gt, torch.Generator(device=dev).manual_seed(1))
                tr.model.zero_grad(set_to_none=True)
                total.backward()
                grads.append({n: p.grad.clone() for n, p in tr.model.named_parameters() if p.grad is not None})
            a, b = grads
            diff = [n for n in a if not torch.equal(a[n], b[n])]
            scale = max(float(t.abs().max()) for t in a.values())
            out[v] = {"grads_bit_equal": not diff, "tensors_differ": len(diff), "tensors": len(a),
                      "max_diff_of_largest": max((float((a[n] - b[n]).abs().max()) for n in diff), default=0.0) / scale,
                      "first_differing": diff[:5], "loss": float(total.detach())}
        finally:
            undo()
    for rnd in range(rounds):
        for v in variants:
            undo = groupfree_variant(v)
            try:
                tr.model.load_state_dict(state0)
                tr.optimizer.load_state_dict(opt0)
                times = []
                for i in range(11):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    tr.train_step_from_batch(batch, GROUPFREE_MEAN_SIZES)
                    torch.cuda.synchronize()
                    if i:  # the first is a warm-up
                        times.append((time.perf_counter() - t0) * 1e3)
                out[v].setdefault("step_ms_median", []).append(statistics.median(times))
            finally:
                undo()
    return out


def part_profile(n: int) -> dict:
    from chip_smoke import GROUPFREE_COUNTED, GROUPFREE_KERNEL_GROUPS, GROUPFREE_MEAN_SIZES, _profile_once, groupfree_batch

    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer

    tr = GroupFreeTrainer(device="cuda", seed=0)
    model = tr.model.eval()
    msa = torch.tensor(GROUPFREE_MEAN_SIZES, device="cuda")
    pc1 = torch.from_numpy(groupfree_batch(14, 1)["point_clouds"]).cuda()

    def forward1():
        with torch.no_grad():
            return model(pc1, msa, train=False)

    forward1()
    torch.cuda.synchronize()
    res = {"guard_s_0.05": [], "guard_s_0": []}
    for _ in range(n):
        for key, guard in (("guard_s_0.05", 0.05), ("guard_s_0", 0.0)):
            prof = _profile_once(forward1, 1.0, GROUPFREE_KERNEL_GROUPS, GROUPFREE_COUNTED, guard_s=guard)
            lost = {g: c for g, c in prof["counted"].items() if c["trace"] != c["counters"]}
            res[key].append(lost)
    return {k: {"profiles": len(v), "lost": sum(bool(x) for x in v), "examples": [x for x in v if x][:3]}
            for k, v in res.items()}


def _cli(argv) -> str:
    from or4d_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    if rc:
        raise SystemExit(f"cli {argv} exited {rc}")
    return buf.getvalue()


def _argmax_flip(card: torch.Tensor, cpu: torch.Tensor) -> list:
    """Rows whose argmax differs: (row, the CPU's top-two margin, the scores'
    largest difference in that row)."""
    a, b = card.argmax(-1), cpu.argmax(-1)
    out = []
    for r in torch.nonzero(a != b).flatten().tolist():
        top = torch.topk(cpu[r], 2).values
        out.append({"row": r, "margin": float(top[0] - top[1]), "diff": float((card[r] - cpu[r]).abs().max())})
    return out


def worst_column(got: dict, want: dict) -> dict:
    """Where ``match_boxes``'s worst pair lies: the list (all boxes or the
    NMS kept), the column (0-6 the box, 7 the score) and its two values."""
    best = {"diff": -1.0}
    for sfx in ("", "_nms"):
        rows = [np.concatenate([d["bboxes" + sfx], d["scores" + sfx][:, None]], 1) for d in (got, want)]
        if not len(rows[1]) or len(rows[0]) != len(rows[1]):
            continue
        scale = np.abs(rows[1]).max(0)
        rel = np.abs(rows[0][:, None] - rows[1][None]) / scale
        cost = rel.max(-1)
        cost[got["classes" + sfx][:, None] != want["classes" + sfx][None]] = np.inf
        free_g, free_w = set(range(len(cost))), set(range(len(cost)))
        for flat in np.argsort(cost, axis=None):
            i, j = divmod(int(flat), len(cost))
            if i in free_g and j in free_w:
                free_g.discard(i)
                free_w.discard(j)
                if cost[i, j] > best["diff"]:
                    col = int(rel[i, j].argmax())
                    best = {"diff": float(cost[i, j]), "list": sfx or "all", "column": col,
                            "card": float(rows[0][i, col]), "cpu": float(rows[1][j, col]),
                            "card_row": rows[0][i].tolist(), "cpu_row": rows[1][j].tolist()}
    return best


def scan_decisions(out_card: dict, out_cpu: dict, msa_np, res_card: dict, res_cpu: dict) -> dict:
    """The two devices' decisions on one scan, in the order the forward
    takes them (see the module docstring)."""
    from or4d_tpu_torch.models.groupfree import decode_boxes

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, list):
            return [host(v) for v in x]
        return x.cpu() if torch.is_tensor(x) else x

    c = host(out_card)
    lc, lp = c["seeds_obj_cls_logits"][0].float(), out_cpu["seeds_obj_cls_logits"][0].float()
    ranked = torch.sort(lp, descending=True).values
    sc, sp = c["sample_inds"][0], out_cpu["sample_inds"][0]
    d = {"seed_inds_equal": bool(torch.equal(c["seed_inds"].long(), out_cpu["seed_inds"].long())),
         "logits_max_abs_diff": float((lc - lp).abs().max()), "rank128_gap": float(ranked[127] - ranked[128]),
         "candidate_set_equal": set(sc.tolist()) == set(sp.tolist()),
         "candidate_order_equal": bool(torch.equal(sc, sp))}
    # candidates aligned by seed index (the CPU's order)
    pos = {int(s): i for i, s in enumerate(sc.tolist())}
    common = [(pos[int(s)], j) for j, s in enumerate(sp.tolist()) if int(s) in pos]
    ic, ip = torch.tensor([a for a, _ in common]), torch.tensor([b for _, b in common])
    lc_last, lp_last = c["last"], out_cpu["last"]
    for key in ("heading_scores", "size_scores", "sem_scores"):
        d[key + "_flips"] = _argmax_flip(lc_last[key][0][ic].float(), lp_last[key][0][ip].float())
    d["head_max_rel_diff"] = {k: float((lc_last[k][0][ic] - lp_last[k][0][ip]).abs().max() / lp_last[k].abs().max())
                              for k in lp_last if lp_last[k].is_floating_point()}
    dec_c = [x[0] for x in decode_boxes(lc_last, msa_np)]
    dec_p = [x[0] for x in decode_boxes(lp_last, msa_np)]
    score_c, score_p = dec_c[4][ic], dec_p[4][ip]
    d["score_filter_flips"] = [{"row": int(r), "card": float(score_c[r]), "cpu": float(score_p[r])}
                               for r in torch.nonzero((score_c > 0.05) != (score_p > 0.05)).flatten().tolist()]
    d["heading_max_abs_diff"] = float((dec_c[2][ic] - dec_p[2][ip]).abs().max())
    d["boxes"] = len(res_cpu["scores"])
    d["nms_kept"] = [len(res_card["scores_nms"]), len(res_cpu["scores_nms"])]
    d["worst_column"] = worst_column(res_card, res_cpu)
    d.update(nms_flips([x[ic] for x in dec_c], [x[ip] for x in dec_p]))
    return d


def nms_flips(card: list, cpu: list, iou_threshold: float = 0.25, score_threshold: float = 0.05) -> dict:
    """The NMS's decisions on the candidates both sides keep through the
    score filter (``decode_boxes`` outputs, aligned): same-class pairs whose
    AABB IoU lies over the threshold on one side only, and overlapping
    same-class pairs whose score order differs (each with its values)."""
    from or4d_tpu_torch.ops.box_geometry import box_corners

    def iou(dec):
        corners = box_corners(dec[0].numpy().astype(np.float64), dec[1].numpy().astype(np.float64),
                              dec[2].numpy().astype(np.float64))
        mins, maxs = corners.min(1), corners.max(1)
        area = np.prod(maxs - mins, 1)
        inter = np.prod(np.clip(np.minimum(maxs[:, None], maxs[None]) - np.maximum(mins[:, None], mins[None]),
                                0, None), -1)
        return inter / np.maximum(area[:, None] + area[None] - inter, 1e-12)

    keep = ((card[4] > score_threshold) & (cpu[4] > score_threshold)).numpy()
    same = (card[3] == cpu[3]).numpy()
    ic, ip = iou(card), iou(cpu)
    sc, sp = card[4].numpy(), cpu[4].numpy()
    thr, order = [], []
    K = len(sc)
    for i in range(K):
        for j in range(i + 1, K):
            if not (keep[i] and keep[j] and same[i] and same[j] and int(card[3][i]) == int(card[3][j])):
                continue
            if (ic[i, j] > iou_threshold) != (ip[i, j] > iou_threshold):
                thr.append({"pair": [i, j], "iou_card": float(ic[i, j]), "iou_cpu": float(ip[i, j])})
            if max(ic[i, j], ip[i, j]) > iou_threshold and (sc[i] > sc[j]) != (sp[i] > sp[j]):
                order.append({"pair": [i, j], "scores_card": [float(sc[i]), float(sc[j])],
                              "scores_cpu": [float(sp[i]), float(sp[j])]})
    return {"nms_iou_threshold_flips": thr[:5], "nms_iou_threshold_flip_count": len(thr),
            "nms_score_order_flips": order[:5], "nms_score_order_flip_count": len(order)}


def part_gap(n_seeds: int, tmp: Path) -> dict:
    from chip_smoke import detect_gate, match_rows

    from or4d_tpu_torch.data.groupfree_dataset import GroupFreeDetectionDataset
    from or4d_tpu_torch.data.synthetic_root import write_data_root
    from or4d_tpu_torch.pipeline.perception_infer import _decoded, _finish_boxes, _forward, _mean_sizes
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer

    root = tmp / "data"
    write_data_root(root, seed=0, scans_per_take=2)
    _cli(["instance-labels", "--data-root", root])
    ds = GroupFreeDetectionDataset(root, "test")
    msa_np = np.asarray(ds.mean_size_arr())
    scans = [ds[i] for i in range(len(ds))]
    out = {"test_scans": len(scans), "seeds": []}

    def train(seed, ck):
        text = _cli(["perception", "--data-root", root, "--checkpoint-dir", ck, "--seed", seed, "--task",
                     "detect-train"])
        return float(text.split("loss=")[1].split()[0])

    def state(ck, device):
        tr = GroupFreeTrainer(device=device, seed=0)
        ckpt.restore(ck, tr.model)
        return tr.model.eval()

    losses0 = [train(0, tmp / "ck0"), train(0, tmp / "ck0b")]
    a, b = state(tmp / "ck0", "cpu").state_dict(), state(tmp / "ck0b", "cpu").state_dict()
    out["seed0_twice"] = {"losses": losses0, "checkpoints_equal": all(torch.equal(a[k], b[k]) for k in a)}
    for seed in range(n_seeds):
        ck = tmp / f"ck{seed}"
        loss = losses0[0] if seed == 0 else train(seed, ck)
        models = {"cuda": state(ck, "cuda"), "cpu": state(ck, "cpu")}
        rec = {"seed": seed, "loss": loss, "scans": []}
        for i, ret in enumerate(scans):
            outs, res = {}, {}
            for dev, m in models.items():
                msa = _mean_sizes(m, msa_np)
                outs[dev] = _forward(m, ret["point_clouds"], msa)
                decoded = _decoded(outs[dev], msa_np)
                if dev == "cuda":
                    torch.cuda.synchronize()
                res[dev] = _finish_boxes(decoded, tmp / f"s{seed}_{i}_{dev}.npz", 0.25, 0.05)
            shapes_equal = all(res["cuda"][k].shape == res["cpu"][k].shape for k in res["cpu"])
            worst = (max(match_rows(res["cuda"], res["cpu"], sfx)[0] for sfx in ("", "_nms")) if shapes_equal
                     else float("inf"))
            d = {"scan": ret["scan_name"], "gate": worst, "shapes_equal": shapes_equal,
                 "detect_gate": detect_gate(res["cuda"], res["cpu"])}
            if worst > 1e-4:
                d.update(scan_decisions(outs["cuda"], outs["cpu"], msa_np, res["cuda"], res["cpu"]))
            rec["scans"].append(d)
        rec["gate"] = max(s["gate"] for s in rec["scans"])
        rec["detect_gate"] = max(s["detect_gate"]["worst"] for s in rec["scans"])
        out["seeds"].append(rec)
        print(json.dumps({"gap_seed": seed, "loss": loss, "gate": rec["gate"], "detect_gate": rec["detect_gate"],
                          "ties": [s["detect_gate"] for s in rec["scans"] if "nms_in_card_order" in s["detect_gate"]]}),
              flush=True)
    out["failing_seeds"] = [r["seed"] for r in out["seeds"] if r["gate"] > 1e-4]
    out["failing_seeds_detect_gate"] = [r["seed"] for r in out["seeds"] if r["detect_gate"] > 1e-4]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/groupfree_study")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--profiles", type=int, default=30)
    ap.add_argument("--rounds", type=int, default=4, help="steps: rounds of 10 timed steps a variant")
    ap.add_argument("--parts", default="gathers,steps,profile,gap")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("groupfree_card_study: no CUDA card", file=sys.stderr)
        return 1
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    results = {"nvidia_smi": smi, "torch": torch.__version__}
    print(json.dumps(results), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    with tempfile.TemporaryDirectory(prefix="gf_study_") as tmp:
        for part in args.parts.split(","):
            t0 = time.perf_counter()
            try:
                if part == "gathers":
                    r = part_gathers()
                elif part == "steps":
                    r = part_steps(args.rounds)
                elif part == "profile":
                    r = part_profile(args.profiles)
                else:
                    r = part_gap(args.seeds, Path(tmp))
            except Exception as e:  # the other parts still run
                import traceback

                r = {"error": repr(e), "traceback": traceback.format_exc()[-3000:]}
                failed = True
            r["seconds"] = time.perf_counter() - t0
            results[part] = r
            (out / "study.json").write_text(json.dumps(results, indent=1, default=str))
            line = json.dumps({part: r}, default=str)
            print(line if len(line) < 6000 else json.dumps({part: "see study.json", "seconds": r["seconds"]}),
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
