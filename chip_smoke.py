#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``or4d_tpu_torch``) on one
NVIDIA GPU: the SGPN eval path, the SGPN train step (SA1 on its default raw
path and with ``train_raw`` false; at the largest batch with ``remat``),
the bounds pre-pass, FPS over 8192 points (the cluster kernel), Group-Free
3D detection, Graphormer role prediction, the ``no_gt_image`` path
(EfficientNet-B5 image branch),
serving mode (cached SA1 geometry) and the command line from disk to JSON
(L2 instance labels, Group-Free detect-train / detect-infer, train,
evaluate, infer, roles, graphormer-roles, phases, visualize;
``no_gt_image``; ``--from-gt`` on registered scans over 8192 points) at the
paper's full widths.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --bounds-timing
    python3 chip_smoke.py --largest-batch

Every run drives all phases, each printing JSON lines; any failure exits
non-zero, and nothing runs on the CPU except the CPU reference passes of the
slice and train phases and the disk phase's host stages (ingest, roles,
phases) and its ``--device cpu`` L2 reference.

1. device  — the card's name and count, and nvidia-smi's name/power limit.
2. build   — nvcc builds every kernel source; per kernel its registers,
             shared memory and spill bytes (ptxas -v), and per kernel the count
             of tensor-core instructions (HMMA) in its SASS (cuobjdump): the
             bfloat16 bodies of the fused SA stage and of the serving SA1 MLP
             must have them. The bounds pre-pass's inner loop by opcode and
             its instructions a query-point pair (``sass_bounds_loop``).
3. check   — every kernel against its plain PyTorch version on the card, on
             the inputs the main path hands it (recorded from an S=8 eval
             forward, cut to 64 clouds): FPS indices and its search bounds
             exactly (the plain FPS counts, then ``counts_to_bounds``), the
             fused SA stage within 1e-4 in float32 and 2e-2 in bfloat16.
4. slice   — ``predict_relations`` on S=8 synthetic pair-shared scenes in
             bfloat16 (scan_relations JSON written to --out); every kernel's
             launch counter must rise in that pass. Then float32 at S=1 on
             the card and on the CPU with the same weights: log-probs within
             1e-3.
5. timing  — CUDA-event times of each kernel on the inputs of an S=64
             bfloat16 batch (the bench.py default) beside its plain version
             and its bound (and bound_share = bound / time); end-to-end batch
             time, scenes/s, peak memory and a torch.profiler breakdown; the
             batch must run the fused SA stage's bfloat16 (tensor-core) body
             only. Row 1's calls split: FPS alone, with counts, the
             ``counts_to_bounds`` of the counts, and the bounds variant.
5b. fps_large — row 2's cluster variant (``fps_cluster.cu``) against its
             plain version on the card, exactly, then timed beside it and its
             bound: N = 8193, GroupFree's (8, 20,000) -> 2048, the streamed
             tier at (1, 200,000) -> 200, grids of exact ties at 20,000 and
             100,000, the counts and bounds variants at (8, 20,000) -> 2048;
             each call launches the cluster kernel once.
5b'. groupfree — the Group-Free detector at full width (20,000 points x 6
             channels, SA 2048/1024/512/256, 128 proposals, 6 decoder
             layers; ``groupfree_phase``): the main path (a B = 1 eval
             forward and a B = 16 train step) with every counter zeroed
             before and read after, FPS (both variants) and the ball query
             launched; rows 2 and 8 exact against their plain versions at
             every call of a recorded B = 16 forward (the cluster FPS at
             (16, 20,000) -> 2048, row 8 unstaged at SA1); card vs CPU (the
             B = 1 forward's seed indices, the rank-128 gap over twice the
             logits' difference, candidate set and heads 1e-4, one
             dropout-0 step's loss 1e-4 and every gradient 1e-2 of the
             largest, SA1's train VJP 1e-2); the forward ms and ten step ms,
             scans/s, peaks, profiles split by kernel kind (their FPS and
             ball-query launches held against the launch counters), and
             each kernel's ms beside its plain version and bound.
5c. graphormer — the role-prediction Graphormer at full width (12 layers,
             hidden 80, 8 heads) on five synthetic tracks of 8 graphs of
             40-64 nodes (``dense_role_take``): card against CPU from the
             same weights (scores 1e-5, logits 1e-4 of their largest; one
             train step's loss 1e-5 and gradients 1e-3 of the largest), a
             3-epoch ``fit`` whose loss falls, and the forward, train step,
             FLAG step (m = 3) and scoring ms (CUDA events), the host ms of
             ``track_to_batch`` a track and peak memory. No hand-written
             kernel sits on this path (plain PyTorch, as the JAX package's is
             ``jnp`` outside any Pallas kernel).
6. check_train — the train grouping kernels (forward and backward: raw
             mode, plane mode, and plane mode with the FPS bound, SA1's
             grouping with ``train_raw`` false) against their plain versions
             on the card, on the inputs and cotangents of one S=8 float32
             ``no_gt`` train step on each SA1 path (cut to 64 clouds), in
             float32 and bfloat16: forwards exactly, dA within 1e-5 and dW0
             within 1e-4 of their largest value (another summation order),
             plus one bf16 ulp in bfloat16; each backward called twice must
             agree bit for bit. The bounds pre-pass on the
             ``train_raw=False`` step's SA1 geometry: exactly its plain
             version, and the need and hit totals of the FPS kernel's counts.
7. train   — ``Trainer.train_step`` three times on S=8 synthetic scenes, on
             each SA1 path: finite losses, and every launch counter of that
             path (FPS with and without bounds, its grouping kernels forward
             and backward) rises, the other path's SA1 counters do not. Then
             per path one float32 S=1 step on the card and on the CPU from
             the same weights and random draws: losses within 1e-4, every
             gradient within 1e-2 and every updated parameter within 1e-3 of
             the model's largest (a ~1e-5 forward difference flips a few
             max-pool winners, each moving a slot's gradient). Then
             ``Trainer.evaluate`` gives a finite macro F1.
8. timing_train — per SA1 path, ms per train step, scenes/s and peak
             memory in float32 and bfloat16 at S=8 (or the largest of 4 and
             2 that fits), the float32 step's device time by kernel
             (torch.profiler), and each grouping kernel's ms per step on the
             step's own inputs beside its plain version and its bound (rows
             5 and 6 from the raw step, row 9 from the other), each first
             held against its plain version on those full inputs as in
             check_train (``check_train_full``: the launch layouts the
             plans pick for the step's own sizes), and row 5's
             forward calls split (``timing_group_split``): row 5, the plane
             mode on the same geometry and bound, row 8's ball query (the
             search alone). The plane backward's calls (rows 6 and 9) split
             (``timing_bwd_split``): the kernel, the kernel on 8 of the
             cotangent's channels, and ``index_add_`` of the cotangent rows
             at the flattened hit indices (the ``library_ms`` of rows 6 and
             9 bwd). Then the bounds pre-pass on the
             ``train_raw=False`` float32 step's full SA1 geometry (its own
             path: counters zeroed before, read after), held exactly against
             its plain version and the FPS counts at that size
             (``check_train_full``, with the plan each call ran), and its
             ms beside its plain version, its bound and its issue floor (the SASS
             loop's instructions a pair over the card's issue rate at its
             top clock); its calls split (``timing_bounds_split``): every
             scale at once, each scale alone, the first half of the
             queries.
8b. largest_batch — the S=8 float32 ``no_gt`` step at the config's
             largest batch (12 objects, 132 edges a scene: 96 and 1056 rows)
             with ``TPUConfig.remat`` (the step runs out of memory without
             it: ``--largest-batch`` alone, which lists the tensors held for
             the backward first): peak memory and step ms. ``remat_equal``:
             one step at the train phase's batch with ``remat`` off and on
             from the same weights and draws, losses within 1e-4 and
             gradients within 1e-3 of the largest.
8c. image   — the ``no_gt_image`` float32 train step at S=8 on 456 x 456
             frames (three steps; the SGPN kernels' counters must rise) and
             an S=64 eval batch with frames: ms, scenes/s, peak memory, the
             image branch's ms alone; the card's embedding against the
             CPU's on one scene, within 1e-4 of its largest value.
9. check_serving — the multi-scale ball query (exactly, every scale) and
             the serving SA1 MLP (1e-4 float32, 2e-2 bfloat16) against their
             plain versions on the card, on the inputs of an S=8 bfloat16
             serving cache build and forward (unpaired synthetic scenes), cut
             to 64 clouds; then the serving SA1 stage against the cold one on
             the same S=8 crops in bfloat16, per encoder and scale: equal bit
             for bit (one tile code).
10. serving — a ``ServingEvaluator`` on those S=8 scenes in bfloat16 with
             its cache directory under --out: a finite macro F1, and the FPS,
             SA plane-mode, ball-query and serving-MLP counters rise; a second
             evaluator loads the cache files (no ball-query launch) and
             gives the same F1; the files are then removed. Serving against
             the cold unpaired forward at S=8 in bfloat16 within 1e-4. Then
             float32 at S=1: serving log-probs on the card and on the CPU
             within 1e-3, serving against the cold unpaired forward on the
             card bit for bit, and every stage (``eval_stages``:
             SA1-SA3 per encoder, the GCN's inputs and outputs, both heads)
             of serving against cold, and of each against a second run of
             itself, bit for bit.
11. timing_serving — the S=64 bfloat16 serving batch: cache build host
             seconds and bytes (set-up), forward batch ms with the caches
             resident, scenes/s, peak memory and a torch.profiler breakdown;
             the ball query's ms on the cache build's inputs, each call first
             held exactly against its plain version on those full inputs
             (``check_serving_full``: the layout the plan picks at full
             size), and the serving MLP's ms on the forward's, beside their
             plain versions and bounds (and bound_share); the ball query's
             calls split by scale (``timing_multiscale_split``: every scale
             in one launch and each alone, and the points the searches read
             with and without a chunk bound).

12. disk — a data root in the 4D-OR release layout (every take of every
             split, two scans each; 20,000 points a scan in millimetres:
             four furniture objects, the patient and four staff at 2,000
             points each, and a 2,000-point floor; every other pcd
             ``binary_compressed``; GT labels, GT joints, Group-Free box npzs,
             pose npys and registered furniture scans), written with the
             port's writers
             (``data/synthetic_root.py``) into a temporary directory, then
             the port's CLI (``cli.main``) through every stage on the card,
             each stage's launch counters zeroed before it and read after
             (``DISK_KERNELS``: the kernels it must launch):
             ``instance-labels`` (the pred path; its FPS calls and distance
             tests recorded), then the same command with ``--device cpu``,
             whose label npzs must be equal but for points within 2 mm^2 of a
             distance test's threshold^2; ``perception --task detect-train``
             (one epoch, batches of 2, a checkpoint), ``detect-infer --split
             test`` from it on the card and with ``--device cpu`` (the same
             files; boxes matched one to one by class, coordinates and
             scores 1e-4 of their largest) and ``instance-labels
             --boxes-dir`` on the card's boxes
             (``detect_stages``); the ingest (read + prep of every
             sample the later stages read, into their cache); ``train
             --strict-data`` (one epoch: two S=8 steps and the validation,
             a checkpoint); ``evaluate`` cold and ``--serving``; ``infer``
             from the checkpoint and with ``--torch-checkpoint`` of a random
             reference-layout .pth written under --out (its scan_relations
             keys must be the test scans); ``roles``, ``phases`` and
             ``phases-eval`` on that JSON; ``graphormer-roles`` twice on one
             checkpoint dir (the second restores, skips training and writes
             the same JSON), ``phases --roles`` on its JSON and ``visualize``
             of the infer JSON (one HTML a non-empty scan, at most 20). One ``disk`` line: each stage's
             host seconds, ingest and infer scans/s, peak device memory and
             the process's peak RSS, losses and F1 (finite). Then, on the
             same root with the fixture's camera frames added to every take,
             ``train``, ``evaluate`` and ``infer`` with ``--config
             no_gt_image``; and ``instance-labels --from-gt`` on a copy of
             the fixture root whose two take-1 registered object scans are
             rewritten at 20,000 points, on the card and with ``--device
             cpu``: labels equal. Then row 2 at L2's recorded calls
             (``timing_l2_fps``) and its cluster variant at the from-gt
             calls over 8192 points (``timing_from_gt_fps``): each held
             exactly against its plain version on the card, then timed (ms
             per call) beside it and its bound.

Then one ``kernels`` JSON line (row 2's L2 calls as its own entry,
``fps_l2``, per call, with its launches per scan; row 2's cluster variant
as ``fps_large``, per call at the from-gt calls; rows 2 and 8 as the
Group-Free detector calls them, ``fps_large_groupfree``, ``fps_groupfree``
and ``ball_query_groupfree``, per B = 16 forward, with the main path's
launches), nvidia-smi's line, and
the last line ``{"ok": true, "device": {...}}``. Weights are random, from a
seed.

``--bounds-timing`` runs only ``bounds_timing``: the bounds pre-pass alone
at the train step's two SA1 call shapes, for comparing the kernel of two
checkouts (this script copied into each) and its block shapes in one call.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s, FP32 (non-tensor)
# and BF16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

# TPU kernel rows of the eval path (PERF.md table rows 1-4:
# furthest_point_sample_with_counts, furthest_point_sample_pallas,
# ball_query_group_mlp_pallas_v4, ball_query_group_mlp_pallas) and the
# counter that counts the port kernel serving each; row 1 runs as the FPS
# kernel's bounds variant on the model paths
ROWS = (
    ("fps_with_counts", "fps.fps_bounds", "or4d_tpu_torch/ops/csrc/fps.cu",
     "or4d_tpu/ops/pallas_fps.py:156"),
    ("fps", "fps.fps", "or4d_tpu_torch/ops/csrc/fps.cu",
     "or4d_tpu/ops/pallas_fps.py:200"),
    ("sa_group_mlp_raw", "sa_group_mlp.raw", "or4d_tpu_torch/ops/csrc/sa_group_mlp.cu",
     "or4d_tpu/ops/pallas_ball_query.py:1928"),
    ("sa_group_mlp_plane", "sa_group_mlp.plane", "or4d_tpu_torch/ops/csrc/sa_group_mlp.cu",
     "or4d_tpu/ops/pallas_ball_query.py:1064"),
)
# TPU kernel rows 5 (ball_query_group_pallas_gated_raw: fwd and its VJP's
# bwd) and 6 (ball_query_group_pallas), driven by the train step
GROUP_SRC = "or4d_tpu_torch/ops/csrc/ball_query_group.cu"
TRAIN_ROWS = (
    ("group_raw_fwd", "group_raw.fwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:1743"),
    ("group_raw_bwd", "group_raw.bwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:1907"),
    ("group_fwd", "group.fwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:295"),
    ("group_bwd", "group.bwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:413"),
)
# TPU kernel rows 9 (ball_query_group_pallas_gated: fwd and its VJP's bwd),
# driven by the train step with train_raw false, and 10
# (ball_query_bounds_pallas), driven on that step's SA1 geometry
GATED_ROWS = (
    ("group_gated_fwd", "group_gated.fwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:1563"),
    ("group_gated_bwd", "group_gated.bwd", GROUP_SRC, "or4d_tpu/ops/pallas_ball_query.py:1656"),
)
BOUNDS_ROWS = (
    ("ball_query_bounds", "bounds.prepass", "or4d_tpu_torch/ops/csrc/ball_query_bounds.cu",
     "or4d_tpu/ops/pallas_ball_query.py:498"),
)
# TPU kernel rows 7 (serving_sa1_mlp_pallas) and 8
# (ball_query_multiscale_pallas), driven by serving mode
SERVING_ROWS = (
    ("serving_sa1_mlp", "serving_sa1.mlp", "or4d_tpu_torch/ops/csrc/serving_sa1_mlp.cu",
     "or4d_tpu/ops/pallas_serving_mlp.py:128"),
    ("ball_query_multiscale", "ball_query.multiscale", "or4d_tpu_torch/ops/csrc/ball_query_multiscale.cu",
     "or4d_tpu/ops/pallas_ball_query.py:139"),
)
SA_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# launches a row-10 timing averages over (a call of 0.1-1.2 ms)
ROW10_LAUNCHES = 100
BWD_TOL = {"group_raw_bwd": 1e-4, "group_bwd": 1e-5, "group_gated_bwd": 1e-5}  # of the largest |value|


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def nvidia_smi_line() -> str:
    return nvidia_smi("name,power.limit")


def max_sm_clock_mhz() -> float:
    return float(nvidia_smi("clocks.max.sm").split()[0])


def sass_listings(paths) -> dict:
    """{source: SASS text} from ``cuobjdump -sass`` of each built library,
    or None where the toolkit has no cuobjdump."""
    import os

    tool = shutil.which("cuobjdump") or str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).exists():
        return None
    return {name: subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True, timeout=300,
                                 check=True).stdout for name, path in paths.items()}


def sass_functions(sass: str) -> dict:
    """{kernel: [(address, opcode, text)]} of one SASS listing; a kernel is
    named as in ``short_name``, the opcode without predicate or modifiers."""
    import re

    per, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = short_name(m.group(1))
            per[fn] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);", line)
        if fn is not None and m:
            per[fn].append((int(m.group(1), 16), m.group(2), m.group(2) + m.group(3)))
    return per


def sass_mma_counts(sass) -> dict:
    """{source: {kernel: HMMA instructions}}, or None without listings."""
    if sass is None:
        return None
    return {name: {fn: sum(op == "HMMA" for _a, op, _t in ins) for fn, ins in sass_functions(text).items()}
            for name, text in sass.items()}


def sass_loop_mix(sass: str, part: str) -> dict:
    """Per kernel whose name holds ``part``: the instruction mix of its
    densest loop (the backward branch whose body has the most FMUL per
    instruction), by opcode, with the pairs an iteration computes taken as
    FMUL / 3 (each distance has three products) and instructions per pair."""
    import re

    out = {}
    for fn, ins in sass_functions(sass).items():
        if part not in fn:
            continue
        best = None
        for addr, op, text in ins:
            m = re.search(r"BRA\S*\s+`?\(?(0x[0-9a-f]+)", text) if op == "BRA" else None
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o, _t in ins if int(m.group(1), 16) <= a <= addr]
            fmul = body.count("FMUL")
            if fmul and (best is None or fmul / len(body) > best[0]):
                best = (fmul / len(body), body)
        if best is None:
            continue
        body = best[1]
        mix = {op: body.count(op) for op in sorted(set(body))}
        pairs = mix["FMUL"] / 3
        out[fn] = {"instructions": len(body), "pairs": pairs, "per_pair": len(body) / pairs, "mix": mix}
    return out


def short_name(mangled: str) -> str:
    """A kernel as "name<mangled template arguments>" from its mangled name
    (_ZN<len><namespace><len><name>I<args>Ev<params>)."""
    import re

    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]
    n = re.match(r"(\d+)", rest)
    if not n:
        return mangled
    name, tail = rest[n.end():n.end() + int(n.group(1))], rest[n.end() + int(n.group(1)):]
    return f"{name}<{tail[:tail.index('Ev')]}>" if tail.startswith("I") and "Ev" in tail else name


def ptxas_summary(log: str) -> dict:
    """{kernel: {"registers", "spill_bytes", "smem_bytes"}} from ptxas -v
    output; a kernel is named as in ``short_name``."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = short_name(m.group(1))
            out[fn] = {"registers": None, "spill_bytes": 0, "smem_bytes": 0}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_bytes"] = int(m.group(1)) if m else 0
    return out


class Recorder:
    """Wraps the kernel entry points the encoder and the serving cache build
    call and keeps each call's arguments (tensors on the card) while ``on``,
    as [name, args, kw, g]: ``g`` is the cotangent of the call's output,
    caught by a hook in the backward. With ``rows`` the tensors are cut to
    that many clouds and copied (W0 is a weight and stays whole)."""

    NAMES = ("furthest_point_sample", "furthest_point_sample_with_bounds", "sa_group_mlp",
             "ball_query_group", "ball_query_group_gated", "ball_query_group_raw", "serving_sa1_mlp")
    SERVING_NAMES = ("ball_query_multiscale",)

    def __init__(self):
        from or4d_tpu_torch import serving
        from or4d_tpu_torch.models import pointnet2

        self.orig = {n: getattr(pointnet2, n) for n in self.NAMES}
        self.orig.update({n: getattr(serving, n) for n in self.SERVING_NAMES})
        self.calls: list[list] = []
        self.on = False
        self.rows = None
        for n in self.NAMES:
            setattr(pointnet2, n, self._wrap(n))
        for n in self.SERVING_NAMES:
            setattr(serving, n, self._wrap(n))

    def _keep(self, t, whole=False):
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        return t if self.rows is None else (t if whole else t[: self.rows]).clone()

    def _wrap(self, name):
        fn = self.orig[name]

        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            if self.on:
                keep = [self._keep(a, whole=name == "ball_query_group_raw" and i == 4) for i, a in enumerate(args)]
                rec = [name, tuple(keep), {k: self._keep(v) for k, v in kw.items()}, None]
                self.calls.append(rec)
                if isinstance(out, torch.Tensor) and out.requires_grad:
                    out.register_hook(lambda g, rec=rec: rec.__setitem__(3, self._keep(g)))
            return out

        return wrapped

    def record(self, run, rows=None):
        self.calls, self.on, self.rows = [], True, rows
        try:
            run()
        finally:
            self.on = False
        calls, self.calls = self.calls, []
        return calls


def row_of(name: str, kw: dict) -> str:
    if name == "furthest_point_sample_with_bounds":
        return "fps_with_counts"
    if name == "furthest_point_sample":
        return "fps"
    return "sa_group_mlp_raw" if kw.get("raw") is not None else "sa_group_mlp_plane"


def cut(args, kw, rows: int, dtype=None):
    """The call's tensors cut to the first ``rows`` clouds; floating kernel
    operands (not geometry or the folded affines) cast to ``dtype``."""
    def c(key, v):
        if not isinstance(v, torch.Tensor):
            return v
        if v.dim() >= 2 and key not in ("W0", "W1"):
            v = v[:rows]
        if dtype is not None and key in ("raw", "W0", "A", "Bq", "W1"):
            v = v.to(dtype)
        return v.contiguous()

    names = ("xyz", "new_xyz", "radius", "nsample", "Bq", "a0", "b0", "W1", "a1", "b1")
    return [c(names[i] if i < len(names) else "", a) for i, a in enumerate(args)], {k: c(k, v) for k, v in kw.items()}


def run_call(name, args, kw, plain: bool):
    from or4d_tpu_torch.ops import fps, sa_group_mlp

    if name == "furthest_point_sample_with_bounds":
        # plain: the plain FPS counts, then counts_to_bounds
        fn = fps.furthest_point_sample_with_bounds_plain if plain else fps.furthest_point_sample_with_bounds
        return fn(*args)
    if name == "furthest_point_sample":
        return (fps.furthest_point_sample_plain if plain else fps.furthest_point_sample)(*args)
    if plain:
        return sa_group_mlp.sa_group_mlp_plain(*args, **kw)
    return sa_group_mlp.sa_group_mlp(*args, **kw)


def reset_bodies() -> dict:
    """Zeroes and returns the fused SA stage's per-body launch counts (a
    live dict: read it after the run)."""
    from or4d_tpu_torch.ops.sa_group_mlp import BODY_LAUNCHES

    for k in BODY_LAUNCHES:
        BODY_LAUNCHES[k] = 0
    return BODY_LAUNCHES


def max_abs_diff(a, b) -> float:
    if isinstance(a, tuple):
        a = (a[0], *a[1]) if isinstance(a[1], tuple) else a
        b = (b[0], *b[1]) if isinstance(b[1], tuple) else b
        return max(max_abs_diff(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def search_work(xyz, new_xyz, radius, ns, need) -> tuple[int, int, int]:
    """(real slots, points scanned, points read) of one ball-query search
    on these inputs: a search ends at the ns-th hit; with counts (``need``)
    it ends at the last hit it needs, without them a query short of ns hits
    scans all N points. A query with no hit counts one slot. Points read:
    per cloud, the furthest point any of its searches reaches."""
    from or4d_tpu_torch.ops.ball_query import ball_query_with_counts

    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    real, scanned, read = 0, 0, 0
    step = max(1, (1 << 26) // (M * N))
    for s in range(0, B, step):
        idx, total = ball_query_with_counts(radius, ns, xyz[s:s + step], new_xyz[s:s + step])
        thr = total.clamp(max=ns)
        real += int(thr.clamp(min=1).sum())
        last = torch.gather(idx, 2, (thr - 1).clamp(min=0)[..., None])[..., 0] + 1
        full = thr < ns if need is None else torch.zeros_like(thr, dtype=torch.bool)
        ends = torch.where(full | (thr == 0), torch.full_like(last, N), last)
        scanned += int(ends.sum())
        read += int(ends.amax(1).sum())
    return real, scanned, read


def rows_read(idx, N: int) -> int:
    """Distinct support points that hit indices (B, M, ns) point at, over
    all clouds: the plane rows a gather or scatter by them touches."""
    flat = (torch.arange(idx.shape[0], device=idx.device)[:, None, None] * N + idx.long())[idx >= 0]
    seen = torch.zeros(idx.shape[0] * N, dtype=torch.bool, device=idx.device)
    seen[flat] = True
    return int(seen.sum())


def bound(name, args, kw) -> tuple[float, str, dict]:
    """(least ms, "bytes"/"operations", counts) for one call on these inputs:
    every input read once and every output written once over the HBM rate,
    against the operations this data needs over the peak for their type."""
    from or4d_tpu_torch.ops.fps import CHUNK

    if name.startswith("furthest"):
        xyz, npoint = args[0], args[1]
        nr = len(args[2]) if len(args) > 2 else 0
        B, N, _ = xyz.shape
        # out: idx, and per scale the bound need (the bounds variant) or the
        # per-chunk counts
        per_query = 1 if name == "furthest_point_sample_with_bounds" else -(-N // CHUNK)
        nbytes = B * N * 12 + B * npoint * 4 + nr * B * npoint * per_query * 4
        # per point and step: 3 sub, 3 mul, 2 add, min, argmax compare; + a compare per radius
        steps = npoint - 1 + (1 if nr else 0)
        f32_ops = B * steps * N * (10 + nr)
        t_ops = f32_ops / PEAK_F32
        info = {"bytes": nbytes, "f32_ops": f32_ops}
    else:
        xyz, new_xyz, radius, ns, Bq, a0, b0, W1 = args[:8]
        raw, W0, A, need = kw.get("raw"), kw.get("W0"), kw.get("A"), kw.get("need")
        halves = 2 if kw.get("paired") else 1
        B, N, _ = xyz.shape
        M = new_xyz.shape[1]
        C1, C2 = W1.shape
        es = W1.element_size()
        main = raw if raw is not None else A
        nbytes = (xyz.numel() * 4 + new_xyz.numel() * 4 + main.numel() * es + Bq.numel() * es
                  + W1.numel() * es + (W0.numel() * es if W0 is not None else 0) + 4 * (C1 + C2) * 4
                  + (need.numel() * 4 if need is not None else 0) + B * M * C2 * halves * es)
        real, scanned, _read = search_work(xyz, new_xyz, radius, ns, need)
        mm = real * halves * 2 * ((W0.shape[0] * C1 if W0 is not None else 0) + C1 * C2)
        f32_ops = scanned * 9 + real * halves * (4 * C1 + 3 * C2)
        # bf16 products run on the tensor cores, concurrently with the FP32
        # pipes, so the slower of the two bounds; f32 products share the
        # FP32 pipes with the rest and add to it
        if W1.dtype == torch.bfloat16:
            t_ops = max(mm / PEAK_BF16, f32_ops / PEAK_F32)
        else:
            t_ops = (mm + f32_ops) / PEAK_F32
        info = {"bytes": nbytes, "mm_flops": mm, "f32_ops": f32_ops, "real_slots": real, "scanned": scanned}
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), info


def fps_split(calls, smi) -> list:
    """Row 1's calls of one batch split by what they compute, each timed on
    the recorded inputs in this call: FPS alone, FPS with the per-chunk
    counts, the ``counts_to_bounds`` that turns the counts into the search
    bounds, and the bounds variant the model paths run, which does both."""
    from or4d_tpu_torch.ops import fps
    from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

    out = []
    for name, cargs, _kw, _g in calls:
        if name != "furthest_point_sample_with_bounds":
            continue
        xyz, npoint, scales = cargs
        radii = tuple(r for r, _ns in scales)
        _idx, counts = fps.furthest_point_sample_with_counts(xyz, npoint, radii)
        entry = {"card": smi, "shape": str(tuple(xyz.shape)), "npoint": npoint, "scales": scales,
                 "fps_ms": cuda_ms(lambda: fps.furthest_point_sample(xyz, npoint), 3),
                 "fps_counts_ms": cuda_ms(lambda: fps.furthest_point_sample_with_counts(xyz, npoint, radii), 3),
                 "counts_to_bounds_ms": cuda_ms(lambda: counts_to_bounds(scales, counts), 5),
                 "fps_bounds_ms": cuda_ms(lambda: fps.furthest_point_sample_with_bounds(xyz, npoint, scales), 3)}
        del counts
        out.append(entry)
        emit({"phase": "timing_fps_split", **entry})
    return out


def group_split(calls, smi) -> list:
    """Row 5's forward calls of one step split by what they compute, each
    timed on the recorded geometry and ``need`` in this call: row 5 (search,
    rows built from raw), the plane-mode forward on a (B, N, C) plane (the
    same search, rows copied), and row 8's ball query (the search alone,
    without the ``need`` bound)."""
    from or4d_tpu_torch.ops import ball_query_group as bqg, ball_query_group_raw as bqgr
    from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale

    out = []
    scratch = {"fwd": 0, "bwd": 0}  # the plane-mode launches here count on no path
    for name, a, _kw, _g in calls:
        if name != "ball_query_group_raw":
            continue
        xyz, q, r, ns, W0, raw, need = a
        A = torch.randn(xyz.shape[0], xyz.shape[1], W0.shape[1], device=xyz.device, dtype=W0.dtype)
        entry = {"card": smi, "shape": str((tuple(xyz.shape), q.shape[1], ns, W0.shape[0], W0.shape[1])),
                 "row5_fwd_ms": cuda_ms(lambda: bqgr.group_raw_fwd(xyz, q, r, ns, W0, raw, need), 3),
                 "plane_fwd_ms": cuda_ms(lambda: bqg.group_fwd(xyz, q, r, ns, A, need, scratch), 3),
                 "ball_query_ms": cuda_ms(lambda: ball_query_multiscale(((r, ns),), xyz, q), 3)}
        del A
        out.append(entry)
        emit({"phase": "timing_group_split", **entry})
    return out


def bwd_split(calls, smi, stats) -> list:
    """The plane backward's calls of one step (rows 6 and 9) split, each
    timed on the recorded cotangent and the kernel forward's hit indices in
    this call: the kernel as it stands, the kernel on the first 8 channels
    of ``g`` (the same inverse with an eighth of the rows' bytes), and the
    one PyTorch call that computes the same sums, ``index_add_`` of the
    cotangent rows at the flattened hit indices (every -1 slot sent to an
    extra row; the indices are prepared outside the timed region). The
    ``index_add_`` times add up, per row, to its ``library_ms``."""
    from or4d_tpu_torch.ops import ball_query_group as bqg

    out = []
    scratch = {"fwd": 0, "bwd": 0}  # these launches count on no path
    for name, a, _kw, g in calls:
        if name not in ("ball_query_group", "ball_query_group_gated"):
            continue
        row = "group_gated_bwd" if name == "ball_query_group_gated" else "group_bwd"
        xyz, q, r, ns, A = a[:5]
        need = a[5] if name == "ball_query_group_gated" else None
        B, N, _ = xyz.shape
        C = A.shape[-1]
        g = g.contiguous()
        _out, idx = bqg.group_fwd(xyz, q, r, ns, A, need, scratch)
        del _out
        g8 = g[..., :8].contiguous()
        flat = (torch.arange(B, device=idx.device)[:, None, None] * N + idx.long()).view(-1)
        flat = torch.where(idx.view(-1) >= 0, flat, torch.full_like(flat, B * N))
        dA_ext = torch.zeros(B * N + 1, C, dtype=g.dtype, device=g.device)
        rows = g.view(-1, C)
        entry = {"row": row, "card": smi, "shape": str((tuple(xyz.shape), q.shape[1], ns, C)),
                 "dtype": str(g.dtype),
                 "bwd_ms": cuda_ms(lambda: bqg.group_bwd(idx, g, N, scratch), 3),
                 "bwd_c8_ms": cuda_ms(lambda: bqg.group_bwd(idx, g8, N, scratch), 3),
                 "index_add_ms": cuda_ms(lambda: dA_ext.index_add_(0, flat, rows), 3)}
        del g8, flat, dA_ext, rows, idx
        stats["library_ms"][row] = stats["library_ms"].get(row, 0.0) + entry["index_add_ms"]
        out.append(entry)
        emit({"phase": "timing_bwd_split", **entry})
    return out


def group_jobs(name, a, g, dtype=None):
    """The two kernel calls a recorded grouping call stands for, as
    {row: (kernel(), plain(), bound(), shape, reference())}: the forward,
    and the backward on the kernel forward's hit indices and the recorded
    cotangent ``g``. ``reference`` is what the check holds the kernel
    against: the plain version, but for row 5's dW0 the plain version on
    float64 operands (the float32 product over the step's 10 M slots lands
    up to ~1e-4 of the largest value away from the exact sum, near the
    gate). With ``dtype`` the value operands (A, raw, W0, g) are cast to
    it."""
    from or4d_tpu_torch.ops import ball_query_group as bqg, ball_query_group_raw as bqgr

    cast = (lambda t: t.contiguous()) if dtype is None else (lambda t: t.to(dtype).contiguous())
    g = cast(g)
    es = g.element_size()
    if name == "ball_query_group_raw":
        xyz, q, r, ns, W0, raw, need = a
        W0, raw = cast(W0), cast(raw)
        fwd = lambda: bqgr.group_raw_fwd(xyz, q, r, ns, W0, raw, need)
        fwd_plain = lambda: bqgr.group_raw_fwd_plain(xyz, q, r, ns, W0, raw, need)
        C0, C = W0.shape
        # per support point its raw column; W0 and the bound once
        row_bytes = C0 * es
        other_bytes = W0.numel() * es + (need.numel() * 4 if need is not None else 0)
        prefix = "group_raw"
    else:
        # ball_query_group (row 6), or ball_query_group_gated (row 9) with
        # the FPS counts' bound and counters of its own
        gated = name == "ball_query_group_gated"
        xyz, q, r, ns, A = a[:5]
        A, need, C0, C = cast(A), a[5] if gated else None, 0, A.shape[-1]
        counter = bqg.LAUNCHES_GATED if gated else bqg.LAUNCHES
        fwd = lambda: bqg.group_fwd(xyz, q, r, ns, A, need, counter)
        fwd_plain = lambda: bqg.group_fwd_plain(xyz, q, r, ns, A, need)
        row_bytes, other_bytes = C * es, (need.numel() * 4 if gated else 0)
        prefix = "group_gated" if gated else "group"
    B, N, _ = xyz.shape
    M = q.shape[1]
    slots = B * M * ns
    _out, idx = fwd()
    if prefix == "group_raw":
        bwd = lambda: bqgr.group_raw_bwd(idx, g, raw)
        bwd_plain = lambda: bqgr.group_raw_bwd_plain(idx, g, raw)
        bwd_ref = lambda: bqgr.group_raw_bwd_plain(idx, g.double(), raw.double()).to(g.dtype)
        bwd_out_bytes = C0 * C * es
    else:
        bwd = lambda: bqg.group_bwd(idx, g, N, counter)
        bwd_plain = bwd_ref = lambda: bqg.group_bwd_plain(idx, g, N)
        bwd_out_bytes = B * N * C * es

    def fwd_bound():
        # the points the searches read, the queries, the plane rows (raw
        # columns) of the points hit, and the slots and indices written
        real, scanned, read = search_work(xyz, q, r, ns, need)
        rows = rows_read(idx, N)
        nbytes = 12 * (read + B * M) + rows * row_bytes + other_bytes + slots * (C * es + 4)
        # distances over the scanned points; raw mode also builds each real
        # slot's row (C0 x C multiply-adds)
        return nbytes, scanned * 9 + real * 2 * C0 * C, {"real_slots": real, "scanned": scanned,
                                                          "points_read": read, "rows_read": rows}

    def bwd_bound():
        valid = int((idx >= 0).sum())
        rows = rows_read(idx, N)
        nbytes = slots * (4 + C * es) + (rows * row_bytes if prefix == "group_raw" else 0) + bwd_out_bytes
        return nbytes, valid * (2 * C0 * C if prefix == "group_raw" else C), {"valid_slots": valid, "rows_read": rows}

    shape = (tuple(xyz.shape), M, ns, C0, C)
    return {f"{prefix}_fwd": (fwd, fwd_plain, fwd_bound, shape, fwd_plain),
            f"{prefix}_bwd": (bwd, bwd_plain, bwd_bound, shape, bwd_ref)}


def as_bound(nbytes, f32_ops, info) -> tuple[float, str, dict]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, f32_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), {
        "bytes": nbytes, "f32_ops": f32_ops, **info}


def bwd_close(row, got, want) -> bool:
    """Backward tolerance: BWD_TOL of the largest |value|, plus one bf16 ulp
    of each value in bfloat16 (the f32 sums round once)."""
    scale = float(want.float().abs().max())
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
    return bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=BWD_TOL[row] * scale))


def build_batches(S: int, seed: int):
    from or4d_tpu_torch.config import DatasetConfig
    from or4d_tpu_torch.data.synthetic import make_scene_samples

    # bench.py's scenes: 12 objects x 4000 points, 132 edges x 8000 points
    return make_scene_samples(S, seed=seed, n_objects=9, ds=DatasetConfig(), points_per_obj=2000,
                              pair_shared=True)


def profile_step(run, step_ms: float, groups=None, counted=None) -> dict:
    """Device time of one run by kernel name (torch.profiler, CUDA
    activity): the 12 largest, their sum over all kernels, the busy share of
    the step's host-clock time and the count of device launches. The run is
    made twice in the profiler, a warm-up whose trace is dropped and the
    recorded one: a trace started just before the run can miss its first
    kernels. With ``groups`` ((group, name fragments), ...) also the device
    time and launches split by group (the first whose fragment is in a
    kernel's lower-cased name, else "other") and the host gaps (the run's
    time with no kernel running). ``counted`` ({group: launch counter
    prefixes}) holds the trace against the port's launch counters: a
    group's kernels in the trace must be as many as those counters rose in
    the recorded run, else the trace lost some and the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from or4d_tpu_torch.ops import launch_counts

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        torch.cuda.synchronize()
        prof.step()
        before = launch_counts()
        run()
        torch.cuda.synchronize()
        after = launch_counts()
        prof.step()
    # the kernels and copies themselves (the aten ops that launch them carry
    # the same device time again)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and not e.key.startswith("ProfilerStep")]  # the step's own range on the device timeline
    events.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    out = {"device_ms": device_ms, "busy_share": device_ms / step_ms, "launches": sum(e.count for e in events),
           "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in events[:12]]}
    if groups is not None:
        split = {g: 0.0 for g, _k in groups}
        split["other"] = 0.0
        calls = dict.fromkeys(split, 0)
        for e in events:
            name = e.key.lower()
            g = next((g for g, keys in groups if any(k in name for k in keys)), "other")
            split[g] += e.self_device_time_total / 1e3
            calls[g] += e.count
        out.update(split_ms=split, split_launches=calls, host_gap_ms=max(step_ms - device_ms, 0.0))
        for g, prefixes in (counted or {}).items():
            rose = sum(n - before.get(c, 0) for c, n in after.items() if c.startswith(prefixes))
            out.setdefault("counted", {})[g] = {"trace": calls[g], "counters": rose}
            if calls[g] != rose:
                fail(f"profile: the trace holds {calls[g]} {g} kernels, the launch counters rose by {rose}")
    return out


def sa1_geometries(calls):
    """The SA1 geometries of recorded ``ball_query_group_gated`` calls, one
    per encoder (its scales are consecutive calls on the same clouds):
    [(xyz, new_xyz, ((radius, nsample), ...), (need, ...))]."""
    geoms = []
    for name, a, _kw, _g in calls:
        if name != "ball_query_group_gated":
            continue
        xyz, q, r, ns, _A, need = a
        last = geoms[-1] if geoms else None
        if last and last[0].shape == xyz.shape and torch.equal(last[0], xyz) and torch.equal(last[1], q):
            last[2].append((r, ns))
            last[3].append(need)
        else:
            geoms.append((xyz, q, [(r, ns)], [need]))
    return [(x, q, tuple(sc), tuple(nd)) for x, q, sc, nd in geoms]


def bounds_bound(xyz, new_xyz, scales) -> tuple[float, str, dict]:
    """The bounds pre-pass reads every point for every query (no early
    stop): per pair 3 subtractions, 3 products and 2 sums, then a compare
    and a count per scale on the FP32 pipes; the points, the queries and 2
    floats per query and scale out once over the HBM rate."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    pairs = B * M * N
    nbytes = (xyz.numel() + new_xyz.numel() + 2 * len(scales) * B * M) * 4
    return as_bound(nbytes, pairs * (8 + 2 * len(scales)), {"pairs": pairs})


def check_bounds(geoms, errs, phase) -> list:
    """Row 10 on recorded SA1 geometries: the kernel against its plain
    version, and against the FPS kernel rerun on the same clouds (its
    centroids must be the recorded queries): need equal to counts_to_bounds'
    and to the recorded need, total equal to the sum of the counts. Each
    line names the plan the call ran; a mismatch fails the run."""
    from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds, ball_query_bounds_plain, bounds_plan
    from or4d_tpu_torch.ops.fps import furthest_point_sample_with_counts
    from or4d_tpu_torch.ops.sa_group_mlp import counts_to_bounds

    checks = []
    for xyz, q, scales, needs in geoms:
        got = ball_query_bounds(scales, xyz, q)
        torch.cuda.synchronize()
        want = ball_query_bounds_plain(scales, xyz, q)
        d = max(max_abs_diff(g, w) for gw, ww in zip(got, want) for g, w in zip(gw, ww))
        idx, counts = furthest_point_sample_with_counts(xyz, q.shape[1], tuple(r for r, _ns in scales))
        same_q = torch.equal(torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)), q)
        agree = all(torch.equal(gn, fn) and torch.equal(gt, c.sum(-1)) and torch.equal(gn.int(), rn)
                    for (gn, gt), (fn, _thr), c, rn in zip(got, counts_to_bounds(scales, counts), counts, needs))
        ok = d == 0.0 and same_q and agree
        plan = bounds_plan(xyz.shape[0], xyz.shape[1], q.shape[1], len(scales),
                           torch.cuda.get_device_properties(xyz.device).multi_processor_count)
        checks.append({"row": "ball_query_bounds", "shape": str((tuple(xyz.shape), q.shape[1], scales)),
                       "plan": vars(plan), "max_abs_err": d, "equals_fps_counts": bool(same_q and agree), "ok": ok,
                       "max_need": float(max(g[0].max() for g in got))})
        emit({"phase": phase, **checks[-1]})
        errs["ball_query_bounds"] = max(errs.get("ball_query_bounds", 0.0), d)
        if not ok:
            fail(f"ball_query_bounds disagrees with its plain version or the FPS counts: {checks[-1]}")
    return checks


def check_job(row, shape, dt, kern, ref, errs, phase) -> dict:
    """One grouping kernel call against its reference (``group_jobs``) on
    the same inputs: forwards bit for bit (rows and indices), backwards within
    BWD_TOL and equal to themselves bit for bit across two calls (a fixed
    summation order). Fails the run on a mismatch."""
    got = kern()
    torch.cuda.synchronize()
    want = ref()
    equal = row.endswith("fwd") and all(torch.equal(x, y) for x, y in zip(got, want))
    d = 0.0 if equal else max_abs_diff(got, want)  # a full-size forward's diff in float64 takes GBs
    ok = d == 0.0 if row.endswith("fwd") else bwd_close(row, got, want)
    vals = (got[0] if isinstance(got, tuple) else got).float()
    check = {"row": row, "shape": str(shape), "dtype": str(dt), "max_abs_err": d, "ok": ok,
             "max_abs_value": float(vals.abs().max())}
    del want, vals
    if row.endswith("bwd"):
        check["deterministic"] = bool(torch.equal(kern(), got))
    emit({"phase": phase, **check})
    errs[row] = max(errs.get(row, 0.0), d)
    if not ok:
        fail(f"{row} kernel disagrees with its plain version at {shape} {dt}: max |diff| {d}")
    if not check.get("deterministic", True):
        fail(f"{row} kernel is not deterministic at {shape} {dt}: two calls differ")
    return check


def check_group_calls(calls, errs) -> list:
    """The grouping kernels of recorded train calls (with their cotangents)
    against their plain versions, in float32 and bfloat16. A function of
    its own, so the tensors it makes are freed when it returns."""
    checks = []
    for name, a, _kw, g in calls:
        if g is None:
            fail(f"{name}: no cotangent reached the recorded call")
        for dt in (torch.float32, torch.bfloat16):
            for row, (kern, _p, _b, shape, ref) in group_jobs(name, a, g, dt).items():
                checks.append(check_job(row, shape, dt, kern, ref, errs, "check_train"))
    return checks


def add_timing(stats, row, k_ms, p_ms, b_ms, b_by) -> None:
    for d, v in ((stats["ms"], k_ms), (stats["plain_ms"], p_ms), (stats["bound_ms"], b_ms)):
        d[row] = d.get(row, 0.0) + v
    stats["bound_t"][row][0 if b_by == "bytes" else 1] += b_ms


def time_group_calls(calls, smi, stats) -> list:
    """Each recorded grouping call's kernels on its own full inputs: first
    held against their plain versions (``check_job``: the launch layouts
    that the plans pick for the step's own sizes, which the cut calls of
    check_train do not all reach), then timed beside the plain versions and
    bounds, added to ``stats``."""
    per_call = []
    for name, a, _kw, g in calls:
        for row, (kern, plain, bnd, shape, ref) in group_jobs(name, a, g).items():
            check = check_job(row, shape, torch.float32, kern, ref, stats["errs"], "check_train_full")
            k_ms = cuda_ms(kern, 3)
            p_ms = cuda_ms(plain, 1)
            b_ms, b_by, info = as_bound(*bnd())
            add_timing(stats, row, k_ms, p_ms, b_ms, b_by)
            per_call.append({"row": row, "card": smi, "shape": str(shape), "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": check["max_abs_err"], **info})
            emit({"phase": "timing_train_kernel", **per_call[-1]})
    return per_call


def issue_floor_ms(pairs: int, per_pair: float, sms: int, clock_mhz: float) -> float:
    """The least time for ``pairs`` at ``per_pair`` instructions each (the
    SASS of the kernel's inner loop), one warp instruction a clock on each
    of the card's 4 x ``sms`` SM sub-partitions at its top clock."""
    return 1e3 * pairs * per_pair / 32 / (4 * sms * clock_mhz * 1e6)


def bounds_path(geoms, smi, stats, sass_loop) -> list:
    """Row 10's own path on the recorded step's full SA1 geometries
    (``sa1_geometries``): counters zeroed before, read after; then each
    call held against its plain version and the FPS counts at these sizes
    (``check_bounds``, phase ``check_train_full``: the plans the full calls
    take, which the cut calls of check_train do not all reach); then its
    timings (ROW10_LAUNCHES launches each), beside the issue floor of the
    inner loop that the call's plan runs (``sass_loop``)."""
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
    from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds, ball_query_bounds_plain, bounds_plan

    reset_launch_counts()
    for x, q, sc, _n in geoms:
        ball_query_bounds(sc, x, q)
    torch.cuda.synchronize()
    stats["launches"]["bounds.prepass"] = launch_counts()["bounds.prepass"]
    check_bounds(geoms, stats["errs"], "check_train_full")
    per_call = []
    for x, q, sc, _n in geoms:
        k_ms = cuda_ms(lambda: ball_query_bounds(sc, x, q), ROW10_LAUNCHES)
        p_ms = cuda_ms(lambda: ball_query_bounds_plain(sc, x, q), 1)
        b_ms, b_by, info = bounds_bound(x, q, sc)
        add_timing(stats, "ball_query_bounds", k_ms, p_ms, b_ms, b_by)
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        plan = bounds_plan(x.shape[0], x.shape[1], q.shape[1], len(sc), sms)
        loop = (sass_loop or {}).get(f"bounds_kernel<ILi{len(sc)}ELi{plan.queries}EE>")
        floor = issue_floor_ms(info["pairs"], loop["per_pair"], sms, max_sm_clock_mhz()) if loop else None
        per_call.append({"row": "ball_query_bounds", "card": smi, "shape": str((tuple(x.shape), q.shape[1], sc)),
                         "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "bound_share": b_ms / k_ms, "plan": vars(plan),
                         "instructions_per_pair": loop and loop["per_pair"], "issue_floor_ms": floor, **info})
        emit({"phase": "timing_train_kernel", **per_call[-1]})
    return per_call


def bounds_split(geoms, smi) -> list:
    """Row 10's calls split, each timed on the recorded SA1 geometry in
    this call: every scale at once (as the path runs it), each scale alone,
    and every scale on the first half of the queries. A time that follows
    the pairs and the scales, not the points staged, is held by the
    instructions a pair."""
    from or4d_tpu_torch.ops.ball_query_bounds import ball_query_bounds

    out = []
    for x, q, sc, _n in geoms:
        half = q[:, : q.shape[1] // 2].contiguous()
        n = ROW10_LAUNCHES
        entry = {"card": smi, "shape": str((tuple(x.shape), q.shape[1])), "scales": sc,
                 "pairs": x.shape[0] * x.shape[1] * q.shape[1],
                 "all_scales_ms": cuda_ms(lambda: ball_query_bounds(sc, x, q), n),
                 "scale_ms": [cuda_ms(lambda: ball_query_bounds((s,), x, q), n) for s in sc],
                 "half_queries_ms": cuda_ms(lambda: ball_query_bounds(sc, x, half), n)}
        out.append(entry)
        emit({"phase": "timing_bounds_split", **entry})
    return out


def bounds_timing(seed: int, rounds: int = 20, launches: int = 20) -> None:
    """Row 10 alone at the S=8 ``train_raw=False`` step's two SA1 call
    shapes (96 object clouds of 4000 points and 640 relation clouds of
    8000, 512 FPS centroids each, scales (0.1, 16) and (0.2, 32)), on
    Gaussian clouds made from ``seed`` (the kernel's work does not depend on
    the points: every pair is counted): the plan as it stands and, where
    the package plans its calls (``bounds_plan``), the same plan at 1, 2
    and 4 queries a thread. Each is first held bit for bit against the
    plain version, then timed in ``rounds`` rounds of ``launches`` launches
    (CUDA events), the shapes in turn within a round; per shape the median,
    least and most of its rounds' ms a launch. The package is the one
    beside this script, so a copy of it in another checkout times that
    checkout's kernel."""
    import dataclasses
    import statistics

    from or4d_tpu_torch.ops import ball_query_bounds as bqb
    from or4d_tpu_torch.ops.fps import furthest_point_sample

    smi = nvidia_smi_line()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    scales = ((0.1, 16), (0.2, 32))
    planned = getattr(bqb, "bounds_plan", None)
    for B, N in ((96, 4000), (640, 8000)):
        x = torch.randn(B, N, 3, device="cuda", generator=gen) * 0.5
        q = torch.gather(x, 1, furthest_point_sample(x, 512).long()[..., None].expand(-1, -1, 3)).contiguous()
        want = bqb.ball_query_bounds_plain(scales, x, q)
        shapes = {"planned": None}
        if planned is not None:
            base = planned(B, N, 512, len(scales), torch.cuda.get_device_properties(0).multi_processor_count)
            for k in (1, 2, 4):
                bq = bqb.THREADS * k
                shapes[f"queries_{k}"] = dataclasses.replace(base, queries=k, block_queries=bq,
                                                             blocks=B * -(-512 // bq))
            shapes["planned"] = base
        ms = {name: [] for name in shapes}
        try:
            for name, plan in shapes.items():
                if plan is not None:
                    bqb.bounds_plan = lambda *a, plan=plan: plan
                got = bqb.ball_query_bounds(scales, x, q)
                if not all(torch.equal(g, w) for gw, ww in zip(got, want) for g, w in zip(gw, ww)):
                    fail(f"ball_query_bounds ({name}, {plan}) disagrees with its plain version at {(B, N)}")
            for _ in range(rounds):
                for name, plan in shapes.items():
                    if plan is not None:
                        bqb.bounds_plan = lambda *a, plan=plan: plan
                    ms[name].append(cuda_ms(lambda: bqb.ball_query_bounds(scales, x, q), launches))
        finally:
            if planned is not None:
                bqb.bounds_plan = planned
        for name, plan in shapes.items():
            emit({"phase": "bounds_timing", "card": smi, "shape": str(((B, N, 3), 512, scales)), "shape_of": name,
                  "plan": plan and vars(plan), "median_ms": statistics.median(ms[name]), "min_ms": min(ms[name]),
                  "max_ms": max(ms[name]), "rounds": rounds, "launches": launches})


def train_phases(args, rec, smi, results, stats) -> None:
    """check_train, train and timing_train (see the module docstring), on
    SA1's default raw path and with ``train_raw`` false. Adds the train
    rows' checks, main-path launches and timings to ``stats``."""
    import dataclasses
    import gc
    import math

    from or4d_tpu_torch.config import NO_GT, DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.data.weights import sample_counts, weights_from_counts
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
    from or4d_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    # labeled scenes at paper shapes, one crop per directed edge (train data)
    samples = make_scene_samples(8, seed=args.seed + 100, n_objects=9, ds=DatasetConfig(), points_per_obj=2000)
    weights = weights_from_counts(DEFAULT_VOCAB, *sample_counts(DEFAULT_VOCAB, samples))
    emit({"phase": "train_data", "scenes": len(samples), "host_seconds": time.perf_counter() - t0})

    def trainer(dtype: str, device: str, seed: int, train_raw: bool) -> Trainer:
        tpu = dataclasses.replace(NO_GT.tpu, compute_dtype=dtype, train_raw=train_raw)
        return Trainer(dataclasses.replace(NO_GT, tpu=tpu), DEFAULT_VOCAB, *weights, device=device, seed=seed)

    gen = lambda seed: torch.Generator().manual_seed(seed)
    b8 = SceneBatch.stack(samples)
    errs = stats["errs"]
    # SA1's grouping calls and counters on each path; SA2 takes row 6 on both
    sa1_name = {True: "ball_query_group_raw", False: "ball_query_group_gated"}
    sa1_counters = {True: ("group_raw.fwd", "group_raw.bwd"), False: ("group_gated.fwd", "group_gated.bwd")}

    # check_train: the grouping kernels on one S=8 step's inputs and
    # cotangents per path (row 6 on the raw step's), row 10 on the other's
    checks = []
    for train_raw in (True, False):
        tr = trainer("float32", "cuda", args.seed, train_raw)
        names = ("ball_query_group", sa1_name[True]) if train_raw else (sa1_name[False],)
        calls = [c for c in rec.record(lambda: tr.train_step(b8, gen(1)), rows=64) if c[0] in names]
        torch.cuda.synchronize()
        del tr
        checks += check_group_calls(calls, errs)
        if not train_raw:
            checks += check_bounds(sa1_geometries(calls), errs, "check_train")
        del calls
    results["check_train"] = checks

    # train: three steps of each path's main path, its counters rise and
    # the other path's SA1 counters do not; then S=1 card vs CPU
    b1 = SceneBatch.stack(samples[:1])
    for train_raw in (True, False):
        tr = trainer("float32", "cuda", args.seed, train_raw)
        reset_launch_counts()
        t0 = time.perf_counter()
        losses = [{k: float(v) for k, v in tr.train_step(b8, gen(2 + k)).items()} for k in range(3)]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        rows = TRAIN_ROWS if train_raw else GATED_ROWS
        stats["launches"].update({c: launches[c] for _r, c, _s, _p in rows})
        f1 = tr.evaluate([b8])
        train = {"scenes": 8, "dtype": "float32", "train_raw": train_raw, "losses": losses, "seconds": train_s,
                 "launches": launches, "macro_f1": f1}
        missing = [c for c in ("fps.fps_bounds", "fps.fps", "group.fwd", "group.bwd", *sa1_counters[train_raw])
                   if launches.get(c, 0) == 0]
        stray = [c for c in sa1_counters[not train_raw] if launches.get(c, 0) != 0]
        if missing or stray:
            fail(f"train_raw={train_raw}: kernels not launched {missing}, other path's kernels launched {stray} "
                 f"({launches})")
        if not all(math.isfinite(v) for d in losses for v in d.values()) or not math.isfinite(f1):
            fail(f"non-finite train losses or macro F1: {losses}, {f1}")
        del tr

        # one float32 S=1 step on the card and on the CPU: same weights and draws
        tg, tc = (trainer("float32", dev, args.seed + 1, train_raw) for dev in ("cuda", "cpu"))
        pg = tg.train_step(b1, gen(5))
        t0 = time.perf_counter()
        pc = tc.train_step(b1, gen(5))
        cpu_s = time.perf_counter() - t0
        d_loss = max(abs(float(pg[k]) - float(pc[k])) for k in pg)
        # differences against the model's largest gradient and parameter: a
        # gradient that is rounding noise on both sides (a Dense bias feeding a
        # BN) has no scale of its own, and AdamW moves every parameter by about
        # +-lr whatever the size of its gradient
        gscale = max(float(p.grad.abs().max()) for p in tc.model.parameters())
        pscale = max(float(p.detach().abs().max()) for p in tc.model.parameters())
        d_grad = d_param = 0.0
        worst = ""
        for (k, pgr), (_k, pcp) in zip(tg.model.named_parameters(), tc.model.named_parameters()):
            dg = float((pgr.grad.cpu() - pcp.grad).abs().max()) / gscale
            if dg > d_grad:
                d_grad, worst = dg, k
            d_param = max(d_param, float((pgr.detach().cpu() - pcp.detach()).abs().max()) / pscale)
        train.update({"s1_loss_max_abs_diff": d_loss, "s1_grad_max_diff_of_largest": d_grad,
                      "s1_grad_worst": worst, "s1_param_max_diff_of_largest": d_param, "cpu_reference_seconds": cpu_s})
        results["train" if train_raw else "train_raw_false"] = train
        emit({"phase": "train", **train})
        # gradients: 1e-2 of the largest, not 1e-3: the card's and the CPU's
        # forwards differ by ~1e-5, which flips the SA max-pool's winning slot
        # for a few (query, channel) pairs and moves that slot's whole gradient
        if d_loss > 1e-4 or d_grad > 1e-2 or d_param > 1e-3:
            fail(f"S=1 float32 train step (train_raw={train_raw}) card vs CPU differs: loss {d_loss}, "
                 f"grad {d_grad} ({worst}), param {d_param}")
        del tg, tc

    # timing_train: step time and peak memory per path and dtype, then each
    # SA1 path's grouping kernels on its float32 step's own inputs
    timing = []
    per_call = []

    for train_raw in (True, False):
        timed_calls = None
        for dtype in ("float32", "bfloat16"):
            for S in (8, 4, 2):
                tt = None
                torch.cuda.reset_peak_memory_stats()
                try:
                    tt = trainer(dtype, "cuda", args.seed, train_raw)
                    batch = SceneBatch.stack(samples[:S])
                    tt.train_step(batch, gen(11))  # warm-up
                    torch.cuda.synchronize()
                    reset_launch_counts()
                    tt.train_step(batch, gen(12))
                    torch.cuda.synchronize()
                    per_step = launch_counts()
                    reps = 3
                    t0 = time.perf_counter()
                    for k in range(reps):
                        tt.train_step(batch, gen(13 + k))
                    torch.cuda.synchronize()
                    step_ms = 1e3 * (time.perf_counter() - t0) / reps
                    rec_ = {"card": smi, "train_raw": train_raw, "dtype": dtype, "scenes": S, "step_ms": step_ms,
                            "scenes_per_s": S / (step_ms / 1e3), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                            "launches_per_step": per_step}
                    if dtype == "float32":
                        rec_["profile"] = profile_step(lambda: tt.train_step(batch, gen(19)), step_ms)
                        # rows 5 and 6 from the raw step; row 9 from the other
                        names = ("ball_query_group", sa1_name[True]) if train_raw else (sa1_name[False],)
                        timed_calls = [c for c in rec.record(lambda: tt.train_step(batch, gen(20))) if c[0] in names]
                        torch.cuda.synchronize()
                    timing.append(rec_)
                    emit({"phase": "timing_train", **rec_})
                    break
                except torch.cuda.OutOfMemoryError:
                    oom = {"card": smi, "train_raw": train_raw, "dtype": dtype, "scenes": S, "oom": True,
                           "peak_mem_bytes": torch.cuda.max_memory_allocated()}
                    timing.append(oom)
                    emit({"phase": "timing_train", **oom})
                finally:
                    tt = batch = None
                    gc.collect()
                    torch.cuda.empty_cache()
            else:
                fail(f"no train step (train_raw={train_raw}) fits in {dtype} at S = 8, 4 or 2")
            if dtype != "float32":
                continue
            # the kernels on the float32 step's inputs, freed before bfloat16
            per_call += time_group_calls(timed_calls, smi, stats)
            results.setdefault("timing_bwd_split", []).extend(bwd_split(timed_calls, smi, stats))
            if train_raw:
                results["timing_group_split"] = group_split(timed_calls, smi)
            else:
                geoms = sa1_geometries(timed_calls)
                per_call += bounds_path(geoms, smi, stats, results["build"]["sass_bounds_loop"])
                results["timing_bounds_split"] = bounds_split(geoms, smi)
                del geoms
            timed_calls = None
            gc.collect()
            torch.cuda.empty_cache()
    results["timing_train"] = {"steps": timing, "per_call": per_call}


def scan_ends(xyz, new_xyz, radius, ns, chunk_bound=False):
    """(B, M) points each query's scan-order search for ``ns`` hits reads
    on these inputs: through its ns-th hit, or all N points when it has
    fewer. With ``chunk_bound`` a query with fewer hits stops at the end of
    the 512-point chunk of its last hit (the FPS counts' ``need`` bound;
    the first chunk when it has none)."""
    from or4d_tpu_torch.ops.ball_query import ball_query_with_counts
    from or4d_tpu_torch.ops.fps import CHUNK

    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    ends = []
    step = max(1, (1 << 26) // (M * N))
    for s in range(0, B, step):
        idx, total = ball_query_with_counts(radius, ns, xyz[s:s + step], new_xyz[s:s + step])
        last = idx[..., ns - 1] + 1 if ns <= N else torch.full_like(total, N)
        short = torch.full_like(last, N)
        if chunk_bound:
            thr = total.clamp(max=ns)
            last_hit = torch.gather(idx, 2, (thr - 1).clamp(min=0)[..., None])[..., 0] + 1
            need = torch.where(thr > 0, (last_hit + CHUNK - 1) // CHUNK, torch.ones_like(last_hit))
            short = (need * CHUNK).clamp(max=N)
        ends.append(torch.where(total >= ns, last, short))
    return torch.cat(ends)


def multiscale_split(calls, smi) -> list:
    """Row 8's calls of one cache build split by scale, each timed on the
    recorded inputs in this call: every scale in one launch and each scale
    alone, beside the points the searches read (``scan_ends``: a query
    reads until every scale has its ns hits, the whole cloud where one has
    fewer) and the points they would read with the FPS counts' chunk bound
    (which the cache build's FPS does not compute)."""
    from or4d_tpu_torch.ops.ball_query_multiscale import ball_query_multiscale

    out = []
    for _name, (scales, xyz, q), _kw, _g in calls:
        ends = [scan_ends(xyz, q, r, ns) for r, ns in scales]
        bounded = [scan_ends(xyz, q, r, ns, chunk_bound=True) for r, ns in scales]
        entry = {"card": smi, "shape": str((tuple(xyz.shape), q.shape[1])), "scales": scales,
                 "all_scales_ms": cuda_ms(lambda: ball_query_multiscale(scales, xyz, q), 3),
                 "scale_ms": [cuda_ms(lambda: ball_query_multiscale((sc,), xyz, q), 3) for sc in scales],
                 "points_read": int(torch.stack(ends).amax(0).sum()),
                 "points_read_per_scale": [int(e.sum()) for e in ends],
                 "points_read_with_chunk_bound": int(torch.stack(bounded).amax(0).sum()),
                 "queries": int(q.shape[0] * q.shape[1])}
        out.append(entry)
        emit({"phase": "timing_multiscale_split", **entry})
    return out


def serving_bound(name, args) -> tuple[float, str, dict]:
    """(least ms, "bytes"/"operations", counts) of one serving-path call on
    these inputs. Ball query: xyz, queries and indices once over the HBM
    rate against one distance (9 f32 operations, plus a compare per further
    scale) per point read, a query reading until every scale has its ns
    hits. Serving MLP: planes (as stored, 8 channels), Bq, weights and
    output once, against the W0 and W1 products (tensor cores in bfloat16,
    FP32 pipes in float32) and the f32 affine/ReLU/max work on the FP32
    pipes."""
    if name == "ball_query_multiscale":
        scales, xyz, new_xyz = args
        B, N, _ = xyz.shape
        M = new_xyz.shape[1]
        ends = torch.stack([scan_ends(xyz, new_xyz, r, ns) for r, ns in scales]).amax(0)
        scanned = int(ends.sum())
        nbytes = xyz.numel() * 4 + new_xyz.numel() * 4 + B * M * sum(ns for _r, ns in scales) * 4
        return as_bound(nbytes, scanned * (9 + len(scales) - 1), {"scanned": scanned, "queries": B * M})
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
    info = {"bytes": nbytes, "mm_flops": mm, "f32_ops": f32_ops, "slots": slots}
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), info


def sa1_serving_vs_cold(model, batch, pack) -> dict:
    """Per encoder and SA1 scale, max |diff| between the serving SA1 stage
    (the serving MLP on the batch's caches) and the cold one (FPS with
    bounds, the fused SA stage in raw mode) on the same unpaired crops; inf
    where the centroids differ."""
    from or4d_tpu_torch import serving

    caches = serving.build_sgpn_sa1_caches(model, batch, pack)
    S, O, Po, Co = batch.obj_points.shape
    _, E, Pr, Cr = batch.rel_points.shape
    crops = (batch.obj_points.reshape(S * O, Po, Co).float()[pack.obj_idx],
             batch.rel_points.reshape(S * E, Pr, Cr).float()[pack.edge_idx])
    out = {}
    for key, enc, pc, cache in zip(("obj", "rel"), (model.obj_encoder, model.rel_encoder), crops, caches):
        q_cold, cold = enc.sa1(pc[..., :3].contiguous(), pc[..., 3:])
        q_served, served = enc.sa1(None, None, cache=cache)
        c0 = 0
        for si, sc in enumerate(enc.sa1.scales):
            c2 = sc.mlp[-1]
            same_q = torch.equal(q_cold, q_served)
            out[f"{key}_scale{si}"] = max_abs_diff(served[..., c0:c0 + c2], cold[..., c0:c0 + c2]) if same_q else \
                float("inf")
            c0 += c2
    return out


def eval_stages(model, batch, pack=None, sa1_caches=None) -> dict:
    """One eval forward of an SGPN (cold, or serving with ``sa1_caches``),
    its outputs stage by stage: per encoder ("obj", "rel") SA1's centroids
    and features and SA2's and SA3's features; the GCN's node and edge
    inputs and outputs; both heads' log-probs (forward hooks)."""
    out, hooks = {}, []

    def keep(name, pick):
        return lambda _m, args, res: out.__setitem__(name, pick(args, res).detach())

    for key, enc in (("obj", model.obj_encoder), ("rel", model.rel_encoder)):
        hooks += [enc.sa1.register_forward_hook(keep(f"{key}_sa1_xyz", lambda a, r: r[0])),
                  enc.sa1.register_forward_hook(keep(f"{key}_sa1", lambda a, r: r[1])),
                  enc.sa2.register_forward_hook(keep(f"{key}_sa2", lambda a, r: r[1])),
                  enc.sa3.register_forward_hook(keep(f"{key}_sa3", lambda a, r: r))]
    for i, part in enumerate(("obj", "rel")):
        hooks += [model.gcn.register_forward_hook(keep(f"gcn_in_{part}", lambda a, r, i=i: a[i])),
                  model.gcn.register_forward_hook(keep(f"gcn_out_{part}", lambda a, r, i=i: r[i]))]
    hooks += [model.obj_predictor.register_forward_hook(keep("obj_head", lambda a, r: r)),
              model.rel_predictor.register_forward_hook(keep("rel_head", lambda a, r: r))]
    try:
        with torch.no_grad():
            model(batch, pack, sa1_caches=sa1_caches)
    finally:
        for h in hooks:
            h.remove()
    return out


def run_serving_call(name, args, plain: bool):
    from or4d_tpu_torch.ops import ball_query_multiscale as bqm, serving_sa1_mlp as ssm

    if name == "ball_query_multiscale":
        return (bqm.ball_query_multiscale_plain if plain else bqm.ball_query_multiscale)(*args)
    return (ssm.serving_sa1_mlp_plain if plain else ssm.serving_sa1_mlp)(*args)


def serving_phases(args, rec, smi, results, stats) -> None:
    """check_serving, serving and timing_serving (see the module
    docstring). Adds the serving rows' checks, main-path launches and
    timings to ``stats``."""
    import dataclasses
    import gc
    import math

    from or4d_tpu_torch import serving
    from or4d_tpu_torch.config import NO_GT, DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
    from or4d_tpu_torch.train.loop import Trainer

    t0 = time.perf_counter()
    # bench.py --serving's scenes: 9 objects, one crop per directed edge
    S = args.scenes
    samples = make_scene_samples(max(S, 8), seed=args.seed + 200, n_objects=9, ds=DatasetConfig(),
                                 points_per_obj=2000)
    emit({"phase": "serving_data", "scenes": len(samples), "host_seconds": time.perf_counter() - t0})
    errs = stats["errs"]
    strip = lambda b: serving._strip_points(b).to("cuda")
    cfg = dataclasses.replace(NO_GT, tpu=dataclasses.replace(NO_GT.tpu, compute_dtype="bfloat16"))
    ones = (torch.ones(DEFAULT_VOCAB.num_classes).numpy(), torch.ones(DEFAULT_VOCAB.num_relations).numpy())
    trainer = Trainer(cfg, DEFAULT_VOCAB, *ones, device="cuda", seed=args.seed)
    model = trainer.model
    torch.set_grad_enabled(False)

    # check_serving: both kernels on an S=8 cache build's and forward's inputs
    b8 = SceneBatch.stack(samples[:8])
    p8 = SlotPack.build(b8).to("cuda")

    def s8():
        caches = serving.build_sgpn_sa1_caches(model, b8.to("cuda"), p8)
        model(strip(b8), p8, sa1_caches=caches)

    calls = [c for c in rec.record(s8) if c[0] in ("ball_query_multiscale", "serving_sa1_mlp")]
    torch.cuda.synchronize()
    checks = []
    for name, cargs, _kw, _g in calls:
        if name == "ball_query_multiscale":
            jobs = [(None, (cargs[0], cargs[1][:64].contiguous(), cargs[2][:64].contiguous()))]
        else:
            jobs = [(dt, tuple(a[:64].contiguous() if i < 2 else a for i, a in enumerate(cargs)))
                    for dt in (torch.bfloat16, torch.float32)]
            jobs = [(dt, tuple(a.to(dt) if i in (0, 1, 2, 5) else a for i, a in enumerate(ja))) for dt, ja in jobs]
        for dt, ja in jobs:
            got = run_serving_call(name, ja, plain=False)
            torch.cuda.synchronize()
            want = run_serving_call(name, ja, plain=True)
            if dt is None:
                d = max(max_abs_diff(g, w) for g, w in zip(got, want))
                ok = d == 0.0
                shape = (tuple(ja[1].shape), ja[2].shape[1], ja[0])
                vals = torch.cat([g.flatten() for g in got]).float()
            else:
                d = max_abs_diff(got, want)
                ok = torch.allclose(got.float(), want.float(), rtol=SA_TOL[dt], atol=SA_TOL[dt])
                shape = (tuple(ja[0].shape), tuple(ja[5].shape))
                vals = got.float()
            checks.append({"row": name, "shape": str(shape), "dtype": str(dt), "max_abs_err": d, "ok": bool(ok),
                           "max_abs_value": float(vals.abs().max())})
            emit({"phase": "check_serving", **checks[-1]})
            errs[name] = max(errs.get(name, 0.0), d)
            if not ok:
                fail(f"{name} kernel disagrees with its plain version at {shape} {dt}: max |diff| {d}")
    # the serving SA1 stage against the cold one on the same S=8 crops, in
    # bfloat16: the same tile code, so bit for bit
    sa1 = sa1_serving_vs_cold(model, b8.to("cuda"), p8)
    checks.append({"row": "serving_sa1_vs_cold_sa1", "dtype": str(torch.bfloat16), "max_abs_err_per_scale": sa1,
                   "ok": all(d == 0.0 for d in sa1.values())})
    emit({"phase": "check_serving", **checks[-1]})
    if not checks[-1]["ok"]:
        fail(f"bfloat16 serving SA1 differs from the cold SA1 stage on the same crops: {sa1}")
    results["check_serving"] = checks
    del calls, got, want, vals, jobs

    # serving: the evaluator end to end, then from its cache files
    cache_dir = Path(args.out) / "serving_cache"
    shutil.rmtree(cache_dir, ignore_errors=True)  # this run's own files only
    reset_launch_counts()
    t0 = time.perf_counter()
    ev = serving.ServingEvaluator(trainer, [b8], cache_dir=cache_dir)
    f1 = ev.evaluate()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = launch_counts()
    stats["launches"].update({c: launches[c] for _r, c, _s, _p in SERVING_ROWS})
    missing = [c for c in ("fps.fps", "sa_group_mlp.plane", *(r[1] for r in SERVING_ROWS)) if launches.get(c, 0) == 0]
    if missing:
        fail(f"kernels not launched on the serving path: {missing} ({launches})")
    if not math.isfinite(f1):
        fail(f"serving macro F1 is not finite: {f1}")
    reset_launch_counts()
    f1_loaded = serving.ServingEvaluator(trainer, [b8], cache_dir=cache_dir).evaluate()
    loaded_launches = launch_counts()
    files = sorted(p.name for p in cache_dir.glob("sa1_*.npz"))
    if loaded_launches["ball_query.multiscale"] != 0 or len(files) != 1 or abs(f1_loaded - f1) > 1e-9:
        fail(f"the second evaluator did not serve from its cache file: {files}, {loaded_launches}, "
             f"F1 {f1_loaded} vs {f1}")
    shutil.rmtree(cache_dir)  # hundreds of MB of planes, not an output
    # bfloat16 S=8: serving against the cold unpaired forward
    caches8 = ev.batches[0][2]
    d_bf16 = float((model(strip(b8), p8, sa1_caches=caches8).rel_logprobs
                    - model(b8.to("cuda"), p8).rel_logprobs).abs().max())
    del ev, caches8
    # float32 S=1: card vs CPU, and serving vs cold on the card
    b1 = SceneBatch.stack(samples[:1])
    pack1 = SlotPack.build(b1, bucket=8)
    m_gpu, m_cpu = SGPN(device="cuda", seed=args.seed + 1), SGPN(device="cpu", seed=args.seed + 1)

    def serve(m, dev):
        pk = pack1.to(dev)
        return m(serving._strip_points(b1).to(dev), pk,
                 sa1_caches=serving.build_sgpn_sa1_caches(m, b1.to(dev), pk))

    out_gpu = serve(m_gpu, "cuda")
    t0 = time.perf_counter()
    out_cpu = serve(m_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    cold = m_gpu(b1.to("cuda"), pack1.to("cuda"))
    em, om = torch.from_numpy(b1.edge_mask), torch.from_numpy(b1.obj_mask)
    d_rel = float((out_gpu.rel_logprobs.cpu()[em] - out_cpu.rel_logprobs[em]).abs().max())
    d_obj = float((out_gpu.obj_logprobs.cpu()[om] - out_cpu.obj_logprobs[om]).abs().max())
    d_cold = max(float((out_gpu.rel_logprobs - cold.rel_logprobs).abs().max()),
                 float((out_gpu.obj_logprobs - cold.obj_logprobs).abs().max()))
    # stage by stage, each path also against a second run of itself: every
    # stage runs in one order on every run, so all bit-equal
    pk1 = pack1.to("cuda")
    caches1 = serving.build_sgpn_sa1_caches(m_gpu, b1.to("cuda"), pk1)
    served_st = [eval_stages(m_gpu, strip(b1), pk1, caches1) for _ in range(2)]
    cold_st = [eval_stages(m_gpu, b1.to("cuda"), pk1) for _ in range(2)]
    stages = {"serving_vs_cold": {k: max_abs_diff(v, cold_st[0][k]) for k, v in served_st[0].items()},
              "cold_vs_cold": {k: max_abs_diff(v, cold_st[0][k]) for k, v in cold_st[1].items()},
              "serving_vs_serving": {k: max_abs_diff(v, served_st[0][k]) for k, v in served_st[1].items()}}
    del caches1, served_st, cold_st
    finite = bool(torch.isfinite(out_gpu.rel_logprobs).all() and torch.isfinite(out_gpu.obj_logprobs).all())
    srv = {"scenes": 8, "dtype": "bfloat16", "macro_f1": f1, "macro_f1_from_cache_files": f1_loaded,
           "cache_files": files, "seconds": serve_s, "launches": launches,
           "launches_loading_cache": loaded_launches, "bf16_s8_serving_vs_cold_max_abs_diff": d_bf16,
           "f32_s1_rel_max_abs_diff": d_rel, "f32_s1_obj_max_abs_diff": d_obj,
           "f32_s1_serving_vs_cold_max_abs_diff": d_cold,
           "f32_s1_stages_max_abs_diff": stages,
           "cpu_reference_seconds": cpu_s, "finite": finite}
    results["serving"] = srv
    emit({"phase": "serving", **srv})
    if not finite or d_rel > 1e-3 or d_obj > 1e-3 or d_cold > 1e-4 or d_bf16 > 1e-4:
        fail(f"serving differs: S=1 float32 card vs CPU rel {d_rel} obj {d_obj}, vs cold {d_cold}; "
             f"S=8 bfloat16 vs cold {d_bf16}")
    parted = {f"{pair}: {k}": d for pair, per in stages.items() for k, d in per.items() if d != 0.0}
    if d_cold != 0.0 or parted:
        fail(f"S=1 float32 forwards part (serving vs cold {d_cold}): {parted}")
    del m_gpu, m_cpu, out_gpu, out_cpu, cold

    # timing_serving: the S=64 bf16 batch, caches resident
    bS = SceneBatch.stack(samples[:S])
    del samples
    pS = SlotPack.build(bS).to("cuda")
    full = bS.to("cuda")
    torch.cuda.synchronize()
    built = []
    t0 = time.perf_counter()
    build_calls = [c for c in rec.record(lambda: built.append(serving.build_sgpn_sa1_caches(model, full, pS)))
                   if c[0] == "ball_query_multiscale"]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    caches = built[0]
    del full, built
    gc.collect()
    torch.cuda.empty_cache()
    per_call = []

    def check_full(name, cargs):
        """Row 8 exactly against its plain version on the S-scene build's
        own inputs: the launch layout its plan picks at full size."""
        got = run_serving_call(name, cargs, plain=False)
        torch.cuda.synchronize()
        want = run_serving_call(name, cargs, plain=True)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        check = {"row": name, "shape": str((tuple(cargs[1].shape), cargs[2].shape[1], cargs[0])), "ok": equal}
        del got, want
        emit({"phase": "check_serving_full", **check})
        if not equal:
            fail(f"{name} kernel disagrees with its plain version on the S={S} cache build's inputs: {check}")
        results.setdefault("check_serving_full", []).append(check)

    def time_calls(calls, reps):
        for name, cargs, _kw, _g in calls:
            if name == "ball_query_multiscale":
                check_full(name, cargs)
            k_ms = cuda_ms(lambda: run_serving_call(name, cargs, plain=False), reps)
            p_ms = cuda_ms(lambda: run_serving_call(name, cargs, plain=True), 1)
            b_ms, b_by, info = serving_bound(name, cargs)
            for d, v in ((stats["ms"], k_ms), (stats["plain_ms"], p_ms), (stats["bound_ms"], b_ms)):
                d[name] = d.get(name, 0.0) + v
            stats["bound_t"][name][0 if b_by == "bytes" else 1] += b_ms
            shape = tuple((cargs[1] if name == "ball_query_multiscale" else cargs[0]).shape)
            per_call.append({"row": name, "card": smi, "shape": str(shape), "ms": k_ms, "plain_ms": p_ms,
                             "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms, **info})
            emit({"phase": "timing_serving_kernel", **per_call[-1]})

    time_calls(build_calls, 3)
    results["timing_multiscale_split"] = multiscale_split(build_calls, smi)
    del build_calls
    bst = strip(bS)
    model(bst, pS, sa1_caches=caches)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    bodies = reset_bodies()
    torch.cuda.reset_peak_memory_stats()
    model(bst, pS, sa1_caches=caches)
    torch.cuda.synchronize()
    per_batch = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if bodies["fp32"] != 0 or bodies["mma"] == 0:
        fail(f"the S={S} bfloat16 serving batch did not run the SA tensor-core body only: {bodies}")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = model(bst, pS, sa1_caches=caches)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0) / reps
    e2e = {"card": smi, "scenes": S, "dtype": "bfloat16", "batch_ms": batch_ms, "scenes_per_s": S / (batch_ms / 1e3),
           "peak_mem_bytes": peak, "cache_build_host_seconds": build_s,
           "cache_bytes": sum(c.nbytes for c in caches), "object_rows": int(pS.obj_idx.numel()),
           "relation_rows": int(pS.edge_idx.numel()), "launches_per_batch": per_batch,
           "sa_body_launches": dict(bodies),
           "finite": bool(torch.isfinite(out.rel_logprobs).all())}
    e2e["profile"] = profile_step(lambda: model(bst, pS, sa1_caches=caches), batch_ms)
    emit({"phase": "timing_serving", **e2e})
    if not e2e["finite"]:
        fail(f"S={S} bfloat16 serving log-probs are not finite")
    fwd_calls = [c for c in rec.record(lambda: model(bst, pS, sa1_caches=caches)) if c[0] == "serving_sa1_mlp"]
    torch.cuda.synchronize()
    time_calls(fwd_calls, 5)
    results["timing_serving"] = {"e2e": e2e, "per_call": per_call}
    torch.set_grad_enabled(True)
    del fwd_calls, caches, bst, pS, out, model, trainer
    gc.collect()
    torch.cuda.empty_cache()


# TPU kernel row 2 as L2 (instance-labels) calls it: box grids and limb
# clouds -> 200 samples; its own entry in the kernels line, per call
L2_ROW = ("fps_l2", "fps.fps", "or4d_tpu_torch/ops/csrc/fps.cu", "or4d_tpu/ops/pallas_fps.py:200")
# the kernels each CLI stage of the disk phase must launch (counters)
DISK_KERNELS = {
    "instance-labels": ("fps.fps",),
    "train": ("fps.fps_bounds", "fps.fps", "group_raw.fwd", "group_raw.bwd", "group.fwd", "group.bwd",
              "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "evaluate": ("fps.fps_bounds", "fps.fps", "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "evaluate_serving": ("fps.fps", "ball_query.multiscale", "serving_sa1.mlp", "sa_group_mlp.plane"),
    "infer": ("fps.fps_bounds", "fps.fps", "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "infer_torch_checkpoint": ("fps.fps_bounds", "fps.fps", "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "train_image": ("fps.fps_bounds", "fps.fps", "group_raw.fwd", "group_raw.bwd", "group.fwd", "group.bwd",
                    "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "evaluate_image": ("fps.fps_bounds", "fps.fps", "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "infer_image": ("fps.fps_bounds", "fps.fps", "sa_group_mlp.raw", "sa_group_mlp.plane"),
    "instance-labels-from-gt": ("fps.fps_large",),
    "detect-train": ("fps.fps_large", "fps.fps", "ball_query.multiscale"),
    "detect-infer": ("fps.fps_large", "fps.fps", "ball_query.multiscale"),
    "instance-labels-detect-boxes": ("fps.fps",),
}
FIXTURE = Path(__file__).resolve().parent / "tests" / "golden" / "real_data"
L2_BOUNDARY_MM2 = 2.0  # a label may flip only this close to a distance test's threshold^2


def run_cli(argv, log) -> tuple[float, dict, str]:
    """``or4d_tpu_torch.cli.main(argv)`` with its counters zeroed just before
    and read just after: (host seconds, launches, its standard output, also
    appended to ``log``)."""
    import contextlib
    import io

    from or4d_tpu_torch import cli
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts

    buf = io.StringIO()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    out = buf.getvalue()
    with open(log, "a") as f:
        f.write(f"$ cli {' '.join(argv)}\n{out}\n")
    if rc != 0:
        fail(f"cli {argv[0]} exited {rc}")
    return seconds, launches, out


def l2_label_diffs(card_dir: Path, cpu_dir: Path, root: Path, tests) -> dict:
    """Every label npz of the card run against the ``--device cpu`` run:
    differing points, each only within L2_BOUNDARY_MM2 of some distance
    test's threshold^2 (the f32 expansion rounds apart there)."""
    import numpy as np

    from or4d_tpu_torch.data.pcd_io import read_pcd

    files = sorted(p.name for p in card_dir.glob("*.npz"))
    if not files or files != sorted(p.name for p in cpu_dir.glob("*.npz")):
        fail(f"instance-labels wrote different files on the card and the CPU: {files}")
    n_diff, worst, listed = 0, 0.0, []
    for name in files:
        a, b = np.load(card_dir / name)["arr_0"], np.load(cpu_dir / name)["arr_0"]
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{name}: labels {a.dtype}{a.shape} on the card, {b.dtype}{b.shape} on the CPU")
        idx = np.nonzero(a != b)[0]
        if len(idx) == 0:
            continue
        take, scan = name[:-4].split("_")
        pts = read_pcd(root / f"export_holistic_take{take}_processed" / "pcds" / f"{scan}.pcd")[idx, :3]
        for i, p in zip(idx, pts.astype(np.float64)):
            near = min(abs(float(((s - p) ** 2).sum(1).min()) - thr * thr) for s, thr in tests)
            listed.append((name, int(i), int(a[i]), int(b[i]), near))
            worst = max(worst, near)
        n_diff += len(idx)
    if worst > L2_BOUNDARY_MM2:
        fail(f"L2 labels on the card differ from the CPU's away from every threshold: {listed}")
    return {"files": len(files), "differing_points": n_diff, "max_threshold_distance_mm2": worst,
            "points": listed[:20]}


def detect_stages(root: Path, tmp: Path, seed: int, log: Path, stages: dict, launches: dict) -> dict:
    """Group-Free from disk on ``root`` (after its instance labels):
    ``perception --task detect-train`` (one epoch, batches of 2, a
    checkpoint), ``--task detect-infer --split test`` from it on the card and
    with ``--device cpu`` (the same files and keys, classes equal, boxes and
    scores within 1e-4 of their largest value), then ``instance-labels
    --boxes-dir`` on the card's boxes. Host seconds into ``stages``,
    counters into ``launches``; returns the summary."""
    import numpy as np

    from or4d_tpu_torch.pipeline.instance_labels import load_boxes_npz

    ck, preds, preds_cpu = tmp / "ck_detect", tmp / "gf_preds", tmp / "gf_preds_cpu"
    base = ["perception", "--data-root", str(root), "--checkpoint-dir", str(ck), "--seed", str(seed)]
    stages["detect_train"], launches["detect-train"], text = run_cli([*base, "--task", "detect-train"], log)
    losses = [float(line.split("loss=")[1].split()[0]) for line in text.splitlines() if "detect epoch" in line]
    infer = [*base, "--task", "detect-infer", "--split", "test"]
    stages["detect_infer"], launches["detect-infer"], text = run_cli([*infer, "--output-dir", str(preds)], log)
    t0 = time.perf_counter()
    run_cli([*infer, "--output-dir", str(preds_cpu), "--device", "cpu"], log)
    stages["detect_infer_cpu"] = time.perf_counter() - t0
    files = sorted(p.name for p in preds.glob("*.npz"))
    if not files or files != sorted(p.name for p in preds_cpu.glob("*.npz")) or "RANDOM INITIALIZATION" in text:
        fail(f"detect-infer wrote different files on the card and the CPU, or ran without the checkpoint: {files}")
    worst, boxes_nms = 0.0, 0
    for name in files:
        got, want = load_boxes_npz(preds / name), load_boxes_npz(preds_cpu / name)
        if set(got) != set(want) or any(got[k].shape != want[k].shape or got[k].dtype != want[k].dtype for k in got):
            fail(f"detect-infer {name}: card and CPU box dicts differ in keys, shapes or dtypes")
        # boxes come in candidate (logit) or score order, which two nearly
        # equal values may swap between the card and the CPU: rows are
        # matched one to one, of the same class, nearest first
        for sfx in ("", "_nms"):
            rows = [np.concatenate([d["bboxes" + sfx], d["scores" + sfx][:, None]], 1) for d in (got, want)]
            if not len(rows[1]):
                continue
            scale = np.abs(rows[1]).max(0)
            cost = (np.abs(rows[0][:, None] - rows[1][None]) / scale).max(-1)
            cost[got["classes" + sfx][:, None] != want["classes" + sfx][None]] = np.inf
            free_g, free_w, matched = set(range(len(cost))), set(range(len(cost))), []
            for flat in np.argsort(cost, axis=None):
                i, j = divmod(int(flat), len(cost))
                if i in free_g and j in free_w:
                    free_g.discard(i)
                    free_w.discard(j)
                    matched.append(cost[i, j])
            worst = max(worst, float(max(matched)))
        boxes_nms += len(got["classes_nms"])
    if worst > 1e-4:
        fail(f"detect-infer: card boxes/scores {worst} of their largest from the CPU's")
    stages["instance_labels_detect_boxes"], launches["instance-labels-detect-boxes"], _ = run_cli(
        ["instance-labels", "--data-root", str(root), "--boxes-dir", str(preds), "--output-dir", str(tmp / "l2_gf")],
        log)
    labelled = sorted(p.name for p in (tmp / "l2_gf" / "instance_labels_pred").glob("*.npz"))
    if not set(files) <= set(labelled):
        fail(f"instance-labels --boxes-dir did not label the detected scans: {labelled}")
    return {"train_epoch_losses": losses, "files": files, "boxes_nms": boxes_nms,
            "card_vs_cpu_max_rel_diff": worst, "labelled_scans": len(labelled)}


def disk_phases(args, smi, results, stats) -> None:
    """The disk phase (see the module docstring): a data root in the release
    layout written with the port's writers into a temporary directory, then
    the port's CLI from it through every stage on the card. Adds row 2's L2
    entry (``stats["l2_row"]``) for the kernels line."""
    import contextlib
    import math
    import resource
    import tempfile

    from or4d_tpu_torch.config import load_config
    from or4d_tpu_torch.data.dataset import ORDataset
    import numpy as np

    from or4d_tpu_torch.data.synthetic_root import add_camera_frames, densify_object_scan, write_data_root
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.ops import fps
    from or4d_tpu_torch.pipeline import instance_labels as il
    from or4d_tpu_torch.train import checkpoint as ckpt
    from or4d_tpu_torch.utils.torch_import import export_reference_state_dict

    out_dir = Path(args.out) / "disk"
    out_dir.mkdir(parents=True, exist_ok=True)
    log = out_dir / "cli.log"
    log.write_text("")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    stages, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="or4d_disk_") as tmp:
        tmp = Path(tmp)
        root, cache = tmp / "data", tmp / "cache"
        t0 = time.perf_counter()
        info = write_data_root(root, seed=args.seed, scans_per_take=2)
        stages["write"] = time.perf_counter() - t0
        n_scans = sum(info["scans"].values())

        # instance-labels (pred path) on the card, its FPS calls and distance
        # tests recorded; then the same command on the CPU
        calls, tests = [], []
        orig_fps, orig_close = il.furthest_point_sample, il.close_mask

        def fps_rec(xyz, n):
            calls.append((xyz.detach().clone(), n))
            return orig_fps(xyz, n)

        def close_rec(points, samples, bbox, threshold):
            tests.append((samples.detach().double().cpu().numpy(), float(threshold)))
            return orig_close(points, samples, bbox, threshold)

        il.furthest_point_sample, il.close_mask = fps_rec, close_rec
        try:
            stages["instance_labels"], launches["instance-labels"], _ = run_cli(
                ["instance-labels", "--data-root", str(root)], log)
        finally:
            il.furthest_point_sample, il.close_mask = orig_fps, orig_close
        t0 = time.perf_counter()
        run_cli(["instance-labels", "--data-root", str(root), "--output-dir", str(tmp / "l2_cpu"), "--device", "cpu"],
                log)
        stages["instance_labels_cpu"] = time.perf_counter() - t0
        l2_diff = l2_label_diffs(root / "instance_labels_pred", tmp / "l2_cpu" / "instance_labels_pred", root, tests)
        detect = detect_stages(root, tmp, args.seed, log, stages, launches)

        # ingest: read + prep of every sample the CLI stages below read, into
        # their cache (train; val paired for train's validation and evaluate;
        # val unpaired for serving; test for infer)
        cfg = load_config("no_gt")
        kw = dict(data_root=root, cache_dir=cache, synthetic_fallback=False)
        t0 = time.perf_counter()
        n_ingest = 0
        with open(log, "a") as f, contextlib.redirect_stdout(f):
            for split, extra in (("train", {}), ("val", {"pair_shared": True}), ("val", {"pair_shared": False}),
                                 ("test", {"for_eval": True})):
                ds = ORDataset(cfg, split, DEFAULT_VOCAB, **kw, **extra)
                for i in range(len(ds)):
                    ds.sample(i)
                n_ingest += len(ds)
        stages["ingest"] = time.perf_counter() - t0

        base = ["--config", "no_gt", "--data-root", str(root), "--cache-dir", str(cache), "--strict-data",
                "--seed", str(args.seed)]
        ck = tmp / "ck"
        stages["train"], launches["train"], text = run_cli(["train", *base, "--checkpoint-dir", str(ck),
                                                            "--epochs", "1"], log)
        history = json.loads(text.strip().splitlines()[-1])
        f1 = {}
        stages["evaluate"], launches["evaluate"], text = run_cli(["evaluate", *base, "--checkpoint-dir", str(ck)], log)
        f1["evaluate"] = json.loads(text.strip().splitlines()[-1])["relation_macro_f1"]
        stages["evaluate_serving"], launches["evaluate_serving"], text = run_cli(
            ["evaluate", *base, "--checkpoint-dir", str(ck), "--serving", "--serving-cache-dir", str(tmp / "sc")], log)
        f1["evaluate_serving"] = json.loads(text.strip().splitlines()[-1])["relation_macro_f1"]
        rels_path = tmp / "scan_relations_no_gt_test.json"
        stages["infer"], launches["infer"], _ = run_cli(["infer", *base, "--checkpoint-dir", str(ck),
                                                         "--output", str(rels_path)], log)
        if ckpt.latest_step(ck) is None:
            fail(f"train wrote no checkpoint under {ck}")
        pth = out_dir / "reference_layout.pth"
        torch.save(export_reference_state_dict(SGPN.from_config(cfg, DEFAULT_VOCAB.num_classes,
                                                                DEFAULT_VOCAB.num_relations, device="cpu",
                                                                seed=args.seed + 7)), pth)
        ref_rels = tmp / "scan_relations_reference_layout.json"
        stages["infer_torch_checkpoint"], launches["infer_torch_checkpoint"], text = run_cli(
            ["infer", *base, "--torch-checkpoint", str(pth), "--output", str(ref_rels)], log)
        pth.unlink()
        if "imported reference torch checkpoint" not in text:
            fail("infer --torch-checkpoint did not import the reference-layout .pth")
        with open(log, "a") as f, contextlib.redirect_stdout(f):
            test_scans = ORDataset(cfg, "test", DEFAULT_VOCAB, for_eval=True, **kw).scans
        test_ids = sorted(f"{s['take_idx']}_{s['scan']}_2" for s in test_scans)
        rels = {p.name: json.loads(p.read_text()) for p in (rels_path, ref_rels)}
        for name, r in rels.items():
            if sorted(r) != test_ids or not all(len(t) == 3 for v in r.values() for t in v):
                fail(f"{name}: scan_relations keys {sorted(r)} are not the test scans {test_ids}")

        roles = tmp / "roles.json"
        stages["roles"], _, _ = run_cli(["roles", "--relations", str(rels_path), "--output", str(roles)], log)
        stages["phases"], _, _ = run_cli(["phases", "--relations", str(rels_path), "--roles", str(roles),
                                          "--output-dir", str(tmp / "phases")], log)
        gt_dir = tmp / "phases_gt"
        gt_dir.mkdir()
        for take in sorted({k.split("_")[0] for k in rels[rels_path.name]}):
            (gt_dir / f"phase_to_frames_{take}.json").write_text(json.dumps({"sterile": [0, 1]}))
        stages["phases_eval"], _, _ = run_cli(["phases-eval", "--gt-dir", str(gt_dir), "--pred-dir",
                                               str(tmp / "phases")], log)
        written = {"roles": roles.exists(), "phases": len(list((tmp / "phases").glob("*.json")))}
        if not written["roles"] or written["phases"] != len({k.split("_")[0] for k in test_ids}):
            fail(f"roles/phases files missing: {written}")

        # graphormer-roles twice on one checkpoint dir (the second restores
        # and skips training, the same JSON), phases on its roles, visualize
        # on the infer JSON
        groles, gck = tmp / "graphormer_roles.json", tmp / "ck_graphormer"
        gargs = ["graphormer-roles", "--data-root", str(root), "--checkpoint-dir", str(gck), "--output", str(groles),
                 "--seed", str(args.seed)]
        stages["graphormer_roles"], _, text = run_cli(gargs, log)
        first = json.loads(groles.read_text())
        stages["graphormer_roles_resumed"], _, text2 = run_cli(gargs, log)
        if "skipping training" in text or "skipping training" not in text2 or json.loads(groles.read_text()) != first:
            fail(f"graphormer-roles did not resume from {gck} to the same JSON: {text2}")
        if not first or not all(isinstance(v, dict) and v for v in first.values()):
            fail(f"graphormer-roles wrote no role predictions: {first}")
        stages["phases_graphormer_roles"], _, _ = run_cli(
            ["phases", "--relations", str(rels_path), "--roles", str(groles), "--output-dir", str(tmp / "phases_g")],
            log)
        stages["visualize"], _, _ = run_cli(["visualize", "--relations", str(rels_path), "--output-dir",
                                             str(tmp / "vis")], log)
        html = sorted(p.name for p in (tmp / "vis").glob("*.html"))
        n_nonempty = sum(1 for v in rels[rels_path.name].values() if v)
        written.update(graphormer_frames=len(first), phases_graphormer=len(list((tmp / "phases_g").glob("*.json"))),
                       visualize_html=len(html))
        if written["phases_graphormer"] != written["phases"] or len(html) != min(n_nonempty, 20):
            fail(f"phases on the graphormer roles or visualize wrote the wrong files: {written}")
        data_bytes = sum(p.stat().st_size for p in root.rglob("*") if p.is_file())

        # no_gt_image: the fixture's camera frames in every take, then train,
        # evaluate and infer with --config no_gt_image from the same sample
        # cache (the frames ride outside it, decoded per access)
        add_camera_frames(root, FIXTURE / "export_holistic_take1_processed" / "colorimage")
        ibase = ["--config", "no_gt_image", *base[2:]]
        ck_img = tmp / "ck_image"
        stages["train_image"], launches["train_image"], text = run_cli(
            ["train", *ibase, "--checkpoint-dir", str(ck_img), "--epochs", "1"], log)
        history_img = json.loads(text.strip().splitlines()[-1])
        stages["evaluate_image"], launches["evaluate_image"], text = run_cli(
            ["evaluate", *ibase, "--checkpoint-dir", str(ck_img)], log)
        f1["evaluate_image"] = json.loads(text.strip().splitlines()[-1])["relation_macro_f1"]
        rels_img = tmp / "scan_relations_no_gt_image_test.json"
        stages["infer_image"], launches["infer_image"], _ = run_cli(
            ["infer", *ibase, "--checkpoint-dir", str(ck_img), "--output", str(rels_img)], log)
        r = json.loads(rels_img.read_text())
        if sorted(r) != test_ids or not all(len(t) == 3 for v in r.values() for t in v):
            fail(f"no_gt_image infer: scan_relations keys {sorted(r)} are not the test scans {test_ids}")

        # instance-labels --from-gt on the fixture's takes with two registered
        # object scans of take 1 rewritten at 20,000 points (the cluster FPS),
        # its FPS calls over 8192 points recorded; then on the CPU
        gt_root = tmp / "gt_root"
        shutil.copytree(FIXTURE, gt_root, ignore=shutil.ignore_patterns("instance_labels"))
        for name in ("instrument_table", "operating_table"):
            densify_object_scan(gt_root, name, 1, 20000, seed=args.seed)
        big_calls = []

        def fps_big(xyz, n):
            if xyz.shape[1] > fps._MAX_N:
                big_calls.append((xyz.detach().clone(), n))
            return orig_fps(xyz, n)

        il.furthest_point_sample = fps_big
        try:
            stages["instance_labels_from_gt"], launches["instance-labels-from-gt"], _ = run_cli(
                ["instance-labels", "--from-gt", "--data-root", str(gt_root)], log)
        finally:
            il.furthest_point_sample = orig_fps
        t0 = time.perf_counter()
        run_cli(["instance-labels", "--from-gt", "--data-root", str(gt_root), "--output-dir", str(tmp / "gt_cpu"),
                 "--device", "cpu"], log)
        stages["instance_labels_from_gt_cpu"] = time.perf_counter() - t0
        gt_card = {p.name: np.load(p)["arr_0"] for p in sorted((gt_root / "instance_labels").glob("*.npz"))}
        gt_cpu = {p.name: np.load(p)["arr_0"] for p in sorted((tmp / "gt_cpu" / "instance_labels").glob("*.npz"))}
        from_gt = {"scans": len(gt_card), "big_calls": [str(tuple(x.shape)) for x, _n in big_calls],
                   "labels_differing": {k: int((gt_card[k] != gt_cpu.get(k)).sum()) for k in gt_card}}
        if not big_calls or sorted(gt_card) != sorted(gt_cpu) or any(from_gt["labels_differing"].values()):
            fail(f"instance-labels --from-gt on scans over 8192 points: card vs CPU {from_gt}")

    finite = all(math.isfinite(v) for v in (history["train_loss"], history["val_macro_f1"],
                                            history_img["train_loss"], history_img["val_macro_f1"], *f1.values(),
                                            *detect["train_epoch_losses"]))
    missing = {stage: [c for c in need if launches[stage].get(c, 0) == 0] for stage, need in DISK_KERNELS.items()}
    missing = {k: v for k, v in missing.items() if v}
    disk = {
        "card": smi, "config": "no_gt", "scans": info["scans"], "points_per_scan": info["points_per_scan"],
        "binary_compressed_pcds": info["compressed"], "data_bytes": data_bytes, "stage_host_seconds": stages,
        "ingest_scans": n_ingest, "ingest_scans_per_s": n_ingest / stages["ingest"],
        "infer_scans_per_s": info["scans"]["test"] / stages["infer"],
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        # the process's peak since it started (earlier phases included)
        "process_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "train": history, "train_image": history_img, "relation_macro_f1": f1, "l2_vs_cpu": l2_diff,
        "from_gt": from_gt, "files_written": written, "detect": detect,
        "l2_launches_per_scan": launches["instance-labels"]["fps.fps"] / n_scans,
        "launches": {stage: {c: n for c, n in d.items() if n} for stage, d in launches.items()},
        "finite": finite,
    }
    results["disk"] = disk
    emit({"phase": "disk", **disk})
    if not finite:
        fail(f"disk phase: non-finite loss or F1: {history} {f1}")
    if missing:
        fail(f"disk phase: kernels not launched: {missing}")

    # row 2 at L2's calls: each held exactly against its plain version on the
    # card, then timed beside it and its bound
    err, k_ms, p_ms, b_ms, b_t = 0.0, [], [], [], [0.0, 0.0]
    for xyz, n in calls:
        got = fps.furthest_point_sample(xyz, n)
        want = fps.furthest_point_sample_plain(xyz, n)
        d = max_abs_diff(got, want)
        err = max(err, d)
        if d != 0.0:
            fail(f"fps_l2 kernel disagrees with its plain version at {tuple(xyz.shape)}: max |diff| {d}")
        k_ms.append(cuda_ms(lambda: fps.furthest_point_sample(xyz, n), 5))
        p_ms.append(cuda_ms(lambda: fps.furthest_point_sample_plain(xyz, n), 1))
        ms, by, _info = bound("furthest_point_sample", (xyz, n), {})
        b_ms.append(ms)
        b_t[0 if by == "bytes" else 1] += ms
    shapes = sorted({tuple(x.shape) for x, _n in calls})
    stats["errs"][L2_ROW[0]] = err
    stats["l2_row"] = {
        "name": L2_ROW[0], "route": "cuda", "source": L2_ROW[2], "replaces": L2_ROW[3],
        "launches": launches["instance-labels"][L2_ROW[1]], "max_abs_err": err,
        "ms": sum(k_ms) / len(k_ms), "plain_ms": sum(p_ms) / len(p_ms), "bound_ms": sum(b_ms) / len(b_ms),
        "bound_by": "bytes" if b_t[0] >= b_t[1] else "operations", "library_ms": None,
        "per": "call", "launches_per_scan": disk["l2_launches_per_scan"], "calls": len(calls),
        "shapes": [str(s) for s in (shapes[0], shapes[-1])],
    }
    emit({"phase": "timing_l2_fps", "card": smi, **stats["l2_row"]})

    # row 2's cluster variant at the from-gt calls over 8192 points: each held
    # exactly against its plain version on the card, then timed
    err, k_ms, p_ms, b_ms, b_t = stats["errs"].get(FPS_LARGE_ROW[0], 0.0), [], [], [], [0.0, 0.0]
    for xyz, n in big_calls:
        d = max_abs_diff(fps.furthest_point_sample(xyz, n), fps.furthest_point_sample_plain(xyz, n))
        err = max(err, d)
        if d != 0.0:
            fail(f"fps_large kernel disagrees with its plain version at {tuple(xyz.shape)}: max |diff| {d}")
        k_ms.append(cuda_ms(lambda: fps.furthest_point_sample(xyz, n), 5))
        p_ms.append(cuda_ms(lambda: fps.furthest_point_sample_plain(xyz, n), 1))
        ms, by, _info = bound("furthest_point_sample", (xyz, n), {})
        b_ms.append(ms)
        b_t[0 if by == "bytes" else 1] += ms
    stats["errs"][FPS_LARGE_ROW[0]] = err
    stats["fps_large_row"] = {
        "name": FPS_LARGE_ROW[0], "route": "cuda", "source": FPS_LARGE_ROW[2], "replaces": FPS_LARGE_ROW[3],
        "launches": launches["instance-labels-from-gt"][FPS_LARGE_ROW[1]], "max_abs_err": err,
        "ms": sum(k_ms) / len(k_ms), "plain_ms": sum(p_ms) / len(p_ms), "bound_ms": sum(b_ms) / len(b_ms),
        "bound_by": "bytes" if b_t[0] >= b_t[1] else "operations", "library_ms": None,
        "per": "call", "calls": len(big_calls), "shapes": sorted({str(tuple(x.shape)) for x, _n in big_calls}),
    }
    emit({"phase": "timing_from_gt_fps", "card": smi, **stats["fps_large_row"]})


FPS_LARGE_ROW = ("fps_large", "fps.fps_large", "or4d_tpu_torch/ops/csrc/fps_cluster.cu",
                 "or4d_tpu/ops/pallas_fps.py:200")
SA1_SCALES = ((0.1, 16), (0.2, 32))


def grid_cloud(N: int, spacing: float = 0.05) -> torch.Tensor:
    """(1, N, 3): N points of a regular grid (exact distance ties
    everywhere), index 0 off the origin, a few within |p|^2 <= 1e-3."""
    import numpy as np

    side = int(np.ceil(N ** (1 / 3)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)[:N]
    pts = ((g - side // 2) * spacing).astype(np.float32)
    pts[[0, side * side // 2]] = pts[[side * side // 2, 0]]
    return torch.from_numpy(pts)[None]


def fps_large_phase(seed: int, smi: str, results: dict, stats: dict) -> None:
    """fps_large: the cluster FPS (``fps_cluster.cu``, N > 8192) against its
    plain version on the card, bit for bit, then timed beside it and its
    bound: random clouds at N = 8193, GroupFree's (8, 20,000) -> 2048 and
    (1, 200,000) -> 200 (the streamed tier), grids of exact ties at 20,000
    and 100,000, and the counts and bounds variants at (8, 20,000) -> 2048
    with SA1's scales. Each call must launch the cluster kernel once."""
    from or4d_tpu_torch.ops import fps, launch_counts, reset_launch_counts

    g = torch.Generator().manual_seed(seed + 7)
    rnd = lambda B, N: (torch.randn(B, N, 3, generator=g) * 0.5).contiguous()
    cases = [("8193", "fps", rnd(4, 8193), 512, None), ("groupfree", "fps", rnd(8, 20000), 2048, None),
             ("streamed", "fps", rnd(1, 200000), 200, None), ("grid_20000", "fps", grid_cloud(20000), 512, None),
             ("grid_100000", "fps", grid_cloud(100000), 200, None),
             ("counts_20000", "counts", rnd(8, 20000), 2048, SA1_SCALES),
             ("bounds_20000", "bounds", rnd(8, 20000), 2048, SA1_SCALES)]
    kern = {"fps": lambda x, n, sc: fps.furthest_point_sample(x, n),
            "counts": lambda x, n, sc: fps.furthest_point_sample_with_counts(x, n, tuple(r for r, _ in sc)),
            "bounds": lambda x, n, sc: fps.furthest_point_sample_with_bounds(x, n, sc)}
    plain = {"fps": lambda x, n, sc: fps.furthest_point_sample_plain(x, n),
             "counts": lambda x, n, sc: fps.furthest_point_sample_plain(x, n, tuple(r for r, _ in sc)),
             "bounds": lambda x, n, sc: fps.furthest_point_sample_with_bounds_plain(x, n, sc)}
    bname = {"fps": "furthest_point_sample", "counts": "furthest_point_sample_with_counts",
             "bounds": "furthest_point_sample_with_bounds"}
    out = []
    for label, variant, xyz, npoint, scales in cases:
        xyz = xyz.cuda()
        reset_launch_counts()
        got = kern[variant](xyz, npoint, scales)
        torch.cuda.synchronize()
        launched = launch_counts()
        counter = "fps.fps_large" + ("" if variant == "fps" else f"_{variant}")
        want = plain[variant](xyz, npoint, scales)
        d = max_abs_diff(got, want)
        idx = got[0] if isinstance(got, tuple) else got
        distinct = min(len(torch.unique(row)) for row in idx)
        entry = {"card": smi, "case": label, "variant": variant, "shape": str(tuple(xyz.shape)), "npoint": npoint,
                 "plan": str(fps.cluster_plan(xyz.shape[1])), "max_abs_err": d, "launches": launched[counter],
                 "distinct_min": distinct}
        emit({"phase": "check_fps_large", **entry})
        if d != 0.0 or launched[counter] != 1 or distinct != npoint:
            fail(f"fps_large {label}: kernel vs plain max |diff| {d}, launches {launched[counter]}, "
                 f"distinct samples {distinct} of {npoint}")
        args = (xyz, npoint) + ((tuple(r for r, _ in scales) if variant == "counts" else scales,) if scales else ())
        b_ms, b_by, info = bound(bname[variant], args, {})
        k_ms = cuda_ms(lambda: kern[variant](xyz, npoint, scales), 3)
        p_ms = cuda_ms(lambda: plain[variant](xyz, npoint, scales), 1)
        entry.update({"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
                      "us_per_step": 1e3 * k_ms / npoint, **info})
        out.append(entry)
        emit({"phase": "timing_fps_large", **entry})
        stats["errs"]["fps_large"] = max(stats["errs"].get("fps_large", 0.0), d)
        del got, want, xyz
    results["fps_large"] = out
    torch.cuda.empty_cache()


def largest_batch_phase(seed: int, smi: str, remat: bool, results: dict | None = None) -> dict:
    """The S=8 float32 ``no_gt`` train step (``train_raw`` as the config
    sets it) at the config's largest batch: 12 objects and 132 edges in
    every scene, 96 object and 1056 edge rows. Three steps; peak memory
    (``max_memory_allocated``), step ms (host clock around synchronised
    steps, the last two), and with ``remat`` off the ten largest tensors
    held for the backward (saved-tensor hooks) and the layers that hold
    them. Nothing here catches an out-of-memory error."""
    import dataclasses

    from or4d_tpu_torch.config import NO_GT, DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.data.weights import sample_counts, weights_from_counts
    from or4d_tpu_torch.train.loop import Trainer

    ds = DatasetConfig()
    samples = make_scene_samples(8, seed=seed + 300, n_objects=ds.max_objects, ds=ds, points_per_obj=2000)
    b8 = SceneBatch.stack(samples)
    rows = (int(b8.obj_mask.sum()), int(b8.edge_mask.sum()))
    if rows != (8 * ds.max_objects, 8 * ds.max_edges):
        fail(f"largest batch: {rows} rows, not {(8 * ds.max_objects, 8 * ds.max_edges)}")
    weights = weights_from_counts(DEFAULT_VOCAB, *sample_counts(DEFAULT_VOCAB, samples))
    cfg = dataclasses.replace(NO_GT, tpu=dataclasses.replace(NO_GT.tpu, remat=remat))
    tr = Trainer(cfg, DEFAULT_VOCAB, *weights, device="cuda", seed=seed)
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = []
    if not remat:
        # every tensor saved for the backward of the first step, by size,
        # with the module whose forward saved it; reported when the
        # backward starts, before it may run out of memory
        from torch.autograd.graph import saved_tensors_hooks

        where = []
        hooks = [m.register_forward_pre_hook(lambda mod, _a, n=n: where.append(n)) for n, m in tr.model.named_modules()]
        orig_backward = torch.Tensor.backward

        def pack(t):
            held.append((t.numel() * t.element_size(), tuple(t.shape), str(t.dtype), where[-1] if where else ""))
            return t

        def backward(t, *a, **k):
            top = sorted(set(held), reverse=True)[:10]
            emit({"phase": "largest_batch_saved", "card": smi, "saved_bytes_total": sum(b for b, *_ in held),
                  "forward_peak_mem_bytes": torch.cuda.max_memory_allocated(),
                  "saved_top10": [{"bytes": b, "shape": str(sh), "dtype": d, "module": w} for b, sh, d, w in top]})
            return orig_backward(t, *a, **k)

        torch.Tensor.backward = backward
        try:
            with saved_tensors_hooks(pack, lambda t: t):
                losses = [tr.train_step(b8, gen)]
        finally:
            torch.Tensor.backward = orig_backward
            for h in hooks:
                h.remove()
    else:
        losses = [tr.train_step(b8, gen)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tr.train_step(b8, gen) for _ in range(2)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 2
    entry = {"card": smi, "remat": remat, "scenes": 8, "dtype": "float32", "train_raw": cfg.tpu.train_raw,
             "object_rows": rows[0], "edge_rows": rows[1], "peak_mem_bytes": torch.cuda.max_memory_allocated(),
             "step_ms": step_ms, "losses": [float(l["loss"]) for l in losses]}
    emit({"phase": "largest_batch", **entry})
    if not all(math.isfinite(x) for x in entry["losses"]):
        fail(f"largest batch: non-finite losses {entry['losses']}")
    if results is not None:
        results.setdefault("largest_batch", []).append(entry)
    del tr, b8
    torch.cuda.empty_cache()
    return entry


def remat_phases(seed: int, smi: str, results: dict) -> None:
    """largest_batch with ``remat`` (the repaired step; fatal if it fails),
    then ``remat_equal``: one S=8 float32 step at the train phase's batch
    (96 object and 640 edge rows, which fits either way) with ``remat`` off
    and on, from the same weights and draws: losses within 1e-4 and every
    gradient within 1e-3 of the model's largest (the stated card-side
    tolerance; recomputation replays the same kernels, so equal is
    expected), with each side's peak memory and step ms."""
    import dataclasses

    from or4d_tpu_torch.config import NO_GT, DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.data.weights import sample_counts, weights_from_counts
    from or4d_tpu_torch.train.loop import Trainer

    largest_batch_phase(seed, smi, True, results)
    samples = make_scene_samples(8, seed=seed + 100, n_objects=9, ds=DatasetConfig(), points_per_obj=2000)
    b8 = SceneBatch.stack(samples)
    weights = weights_from_counts(DEFAULT_VOCAB, *sample_counts(DEFAULT_VOCAB, samples))
    side = {}
    for remat in (False, True):
        cfg = dataclasses.replace(NO_GT, tpu=dataclasses.replace(NO_GT.tpu, remat=remat))
        tr = Trainer(cfg, DEFAULT_VOCAB, *weights, device="cuda", seed=seed + 5)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        parts = tr.train_step(b8, torch.Generator().manual_seed(seed + 9))
        torch.cuda.synchronize()
        side[remat] = {"ms": 1e3 * (time.perf_counter() - t0), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                       "loss": float(parts["loss"]),
                       "grads": {n: q.grad.detach().cpu() for n, q in tr.model.named_parameters() if q.grad is not None}}
        del tr
    scale = max(float(g.abs().max()) for g in side[False]["grads"].values())
    g_diff = max(float((side[True]["grads"][n] - g).abs().max()) for n, g in side[False]["grads"].items())
    entry = {"card": smi, "object_rows": 96, "edge_rows": 640, "loss_diff": abs(side[True]["loss"] - side[False]["loss"]),
             "grad_max_abs_diff": g_diff, "grad_scale": scale,
             **{f"{k}_{'remat' if r else 'plain'}": side[r][k] for r in side for k in ("ms", "peak_mem_bytes")}}
    results["remat_equal"] = entry
    emit({"phase": "remat_equal", **entry})
    if entry["loss_diff"] > 1e-4 or g_diff > 1e-3 * scale:
        fail(f"remat changes the step: loss {entry['loss_diff']}, gradients {g_diff} of {scale}")
    torch.cuda.empty_cache()


def image_phase(seed: int, smi: str, results: dict, eval_samples) -> None:
    """image: the ``no_gt_image`` (float32) train step at S=8 on 456 x 456
    frames (48 trunk images a step; 9 objects a scene), three steps: step
    ms, scenes/s, peak memory, the SGPN kernels' counters (they must
    rise); then an S=64 eval batch (the eval phase's pair-shared scenes with
    frames): batch ms, scenes/s, peak; the image branch alone on each
    batch's frames (CUDA events) beside the whole; then the card's
    embedding of one scene against the CPU's on the same weights and
    frames, within 1e-4 of its largest value (TF32 off on both sides)."""
    import numpy as np

    from or4d_tpu_torch.config import NO_GT_IMAGE, DatasetConfig
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.data.synthetic import make_scene_samples
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.data.weights import sample_counts, weights_from_counts
    from or4d_tpu_torch.models.efficientnet import ImageBranch
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
    from or4d_tpu_torch.train.loop import Trainer

    size = NO_GT_IMAGE.model.image_size
    t0 = time.perf_counter()
    samples = make_scene_samples(8, seed=seed + 500, n_objects=9, ds=DatasetConfig(), points_per_obj=2000,
                                 image_size=size)
    data_s = time.perf_counter() - t0
    weights = weights_from_counts(DEFAULT_VOCAB, *sample_counts(DEFAULT_VOCAB, samples))
    tr = Trainer(NO_GT_IMAGE, DEFAULT_VOCAB, *weights, device="cuda", seed=seed)
    b8 = SceneBatch.stack(samples)
    gen = torch.Generator().manual_seed(seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses = [tr.train_step(b8, gen)]
    torch.cuda.synchronize()
    launched = launch_counts()
    t0 = time.perf_counter()
    losses += [tr.train_step(b8, gen) for _ in range(2)]
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 2
    train_peak = torch.cuda.max_memory_allocated()
    images8 = torch.from_numpy(b8.images).cuda()
    with torch.no_grad():
        trunk8_ms = cuda_ms(lambda: tr.model.image_branch(images8), 3)
    train = {"scenes": 8, "images": 48, "image_size": size, "dtype": "float32", "host_data_seconds": data_s,
             "step_ms": step_ms, "scenes_per_s": 8 / (step_ms / 1e3), "peak_mem_bytes": train_peak,
             "image_branch_ms": trunk8_ms, "rest_ms": step_ms - trunk8_ms,
             "losses": [float(l["loss"]) for l in losses], "launches": {k: v for k, v in launched.items() if v}}
    emit({"phase": "image_train", "card": smi, **train})
    need = ("fps.fps_bounds", "fps.fps", "group_raw.fwd", "group_raw.bwd", "group.fwd", "group.bwd")
    if [c for c in need if launched[c] == 0] or not all(math.isfinite(x) for x in train["losses"]):
        fail(f"no_gt_image train step: launches {launched}, losses {train['losses']}")
    del images8

    rng = np.random.default_rng(seed + 600)
    for smp in eval_samples:
        smp.images = rng.standard_normal((6, size, size, 3), dtype=np.float32)
    bS = SceneBatch.stack(eval_samples)
    for smp in eval_samples:
        smp.images = None
    S = bS.num_scenes
    pack = SlotPack.build(bS, paired=True).to("cuda")
    bS = bS.to("cuda")
    model = tr.model.eval()
    with torch.no_grad():
        model(bS, pack)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model(bS, pack)
        torch.cuda.synchronize()
        batch_ms = 1e3 * (time.perf_counter() - t0)
        eval_peak = torch.cuda.max_memory_allocated()
        trunk_ms = cuda_ms(lambda: model.image_branch(bS.images), 2)
        cpu = ImageBranch(device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in model.image_branch.state_dict().items()})
        x = bS.images[:1]
        got = model.image_branch(x).cpu()
        t0 = time.perf_counter()
        want = cpu(x.cpu())
        cpu_s = time.perf_counter() - t0
    d = float((got - want).abs().max())
    scale = float(want.abs().max())
    ev = {"scenes": S, "images": 6 * S, "dtype": "float32", "batch_ms": batch_ms, "scenes_per_s": S / (batch_ms / 1e3),
          "peak_mem_bytes": eval_peak, "image_branch_ms": trunk_ms, "rest_ms": batch_ms - trunk_ms,
          "embedding_card_vs_cpu_max_abs_diff": d, "embedding_max_abs": scale, "cpu_reference_seconds": cpu_s,
          "finite": bool(torch.isfinite(out.rel_logprobs).all())}
    emit({"phase": "image_eval", "card": smi, **ev})
    results["image"] = {"train": train, "eval": ev}
    if not ev["finite"] or d > 1e-4 * scale:
        fail(f"image branch: card vs CPU embedding max |diff| {d} of {scale}, finite {ev['finite']}")
    del tr, model, bS, pack, out
    torch.cuda.empty_cache()


GRAPHORMER_GRAPHS = 8  # graphs a track (the CLI's max_graphs on real tracks)
GRAPHORMER_NODES = (40, 64)  # star-graph nodes a frame: dense real scenes


def dense_role_take(seed: int):
    """A synthetic take of five tracks (one a role, humans human_0..4) over
    GRAPHORMER_GRAPHS frames whose star graphs have 40-64 nodes: each
    frame's relations are the five roles' behaviours plus random triplets
    among the staff, the patient and the furniture, until the graph's node
    count (entities + one node a relation) reaches a drawn size. Returns
    (tracks, frame_to_relations, [(batch, label)], host ms of
    ``track_to_batch`` a track)."""
    import numpy as np

    from or4d_tpu_torch.pipeline import role_dataset as rd
    from or4d_tpu_torch.pipeline.role_graphormer import star_expand

    rng = np.random.default_rng(seed)
    roles = list(rd._ROLE_BEHAVIORS)
    humans = [f"human_{i}" for i in range(len(roles))]
    things = ["Patient", "anesthesia_equipment", "operating_table", "instrument_table", "secondary_table",
              "instrument", "object", "human_9"]
    preds = ["Assisting", "Cementing", "Cleaning", "CloseTo", "Cutting", "Drilling", "Hammering", "Holding",
             "LyingOn", "Operating", "Preparing", "Sawing", "Suturing", "Touching"]
    frame_to_relations, tracks = {}, []
    for i in range(GRAPHORMER_GRAPHS):
        rels = [(h if s == "TARGET" else s, r, h if o == "TARGET" else o)
                for h, role in zip(humans, roles) for s, r, o in rd._ROLE_BEHAVIORS[role]]
        want = int(rng.integers(GRAPHORMER_NODES[0], GRAPHORMER_NODES[1]))  # one relation adds 1 or 2 nodes
        while len(star_expand(rels).node_ids) < want:
            rels.append((humans[rng.integers(len(humans))], preds[rng.integers(len(preds))],
                         (humans + things)[rng.integers(len(humans) + len(things))]))
        frame_to_relations[f"{i:06d}"] = rels
    for ri, h in enumerate(humans):
        poses = {f: (h, rng.normal(size=(14, 3))) for f in frame_to_relations}
        tracks.append(rd.RoleTrack(take_idx=1, track_idx=ri, timestamp_to_human_pose=poses, role_label=ri))
    t0 = time.perf_counter()
    data = [(t.to_batch(frame_to_relations, max_graphs=GRAPHORMER_GRAPHS), t.role_label) for t in tracks]
    host_ms = 1e3 * (time.perf_counter() - t0) / len(tracks)
    return tracks, frame_to_relations, data, host_ms


def graphormer_phase(seed: int, smi: str, results: dict) -> None:
    """graphormer: role prediction at the JAX defaults' full width (12
    layers, hidden 80, FFN 80, 8 heads; 486,805 parameters, float32) on
    ``dense_role_take``'s five tracks of 8 graphs. Gates: the card's scores
    within 1e-5 and logits within 1e-4 of their largest of the CPU's from
    the same weights, one train step's loss within 1e-5 and every gradient
    within 1e-3 of the largest (dropout masks from one CPU generator on both
    sides); a 3-epoch ``fit`` (peak lr 1e-3, 5 warm-up updates) whose last
    epoch's mean loss is below its first's. Times (CUDA events): the eval
    forward, ``train_step``, ``flag_train_step`` (m = 3) and ``score_track``
    a track (with its host copy of the scores); the host ms of
    ``track_to_batch`` a track; peak memory."""
    import numpy as np

    from or4d_tpu_torch.train.graphormer_trainer import GraphormerTrainer

    _tracks, f2r, data, host_ms = dense_role_take(seed + 700)
    nodes = [int((b.x[g] > 0).sum()) for b, _l in data[:1] for g in range(b.x.shape[0])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card = GraphormerTrainer(device="cuda", seed=seed)
    cpu = GraphormerTrainer(device="cpu", seed=seed + 1)
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    n_params = sum(p.numel() for p in card.model.parameters())

    # card vs CPU: eval logits and scores, then one train step
    batch, label = data[0]
    gb = batch.to("cuda")
    with torch.no_grad():
        lg, lc = card.model(gb).cpu(), cpu.model(batch)
    d_logits, logit_scale = float((lg - lc).abs().max()), float(lc.abs().max())
    d_scores = max(abs(a - b) for a, b in zip(card.score_track(gb).values(), cpu.score_track(batch).values()))
    loss_g = float(card.train_step(gb, label, torch.Generator().manual_seed(seed)))
    loss_c = float(cpu.train_step(batch, label, torch.Generator().manual_seed(seed)))
    grads_c = dict(cpu.model.named_parameters())
    g_scale = max(float(p.grad.abs().max()) for p in grads_c.values())
    d_grad = max(float((p.grad.cpu() - grads_c[k].grad).abs().max()) for k, p in card.model.named_parameters())
    check = {"logits_max_abs_diff": d_logits, "logits_max_abs": logit_scale, "scores_max_abs_diff": d_scores,
             "loss_card": loss_g, "loss_cpu": loss_c, "grad_max_abs_diff": d_grad, "grad_max_abs": g_scale}
    ok = (d_scores <= 1e-5 and d_logits <= 1e-4 * logit_scale and abs(loss_g - loss_c) <= 1e-5
          and d_grad <= 1e-3 * g_scale)

    # times on the card
    def fwd():
        with torch.no_grad():
            card.model(gb)

    fwd_ms = cuda_ms(fwd, 20)
    step_ms = cuda_ms(lambda: card.train_step(gb, label), 10)
    flag_ms = cuda_ms(lambda: card.flag_train_step(gb, label, m=3), 5)
    profiles = {"forward": profile_step(fwd, fwd_ms), "train_step": profile_step(lambda: card.train_step(gb, label),
                                                                               step_ms)}
    for prof in profiles.values():
        prof["top"] = prof["top"][:5]
    t0 = time.perf_counter()
    for b, _l in data:
        card.score_track(b)
    score_ms = 1e3 * (time.perf_counter() - t0) / len(data)
    peak = torch.cuda.max_memory_allocated()

    # a short fit whose loss falls
    fitter = GraphormerTrainer(device="cuda", seed=seed, peak_lr=1e-3, warmup_updates=5, tot_updates=1000)
    losses = fitter.fit(data, epochs=3)
    per_epoch = [float(np.mean(losses[i * len(data):(i + 1) * len(data)])) for i in range(3)]
    finite = all(math.isfinite(x) for x in losses)
    g = {"card": smi, "layers": 12, "hidden": 80, "heads": 8, "parameters": n_params, "tracks": len(data),
         "graphs_per_track": GRAPHORMER_GRAPHS, "nodes_per_graph": nodes,
         "relations_per_graph": [len(v) for v in f2r.values()], "card_vs_cpu": check,
         "forward_ms": fwd_ms, "train_step_ms": step_ms, "flag_train_step_ms": flag_ms, "flag_m": 3,
         "score_track_ms": score_ms, "track_to_batch_host_ms": host_ms, "peak_mem_bytes": peak, "profile": profiles,
         "fit_epoch_mean_loss": per_epoch, "finite": finite}
    emit({"phase": "graphormer", **g})
    results["graphormer"] = g
    if not ok:
        fail(f"graphormer card vs CPU outside the gate: {check}")
    if not finite or not per_epoch[-1] < per_epoch[0]:
        fail(f"graphormer fit: losses do not fall over 3 epochs: {per_epoch}")
    del card, cpu, fitter, gb
    torch.cuda.empty_cache()


# TPU rows 2 and 8 as the Group-Free detector calls them (SAVotes): row 2's
# cluster variant on SA1's 20,000-point clouds and fps.cu on SA2-SA4, row 8
# with one scale a stage; their own entries in the kernels line, per B = 16
# forward
GROUPFREE_ROWS = (
    ("fps_large_groupfree", "fps.fps_large", "or4d_tpu_torch/ops/csrc/fps_cluster.cu",
     "or4d_tpu/ops/pallas_fps.py:200"),
    ("fps_groupfree", "fps.fps", "or4d_tpu_torch/ops/csrc/fps.cu", "or4d_tpu/ops/pallas_fps.py:200"),
    ("ball_query_groupfree", "ball_query.multiscale", "or4d_tpu_torch/ops/csrc/ball_query_multiscale.cu",
     "or4d_tpu/ops/pallas_ball_query.py:139"),
)
GROUPFREE_BATCH = 16  # the reference's train batch (perception_trainers.py:7)
GROUPFREE_POINTS = 20000  # the dataset's num_points
# per-class mean box sizes (m) of the synthetic root's furniture
GROUPFREE_MEAN_SIZES = ((0.6, 1.0, 0.5), (2.0, 0.8, 0.7), (1.2, 0.9, 0.6), (0.8, 0.8, 0.6))


def groupfree_batch(seed: int, B: int, N: int = GROUPFREE_POINTS) -> dict:
    """A ``GroupFreeDetectionDataset.batch()``-shaped batch of random room
    scans (5 x 2 x 5 m, xyz in metres, centred colours): four GT boxes a
    scan of the four classes, points within 0.5 m of a box centre labelled
    with its index, padded boxes at +1000 (64 a scan)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-2.5, 0.0, -2.5], [2.5, 2.0, 2.5], (B, N, 3))
    pc = np.concatenate([xyz, rng.uniform(-0.5, 0.5, (B, N, 3))], -1).astype(np.float32)
    K2, k = 64, 4
    msa = np.asarray(GROUPFREE_MEAN_SIZES, np.float32)
    center = np.full((B, K2, 3), 1000.0, np.float32)
    center[:, :k] = rng.uniform([-2.0, 0.3, -2.0], [2.0, 1.0, 2.0], (B, k, 3))
    size_class = np.zeros((B, K2), np.int64)
    size_class[:, :k] = np.arange(k)
    size = np.zeros((B, K2, 3), np.float32)
    size[:, :k] = msa[:k] * rng.uniform(0.8, 1.2, (B, k, 3))
    heading_class = np.zeros((B, K2), np.int64)
    heading_class[:, :k] = rng.integers(0, 12, (B, k))
    mask = np.zeros((B, K2), np.float32)
    mask[:, :k] = 1
    d = ((pc[:, :, None, :3] - center[:, None, :k]) ** 2).sum(-1)
    gt = {"center": center, "size": size, "size_class": size_class, "size_residual": size - msa[size_class],
          "heading_class": heading_class, "heading_residual": rng.uniform(-0.2, 0.2, (B, K2)).astype(np.float32),
          "sem_class": size_class.copy(), "mask": mask}
    return {"point_clouds": pc, "point_instance_label": np.where(d.min(-1) < 0.25, d.argmin(-1), -1), "gt": gt}


# the groupfree phase's profile split by what the kernels do (kernel names)
GROUPFREE_KERNEL_GROUPS = (
    ("fps", ("fps",)), ("ball_query", ("ball_query", "multiscale")),
    ("gemm", ("gemm", "cutlass", "sm90_", "sm80_", "ampere", "cublas", "xmma", "dot_kernel")),
    ("softmax", ("softmax",)), ("reduce", ("reduce", "welford", "norm")))
# the groups whose kernels are the port's, held against their launch counters
GROUPFREE_COUNTED = {"fps": ("fps.",), "ball_query": ("ball_query.",)}
GROUPFREE_STEPS = 10  # B = 16 train steps timed one by one


def groupfree_phase(seed: int, smi: str, results: dict, stats: dict) -> None:
    """groupfree: the Group-Free detector at full width (20,000 points x 6
    channels, SA 2048/1024/512/256, 1024 seeds of 288, 128 proposals, 6
    decoder layers of FFN 2048; random weights from the seed, the synthetic
    root's mean sizes). (1) The main path with the counters zeroed just
    before and read just after: a B = 1 eval forward (the per-scan call of
    ``run_detection_inference``) and a B = 16 train step; FPS (both
    variants) and the ball query must launch. (2) Rows 2 and 8 against
    their plain versions on the card, bit for bit, at every call of a
    B = 16 forward (recorded): the cluster FPS at (16, 20,000) -> 2048 and
    row 8 unstaged at SA1. (3) Card against CPU from the same weights: a
    B = 1 eval forward (``seed_inds`` equal; the set of ``sample_inds``
    equal where the rank-128 gap is over twice the logits' largest
    difference, the gap reported; the heads' outputs within 1e-4 of their
    largest, candidate by candidate: their order may differ) and one
    dropout-0 B = 1 train step (loss 1e-4; every gradient 1e-2 of the
    largest, the SA stages' and the others' reported apart; SA1's train
    backward on one set of inputs and cotangent 1e-2). A rank-128 gap within
    twice the logits' difference fails the phase. (4) CUDA-event ms of the
    B = 1 forward and host-clock ms of GROUPFREE_STEPS B = 16 steps (each
    synchronised; mean, median, least and most), scans/s, peak memory, a
    profile split whose FPS and ball-query launches must equal the launch
    counters', and the launch count; each kernel's ms beside its plain
    version and its bound."""
    import numpy as np

    from or4d_tpu_torch.models import groupfree
    from or4d_tpu_torch.ops import ball_query_multiscale as bqm
    from or4d_tpu_torch.ops import fps, launch_counts, reset_launch_counts
    from or4d_tpu_torch.train.perception_trainers import GroupFreeTrainer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    msa = torch.tensor(GROUPFREE_MEAN_SIZES, device="cuda")
    B = GROUPFREE_BATCH
    t0 = time.perf_counter()
    batch = groupfree_batch(seed + 13, B)
    one = groupfree_batch(seed + 14, 1)
    data_s = time.perf_counter() - t0
    trainer = GroupFreeTrainer(device="cuda", seed=seed)
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    pc16 = torch.from_numpy(batch["point_clouds"]).cuda()
    pc1 = torch.from_numpy(one["point_clouds"]).cuda()

    def forward1():
        with torch.no_grad():
            return model(pc1, msa, train=False)

    def step16():
        return trainer.train_step_from_batch(batch, GROUPFREE_MEAN_SIZES)

    # (1) the main path: the per-scan eval forward and a B = 16 train step
    model.eval()
    reset_launch_counts()
    out1 = forward1()
    model.train()
    loss16, _parts = step16()
    torch.cuda.synchronize()
    main_launches = launch_counts()
    missing = [c for _n, c, _s, _r in GROUPFREE_ROWS if main_launches.get(c, 0) == 0]
    if missing or not math.isfinite(float(loss16)):
        fail(f"groupfree main path: kernels not launched {missing} ({main_launches}), loss {float(loss16)}")

    # (2) rows 2 and 8 at every call of a B = 16 forward, recorded
    calls = []
    f_orig, b_orig = groupfree.furthest_point_sample, groupfree.ball_query_multiscale

    def fps_rec(xyz, n):
        calls.append(("fps", (xyz.detach().clone(), n)))
        return f_orig(xyz, n)

    def bq_rec(scales, xyz, new_xyz):
        calls.append(("bq", (scales, xyz.detach().clone(), new_xyz.detach().clone())))
        return b_orig(scales, xyz, new_xyz)

    groupfree.furthest_point_sample, groupfree.ball_query_multiscale = fps_rec, bq_rec
    try:
        model.eval()
        with torch.no_grad():
            model(pc16, msa, train=False)
    finally:
        groupfree.furthest_point_sample, groupfree.ball_query_multiscale = f_orig, b_orig
    torch.cuda.synchronize()
    per_call, agg = [], {r[0]: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "t": [0.0, 0.0], "err": 0.0}
                         for r in GROUPFREE_ROWS}
    for kind, args in calls:
        if kind == "fps":
            xyz, n = args
            row = "fps_large_groupfree" if xyz.shape[1] > fps._MAX_N else "fps_groupfree"
            kern = lambda: fps.furthest_point_sample(xyz, n)
            plain = lambda: fps.furthest_point_sample_plain(xyz, n)
            b_ms, b_by, info = bound("furthest_point_sample", (xyz, n), {})
            plan = str(fps.cluster_plan(xyz.shape[1])) if row == "fps_large_groupfree" else "fps.cu"
            shape = str((tuple(xyz.shape), n))
        else:
            scales, xyz, q = args
            row = "ball_query_groupfree"
            kern = lambda: bqm.ball_query_multiscale(scales, xyz, q)[0]
            plain = lambda: bqm.ball_query_multiscale_plain(scales, xyz, q)[0]
            b_ms, b_by, info = serving_bound("ball_query_multiscale", (scales, xyz, q))
            plan = str(bqm.multiscale_plan(xyz.shape[0], xyz.shape[1], q.shape[1], scales,
                                           torch.cuda.get_device_properties(0).multi_processor_count))
            shape = str((tuple(xyz.shape), q.shape[1], scales))
        got = kern()
        torch.cuda.synchronize()
        d = max_abs_diff(got, plain())
        entry = {"row": row, "card": smi, "shape": shape, "plan": plan, "max_abs_err": d}
        emit({"phase": "check_groupfree", **entry})
        if d != 0.0:
            fail(f"{row} kernel disagrees with its plain version at {shape}: max |diff| {d}")
        k_ms, p_ms = cuda_ms(kern, 5), cuda_ms(plain, 1)
        entry.update({"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms,
                      **info})
        emit({"phase": "timing_groupfree_kernel", **entry})
        per_call.append(entry)
        a = agg[row]
        a["ms"] += k_ms
        a["plain_ms"] += p_ms
        a["bound_ms"] += b_ms
        a["t"][0 if b_by == "bytes" else 1] += b_ms
        a["err"] = max(a["err"], d)
    sa1_staged = [e["plan"] for e in per_call if e["row"] == "ball_query_groupfree" and "20000" in e["shape"]]
    if len(calls) != 8 or not sa1_staged or "stage_xyz=False" not in sa1_staged[0]:
        fail(f"groupfree: expected 4 FPS and 4 ball-query calls with SA1's unstaged, got {len(calls)}: {sa1_staged}")
    del calls

    # (3) card against CPU from the same weights
    cpu = groupfree.GroupFreeDetector(device="cpu", seed=seed).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    model.eval()
    out1 = forward1()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu(pc1.cpu(), msa.cpu(), train=False)
    cpu_fwd_s = time.perf_counter() - t0
    logits = ref["seeds_obj_cls_logits"]
    d_logits = float((out1["seeds_obj_cls_logits"].cpu() - logits).abs().max())
    ranked = torch.sort(logits, dim=1, descending=True).values
    gap = float(ranked[0, 127] - ranked[0, 128])
    check = {"seed_inds_equal": bool(torch.equal(out1["seed_inds"].cpu(), ref["seed_inds"])),
             "logits_max_abs_diff": d_logits, "rank128_gap": gap, "gap_allows": gap > 2 * d_logits}
    # the set of candidates is compared only where the rank-128 gap decides
    # it on both sides; a gap within the two sides' difference fails
    ok = check["seed_inds_equal"] and check["gap_allows"]
    if check["gap_allows"]:
        # the gap decides the candidate set; their order (by logit) may differ
        # where two candidates' logits are closer than the two sides differ,
        # so each head's outputs are compared candidate by candidate
        got_inds, want_inds = out1["sample_inds"][0].cpu(), ref["sample_inds"][0]
        check["sample_inds_set_equal"] = bool(torch.equal(got_inds.sort().values, want_inds.sort().values))
        check["sample_inds_order_equal"] = bool(torch.equal(got_inds, want_inds))
        ok = ok and check["sample_inds_set_equal"]
        if check["sample_inds_set_equal"]:
            perm = torch.argsort(got_inds)[torch.argsort(torch.argsort(want_inds))]  # card position of each CPU one
            heads = [("proposal", out1["proposal"], ref["proposal"])] + [
                (f"head_{i}", g, w) for i, (g, w) in enumerate(zip(out1["layers"], ref["layers"]))]
            worst = max((float((g[k].cpu()[:, perm] - w[k]).abs().max()) / float(w[k].abs().max()), f"{n}.{k}")
                        for n, g, w in heads for k in w)
            check["heads_max_rel_diff"] = list(worst)
            ok = ok and worst[0] <= 1e-4
    # one dropout-0 B = 1 train step, the same draws: loss, gradients
    gstep = GroupFreeTrainer(device="cuda", seed=seed, dropout=0.0)
    cstep = GroupFreeTrainer(device="cpu", seed=seed, dropout=0.0)
    cstep.model.load_state_dict({k: v.cpu() for k, v in gstep.model.state_dict().items()})
    t0 = time.perf_counter()
    lc, _ = cstep.train_step_from_batch(one, GROUPFREE_MEAN_SIZES)
    cpu_step_s = time.perf_counter() - t0
    lg, _ = gstep.train_step_from_batch(one, GROUPFREE_MEAN_SIZES)
    grads_c = {k: p.grad for k, p in cstep.model.named_parameters()}
    g_scale = max(float(g.abs().max()) for g in grads_c.values())
    diffs = {k: float((p.grad.cpu() - grads_c[k]).abs().max()) / g_scale for k, p in gstep.model.named_parameters()}
    sa = {k: v for k, v in diffs.items() if k.startswith("backbone.sa")}
    rest = {k: v for k, v in diffs.items() if not k.startswith("backbone.sa")}
    check.update({"step_loss_card": float(lg), "step_loss_cpu": float(lc), "grad_max_abs": g_scale,
                  "grad_rel_diff_outside_sa": max(rest.values()), "grad_rel_diff_sa_stages": max(sa.values()),
                  "grad_worst_sa": max(sa, key=sa.get)})
    ok = (ok and abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc)) and check["grad_rel_diff_outside_sa"] <= 1e-2
          and check["grad_rel_diff_sa_stages"] <= 1e-2)
    # SA1's train backward alone, card vs CPU, on one set of inputs and cotangent
    sa1g = gstep.model.backbone.sa1
    sa1c = cstep.model.backbone.sa1
    sa1c.load_state_dict({k: v.cpu() for k, v in sa1g.state_dict().items()})
    xyz1 = pc1[..., :3].contiguous()
    ct = torch.randn(1, 2048, 128, generator=torch.Generator().manual_seed(seed))
    for mod, dev in ((sa1g, "cuda"), (sa1c, "cpu")):
        mod.zero_grad()
        _x, h, _i = mod(xyz1.to(dev), pc1[..., 3:].to(dev), train=True)
        (h * ct.to(dev)).sum().backward()
    s_scale = max(float(p.grad.abs().max()) for p in sa1c.parameters())
    check["sa1_vjp_rel_diff"] = max(float((a.grad.cpu() - b.grad).abs().max()) for a, b in
                                    zip(sa1g.parameters(), sa1c.parameters())) / s_scale
    ok = ok and check["sa1_vjp_rel_diff"] <= 1e-2
    emit({"phase": "groupfree_card_vs_cpu", "card": smi, **check, "cpu_forward_s": cpu_fwd_s,
          "cpu_step_s": cpu_step_s})
    if not ok:
        fail(f"groupfree card vs CPU outside the gate: {check}")
    del gstep, cstep, cpu, ref

    # (4) times: the B = 1 forward (CUDA events), the B = 16 step (host clock)
    model.eval()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = cuda_ms(forward1, 10)
    fwd_peak = torch.cuda.max_memory_allocated()
    fwd_prof = profile_step(forward1, fwd_ms, GROUPFREE_KERNEL_GROUPS, GROUPFREE_COUNTED)
    model.train()
    step16()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_times = []
    for _ in range(GROUPFREE_STEPS):
        t0 = time.perf_counter()
        loss16, _parts = step16()
        torch.cuda.synchronize()
        step_times.append(1e3 * (time.perf_counter() - t0))
    step_ms = sum(step_times) / len(step_times)
    step_peak = torch.cuda.max_memory_allocated()
    step_prof = profile_step(step16, step_ms, GROUPFREE_KERNEL_GROUPS, GROUPFREE_COUNTED)
    g = {"card": smi, "points": GROUPFREE_POINTS, "channels": 6, "proposals": 128, "decoder_layers": 6,
         "parameters": n_params, "host_data_s": data_s,
         "forward_b1_ms": fwd_ms, "forward_b1_scans_per_s": 1e3 / fwd_ms, "forward_b1_peak_mem_bytes": fwd_peak,
         "forward_b1_profile": fwd_prof,
         "step_b16_ms": step_ms, "step_b16_ms_median": statistics.median(step_times),
         "step_b16_ms_min": min(step_times), "step_b16_ms_max": max(step_times), "step_b16_steps": len(step_times),
         "step_b16_scans_per_s": B * 1e3 / step_ms, "step_b16_peak_mem_bytes": step_peak,
         "step_b16_profile": step_prof, "step_loss": float(loss16), "launches": main_launches,
         "kernels": {r: {k: v for k, v in a.items() if k != "t"} for r, a in agg.items()},
         "card_vs_cpu": check, "seconds": time.perf_counter() - t_phase}
    emit({"phase": "groupfree", **g})
    results["groupfree"] = {**g, "per_call": per_call}
    if not math.isfinite(float(loss16)):
        fail(f"groupfree: B = {B} step loss {float(loss16)}")
    stats["groupfree_rows"] = [{
        "name": row, "route": "cuda", "source": src, "replaces": replaces,
        "launches": main_launches[counter], "max_abs_err": agg[row]["err"],
        "ms": agg[row]["ms"], "plain_ms": agg[row]["plain_ms"], "bound_ms": agg[row]["bound_ms"],
        "bound_by": "bytes" if agg[row]["t"][0] >= agg[row]["t"][1] else "operations", "library_ms": None,
        "per": f"B = {B} forward",
    } for row, counter, src, replaces in GROUPFREE_ROWS]
    del trainer, model, pc16, pc1, out1
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="build/chip_smoke", help="directory for the JSON outputs")
    ap.add_argument("--scenes", type=int, default=64, help="timing batch (bench.py default 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bounds-timing", action="store_true", help="time the bounds pre-pass alone (bounds_timing)")
    ap.add_argument("--largest-batch", action="store_true",
                    help="only the S=8 step at the largest batch with remat off (largest_batch_phase)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card", file=sys.stderr)
        return 1
    if args.bounds_timing:
        bounds_timing(args.seed)
        return 0
    if args.largest_batch:
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = nvidia_smi_line()
        emit({"phase": "device", "kind": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__})
        largest_batch_phase(args.seed, smi, False)
        return 0
    from or4d_tpu_torch.data.scene_batch import SceneBatch, SlotPack
    from or4d_tpu_torch.infer import predict_relations
    from or4d_tpu_torch.models import SGPN
    from or4d_tpu_torch.ops import _build, launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi_line()
    card = {"kind": kind, "count": count, "nvidia_smi": smi}
    emit({"phase": "device", **card, "torch": torch.__version__, "cuda": torch.version.cuda})
    results = {"device": card}

    t0 = time.perf_counter()
    paths = _build.build_all()
    ptxas = {n: ptxas_summary(_build.build_log.get(n, "")) for n in paths}
    sass = sass_listings(paths)
    hmma = sass_mma_counts(sass)
    # row 10's inner loop, instruction by instruction (its time is issue-bound)
    bounds_loop = sass_loop_mix(sass["ball_query_bounds"], "bounds") if sass is not None else None
    results["build"] = {"seconds": time.perf_counter() - t0, "per_source_s": _build.build_seconds,
                        "ptxas": ptxas, "sass_hmma": hmma, "sass_bounds_loop": bounds_loop}
    emit({"phase": "build", **results["build"]})
    # the bfloat16 bodies of the fused SA stage and of the serving SA1 MLP
    for src, kern in (("sa_group_mlp", "sa_mma_kernel"), ("serving_sa1_mlp", "serving_mma_kernel")):
        mma_kernels = {k: v for k, v in (hmma or {}).get(src, {}).items() if kern in k}
        if hmma is not None and (not mma_kernels or not all(mma_kernels.values())):
            fail(f"the bfloat16 kernels of {src}.cu have no tensor-core instructions: {mma_kernels}")

    rec = Recorder()
    t0 = time.perf_counter()
    samples = build_batches(max(args.scenes, 8), args.seed)
    emit({"phase": "data", "scenes": len(samples), "host_seconds": time.perf_counter() - t0})
    model_bf16 = SGPN(compute_dtype=torch.bfloat16, device="cuda", seed=args.seed)

    def prepared(batch, bucket=128):
        pack = SlotPack.build(batch, bucket=bucket, paired=True)
        return batch.to("cuda"), pack.to("cuda")

    errs: dict[str, float] = {}
    b8, p8 = prepared(SceneBatch.stack(samples[:8]))
    with torch.no_grad():
        calls = rec.record(lambda: model_bf16(b8, p8))
    torch.cuda.synchronize()
    checks = []
    for name, cargs, ckw, _g in calls:
        dtypes = [None] if name.startswith("furthest") else [torch.bfloat16, torch.float32]
        for dt in dtypes:
            a, k = cut(cargs, ckw, 64, dt)
            got = run_call(name, a, k, plain=False)
            torch.cuda.synchronize()
            want = run_call(name, a, k, plain=True)
            d = max_abs_diff(got, want)
            row = row_of(name, ckw)
            shape = tuple(a[0].shape) if name.startswith("furthest") else (
                tuple(a[0].shape), tuple(a[1].shape[1:2]), a[3], tuple(a[7].shape), bool(k.get("paired")))
            if dt is None:
                ok = d == 0.0
            else:
                ok = torch.allclose(got.float(), want.float(), rtol=SA_TOL[dt], atol=SA_TOL[dt])
            vals = (got[0] if isinstance(got, tuple) else got).float()
            checks.append({"row": row, "shape": str(shape), "dtype": str(dt), "max_abs_err": d, "ok": bool(ok),
                           "max_abs_value": float(vals.abs().max()),
                           "nonzero_frac": float((vals != 0).float().mean())})
            emit({"phase": "check", **checks[-1]})
            errs[row] = max(errs.get(row, 0.0), d)
            if not ok:
                fail(f"{row} kernel disagrees with its plain version at {shape} {dt}: max |diff| {d}")
    results["check"] = checks
    del calls, b8, p8, a, k, got, want, vals  # free the recorded inputs before the memory is measured

    b8 = SceneBatch.stack(samples[:8])
    reset_launch_counts()
    t0 = time.perf_counter()
    rels = predict_relations(model_bf16, [b8])
    torch.cuda.synchronize()
    main_launches = launch_counts()
    infer_s = time.perf_counter() - t0
    (out_dir / "scan_relations_s8_bf16.json").write_text(json.dumps(rels))
    missing = [c for _r, c, _s, _p in ROWS if main_launches.get(c, 0) == 0]
    if missing:
        fail(f"kernels not launched on the main path: {missing} ({main_launches})")
    n_rel = sum(len(v) for v in rels.values())
    if len(rels) != 8 or not all(isinstance(t, tuple) and len(t) == 3 for v in rels.values() for t in v):
        fail("scan_relations malformed")
    # float32 at S=1: card (kernels) vs CPU (plain versions), same weights
    b1 = SceneBatch.stack(samples[:1])
    pack1 = SlotPack.build(b1, bucket=8, paired=True)
    m_gpu = SGPN(device="cuda", seed=args.seed + 1)
    m_cpu = SGPN(device="cpu", seed=args.seed + 1)
    with torch.no_grad():
        out_gpu = m_gpu(b1.to("cuda"), pack1.to("cuda"))
        t0 = time.perf_counter()
        out_cpu = m_cpu(b1.to("cpu"), pack1.to("cpu"))
    cpu_s = time.perf_counter() - t0
    em, om = torch.from_numpy(b1.edge_mask), torch.from_numpy(b1.obj_mask)
    d_rel = float((out_gpu.rel_logprobs.cpu()[em] - out_cpu.rel_logprobs[em]).abs().max())
    d_obj = float((out_gpu.obj_logprobs.cpu()[om] - out_cpu.obj_logprobs[om]).abs().max())
    finite = bool(torch.isfinite(out_gpu.rel_logprobs).all() and torch.isfinite(out_gpu.obj_logprobs).all())
    results["slice"] = {"scenes": 8, "relations": n_rel, "infer_seconds": infer_s, "launches": main_launches,
                        "f32_s1_rel_max_abs_diff": d_rel, "f32_s1_obj_max_abs_diff": d_obj,
                        "cpu_reference_seconds": cpu_s, "finite": finite}
    emit({"phase": "slice", **results["slice"]})
    if not finite or d_rel > 1e-3 or d_obj > 1e-3:
        fail(f"S=1 float32 card vs CPU log-probs differ: rel {d_rel}, obj {d_obj}")

    S = args.scenes
    bS, pS = prepared(SceneBatch.stack(samples[:S]))
    torch.set_grad_enabled(False)  # eval: no autograd graph
    model_bf16(bS, pS)  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    bodies = reset_bodies()
    torch.cuda.reset_peak_memory_stats()
    model_bf16(bS, pS)
    torch.cuda.synchronize()
    launches_S = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if bodies["fp32"] != 0 or bodies["mma"] == 0:
        fail(f"the S={S} bfloat16 batch did not run the fused SA stage's tensor-core body only: {bodies}")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = model_bf16(bS, pS)
    torch.cuda.synchronize()
    batch_ms = 1e3 * (time.perf_counter() - t0) / reps
    e2e = {"card": smi, "scenes": S, "dtype": "bfloat16", "batch_ms": batch_ms, "scenes_per_s": S / (batch_ms / 1e3),
           "peak_mem_bytes": peak, "launches_per_batch": launches_S, "sa_body_launches": dict(bodies),
           "finite": bool(torch.isfinite(out.rel_logprobs).all())}
    e2e["profile"] = profile_step(lambda: model_bf16(bS, pS), batch_ms)
    emit({"phase": "timing_e2e", **e2e})
    if not e2e["finite"]:
        fail(f"S={S} bfloat16 log-probs are not finite")
    calls = rec.record(lambda: model_bf16(bS, pS))  # the kernels' inputs in this batch
    torch.cuda.synchronize()
    per_call = []
    kern_ms, plain_ms, bound_ms = {}, {}, {}
    bound_t = {r[0]: [0.0, 0.0] for r in ROWS + TRAIN_ROWS + GATED_ROWS + BOUNDS_ROWS + SERVING_ROWS}  # bytes, ops time
    for name, cargs, ckw, _g in calls:
        row = row_of(name, ckw)
        k_ms = cuda_ms(lambda: run_call(name, cargs, ckw, plain=False), 5)
        p_ms = cuda_ms(lambda: run_call(name, cargs, ckw, plain=True), 1)
        b_ms, b_by, info = bound(name, cargs, ckw)
        kern_ms[row] = kern_ms.get(row, 0.0) + k_ms
        plain_ms[row] = plain_ms.get(row, 0.0) + p_ms
        bound_ms[row] = bound_ms.get(row, 0.0) + b_ms
        bound_t[row][0 if b_by == "bytes" else 1] += b_ms
        per_call.append({"row": row, "card": smi, "shape": str(tuple(cargs[0].shape)), "ms": k_ms, "plain_ms": p_ms,
                         "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / k_ms, **info})
        emit({"phase": "timing_kernel", **per_call[-1]})
    results["timing"] = {"e2e": e2e, "per_call": per_call, "fps_split": fps_split(calls, smi)}
    torch.set_grad_enabled(True)
    # the last recorded call's tensors too, before the train phases read peak memory
    del calls, bS, pS, out, model_bf16, m_gpu, m_cpu, out_gpu, out_cpu
    cargs = ckw = None
    torch.cuda.empty_cache()

    stats = {"errs": errs, "launches": dict(main_launches), "ms": kern_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_t": bound_t, "library_ms": {}}
    fps_large_phase(args.seed, smi, results, stats)
    groupfree_phase(args.seed, smi, results, stats)
    graphormer_phase(args.seed, smi, results)
    train_phases(args, rec, smi, results, stats)
    remat_phases(args.seed, smi, results)
    image_phase(args.seed, smi, results, samples[:S])
    del samples
    serving_phases(args, rec, smi, results, stats)
    disk_phases(args, smi, results, stats)
    rows = ROWS + TRAIN_ROWS + SERVING_ROWS + GATED_ROWS + BOUNDS_ROWS
    unmeasured = [r[0] for r in rows if r[0] not in errs or r[0] not in kern_ms]
    if unmeasured:
        fail(f"kernels with no check or no timing in this run: {unmeasured}")

    results["seconds"] = time.perf_counter() - t_start
    (out_dir / "results.json").write_text(json.dumps(results, indent=1))
    kernels = []
    for row, counter, src, replaces in rows:
        kernels.append({
            "name": row, "route": "cuda", "source": src, "replaces": replaces,
            "launches": stats["launches"][counter], "max_abs_err": errs[row],
            "ms": kern_ms[row], "plain_ms": plain_ms[row], "bound_ms": bound_ms[row],
            "bound_by": "bytes" if bound_t[row][0] >= bound_t[row][1] else "operations",
            "library_ms": stats["library_ms"].get(row),
        })
    kernels.append(stats["l2_row"])
    kernels.append(stats["fps_large_row"])
    kernels.extend(stats["groupfree_rows"])
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
