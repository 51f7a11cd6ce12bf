"""The metric readers and the trace arithmetic on a recorded synthetic
trace, against sums worked by hand."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from harness.context import Outcome, read_metrics
from harness.spec import metric_reader
from harness.trace import WINDOW, Trace, read_chrome_trace

# one traced window of 1.0 s holding two calls (seconds on one clock)
OPS = [
    ("void fps_kernel<2>(float const*)", 0.10, 0.02),
    ("void sa_mma_kernel<true, 4>(SAArgs)", 0.12, 0.10),
    ("Memcpy HtoD (Pinned -> Device)", 0.25, 0.05),
    ("void at::native::vectorized_elementwise_kernel<4>(int)", 0.30, 0.10),
    ("void at::native::reduce_kernel<512, 1>(int)", 0.35, 0.10),  # overlaps the one before
    ("void fps_kernel<2>(float const*)", 0.60, 0.02),
    ("void sa_mma_kernel<true, 4>(SAArgs)", 0.62, 0.10),
    ("void group_fwd_kernel<float, true, 2>(FwdArgs)", 0.80, 0.05),
    ("void fps_kernel<2>(float const*)", 1.40, 0.10),  # after the window: not busy time
]
RANGES = [(WINDOW, 0.0, 1.0), ("bench.upload", 0.00, 0.10), ("bench.pack", 0.45, 0.15),
          ("bench.eval_step", 0.40, 0.30)]


def outcome(**kw) -> Outcome:
    base = dict(setup_s=12.5, window_s=20.0, calls=40, scenes=2560, call_ms=[float(i) for i in range(1, 41)],
                attempted=40, failed=0, checks={}, memory_peak_bytes=1, dtype="bfloat16", flops_per_call=7.0e12,
                trace=Trace(OPS, RANGES, 0.0, 1.0), trace_calls=2, trace_batches=2,
                spans={"upload": [100.0, 120.0], "pack": [30.0, 34.0], "pack_check": [5.0, 7.0],
                       "relations": [9.0, 11.0]},
                bounds_ms={"fps": 2.0, "sa_tile": 10.0, "grouping": 20.0}, image_branch_ms=[300.0, 320.0])
    base.update(kw)
    return Outcome(**base)


def test_trace_busy_gaps_and_names():
    t = Trace(OPS, RANGES, 0.0, 1.0)
    # busy: [.10,.22] [.25,.30] [.30,.45] [.60,.72] [.80,.85] = .12+.05+.15+.12+.05
    assert t.busy_s() == pytest.approx(0.49)
    assert t.window_s == 1.0
    flat = [x for g in t.gaps() for x in g]
    assert flat == pytest.approx([0.0, 0.10, 0.22, 0.25, 0.45, 0.60, 0.72, 0.80, 0.85, 1.0])
    idle = dict(t.idle_by_host())
    # by their middles: upload; none; pack (inside eval_step, the shorter); none; none
    assert idle == pytest.approx({"upload": 0.10, "host": 0.03 + 0.08 + 0.15, "pack": 0.15})
    top = dict(t.top_ops())
    assert top["void fps_kernel<2>(float const*)"] == pytest.approx(0.04)
    assert t.op_count("fps_kernel") == 3


def test_end_to_end_readers():
    o = outcome()
    assert metric_reader("eval_scenes_per_s")(o) == 2560 / 20.0
    assert metric_reader("train_scenes_per_s")(o) == 2560 / 20.0
    assert metric_reader("serve_scenes_per_s")(o) == 2560 / 20.0
    assert metric_reader("setup_s")(o) == 12.5
    assert metric_reader("eval_batch_p90_ms")(o) == 36.0  # nearest rank: the 36th of 40


def test_per_layer_readers():
    o = outcome()
    assert metric_reader("upload_ms.eval")(o) == 110.0
    assert metric_reader("host_prep_ms.eval")(o) == pytest.approx((64 + 12 + 20) / 2)
    assert metric_reader("cache_upload_ms.serve")(o) == pytest.approx(50.0 / 2)
    assert metric_reader("torch_elementwise_ms.train")(o) == pytest.approx(200.0 / 2)
    assert metric_reader("image_branch_ms.eval")(o) == 310.0
    # 7 TFLOP x 40 calls over 20 s at 989 TFLOP/s
    assert metric_reader("mfu.eval")(o) == pytest.approx(100 * 7e12 * 40 / (20 * 989e12))
    assert metric_reader("mfu.serve")(o) == metric_reader("mfu.eval")(o)
    assert metric_reader("mfu.train")(outcome(dtype="float32")) == pytest.approx(100 * 7e12 * 40 / (20 * 67e12))
    # fps: 3 launches, 0.14 s in the trace over 2 calls; bound 2 ms a call
    assert metric_reader("fps_roofline.eval")(o) == pytest.approx(100 * 2.0 / 70.0)
    assert metric_reader("sa_tile_roofline.eval")(o) == pytest.approx(100 * 10.0 / 100.0)
    assert metric_reader("sa_tile_roofline.serve")(o) == pytest.approx(100 * 10.0 / 100.0)
    assert metric_reader("grouping_roofline.train")(o) == pytest.approx(100 * 20.0 / 95.0)
    assert metric_reader("device_idle_share.eval")(o) == pytest.approx(51.0)
    assert metric_reader("device_idle_share.train")(o) == pytest.approx(51.0)
    assert metric_reader("device_idle_share.serve")(o) == pytest.approx(51.0)


def test_readers_find_nothing_without_their_source():
    o = outcome(trace=None, spans={}, bounds_ms={}, image_branch_ms=[], calls=0, window_s=0.0, call_ms=[])
    for name in ("upload_ms.eval", "host_prep_ms.eval", "cache_upload_ms.serve", "torch_elementwise_ms.train",
                 "image_branch_ms.eval", "fps_roofline.eval", "sa_tile_roofline.eval", "grouping_roofline.train",
                 "device_idle_share.eval", "device_idle_share.serve", "mfu.eval", "mfu.serve",
                 "sa_tile_roofline.serve", "eval_scenes_per_s", "serve_scenes_per_s", "eval_batch_p90_ms"):
        assert metric_reader(name)(o) is None, name
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert read_metrics(o, spec["per_layer"]) == {}


def test_chrome_trace_is_read_back(tmp_path):
    us = 1e6
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": s * us, "dur": d * us} for n, s, d in OPS]
    events += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s * us, "dur": d * us} for n, s, d in RANGES]
    events += [{"ph": "X", "cat": "user_annotation", "name": "ProfilerStep#1", "ts": 0, "dur": 2 * us},
               {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.1 * us, "dur": 0.01 * us}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = read_chrome_trace(path)
    assert t.busy_s() == pytest.approx(0.49) and t.window_s == pytest.approx(1.0)
    assert [r[0] for r in t.ranges] == [r[0] for r in RANGES]
