"""Metrics logging (port of ``or4d_tpu/utils/logging.py``; the same
records, keys and files).

The reference logs ~90 per-take scalars through TensorBoardLogger
(scene_graph_prediction_model.py:205-237, main.py:47). Here the equivalent is
a structured JSONL stream (one object per event) that any dashboard can
tail, plus text classification reports on disk.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, log_dir: str | Path, name: str = "metrics"):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{name}.jsonl"
        self._fh = open(self.path, "a")

    def log(self, step: int, **scalars) -> None:
        rec = {"ts": time.time(), "step": int(step)}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def log_report(self, tag: str, step: int, report_text: str) -> None:
        (self.dir / f"{tag}_step{step}.txt").write_text(report_text)

    def log_per_take(self, step: int, split: str, reports: dict) -> None:
        """Per-take per-relation P/R/F1 scalars (the reference's
        '{rel}/{take}_{PR|RE|F1}' logging)."""
        for take, rep in reports.items():
            for i, rel_name in enumerate(rep.labels):
                self.log(
                    step,
                    **{
                        f"{rel_name}/{take}_PR": rep.precision[i],
                        f"{rel_name}/{take}_RE": rep.recall[i],
                        f"{rel_name}/{take}_F1": rep.f1[i],
                    },
                    split=split,
                )

    def close(self) -> None:
        self._fh.close()
