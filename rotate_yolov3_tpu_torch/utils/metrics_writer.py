"""Structured training-metrics writer: CSV + JSONL (+ optional TensorBoard).

A copy of ``rotate_yolov3_tpu/utils/metrics_writer.py``. The training CLI
keeps the reference's ``results.txt`` row per epoch and adds:

  * ``metrics.csv``   — one row per epoch, stable column set;
  * ``metrics.jsonl`` — the full metric dict per epoch;
  * TensorBoard event files if a writer is importable
    (``torch.utils.tensorboard`` or ``tensorboardX``); without one, only
    the CSV and JSONL files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, out_dir: str, tensorboard: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.csv_path = os.path.join(out_dir, "metrics.csv")
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")
        self._csv_columns = None
        if os.path.exists(self.csv_path):
            with open(self.csv_path) as f:
                header = f.readline().strip()
            if header:
                self._csv_columns = header.split(",")

        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
            except Exception:
                try:
                    from tensorboardX import SummaryWriter
                    self._tb = SummaryWriter(os.path.join(out_dir, "tb"))
                except Exception:
                    self._tb = None

    def write(self, step: int, metrics: Dict[str, float],
              prefix: str = "") -> None:
        """Record one epoch/step of scalar metrics."""
        row = {("%s%s" % (prefix, k)): float(v) for k, v in metrics.items()}
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": int(step), **row},
                               sort_keys=True) + "\n")

        if self._csv_columns is None:
            self._csv_columns = ["step"] + sorted(row)
            with open(self.csv_path, "a") as f:
                f.write(",".join(self._csv_columns) + "\n")
        vals = {"step": step, **row}
        with open(self.csv_path, "a") as f:
            f.write(",".join(
                ("%g" % vals[c]) if c in vals else ""
                for c in self._csv_columns) + "\n")

        if self._tb is not None:
            for k, v in row.items():
                self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
