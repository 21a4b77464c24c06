"""Metric logging as JSON lines (``repurpose_tpu/utils/logging_utils.py``
without wandb and without the multi-host process check: the port trains in
one process). Each record is one line of ``workdir/metrics.jsonl``."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class MetricLogger:
    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self._file = open(os.path.join(workdir, "metrics.jsonl"), "a")

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        """One record; tensors and numpy scalars become floats (a device
        tensor is read back here, so log on a cadence)."""
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
