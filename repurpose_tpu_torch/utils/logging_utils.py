"""Metric logging as JSON lines, and to wandb when asked for
(``repurpose_tpu/utils/logging_utils.py``). Each record is one line of
``workdir/metrics.jsonl``. ``use_wandb`` imports wandb at construction
only; where it is missing or its run cannot start, the logger warns and
keeps to the JSONL file. Only the main rank (``is_main``) writes."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

import numpy as np

from repurpose_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class MetricLogger:
    def __init__(self, workdir: str, use_wandb: bool = False,
                 config: Mapping | None = None, is_main: bool = True):
        self.is_main = is_main
        self._file = None
        self._wandb = None
        if not is_main:
            return
        os.makedirs(workdir, exist_ok=True)
        self._file = open(os.path.join(workdir, "metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                wandb.init(
                    project=os.environ.get("WANDB_PROJECT", "repurpose-tpu"),
                    name=f"mmct_{time.strftime('%Y%m%d_%H%M%S')}",
                    config=dict(config or {}),
                    dir=workdir,
                )
                # set only after init succeeds: a module without a run would
                # make every later log() raise
                self._wandb = wandb
            except Exception as e:  # missing package, no login, no network
                logger.warning("wandb unavailable (%s); JSONL logging only", e)

    def log(self, metrics: Mapping[str, Any], step: int) -> None:
        """One record; tensors and numpy scalars become floats (a device
        tensor is read back here, so log on a cadence)."""
        if not self.is_main:
            return
        with span("train.telemetry"):
            record = {"step": step, "time": time.time()}
            for k, v in metrics.items():
                record[k] = float(v) if hasattr(v, "__float__") else v
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
            if self._wandb is not None:
                self._wandb.log({k: v for k, v in record.items() if k != "time"}, step=step)

    def log_histograms(self, names: list[str], counts, edges, step: int,
                       prefix: str = "grads") -> None:
        """Per-layer histograms, the wandb.watch(model) equivalent: ``counts``
        [L, B] and ``edges`` [L, B + 1] (tensors or arrays), rows labelled by
        ``names``. The JSONL file gets the raw arrays; wandb its Histogram
        objects."""
        if not self.is_main:
            return
        with span("train.telemetry"):
            counts = np.asarray(counts.cpu() if hasattr(counts, "cpu") else counts)
            edges = np.asarray(edges.cpu() if hasattr(edges, "cpu") else edges)
            record: dict[str, Any] = {"step": step, "time": time.time()}
            for i, name in enumerate(names):
                record[f"hist/{prefix}/{name}"] = {"counts": counts[i].tolist(),
                                                   "edges": edges[i].tolist()}
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
            if self._wandb is not None:
                try:
                    self._wandb.log(
                        {f"hist/{prefix}/{n}": self._wandb.Histogram(
                            np_histogram=(counts[i], edges[i])) for i, n in enumerate(names)},
                        step=step,
                    )
                except Exception as e:  # an upload failure must not stop training
                    logger.warning("wandb histogram upload failed: %s", e)

    def log_images(self, paths: list[str], step: int, key: str = "debug") -> None:
        """Uploads debug figures to wandb (nothing without it)."""
        if self._wandb is None:
            return
        try:
            self._wandb.log({key: [self._wandb.Image(p) for p in paths]}, step=step)
        except Exception as e:  # an upload failure must not stop training
            logger.warning("wandb image upload failed: %s", e)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None
