"""Profiling and step timing (``repurpose_tpu/utils/profiling.py`` on
``torch.profiler`` instead of ``jax.profiler``).

- ``trace(logdir)``: a context manager that records the CPU side and, on a
  card, the CUDA side of what runs inside it, and writes a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) and the operator
  table by CPU time (``ops.txt``) into ``logdir``; the profile object is
  yielded for callers that read ``key_averages()`` themselves;
- ``annotate(name)``: a named span in the trace (``record_function``);
- ``StepTimer``: rolling wall-clock step statistics, synchronised with the
  card so that a step boundary is the end of its device work.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profiles the body, the card's activity too where a card is visible."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=50))


def annotate(name: str):
    return record_function(name)


class StepTimer:
    """Rolling step-time stats; ``tick`` returns seconds since the last tick."""

    def __init__(self, window: int = 50):
        self._times: deque[float] = deque(maxlen=window)
        self._last: float | None = None

    def tick(self, sync: bool = False) -> float:
        """With ``sync``, waits for the card's queued work first."""
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        if self._last is not None:
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def p50(self) -> float:
        if not self._times:
            return 0.0
        s = sorted(self._times)
        return s[len(s) // 2]

    def summary(self) -> dict:
        return {"step_time_mean_s": self.mean, "step_time_p50_s": self.p50}
