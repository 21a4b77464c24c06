"""Per-second supervision targets from segment annotations (numpy only).

Copied from ``repurpose_tpu/data/labels.py``, which re-derives the
reference's label builders (dataset/RepurposeClip.py:322-399), parity quirks
included: length ``int(end - start) + 1``, labels over the inclusive integer
range, offsets from float endpoints with the first matching segment winning.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def generate_time_status_list(
    time_range: Sequence[float], segments: Sequence[Sequence[float]]
) -> np.ndarray:
    """Binary per-second labels, shape (T,), dtype int32. A segment writing
    past the range raises, as the reference's per-index loop does."""
    t0, t1 = time_range
    total_seconds = int(t1 - t0) + 1
    status = np.zeros(max(total_seconds, 0), dtype=np.int32)
    it0, it1 = int(t0), int(t1)
    for seg in segments:
        start = max(int(seg[0]), it0)
        end = min(int(seg[1]), it1)
        if end >= start:
            if end - it0 >= len(status):
                raise IndexError(
                    f"segment {seg} writes past the {len(status)}-slot range "
                    f"{time_range} (reference RepurposeClip.py:342 raises here)"
                )
            status[start - it0 : end - it0 + 1] = 1
    return status


def generate_regression_offsets(
    time_range: Sequence[float], segments: Sequence[Sequence[float]]
) -> np.ndarray:
    """Per-second (left, right) boundary offsets, shape (T, 2), dtype float32."""
    if not isinstance(time_range, (list, tuple, np.ndarray)) or len(time_range) != 2:
        return np.zeros((1, 2), dtype=np.float32)
    t0, t1 = float(time_range[0]), float(time_range[1])
    if t1 <= t0:
        return np.zeros((1, 2), dtype=np.float32)
    total_seconds = int(t1 - t0) + 1
    offsets = np.zeros((total_seconds, 2), dtype=np.float32)
    if not len(segments):
        return offsets

    times = t0 + np.arange(total_seconds, dtype=np.float64)
    assigned = np.zeros(total_seconds, dtype=bool)
    for seg in segments:
        if not isinstance(seg, (list, tuple, np.ndarray)) or len(seg) != 2:
            continue
        s0, s1 = float(seg[0]), float(seg[1])
        if s1 <= s0:
            continue
        inside = (times >= s0) & (times <= s1) & ~assigned
        offsets[inside, 0] = (times[inside] - s0).astype(np.float32)
        offsets[inside, 1] = (s1 - times[inside]).astype(np.float32)
        assigned |= inside
    return offsets
