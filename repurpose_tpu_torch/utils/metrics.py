"""Precision@tIoU, the metric that picks the best checkpoint
(``calculate_tiou`` of ``repurpose_tpu/utils/metrics.py``; host-side numpy
on the short per-video lists after decode and Soft-NMS), and the
reference's per-second AP and recall (``calculate_ap``,
``calculate_recall``: BASELINE.md's secondary metrics)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

Segment = Sequence[float]


def _segment_iou_matrix(preds: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Pairwise IoU between (P, 2) predicted and (R, 2) reference intervals."""
    if preds.size == 0 or refs.size == 0:
        return np.zeros((preds.shape[0], refs.shape[0]))
    start_max = np.maximum(preds[:, None, 0], refs[None, :, 0])
    end_min = np.minimum(preds[:, None, 1], refs[None, :, 1])
    inter = np.maximum(0.0, end_min - start_max)
    union = (
        (preds[:, 1] - preds[:, 0])[:, None]
        + (refs[:, 1] - refs[:, 0])[None, :]
        - inter
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union != 0, inter / union, 0.0)


def calculate_tiou(
    reference_segments: Sequence[Segment],
    predicted_segments: Sequence[Segment],
    tiou_thresholds: Sequence[float] = (0.5,),
) -> Dict[float, float]:
    """Fraction of predictions whose best IoU against any reference segment
    clears each threshold. No predictions: 0; no references: every
    prediction scores IoU 0."""
    preds = np.asarray(predicted_segments, dtype=np.float64).reshape(-1, 2)
    refs = np.asarray(reference_segments, dtype=np.float64).reshape(-1, 2)
    n_pred = preds.shape[0]
    if n_pred == 0:
        return {t: 0.0 for t in tiou_thresholds}
    max_iou = (
        _segment_iou_matrix(preds, refs).max(axis=1)
        if refs.shape[0]
        else np.zeros(n_pred)
    )
    return {t: float(np.mean(max_iou >= t)) for t in tiou_thresholds}


def _mark_seconds(segments: Sequence[Segment], n: int) -> np.ndarray:
    """Per-second 0/1 coverage of predicted segments over an n-second timeline,
    with the reference's inclusive end and boundary clamping."""
    marked = np.zeros(n, dtype=np.int64)
    for seg in segments:
        start = int(seg[0]) if int(seg[0]) >= 0 else 0
        end = int(seg[1]) if int(seg[1]) < n else n - 1
        if end >= start:
            marked[start : end + 1] = 1
    return marked


def calculate_ap(segments: Sequence[Segment], labels: Sequence[int]) -> float:
    """Per-second interpolated average precision of the predicted coverage
    against per-second 0/1 labels (0 when no second is positive)."""
    labels_arr = np.asarray(labels, dtype=np.int64)
    n = labels_arr.shape[0]
    n_pos = int(labels_arr.sum())
    if n_pos == 0:
        return 0.0
    preds = _mark_seconds(segments, n)
    tp = (preds == 1) & (labels_arr == 1)
    cum_pos = np.cumsum(tp)
    precision_at_hits = cum_pos[tp] / (np.nonzero(tp)[0] + 1)
    return float(precision_at_hits.sum() / n_pos)


def calculate_recall(segments: Sequence[Segment], labels: Sequence[int]) -> float:
    """Per-second recall of the predicted coverage (0 when no second is
    positive)."""
    labels_arr = np.asarray(labels, dtype=np.int64)
    n_pos = int(labels_arr.sum())
    if n_pos == 0:
        return 0.0
    preds = _mark_seconds(segments, labels_arr.shape[0])
    tp = int(((preds == 1) & (labels_arr == 1)).sum())
    return tp / n_pos
