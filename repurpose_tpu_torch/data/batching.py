"""Fixed-shape bucketed batching and sequence packing (numpy only).

Copied from ``repurpose_tpu/data/batching.py``; ``iter_packed_batches``
records each batch's build as an ``infer.batch_build`` span
(``utils/profiling.py``). Each batch is padded to the
smallest configured bucket >= its longest sample; ``pack_batch`` lays
several videos head-to-tail in one row, with ``seg_ids`` for block-diagonal
attention and ``positions`` restarting the positional encoding per video.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Sequence

import numpy as np

from repurpose_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class Batch(NamedTuple):
    visual: np.ndarray  # [B, T, vis_dim] float32
    audio: np.ndarray  # [B, T, aud_dim] float32
    text: np.ndarray  # [B, T, text_dim] float32
    mask: np.ndarray  # [B, T] bool
    labels: np.ndarray  # [B, T] float32
    segments: np.ndarray  # [B, T, 2] float32 — per-second GT (left, right)
    durations: np.ndarray  # [B] int32 — true lengths
    seg_ids: np.ndarray | None = None  # [B, T] int32, -1 on padding
    positions: np.ndarray | None = None  # [B, T] int32, 0-based within video


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= length; longer sequences truncate to the largest
    bucket, with a warning (once per bucket config)."""
    for b in buckets:
        if length <= b:
            return b
    if buckets[-1] not in _truncation_warned:
        _truncation_warned.add(buckets[-1])
        logger.warning(
            "sequence of length %d exceeds the largest bucket %d and will be "
            "TRUNCATED — add a larger bucket to keep the tail (warned once)",
            length, buckets[-1],
        )
    return buckets[-1]


_truncation_warned: set[int] = set()


def collate(
    samples: Sequence[dict], buckets: Sequence[int], batch_size: int | None = None
) -> Batch:
    """Pad per-video sample dicts (visual, audio, text, labels, segments,
    duration) into one fixed-shape Batch; ``batch_size`` pads the batch
    dimension with all-masked rows."""
    n = len(samples)
    b = n if batch_size is None else batch_size
    if b < n:
        raise ValueError(
            f"batch_size={batch_size} smaller than the {n} samples given"
        )
    t = pick_bucket(max(s["duration"] for s in samples), buckets)

    def dim(key):
        return samples[0][key].shape[-1]

    visual = np.zeros((b, t, dim("visual")), np.float32)
    audio = np.zeros((b, t, dim("audio")), np.float32)
    text = np.zeros((b, t, dim("text")), np.float32)
    mask = np.zeros((b, t), bool)
    labels = np.zeros((b, t), np.float32)
    segments = np.zeros((b, t, 2), np.float32)
    durations = np.zeros((b,), np.int32)

    for i, s in enumerate(samples):
        ln = min(int(s["duration"]), t)
        # streams may be shorter than the duration: clamp per stream and
        # zero-fill the tail (reference RepurposeClip.py:432-437, 466-485)
        for dst, src in (
            (visual[i], s["visual"]), (audio[i], s["audio"]), (text[i], s["text"]),
            (labels[i], s["labels"]), (segments[i], s["segments"]),
        ):
            n_rows = min(ln, len(src))
            dst[:n_rows] = src[:n_rows]
        mask[i, :ln] = True
        durations[i] = ln
    return Batch(visual, audio, text, mask, labels, segments, durations)


def plan_packing(
    durations: Sequence[int], bucket: int, batch_size: int
) -> list[list[list[int]]]:
    """First-fit-decreasing packing plan: ``[batch][row] -> [sample indices]``;
    every row's total duration fits ``bucket``."""
    order = sorted(range(len(durations)), key=lambda i: -min(durations[i], bucket))
    rows: list[tuple[int, list[int]]] = []  # (remaining, indices)
    for i in order:
        d = min(int(durations[i]), bucket)
        for slot, (rem, idxs) in enumerate(rows):
            if d <= rem:
                rows[slot] = (rem - d, idxs + [i])
                break
        else:
            rows.append((bucket - d, [i]))
    row_lists = [idxs for _, idxs in rows]
    return [
        row_lists[i : i + batch_size] for i in range(0, len(row_lists), batch_size)
    ]


def pack_batch(
    samples: Sequence[dict], rows: Sequence[Sequence[int]], bucket: int,
    batch_size: int | None = None,
) -> Batch:
    """Pack per-video sample dicts into one fixed-shape Batch of ``rows``
    (index lists from plan_packing): videos head-to-tail, ``seg_ids`` marks
    each video's span (padding -1), ``positions`` restarts at 0 per video."""
    n = len(rows)
    b = n if batch_size is None else batch_size
    if b < n:
        raise ValueError(f"batch_size={batch_size} smaller than {n} packed rows")
    t = bucket

    def dim(key):
        return samples[0][key].shape[-1]

    visual = np.zeros((b, t, dim("visual")), np.float32)
    audio = np.zeros((b, t, dim("audio")), np.float32)
    text = np.zeros((b, t, dim("text")), np.float32)
    mask = np.zeros((b, t), bool)
    labels = np.zeros((b, t), np.float32)
    segments = np.zeros((b, t, 2), np.float32)
    durations = np.zeros((b,), np.int32)
    seg_ids = np.full((b, t), -1, np.int32)
    positions = np.zeros((b, t), np.int32)

    has_targets = "labels" in samples[0]  # inference samples carry features only
    for i, idxs in enumerate(rows):
        off = 0
        for seg, j in enumerate(idxs):
            s = samples[j]
            ln = min(int(s["duration"]), t)
            if off + ln > t:
                raise ValueError(
                    f"row {i} overflows bucket {t} (offset {off} + video {ln})"
                )
            streams = [
                (visual[i], s["visual"]), (audio[i], s["audio"]),
                (text[i], s["text"]),
            ]
            if has_targets:
                streams += [(labels[i], s["labels"]), (segments[i], s["segments"])]
            for dst, src in streams:
                n_rows = min(ln, len(src))
                dst[off : off + n_rows] = src[:n_rows]
            mask[i, off : off + ln] = True
            seg_ids[i, off : off + ln] = seg
            positions[i, off : off + ln] = np.arange(ln)
            off += ln
        durations[i] = off
    return Batch(
        visual, audio, text, mask, labels, segments, durations,
        seg_ids=seg_ids, positions=positions,
    )


def packing_layout(
    rows: Sequence[Sequence[int]], durations: Sequence[int], bucket: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-video (sample_idx, row, start, length) of a pack_batch layout, in
    row-major packed order; feeds ops/decode.py:unpack_rows."""
    sample_idx, row_of, start, length = [], [], [], []
    for r, idxs in enumerate(rows):
        off = 0
        for i in idxs:
            ln = min(int(durations[i]), bucket)
            sample_idx.append(i)
            row_of.append(r)
            start.append(off)
            length.append(ln)
            off += ln
    return (
        np.asarray(sample_idx, np.int32),
        np.asarray(row_of, np.int32),
        np.asarray(start, np.int32),
        np.asarray(length, np.int32),
    )


def iter_packed_batches(
    fetch, lengths: Sequence[int], buckets: Sequence[int], batch_size: int,
    indices: Sequence[int] | None = None, row_bucket: bool = False,
):
    """FFD sequence packing over a corpus, one packed batch at a time.

    Groups samples by smallest-fit bucket, plans each bucket's rows
    (plan_packing), pads the per-video layout arrays to a per-bucket capacity
    (a multiple of 8) and loads each batch's samples lazily via ``fetch(i)``.
    Yields ``(batch, (row_of, start, length), gidx, samples)`` with the
    batch's videos in packed (row-major) order. ``row_bucket=True`` pads the
    row count to the smallest power of two >= the rows used (at most
    ``batch_size``) instead of always ``batch_size``."""
    idx = list(range(len(lengths))) if indices is None else list(indices)
    buckets = sorted(buckets)
    groups: dict[int, list[int]] = {}
    for i in idx:
        groups.setdefault(pick_bucket(int(lengths[i]), buckets), []).append(i)
    for bucket in sorted(groups):
        g = groups[bucket]
        durs = [min(int(lengths[i]), bucket) for i in g]
        row_batches = plan_packing(durs, bucket, batch_size)
        cap = max(sum(len(r) for r in rows) for rows in row_batches)
        cap = -(-cap // 8) * 8
        for rows in row_batches:
            needed = sorted({j for row in rows for j in row})
            with span("infer.batch_build", videos=len(needed)):
                lmap = {j: k for k, j in enumerate(needed)}
                samples = [fetch(g[j]) for j in needed]
                rows_l = [[lmap[j] for j in row] for row in rows]
                # placement and layout share one duration source: each fetched
                # sample's own duration, which may be shorter than the planning
                # ``lengths`` (an upper bound for dataset-backed inputs)
                actual = [min(int(s["duration"]), bucket) for s in samples]
                b = batch_size
                if row_bucket:
                    b = 1
                    while b < len(rows_l):
                        b *= 2
                    b = min(b, batch_size)
                batch = pack_batch(samples, rows_l, bucket, batch_size=b)
                sidx, row_of, start, length = packing_layout(rows_l, actual, bucket)
                pad = cap - len(sidx)
                row_of, start, length = (
                    np.pad(a, (0, pad)) for a in (row_of, start, length)
                )
            yield (
                batch,
                (row_of, start, length),
                [g[needed[k]] for k in sidx],
                [samples[k] for k in sidx],
            )
