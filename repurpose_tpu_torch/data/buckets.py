"""Bucket selection from a corpus length histogram
(``repurpose_tpu/data/buckets.py``, numpy only).

Batches pad to static buckets (``TrainConfig.buckets``); this module picks
the bucket set that minimises the total padded seconds for a given number of
buckets (an exact dynamic program over lengths rounded up to ``ALIGN``).
``ALIGN`` = 128 keeps every bucket a multiple of the attention kernels'
64-row tiles.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np

ALIGN = 128


def lengths_from_label_json(path: str) -> list[int]:
    """Per-video feature lengths from a reference-schema label JSON
    (the dataset's sequence length is the timeRangeOffset span,
    dataset/RepurposeClip.py:423-437)."""
    with open(path) as f:
        entries = json.load(f)
    out = []
    for e in entries:
        tr = e.get("timeRangeOffset") or e.get("timeRange") or [0, 0]
        out.append(int(tr[1] - tr[0]) + 1)
    return out


def padding_waste(lengths: Sequence[int], buckets: Sequence[int]) -> int:
    """Total padded seconds: each sample pads to the smallest bucket >= len
    (samples longer than every bucket clamp to the largest, as the loader
    truncates them)."""
    buckets = sorted(buckets)
    waste = 0
    for ln in lengths:
        b = next((b for b in buckets if b >= ln), buckets[-1])
        waste += max(b - min(ln, b), 0)
    return waste


def suggest_buckets(
    lengths: Sequence[int], n_buckets: int = 4, align: int = ALIGN
) -> tuple[int, ...]:
    """Exact optimal ``n_buckets`` bucket sizes minimizing total padding.

    Candidates are the align-rounded-up observed lengths (an optimal bucket
    set always sits at such points: lowering a bucket below the largest
    length it serves is infeasible, raising it only adds waste). DP over
    sorted candidates: dp[k][j] = min waste covering candidates <= c_j using
    k buckets with the k-th bucket exactly c_j.
    """
    lengths = np.asarray([max(int(x), 1) for x in lengths])
    if len(lengths) == 0:
        raise ValueError("no lengths")
    rounded = np.unique((lengths + align - 1) // align * align)
    cands = rounded.astype(np.int64)
    c = len(cands)
    n_buckets = min(n_buckets, c)
    # counts[j], mass[j]: #samples and summed length of samples whose rounded
    # length == cands[j]
    idx = np.searchsorted(cands, (lengths + align - 1) // align * align)
    counts = np.bincount(idx, minlength=c).astype(np.int64)
    mass = np.bincount(idx, weights=lengths, minlength=c).astype(np.int64)
    csum_n = np.concatenate([[0], np.cumsum(counts)])
    csum_m = np.concatenate([[0], np.cumsum(mass)])

    def seg_cost(i: int, j: int) -> int:
        """Waste when samples in candidate range (i, j] all pad to cands[j]."""
        n = csum_n[j + 1] - csum_n[i + 1]
        m = csum_m[j + 1] - csum_m[i + 1]
        return int(cands[j]) * int(n) - int(m)

    INF = float("inf")
    dp = np.full((n_buckets + 1, c), INF)
    parent = np.full((n_buckets + 1, c), -1, np.int64)
    for j in range(c):
        dp[1][j] = seg_cost(-1, j)
    for k in range(2, n_buckets + 1):
        for j in range(k - 1, c):
            best, arg = INF, -1
            for i in range(k - 2, j):
                v = dp[k - 1][i] + seg_cost(i, j)
                if v < best:
                    best, arg = v, i
            dp[k][j] = best
            parent[k][j] = arg
    # the largest bucket must cover the longest sample
    j = c - 1
    out = []
    k = n_buckets
    while k >= 1:
        out.append(int(cands[j]))
        j = int(parent[k][j])
        k -= 1
    return tuple(sorted(out))
