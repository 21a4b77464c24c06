"""Gaussian Soft-NMS over 1-D intervals, batched on the device.

Counterpart of ``soft_nms_tpu`` (``repurpose_tpu/ops/softnms.py:117-192``),
over a batch ``[B, K]`` of candidate sets at once. It reproduces the
reference's CPU Soft-NMS (models/softnms.py:3-38) with its quirks:

1. the selection counter tests the score at slot i *before* the swap;
2. interval lengths are computed once and indexed by position, never
   swapped, so after a swap the union denominator uses stale lengths;
3. the loop breaks as soon as ``max_seg_num`` candidates pass the threshold,
   before decaying with that pivot;
4. the kept set is "score still > thresh" in post-swap order, truncated to
   ``max_seg_num``.

A negative union denominator gives a finite weight and a zero one with
positive overlap gives weight 0, as in the reference. One documented
deviation (PARITY.md): 0/0 gives weight 0 where the reference gives NaN.

Plain PyTorch: the JAX version is a ``lax.while_loop``, not a Pallas kernel.
Its early exit becomes a Python loop over pivots with a per-row ``done``
mask: a finished row takes no further swaps or decays, exactly as the
vmapped ``while_loop`` leaves it. Whether every row is done is read on the
host only once every ``SYNC_EVERY`` pivots (16), never per video and never
per pivot: a read stalls the host until the card drains its queue, and one
pivot is some fifty small launches, so a read every 16 pivots costs a few
percent of the loop while running at most 15 pivots past the last row's
exit. The loop is bound by those launches (PERF.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SYNC_EVERY = 16


class SoftNMSResult(NamedTuple):
    """Per row: position-ordered candidates after the NMS pass."""

    orig_idx: torch.Tensor  # [B, K] int64 — original candidate index per position
    scores: torch.Tensor  # [B, K] float32 — decayed scores, post-swap order
    keep: torch.Tensor  # [B, K] bool — kept (score > thresh, within budget)


def soft_nms_batch(
    scores: torch.Tensor,  # [B, K]
    segments: torch.Tensor,  # [B, K, 2]
    max_seg_num: torch.Tensor,  # [B] int — per-row budget
    sigma: float = 0.5,
    thresh: float = 0.001,
) -> SoftNMSResult:
    """Soft-NMS of every row. Padded candidates carry score 0 and segment
    (0, 0): they never decay real ones and are never selected."""
    bsz, k = scores.shape
    dev = scores.device
    s = scores.float().clone()
    b = segments[..., 0].float().clone()
    e = segments[..., 1].float().clone()
    lengths = e - b  # position-indexed, never swapped (quirk 2)
    idx = torch.arange(k, device=dev).expand(bsz, k).clone()
    pos = torch.arange(k, device=dev)
    max_segments = torch.clamp(max_seg_num.to(dev).long(), max=k)
    selected = torch.zeros(bsz, dtype=torch.long, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    rows = torch.arange(bsz, device=dev)

    for i in range(k):
        if i % SYNC_EVERY == 0 and i and bool(done.all()):
            break
        active = ~done
        tscore = s[:, i].clone()  # pre-swap (quirk 1)
        tail = pos > i
        if i < k - 1:
            j = torch.where(tail, s, -torch.inf).argmax(dim=1)  # first max, as argmax
            do_swap = active & (tscore < s[rows, j])
            for a in (s, b, e, idx):
                ai, aj = a[:, i].clone(), a[rows, j]
                a[:, i] = torch.where(do_swap, aj, ai)
                a[rows, j] = torch.where(do_swap, ai, aj)
        hit = active & (tscore > thresh)
        selected += hit.long()
        stop = hit & (selected >= max_segments)  # quirk 3

        overlap = (torch.minimum(e[:, i : i + 1], e) - torch.maximum(b[:, i : i + 1], b)).clamp(min=0.0)
        total = lengths[:, i : i + 1] + lengths - overlap
        ratio = overlap / total  # IEEE: x/0 = inf, 0/0 = nan
        weight = torch.exp(-(ratio * ratio) / sigma)
        weight = torch.nan_to_num(weight, nan=0.0)
        decay = tail & (active & ~stop)[:, None]
        s = torch.where(decay, s * weight, s)
        # early exit once no tail candidate can still pass the threshold
        no_tail_left = ~(torch.where(tail, s, 0.0) > thresh).any(dim=1)
        done = done | (active & (stop | no_tail_left))

    passing = s > thresh
    rank = torch.cumsum(passing.long(), dim=1)
    keep = passing & (rank <= max_segments[:, None])  # quirk 4
    return SoftNMSResult(orig_idx=idx, scores=s, keep=keep)
