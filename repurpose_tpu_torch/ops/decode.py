"""Batched static-shape decode: logits -> candidate segments -> Soft-NMS.

Counterpart of ``repurpose_tpu/ops/decode.py``, which re-derives the
reference's per-video decode (MMCTransformer.inference_single_video,
models/MMCTransformer.py:181-229, and the per-minute budget of inference_,
:231-275) as fixed-shape programs. Here every function takes the batch
dimension directly (the JAX package vmaps a per-video function):

- threshold, then top-k by score. ``lax.top_k`` puts the lower index first
  on ties and both compaction passes depend on that order, while
  ``torch.topk`` on CUDA promises no tie order; so top-k is a stable
  descending ``torch.sort`` sliced to k;
- duration gates, then a second stable sort that moves the valid candidates
  to the front in descending-score order (the reference's boolean
  compaction, whose positions Soft-NMS's stale-length quirk depends on);
- ``soft_nms_batch`` with the per-video budget ceil((duration // 60) * rate).

Kept entries carry their original (undecayed) scores, as the reference's do.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import torch

from repurpose_tpu_torch.config import TestConfig
from repurpose_tpu_torch.ops.softnms import soft_nms_batch


class DecodeResult(NamedTuple):
    """Fixed-size per-video results; only entries with keep=True are real."""

    segments: torch.Tensor  # [B, K, 2] float32
    scores: torch.Tensor  # [B, K] float32
    labels: torch.Tensor  # [B, K] int64 — source timestep index (reference 'labels')
    keep: torch.Tensor  # [B, K] bool


def max_segments_for_duration(duration, max_seg_per_min: float) -> torch.Tensor:
    """ceil((duration // 60) * rate) in exact integer arithmetic.

    The reference evaluates the product in float64; float32 would inflate the
    budget by 1 for many durations (50 min * 0.3 -> 15.000001 -> 16). The
    config rate is taken as an exact rational p/q, so the ceil is
    (mins * p + q - 1) // q."""
    mins = torch.as_tensor(duration).long() // 60
    frac = Fraction(float(max_seg_per_min)).limit_denominator(10_000)
    p, q = frac.numerator, frac.denominator
    return (mins * p + (q - 1)) // q


def _top_k_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode_candidates(
    cls_logits: torch.Tensor,  # [B, T] float32
    offsets: torch.Tensor,  # [B, T, 2] float32
    mask: torch.Tensor,  # [B, T] bool
    test_cfg: TestConfig,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Threshold, top-k, segment build, duration gates, compaction. Returns
    (segments [B,K,2], scores [B,K], labels [B,K], valid [B,K]) with valid
    candidates first in descending-score order."""
    t = cls_logits.shape[1]
    k = min(test_cfg.pre_nms_topk, t)

    prob = torch.sigmoid(cls_logits.float()) * mask.float()
    gated = torch.where(prob > test_cfg.pre_nms_thresh, prob, -1.0)
    vals, idx = _top_k_stable(gated, k)

    off = torch.gather(offsets.float(), 1, idx[..., None].expand(-1, -1, 2))
    left = idx.float() - off[..., 0]
    right = idx.float() + off[..., 1]
    dur = right - left
    valid = (
        (vals > test_cfg.pre_nms_thresh)
        & (dur > test_cfg.duration_thresh)
        & (dur < test_cfg.duration_thresh_max)
    )

    _, perm = _top_k_stable(torch.where(valid, vals, -1.0), k)
    vals, idx, left, right, valid = (
        torch.gather(a, 1, perm) for a in (vals, idx, left, right, valid)
    )
    segments = torch.where(valid[..., None], torch.stack([left, right], dim=-1), 0.0)
    scores = torch.where(valid, vals, 0.0)
    labels = torch.where(valid, idx, -1)
    return segments, scores, labels, valid


def decode_batch(
    cls_logits: torch.Tensor,  # [B, T] float32
    offsets: torch.Tensor,  # [B, T, 2] float32
    mask: torch.Tensor,  # [B, T] bool
    durations: torch.Tensor,  # [B] int — true (unpadded) lengths in seconds
    test_cfg: TestConfig,
) -> DecodeResult:
    """Decode + Soft-NMS of every video of the batch, on the tensors' device
    (the JAX package's ``decode_video`` vmapped)."""
    segments, scores, labels, _ = decode_candidates(cls_logits, offsets, mask, test_cfg)
    max_segs = max_segments_for_duration(durations, test_cfg.max_seg_per_min)
    nms = soft_nms_batch(
        scores, segments, max_segs, sigma=test_cfg.nms_sigma, thresh=test_cfg.min_score
    )
    o = nms.orig_idx
    return DecodeResult(
        segments=torch.gather(segments, 1, o[..., None].expand(-1, -1, 2)),
        scores=torch.gather(scores, 1, o),
        labels=torch.gather(labels, 1, o),
        keep=nms.keep,
    )


def unpack_rows(
    packed: torch.Tensor,  # [B, T, ...] — model output on a sequence-packed batch
    row_of: torch.Tensor,  # [N] — packed row holding video i
    start: torch.Tensor,  # [N] — video i's offset within its row
    length: torch.Tensor,  # [N] — video i's (truncated) duration
) -> tuple[torch.Tensor, torch.Tensor]:
    """Invert sequence packing on the device: ``out[i, p] =
    packed[row_of[i], start[i] + p]`` for p < length[i] (clamped garbage
    beyond, masked False). Returns (out [N, T, ...], mask [N, T])."""
    t = packed.shape[1]
    pos = torch.arange(t, device=packed.device)
    idx = torch.clamp(start.long()[:, None] + pos[None, :], max=t - 1)  # [N, T]
    rows = packed[row_of.long()]  # [N, T, ...]
    idx = idx.reshape(idx.shape + (1,) * (packed.ndim - 2)).expand(rows.shape)
    out = torch.gather(rows, 1, idx)
    mask = pos[None, :] < length.long()[:, None]
    return out, mask


def decode_packed(
    cls_logits: torch.Tensor,  # [B, T] — packed-batch logits
    offsets: torch.Tensor,  # [B, T, 2]
    row_of: torch.Tensor,  # [N] — packing_layout
    start: torch.Tensor,  # [N]
    length: torch.Tensor,  # [N]
    test_cfg: TestConfig,
) -> DecodeResult:
    """Per-video decode + Soft-NMS of a sequence-packed batch: unpack the
    outputs to per-video rows, then ``decode_batch``. Length-0 entries
    (capacity padding) decode to keep=all-False."""
    logits_v, mask_v = unpack_rows(cls_logits, row_of, start, length)
    offsets_v, _ = unpack_rows(offsets, row_of, start, length)
    return decode_batch(logits_v, offsets_v, mask_v, length, test_cfg)
