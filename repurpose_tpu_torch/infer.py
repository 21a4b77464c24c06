"""Batched inference on the card: features -> ranked clips.

Counterpart of ``repurpose_tpu/infer.py``. The MMCT forward (attention in the
CUDA flash kernel), decode and Soft-NMS run on the device for a whole batch;
the host makes ONE device->host copy per batch and unpacks the fixed-size
keep masks into per-video result lists (the reference's schema,
MMCTransformer.py:226-228, 270-272).

Differences from the JAX pipeline: PyTorch runs eagerly, so there is no
compile per shape; the ring-attention mesh branches are not ported (a
"ring" config scores with the kernel attention, as the JAX pipeline does
without a mesh); ``params`` overrides are state dicts, applied with
``torch.func.functional_call``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import ModelConfig, TestConfig
from repurpose_tpu_torch.data.batching import iter_packed_batches, pick_bucket
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops.decode import (
    DecodeResult,
    decode_batch,
    decode_packed,
    unpack_rows,
)


def _unpack(res: DecodeResult, durations, video_ids, raw=None) -> list[dict]:
    """Fixed-size decode output -> per-video result dicts (rows beyond
    len(video_ids) are batch padding). ``raw`` (cls_logits [B,T,1], offsets
    [B,T,2]) attaches the model's duration-sliced raw outputs.

    Everything comes over in one copy: the outputs are laid side by side in
    one float32 tensor on the device (labels < 2**24 and the keep flags are
    exact in float32), so the host waits for the device once per batch."""
    b, k = res.scores.shape
    parts = [res.segments.reshape(b, 2 * k), res.scores, res.labels.float(),
             res.keep.float()]
    if raw is not None:
        t = raw[0].shape[1]
        parts += [raw[0].reshape(b, t).float(), raw[1].reshape(b, 2 * t).float()]
    host = torch.cat(parts, dim=1).cpu().numpy()
    segments = host[:, : 2 * k].reshape(b, k, 2)
    scores = host[:, 2 * k : 3 * k]
    labels = host[:, 3 * k : 4 * k].astype(np.int32)
    keep = host[:, 4 * k : 5 * k] > 0.5
    out = []
    for i in range(b):
        kp = keep[i]
        has_id = video_ids is not None and i < len(video_ids)
        r = {
            "segments": segments[i][kp],
            "scores": scores[i][kp],
            "labels": labels[i][kp],
            "video_id": video_ids[i] if has_id else str(i),
            "duration": int(durations[i]),
        }
        if raw is not None:
            d = int(durations[i])
            r["raw_logits"] = host[i, 5 * k : 5 * k + t][:d]
            r["raw_offsets"] = host[i, 5 * k + t :].reshape(t, 2)[:d]
        out.append(r)
    return out


class InferencePipeline:
    """Scores batches of per-second features and returns ranked clip lists.

    ``params`` is a state dict in the reference's names (tensors or numpy
    arrays), loaded strictly. ``device`` defaults to CUDA and raises when no
    card is visible; pass ``device="cpu"`` to run on the CPU."""

    def __init__(
        self, cfg: ModelConfig, params: Mapping[str, Any], test_cfg: TestConfig,
        raw_outputs: bool = False, device: str | torch.device = "cuda",
    ):
        if cfg.attention_impl == "ring":
            cfg = dataclasses.replace(cfg, attention_impl="auto")
        self.cfg = cfg
        self.test_cfg = test_cfg
        self.raw_outputs = raw_outputs
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.model.load_state_dict(
            {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
             for k, v in params.items()},
            strict=True,
        )

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    @torch.inference_mode()
    def _forward(self, params, *args, **kwargs):
        if params is None:
            return self.model(*args, **kwargs)
        return torch.func.functional_call(self.model, params, args, kwargs)

    @torch.inference_mode()
    def _forward_and_decode(self, params, visual, audio, text, mask, durations):
        stage = self._to_device
        mask = stage(mask, torch.bool)
        durations = stage(durations, torch.int64)
        out = self._forward(params, stage(visual), stage(audio), stage(text), mask)
        res = decode_batch(out.cls_logits[..., 0], out.offsets, mask, durations,
                           self.test_cfg)
        return res, ((out.cls_logits, out.offsets) if self.raw_outputs else None)

    @torch.inference_mode()
    def _forward_and_decode_packed(self, params, batch, layout):
        # several videos per row with block-diagonal attention; the outputs
        # are unpacked to per-video rows on the device before the decode
        stage = self._to_device
        out = self._forward(
            params, stage(batch.visual), stage(batch.audio), stage(batch.text),
            stage(batch.mask, torch.bool),
            seg_ids=stage(batch.seg_ids, torch.int32),
            positions=stage(batch.positions, torch.int64),
        )
        row_of, start, length = (stage(a, torch.int64) for a in layout)
        if self.raw_outputs:
            logits_v, mask_v = unpack_rows(out.cls_logits[..., 0], row_of, start, length)
            offsets_v, _ = unpack_rows(out.offsets, row_of, start, length)
            res = decode_batch(logits_v, offsets_v, mask_v, length, self.test_cfg)
            return res, (logits_v[..., None], offsets_v)
        res = decode_packed(out.cls_logits[..., 0], out.offsets, row_of, start,
                            length, self.test_cfg)
        return res, None

    def score_batch(
        self,
        visual: Any,  # [B, T, vis_dim]
        audio: Any,
        text: Any,
        mask: Any,  # [B, T] bool
        durations: Sequence[int],
        video_ids: Sequence[str] | None = None,
        params: Mapping[str, torch.Tensor] | None = None,
    ) -> list[dict]:
        """One dict per video: {segments (N,2), scores (N,), labels (N,),
        video_id, duration}. ``params`` overrides the instance weights."""
        res, raw = self._forward_and_decode(params, visual, audio, text, mask, durations)
        return _unpack(res, durations, video_ids, raw)

    def score_videos(
        self,
        videos: Sequence[dict],
        buckets: Sequence[int] = (256, 512, 1024, 2048),
        batch_size: int = 8,
        depth: int = 2,
        params: Mapping[str, torch.Tensor] | None = None,
        pack: bool = False,
    ) -> list[dict]:
        """Serve ragged per-video features with multi-bucket routing.

        ``videos``: dicts with ``visual [T,512] / audio [T,2048] / text
        [T,384]`` and an optional ``video_id``. Each video routes to the
        smallest bucket >= its length (longer ones truncate to the largest);
        videos sharing a bucket form batches of at most ``batch_size``, with
        a ragged tail padded to the smallest power of two >= its videos.
        Results return in input order. ``pack=True`` sequence-packs each
        bucket's videos (first-fit decreasing) and gives the same results."""
        if pack:
            return self._score_videos_packed(videos, buckets, batch_size, depth, params)
        buckets = sorted(buckets)
        lens = _lengths(videos)
        groups: dict[int, list[int]] = {}
        for i, t in enumerate(lens):
            groups.setdefault(pick_bucket(t, buckets), []).append(i)

        chunk_fifo: collections.deque = collections.deque()

        def batches():
            for bucket in sorted(groups):
                idxs = groups[bucket]
                for j in range(0, len(idxs), batch_size):
                    chunk = idxs[j : j + batch_size]
                    b = 1
                    while b < len(chunk):
                        b *= 2
                    b = min(b, batch_size)
                    vis = np.zeros((b, bucket, self.cfg.vis_dim), np.float32)
                    aud = np.zeros((b, bucket, self.cfg.aud_dim), np.float32)
                    txt = np.zeros((b, bucket, self.cfg.text_dim), np.float32)
                    mask = np.zeros((b, bucket), bool)
                    durs = np.zeros(b, np.int32)
                    ids = []
                    for r, i in enumerate(chunk):
                        v = videos[i]
                        t = min(
                            len(v["visual"]), len(v["audio"]), len(v["text"]), bucket
                        )
                        vis[r, :t] = v["visual"][:t]
                        aud[r, :t] = v["audio"][:t]
                        txt[r, :t] = v["text"][:t]
                        mask[r, :t] = True
                        durs[r] = t
                        ids.append(str(v.get("video_id", i)))
                    chunk_fifo.append(chunk)
                    yield (vis, aud, txt, mask, durs, ids)

        results: list[dict | None] = [None] * len(videos)
        for batch_results in self.score_stream(batches(), depth=depth, params=params):
            for i, r in zip(chunk_fifo.popleft(), batch_results):
                results[i] = r
        return results  # type: ignore[return-value]

    def _score_videos_packed(
        self, videos, buckets, batch_size: int, depth: int, params,
    ) -> list[dict]:
        """score_videos(pack=True), staged through iter_packed_batches (rows
        padded to a power of two, per-video layout padded to a per-bucket
        capacity with length-0 entries)."""
        buckets = sorted(buckets)
        lengths = _lengths(videos)

        def fetch(i):
            v = videos[i]
            # duration from the features, as the unpacked path takes it
            t = min(len(v["visual"]), len(v["audio"]), len(v["text"]))
            return {
                "visual": v["visual"], "audio": v["audio"], "text": v["text"],
                "duration": t, "video_id": v.get("video_id", i),
            }

        results: list[dict | None] = [None] * len(videos)
        gidx_fifo: collections.deque = collections.deque()

        def stream_items():
            for batch, layout, gidx, samples in iter_packed_batches(
                fetch, lengths, buckets, batch_size, row_bucket=True
            ):
                ids = [str(s.get("video_id", i)) for i, s in zip(gidx, samples)]
                gidx_fifo.append(gidx)
                yield batch, layout, ids

        for rs in self.score_packed_stream(stream_items(), depth=depth, params=params):
            for i, r in zip(gidx_fifo.popleft(), rs):
                results[i] = r
        return results  # type: ignore[return-value]

    def score_packed_stream(self, items, depth: int = 2, params=None):
        """Sequence-packed scoring: ``items`` yields ``(batch, (row_of, start,
        length), video_ids)``; yields one per-video result list per item, in
        order, with up to ``depth`` batches enqueued on the device."""
        pending: collections.deque = collections.deque()
        for batch, layout, ids in items:
            while len(pending) >= depth:
                yield _unpack(*pending.popleft())
            res, raw = self._forward_and_decode_packed(params, batch, layout)
            pending.append((res, list(layout[2]), ids, raw))
        while pending:
            yield _unpack(*pending.popleft())

    def score_stream(self, batches, depth: int = 2, params=None):
        """Scoring of an iterator of (visual, audio, text, mask, durations,
        video_ids) tuples; yields per-video result lists in order, with up to
        ``depth`` batches enqueued on the device before the oldest is read
        back (the Soft-NMS loop's periodic done-check bounds how far ahead
        the host gets)."""
        pending: collections.deque = collections.deque()
        for item in batches:
            visual, audio, text, mask, durations, video_ids = item
            while len(pending) >= depth:
                yield _unpack(*pending.popleft())
            res, raw = self._forward_and_decode(
                params, visual, audio, text, mask, durations
            )
            pending.append((res, list(durations), video_ids, raw))
        while pending:
            yield _unpack(*pending.popleft())


def _lengths(videos) -> list[int]:
    """Per-video lengths: ``videos.lengths()`` where the sequence has it (no
    feature load just to measure), else the shortest stream of each video."""
    if hasattr(videos, "lengths"):
        return [int(t) for t in videos.lengths()]
    return [min(len(v["visual"]), len(v["audio"]), len(v["text"])) for v in videos]
