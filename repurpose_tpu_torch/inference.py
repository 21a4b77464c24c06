"""Evaluation CLI of the port (the JAX package's root ``inference.py``).

    python -m repurpose_tpu_torch.inference --config_path configs/repurpose.yaml --torch_ckpt best.pth
    python -m repurpose_tpu_torch.inference --config_path configs/longvideo.yaml --resume runs/x/ckpt --pack
    python -m repurpose_tpu_torch.inference --synthetic 16 --device cpu

Scores the test split (or ``--synthetic N`` videos) under the published
protocol and prints precision@tIoU {0.5 .. 0.9} and their mean. Weights come
from a reference ``.pth`` (``--torch_ckpt``, a strict load), from the
checkpoint directory of the port's trainer (``--resume``), or from a random
init of the config's seed. ``--export`` writes the ranked clips manifest,
``--export_torch`` the loaded weights as a reference-schema ``.pth``.
``--device`` defaults to ``cuda`` and raises without a card.

``main(argv)`` parses the flags and loads the YAML config (PyYAML);
``run(cfg, args)`` takes a ``Config`` built in Python instead. Long videos
(``configs/longvideo.yaml``, buckets to 32768) go through the streaming
attention kernel past T = 2048.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import Config, load_config
from repurpose_tpu_torch.data.batching import collate, pick_bucket
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model, load_reference_checkpoint
from repurpose_tpu_torch.train.loop import TIOU_THRESHOLDS
from repurpose_tpu_torch.utils.metrics import calculate_tiou


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.inference")
    p.add_argument("--config_path", default="configs/repurpose.yaml")
    p.add_argument("--resume", default=None,
                   help="checkpoint directory of the port's trainer (<dir>/<step>.pt)")
    p.add_argument("--torch_ckpt", default=None, help="reference .pth checkpoint")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--export", default=None,
                   help="write a ranked clips JSON manifest to this path")
    p.add_argument("--export_torch", default=None, metavar="PATH",
                   help="write the loaded weights as a reference-schema .pth and exit "
                        "without scoring")
    p.add_argument("--pack", action="store_true",
                   help="sequence-pack each bucket's videos (several per row, "
                        "block-diagonal attention): same results, less padding compute; "
                        "features load one packed batch at a time")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log-level", default="INFO")
    return p.parse_args(argv)


def load_params(args: argparse.Namespace, cfg: Config) -> dict:
    """The model state dict the flags name (on the CPU)."""
    if args.torch_ckpt:
        return load_reference_checkpoint(args.torch_ckpt)
    if args.resume:
        from repurpose_tpu_torch.train.checkpoint import Checkpointer

        return Checkpointer(args.resume).restore_model()
    logging.warning("no checkpoint given — using random init (smoke mode)")
    return build_model(cfg.model, "cpu", seed=cfg.train.seed).state_dict()


def build_dataset(cfg: Config, synthetic: int):
    """``synthetic`` in-memory videos with durations drawn as the JAX CLI
    draws them, or the config's test split."""
    if synthetic:
        from repurpose_tpu_torch.data.synthetic import SyntheticDataset

        durations = np.random.default_rng(0).integers(60, cfg.train.buckets[-1], synthetic)
        return SyntheticDataset(durations.tolist(), cfg.model, seed=3)
    from repurpose_tpu_torch.data.dataset import RepurposeDataset

    return RepurposeDataset(cfg.test_dataset, validate=False, keep_gt_segments=True)


class _LazyVideos:
    """The dataset as a lazy sequence for ``score_videos(pack=True)``:
    features load one packed batch at a time; each video's ground truth,
    offset and id are kept as it streams through (every video is fetched
    exactly once)."""

    def __init__(self, ds):
        self._ds = ds
        self.meta: dict[int, dict] = {}

    def __len__(self) -> int:
        return len(self._ds)

    def lengths(self):
        return self._ds.lengths()

    def __getitem__(self, i: int) -> dict:
        s = self._ds[i]
        self.meta[i] = {"gt_segments": s.get("gt_segments") or [],
                        "time_offset": s.get("time_offset", 0.0),
                        "video_id": s["video_id"]}
        return s


def evaluate_dataset(ds, cfg: Config, params, batch_size: int | None = None,
                     pack: bool = False, device: str = "cuda"):
    """Score a dataset under the published protocol: per-video decode,
    Soft-NMS and tIoU against the ground-truth segments. Returns ``(results,
    time_offsets, per_thr)``, ``per_thr`` mapping each tIoU threshold to the
    per-video precision list. Unpacked, videos go in bucket-sorted batches
    through ``score_stream``; packed, the dataset streams lazily through
    ``score_videos(pack=True)``. Each result carries its own ``time_offset``
    (several label entries may share a video id with different time ranges)."""
    pipe = InferencePipeline(dataclasses.replace(cfg.model, dropout=0.0), params,
                             cfg.test_cfg, device=device)
    bs = batch_size or cfg.train.batch_size
    buckets = cfg.train.buckets
    per_thr: dict[float, list[float]] = {t: [] for t in TIOU_THRESHOLDS}
    all_results: list[dict] = []
    time_offsets: dict = {}

    def score(r, gt, offset):
        r["time_offset"] = offset
        tiou = calculate_tiou(gt, r["segments"].tolist(), TIOU_THRESHOLDS)
        for t in TIOU_THRESHOLDS:
            per_thr[t].append(tiou[t])

    if pack:
        lazy = _LazyVideos(ds)
        all_results = list(pipe.score_videos(lazy, buckets=buckets, batch_size=bs,
                                             pack=True))
        for i, r in enumerate(all_results):
            m = lazy.meta[i]
            time_offsets[m["video_id"]] = m["time_offset"]
            score(r, m["gt_segments"], m["time_offset"])
        return all_results, time_offsets, per_thr

    order = list(range(len(ds)))
    if hasattr(ds, "lengths"):  # bucket-sorted (stable): no batch pads to a longer bucket
        lens = ds.lengths()
        order.sort(key=lambda i: pick_bucket(int(lens[i]), buckets))
    sample_blocks: list[list[dict]] = []

    def staged_batches():
        for i0 in range(0, len(order), bs):
            samples = [ds[i] for i in order[i0 : i0 + bs]]
            for s in samples:
                time_offsets[s["video_id"]] = s.get("time_offset", 0.0)
            sample_blocks.append(samples)
            batch = collate(samples, buckets, bs)
            yield (batch.visual, batch.audio, batch.text, batch.mask, batch.durations,
                   [s["video_id"] for s in samples])

    for results in pipe.score_stream(staged_batches()):
        samples = sample_blocks.pop(0)  # FIFO: score_stream yields in order
        for s, r in zip(samples, results):
            score(r, s.get("gt_segments") or [], s.get("time_offset", 0.0))
        all_results.extend(results[: len(samples)])
    return all_results, time_offsets, per_thr


def _finish(args, all_results, time_offsets, per_thr) -> dict:
    """``--export`` and the precision lines, as the JAX CLI prints them;
    returns the per-threshold means and ``"mean"``."""
    if args.export:
        from repurpose_tpu_torch.utils.export import write_manifest

        clips = write_manifest(all_results, args.export, time_offsets=time_offsets)
        print(f"wrote {len(clips)} clips to {args.export}")
    means = {t: float(np.mean(v)) if v else 0.0 for t, v in per_thr.items()}
    for t, v in means.items():
        print(f"precision@tIoU={t}: {v:.4f}")
    overall = float(np.mean(list(means.values())))
    print(f"mean precision@tIoU: {overall:.4f}")
    return {**means, "mean": overall}


def run(cfg: Config, args: argparse.Namespace) -> dict:
    """Evaluate ``cfg`` as the flags in ``args`` say; returns the precision
    means (empty after ``--export_torch``)."""
    if args.export_torch:
        params = load_params(args, cfg)
        torch.save({"model": {k: v.detach().cpu() for k, v in params.items()},
                    "epoch": 0, "loss": 0.0}, args.export_torch)
        print("exported reference-schema checkpoint:", args.export_torch)
        return {}
    resolve_device(args.device)  # no card: raise before any feature is read
    ds = build_dataset(cfg, args.synthetic)
    params = load_params(args, cfg)
    all_results, time_offsets, per_thr = evaluate_dataset(
        ds, cfg, params, batch_size=args.batch_size, pack=args.pack, device=args.device)
    return _finish(args, all_results, time_offsets, per_thr)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=args.log_level.upper())
    run(load_config(args.config_path), args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
