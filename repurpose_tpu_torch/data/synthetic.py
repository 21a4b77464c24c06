"""Synthetic samples shaped like Repurpose-10K (numpy only).

Copied from ``repurpose_tpu/data/synthetic.py``: the same random draws from
the same ``numpy`` generator give the same samples in both packages, so a
seed names one corpus for both. ``SyntheticDataset`` holds samples in
memory; ``write_synthetic_dataset`` writes a corpus to disk in the layout
``RepurposeDataset`` reads (the same bytes as the JAX package's writer).
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

from repurpose_tpu_torch.config import DatasetConfig, ModelConfig
from repurpose_tpu_torch.data.labels import (
    generate_regression_offsets,
    generate_time_status_list,
)


def synthetic_entry(rng: np.random.Generator, duration: int) -> dict:
    """One split-JSON entry with plausible segment annotations."""
    n_segs = int(rng.integers(1, max(2, duration // 90)))
    starts = np.sort(rng.uniform(0, max(1.0, duration - 90), n_segs))
    segs = []
    for s in starts:
        e = min(duration, s + float(rng.uniform(10, 90)))
        if not segs or s > segs[-1][1]:
            segs.append([float(s), float(e)])
    return {
        "youtube_id": f"synth{rng.integers(0, 1 << 30):08x}",
        "timeRange": [0, float(duration)],
        "timeRangeOffset": [0, float(duration)],
        "segments": segs,
        "segmentsOffset": segs,
        "coverage": sum(e - s for s, e in segs) / duration,
    }


def synthetic_sample(
    rng: np.random.Generator,
    duration: int,
    model_cfg: ModelConfig,
    signal: float = 0.0,
) -> dict:
    """In-memory sample dict matching RepurposeDataset.__getitem__ output.
    ``signal`` > 0 adds a fixed per-modality direction to the features of
    seconds inside annotated clips, so the corpus is learnable."""
    entry = synthetic_entry(rng, duration)
    t = int(duration) + 1
    labels = generate_time_status_list(
        entry["timeRangeOffset"], entry["segmentsOffset"]
    )
    offsets = generate_regression_offsets(
        entry["timeRangeOffset"], entry["segmentsOffset"]
    )
    n = min(t, len(labels))
    dims = {"visual": model_cfg.vis_dim, "audio": model_cfg.aud_dim,
            "text": model_cfg.text_dim}
    feats = {m: rng.normal(0, 1, (n, d)).astype(np.float32) for m, d in dims.items()}
    if signal > 0.0:
        sig_rng = np.random.default_rng(777)  # fixed directions across samples
        lab = np.asarray(labels[:n], np.float32)[:, None]
        for m, d in dims.items():
            direction = sig_rng.normal(0, 1, d).astype(np.float32)
            direction /= np.linalg.norm(direction)
            feats[m] = feats[m] + signal * lab * direction
    return {
        "video_id": entry["youtube_id"],
        **feats,
        "labels": np.asarray(labels[:n], np.float32),
        "segments": np.asarray(offsets[:n], np.float32),
        "duration": n,
        "gt_segments": entry["segmentsOffset"],
    }


class SyntheticDataset:
    """In-memory dataset with the RepurposeDataset access protocol."""

    def __init__(
        self,
        durations: Sequence[int],
        model_cfg: ModelConfig,
        seed: int = 0,
        signal: float = 0.0,
    ):
        rng = np.random.default_rng(seed)
        self.samples = [
            synthetic_sample(rng, d, model_cfg, signal=signal) for d in durations
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> dict:
        return self.samples[idx]

    def lengths(self) -> list[int]:
        return [s["duration"] for s in self.samples]


def write_synthetic_dataset(
    root: str,
    durations: Sequence[int],
    model_cfg: ModelConfig,
    seed: int = 0,
) -> DatasetConfig:
    """Materialize a synthetic dataset on disk; returns its DatasetConfig."""
    rng = np.random.default_rng(seed)
    dirs = {m: os.path.join(root, m) for m in ("visual", "audio", "text")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    entries = []
    for dur in durations:
        e = synthetic_entry(rng, dur)
        t = int(dur) + 1
        for m, dim in (("visual", model_cfg.vis_dim), ("audio", model_cfg.aud_dim),
                       ("text", model_cfg.text_dim)):
            np.save(os.path.join(dirs[m], f"{e['youtube_id']}.npy"),
                    rng.normal(0, 1, (t, dim)).astype(np.float32))
        entries.append(e)
    label_path = os.path.join(root, "labels.json")
    with open(label_path, "w") as f:
        json.dump(entries, f)
    return DatasetConfig(
        label_path=label_path,
        video_path=dirs["visual"],
        audio_path=dirs["audio"],
        text_path=dirs["text"],
    )
