"""Dataset utilities, a copy of ``repurpose_tpu/preprocessing/tools.py`` (host
code): chunk splitting for fan-out, feature inspection, and legacy-truncation
cleanup.

legacy-truncation cleanup.

Capability parity with the reference's standalone scripts:
- split_dataset.py:14-133  -> ``split_dataset`` (+ manifest)
- inspect_features.py:25-88 -> ``inspect_features`` (shape/dtype report,
  cross-modal length-mismatch flags: >10% or >10 frames)
- cleanup_truncated_features.py:9-117 -> ``cleanup_truncated`` (delete .npy
  whose first dim is exactly the legacy 1800-frame truncation, repair
  progress JSONs)
"""

from __future__ import annotations

import json
import os
from typing import Sequence

import numpy as np

LEGACY_TRUNCATION = 1800


def split_dataset(
    dataset_json: str, out_dir: str, chunk_size: int = 100
) -> list[str]:
    """Shard a split JSON into chunk files + a manifest; returns chunk paths."""
    with open(dataset_json) as f:
        entries = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(dataset_json))[0]
    paths = []
    for i in range(0, len(entries), chunk_size):
        p = os.path.join(out_dir, f"{base}_chunk_{i // chunk_size:04d}.json")
        with open(p, "w") as f:
            json.dump(entries[i : i + chunk_size], f)
        paths.append(p)
    manifest = {
        "source": dataset_json,
        "total_entries": len(entries),
        "chunk_size": chunk_size,
        "chunks": [os.path.basename(p) for p in paths],
    }
    with open(os.path.join(out_dir, f"{base}_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return paths


def inspect_features(
    video_ids: Sequence[str],
    visual_dir: str,
    audio_dir: str,
    text_dir: str,
    mismatch_frac: float = 0.10,
    mismatch_abs: int = 10,
) -> dict:
    """Per-video shape/dtype report + cross-modal length-mismatch flags."""
    dirs = {"visual": visual_dir, "audio": audio_dir, "text": text_dir}
    report: dict = {"videos": {}, "mismatched": []}
    for vid in video_ids:
        info: dict = {}
        lengths = {}
        for mod, d in dirs.items():
            p = os.path.join(d, f"{vid}.npy")
            if not os.path.exists(p):
                info[mod] = None
                continue
            arr = np.load(p, mmap_mode="r", allow_pickle=False)
            info[mod] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
            if arr.ndim >= 1:
                lengths[mod] = int(arr.shape[0])
        if len(lengths) >= 2:
            lo, hi = min(lengths.values()), max(lengths.values())
            if hi - lo > mismatch_abs or (hi and (hi - lo) / hi > mismatch_frac):
                info["length_mismatch"] = lengths
                report["mismatched"].append(vid)
        report["videos"][vid] = info
    return report


def cleanup_truncated(
    feature_dirs: Sequence[str],
    truncated_len: int = LEGACY_TRUNCATION,
    dry_run: bool = False,
) -> dict:
    """Remove features hit by the legacy fixed-length truncation bug and drop
    their 'completed' marks from progress JSONs so extraction re-runs."""
    removed: list[str] = []
    for d in feature_dirs:
        if not os.path.isdir(d):
            continue
        for name in os.listdir(d):
            if not name.endswith(".npy"):
                continue
            p = os.path.join(d, name)
            try:
                arr = np.load(p, mmap_mode="r", allow_pickle=False)
            except Exception:
                continue
            if arr.ndim >= 1 and arr.shape[0] == truncated_len:
                removed.append(p)
                if not dry_run:
                    del arr
                    os.remove(p)
        # repair progress files
        removed_ids = {
            os.path.splitext(os.path.basename(p))[0]
            for p in removed
            # normpath: a trailing slash in the configured dir must not make
            # the progress-repair filter silently match nothing
            if os.path.normpath(os.path.dirname(p)) == os.path.normpath(d)
        }
        if removed_ids and not dry_run:
            for name in os.listdir(d):
                if not name.endswith("_progress.json"):
                    continue
                pp = os.path.join(d, name)
                try:
                    with open(pp) as f:
                        data = json.load(f)
                    status = data.get("status", {})
                    for vid in removed_ids:
                        status.pop(vid, None)
                    with open(pp, "w") as f:
                        json.dump(data, f)
                except Exception:
                    pass
    return {"removed": removed, "count": len(removed)}
