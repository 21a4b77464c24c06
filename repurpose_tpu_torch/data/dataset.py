"""Repurpose-10K dataset: split JSON + per-modality .npy feature files
(``repurpose_tpu/data/dataset.py``, host only, numpy).

- loads the split JSON ({youtube_id, timeRange, segments, timeRangeOffset,
  segmentsOffset, coverage});
- keeps the samples whose three feature files exist, optionally checking
  shapes and lengths (``validate``), with the filter result cached beside the
  label file, keyed by config hash and label mtime;
- precomputes per-second labels and regression offsets;
- ``__getitem__`` slices by timeRange and truncates every stream to the
  common length;
- ``load_batch``: the whole-batch fast path, every sample's three feature
  streams pread straight into the zero-padded batch buffers by the host
  loader (``native.batch_load_npy``, the repository's
  ``csrc/npy_loader.cc``); it gives ``collate``'s batch, and ``None`` where
  it does not apply (no loader library, or a sample sliced by timeRange),
  and the caller then collates samples read with numpy.

``use_cache=False`` filters the label entries anew instead of reading or
writing the filter cache.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time

import numpy as np

from repurpose_tpu_torch.config import DatasetConfig
from repurpose_tpu_torch.data.labels import (
    generate_regression_offsets,
    generate_time_status_list,
)

logger = logging.getLogger(__name__)


class RepurposeDataset:
    def __init__(
        self,
        cfg: DatasetConfig,
        validate: bool = True,
        keep_gt_segments: bool = False,
        use_cache: bool = True,
    ):
        self.cfg = cfg
        self.validate = validate
        self.keep_gt_segments = keep_gt_segments
        self._fmt = {
            "visual": os.path.join(cfg.video_path, "{}.npy"),
            "audio": os.path.join(cfg.audio_path, "{}.npy"),
            "text": os.path.join(cfg.text_path, "{}.npy"),
        }
        with open(cfg.label_path) as f:
            original = json.load(f)
        self.entries = (
            self._filter_cached(original) if use_cache else self._filter(original)[0]
        )
        self._route_logged = False
        for e in self.entries:
            e["_labels"] = generate_time_status_list(
                e["timeRangeOffset"], e["segmentsOffset"]
            )
            e["_offsets"] = generate_regression_offsets(
                e["timeRangeOffset"], e["segmentsOffset"]
            )

    # -- filtering & cache ---------------------------------------------------

    def _config_hash(self) -> str:
        c = self.cfg
        s = f"{c.label_path}_{c.video_path}_{c.audio_path}_{c.text_path}_v{int(self.validate)}"
        return hashlib.md5(s.encode()).hexdigest()[:8]

    def _cache_path(self) -> str:
        base = os.path.splitext(os.path.basename(self.cfg.label_path))[0]
        mtime = int(os.path.getmtime(self.cfg.label_path))
        return os.path.join(
            os.path.dirname(self.cfg.label_path),
            f"{base}_filter_cache_{self._config_hash()}_{mtime}.json",
        )

    def _filter_cached(self, original: list[dict]) -> list[dict]:
        path = self._cache_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    cache = json.load(f)
                if (
                    cache.get("total_original") == len(original)
                    and cache.get("config_hash") == self._config_hash()
                ):
                    logger.info("filter cache hit: %d samples", len(cache["entries"]))
                    return cache["entries"]
            except Exception as e:
                logger.warning("filter cache unreadable (%s); rebuilding", e)
        entries, stats = self._filter(original)
        try:
            with open(path, "w") as f:
                json.dump(
                    {
                        "entries": entries,
                        "stats": stats,
                        "total_original": len(original),
                        "config_hash": self._config_hash(),
                        "timestamp": time.time(),
                    },
                    f,
                )
            self._cleanup_stale_caches()
        except OSError as e:
            logger.warning("could not write filter cache: %s", e)
        return entries

    def _cleanup_stale_caches(self, max_age_s: float = 86400.0) -> None:
        base = os.path.splitext(os.path.basename(self.cfg.label_path))[0]
        d = os.path.dirname(self.cfg.label_path) or "."
        for name in os.listdir(d):
            if name.startswith(f"{base}_filter_cache_") and name.endswith(".json"):
                p = os.path.join(d, name)
                if os.path.getmtime(p) < time.time() - max_age_s:
                    try:
                        os.remove(p)
                    except OSError:
                        pass

    def _filter(self, original: list[dict]) -> tuple[list[dict], dict]:
        kept, stats = [], {"missing": 0, "invalid": 0}
        for e in original:
            vid = e["youtube_id"]
            paths = {m: fmt.format(vid) for m, fmt in self._fmt.items()}
            if not all(os.path.exists(p) for p in paths.values()):
                stats["missing"] += 1
                continue
            if self.validate and not self._validate_entry(e, paths):
                stats["invalid"] += 1
                continue
            kept.append({k: v for k, v in e.items() if not k.startswith("_")})
        stats["kept"] = len(kept)
        logger.info(
            "filtered %d -> %d samples (missing %d, invalid %d)",
            len(original), len(kept), stats["missing"], stats["invalid"],
        )
        return kept, stats

    def _validate_entry(self, e: dict, paths: dict) -> bool:
        """Deep validation (reference _validate_sample_data,
        RepurposeClip.py:244-320): 2-D non-empty features, label/offset
        consistency, positive post-slice length."""
        try:
            tr = e["timeRangeOffset"]
            labels = generate_time_status_list(tr, e["segmentsOffset"])
            offsets = generate_regression_offsets(tr, e["segmentsOffset"])
            if len(labels) != len(offsets) or len(labels) == 0:
                return False
            lengths = []
            for p in paths.values():
                arr = np.load(p, mmap_mode="r", allow_pickle=False)
                if arr.ndim != 2 or arr.shape[0] == 0:
                    return False
                lengths.append(arr.shape[0])
            time_range = e["timeRange"]
            if time_range[0] != 0:
                lengths = [
                    min(ln, int(time_range[1])) - int(time_range[0]) for ln in lengths
                ]
            return min(min(lengths), len(labels)) > 0
        except Exception as exc:
            logger.debug("validation error for %s: %s", e.get("youtube_id"), exc)
            return False

    # -- access ----------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.entries)

    def lengths(self) -> list[int]:
        """Per-sample label lengths (upper bound of true sample length) — used
        by the loader for bucket-aware batch grouping."""
        return [len(e["_labels"]) for e in self.entries]

    def _log_route(self, route: str) -> None:
        if not self._route_logged:
            self._route_logged = True
            logger.info("batches load %s", route)

    def load_batch(self, indices, buckets, batch_size: int | None = None):
        """Whole-batch fast path: the three feature streams of every sample
        pread directly into the zero-padded [B, T, D] batch buffers by the
        host loader, one threaded call per modality. Returns a Batch, or
        None when the fast path does not apply (loader library missing, or
        a sample needs timeRange slicing)."""
        from repurpose_tpu_torch import native
        from repurpose_tpu_torch.data.batching import Batch, pick_bucket

        if not native.available():
            self._log_route("with numpy (the native loader is not built)")
            return None
        entries = [self.entries[i] for i in indices]
        if any(e["timeRange"][0] != 0 for e in entries):
            return None
        self._log_route("through the native loader (csrc/npy_loader.cc)")
        n = len(entries)
        b = batch_size or n
        # the label length bounds the sample; the true length is its min with
        # each stream's rows, resolved after loading
        t = pick_bucket(max(len(e["_labels"]) for e in entries), buckets)

        arrays = {}
        rows = {}
        for m, fmt in self._fmt.items():
            paths = [fmt.format(e["youtube_id"]) for e in entries]
            info = native.probe_npy(paths[0])
            if info is None:
                return None
            loaded = native.batch_load_npy(paths, t=t, d=info[1], n_threads=4)
            if loaded is None:
                return None
            arr, r = loaded
            if b > n:
                arr = np.concatenate([arr, np.zeros((b - n, t, info[1]), np.float32)])
            arrays[m], rows[m] = arr, r

        mask = np.zeros((b, t), bool)
        labels = np.zeros((b, t), np.float32)
        segments = np.zeros((b, t, 2), np.float32)
        durations = np.zeros((b,), np.int32)
        for i, e in enumerate(entries):
            ln = min(int(rows["visual"][i]), int(rows["audio"][i]),
                     len(e["_labels"]), len(e["_offsets"]), t)
            mask[i, :ln] = True
            labels[i, :ln] = e["_labels"][:ln]
            segments[i, :ln] = e["_offsets"][:ln]
            durations[i] = ln
            for m in arrays:  # zero the rows past the common length
                arrays[m][i, ln:] = 0.0
        return Batch(visual=arrays["visual"], audio=arrays["audio"], text=arrays["text"],
                     mask=mask, labels=labels, segments=segments, durations=durations)

    def __getitem__(self, idx: int) -> dict:
        e = self.entries[idx]
        vid = e["youtube_id"]
        feats = {
            m: np.load(fmt.format(vid), allow_pickle=False) for m, fmt in self._fmt.items()
        }
        tr = e["timeRange"]
        if tr[0] != 0:
            for m in feats:
                feats[m] = feats[m][int(tr[0]) : int(tr[1]), :]
        labels = e["_labels"]
        offsets = e["_offsets"]
        min_len = min(
            feats["visual"].shape[0], feats["audio"].shape[0],
            len(labels), len(offsets),
        )
        sample = {
            "video_id": vid,
            # features were sliced from timeRange[0]; decode outputs are on the
            # feature grid, so absolute video time = grid time + time_offset
            "time_offset": float(tr[0]),
            "visual": np.asarray(feats["visual"][:min_len], np.float32),
            "audio": np.asarray(feats["audio"][:min_len], np.float32),
            "text": np.asarray(feats["text"][:min_len], np.float32),
            "labels": np.asarray(labels[:min_len], np.float32),
            "segments": np.asarray(offsets[:min_len], np.float32),
            "duration": int(min_len),
        }
        if self.keep_gt_segments:
            sample["gt_segments"] = [list(s) for s in e["segmentsOffset"]]
        return sample
