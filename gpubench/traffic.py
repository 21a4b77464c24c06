"""Traffic of the benchmark: video lengths and the synthetic corpus.

One general generator reads a cell's traffic parameters (the ``traffic``
object of ``gpubench/workloads/<cell>.json``) and makes its inputs from the
run's seed. Every seed gets the same multiset of lengths, in another order,
so that two seeds differ in which video goes where and not in how much work
a run holds.

The constants are copied as values from the repository's root ``bench.py``
(``CORPUS_QUANTILES`` at line 104, ``LONGT_FILL`` at line 114); nothing
imports that file. The corpus writer is a frozen copy of
``repurpose_tpu_torch/data/synthetic.py`` (``synthetic_entry`` and
``write_synthetic_dataset``): the same split-JSON schema and feature layout,
with two changes: ids carry the video's index, so they are unique, and the
features are drawn by a ``torch.Generator`` on the run's device in one call
per stream, so that writing a corpus takes seconds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

# 32 evenly spaced duration quantiles (seconds) of the Repurpose-10K val
# split (p50 1313 s, mean 1218 s, 40 % at the 1800 s cap); root bench.py:104.
CORPUS_QUANTILES = [
    112, 268, 365, 447, 498, 534, 594, 633, 687, 750, 813, 890, 950, 1033,
    1156, 1245, 1406, 1523, 1676, 1800, 1800, 1800, 1800, 1800, 1800, 1800,
    1800, 1800, 1800, 1800, 1800, 1800,
]
# fractions of a long bucket that long recordings fill; root bench.py:114
LONGT_FILL = [1.0, 0.8, 0.65, 0.9, 0.7, 1.0, 0.85, 0.75]

TABLES = {"corpus": CORPUS_QUANTILES, "longt_fill": LONGT_FILL}
STREAMS = ("visual", "audio", "text")


def _table(x):
    return TABLES[x] if isinstance(x, str) else list(x)


def durations(spec: dict, n: int, seed: int) -> list[int]:
    """``n`` video durations (seconds) from a traffic ``spec``, permuted by
    ``seed``. A video of duration d has d + 1 per-second rows.

    - ``{"quantiles": table}``: the table's piecewise-linear quantile
      function read at the n midpoints (i + 0.5) / n;
    - ``{"bucket": b, "fill": table}``: round(f * b) - 1 for f in the
      table, cycled to n, so that the d + 1 rows fill f of the bucket.
    """
    if "quantiles" in spec:
        q = np.asarray(_table(spec["quantiles"]), np.float64)
        at = (np.arange(n) + 0.5) / n * (len(q) - 1)
        out = np.rint(np.interp(at, np.arange(len(q)), q)).astype(int)
    elif "fill" in spec:
        fill = _table(spec["fill"])
        out = np.asarray([round(fill[i % len(fill)] * spec["bucket"]) - 1 for i in range(n)])
    else:
        raise ValueError(f"traffic lengths need 'quantiles' or 'fill': {spec}")
    order = np.random.default_rng([seed % 2**63, 1]).permutation(n)
    return [int(out[i]) for i in order]


def synthetic_entry(rng: np.random.Generator, index: int, duration: int) -> dict:
    """One split-JSON entry with clip annotations, drawn as
    ``repurpose_tpu_torch/data/synthetic.py:synthetic_entry`` draws them."""
    n_segs = int(rng.integers(1, max(2, duration // 90)))
    starts = np.sort(rng.uniform(0, max(1.0, duration - 90), n_segs))
    segs = []
    for s in starts:
        e = min(duration, s + float(rng.uniform(10, 90)))
        if not segs or s > segs[-1][1]:
            segs.append([float(s), float(e)])
    return {
        "youtube_id": f"v{index:04d}_{int(rng.integers(0, 1 << 30)):08x}",
        "timeRange": [0, float(duration)],
        "timeRangeOffset": [0, float(duration)],
        "segments": segs,
        "segmentsOffset": segs,
        "coverage": sum(e - s for s, e in segs) / duration,
    }


def write_corpus(root: str, lengths: list[int], dims: dict, seed: int,
                 device: torch.device) -> dict:
    """Writes a corpus of ``len(lengths)`` videos under ``root`` in the
    layout ``RepurposeDataset`` and the daemon's ``--feature_root`` read:
    ``{visual,audio,text}/<id>.npy`` (float32 [d + 1, dim], standard
    normal) and ``labels.json``. Returns the paths, the entries and the
    bytes written."""
    rng = np.random.default_rng([seed % 2**63, 2])
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    dirs = {m: os.path.join(root, m) for m in STREAMS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    entries = [synthetic_entry(rng, i, d) for i, d in enumerate(lengths)]
    rows = [d + 1 for d in lengths]
    written = 0
    for m in STREAMS:
        # one draw per stream, split into videos on the host
        flat = torch.randn((sum(rows), dims[m]), generator=gen, device=device)
        flat = flat.cpu().numpy()
        at = 0
        for e, t in zip(entries, rows):
            np.save(os.path.join(dirs[m], f"{e['youtube_id']}.npy"), flat[at : at + t])
            at += t
            written += t * dims[m] * 4
        del flat
    label_path = os.path.join(root, "labels.json")
    with open(label_path, "w") as f:
        json.dump(entries, f)
    # the kernel's write-back of these bytes belongs to set-up, not to the
    # measured window
    os.sync()
    return {"root": root, "label_path": label_path, "dirs": dirs, "entries": entries,
            "bytes": written}


def load_features(corpus: dict, video_id: str) -> dict:
    """The three streams of one video, float32, as written."""
    return {m: np.load(os.path.join(corpus["dirs"][m], f"{video_id}.npy")) for m in STREAMS}
