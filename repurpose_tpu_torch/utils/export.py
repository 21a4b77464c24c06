"""Clip export: scored predictions -> shareable artifacts.

The port's own copy of ``repurpose_tpu/utils/export.py`` (plain Python, no
framework). The reference stops at printed metrics; in production the point
of the pipeline is the clips themselves. This module turns per-video results
(``InferencePipeline.score_batch`` output) into:

- a clips JSON manifest (video_id, start/end seconds, score, rank);
- optional ffmpeg trim commands (stream-copy, no re-encode) to cut the
  actual short-form files.
"""

from __future__ import annotations

import json
import shlex
from typing import Sequence


def results_to_manifest(
    results: Sequence[dict],
    min_score: float = 0.0,
    clamp_start: bool = True,
    time_offsets: dict | None = None,
) -> list[dict]:
    """Flatten per-video results into ranked clip records.

    ``time_offsets`` maps video_id -> timeRange[0]: decode outputs live on the
    feature grid, which starts at that offset inside the original file
    (dataset timeRange slicing) — clips are exported in ABSOLUTE video time.
    A per-result ``time_offset`` key takes precedence: the label schema
    allows SEVERAL entries per youtube_id with different timeRange slices
    (reference RepurposeClip.py:33 dedupes ids), so a video_id-keyed dict
    cannot distinguish them.
    """
    clips = []
    for r in results:
        t0 = float(
            r.get("time_offset", (time_offsets or {}).get(r["video_id"], 0.0))
        )
        order = sorted(
            range(len(r["scores"])), key=lambda i: -float(r["scores"][i])
        )
        kept = []
        for i in order:
            score = float(r["scores"][i])
            if score < min_score:
                continue
            start = float(r["segments"][i][0])
            end = float(r["segments"][i][1])
            if clamp_start:
                start = max(start, 0.0)
                end = min(end, float(r["duration"]))
            if end <= start:
                continue
            kept.append((score, start + t0, end + t0))
        # rank surviving clips densely so rank 0 always exists per video
        for rank, (score, start, end) in enumerate(kept):
            clips.append(
                {
                    "video_id": r["video_id"],
                    "rank": rank,
                    "start": round(start, 2),
                    "end": round(end, 2),
                    "duration": round(end - start, 2),
                    "score": round(score, 4),
                }
            )
    return clips


def write_manifest(results: Sequence[dict], path: str, **kw) -> list[dict]:
    clips = results_to_manifest(results, **kw)
    with open(path, "w") as f:
        json.dump(clips, f, indent=2)
    return clips


def ffmpeg_cut_commands(
    clips: Sequence[dict], video_dir: str, out_dir: str
) -> list[str]:
    """Stream-copy trim command per clip (run them, or pipe to xargs/parallel)."""
    cmds = []
    for c in clips:
        src = f"{video_dir}/{c['video_id']}.mp4"
        dst = f"{out_dir}/{c['video_id']}_r{c['rank']:02d}.mp4"
        # -ss before -i (fast seek) + -t duration after: portable to
        # ffmpeg 4.x, where -to is not an input option.
        cmds.append(
            "ffmpeg -v error -y -ss {start} -i {src} -t {dur} -c copy {dst}".format(
                start=c["start"], dur=c["duration"],
                src=shlex.quote(src), dst=shlex.quote(dst),
            )
        )
    return cmds
