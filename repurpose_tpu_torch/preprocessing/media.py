"""Media decoding helpers, ffmpeg-based frame and audio extraction: a copy of
``repurpose_tpu/preprocessing/media.py`` (host code).

The reference shells out to ffmpeg for all three modalities
(visual_feature_extractor_clip.py:78-92, audio_feature_extractor.py:76-86,
text_feature_extractor.py:86-100); so do we — but decoding goes straight to
numpy via pipes instead of temp-file sprawl. Stdlib-only (no librosa/
soundfile/av needed).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
from typing import Iterator

import numpy as np

logger = logging.getLogger(__name__)


def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def probe_duration(path: str) -> float:
    out = subprocess.run(
        ["ffprobe", "-v", "error", "-show_entries", "format=duration",
         "-of", "json", path],
        capture_output=True, check=True,
    )
    return float(json.loads(out.stdout)["format"]["duration"])


VIDEO_EXTENSIONS = (".mp4", ".webm", ".mkv")
"""Containers a download can land in: yt-dlp's merge_output_format=mp4 only
remuxes MERGED streams, so a single-file fallback format keeps its native
container (the reference checks the same three,
video_downloader_ytdlp.py:126)."""


def find_video_file(video_dir: str, video_id: str) -> str:
    """First existing ``{video_id}{ext}`` under ``video_dir`` in
    VIDEO_EXTENSIONS order; falls back to the .mp4 path (callers treat a
    missing file as 'video file missing')."""
    for ext in VIDEO_EXTENSIONS:
        p = os.path.join(video_dir, f"{video_id}{ext}")
        if os.path.exists(p):
            return p
    return os.path.join(video_dir, f"{video_id}.mp4")


def frames_1fps(path: str, width: int = 224, height: int = 224) -> Iterator[np.ndarray]:
    """Yield one RGB uint8 frame per second of video, center-cropped to
    width x height by ffmpeg (scale shorter side + crop — CLIP preprocessing
    geometry, so no PIL pass is needed afterwards)."""
    vf = (
        f"fps=1,scale='if(gt(a,1),-2,{width})':'if(gt(a,1),{height},-2)',"
        f"crop={width}:{height}"
    )
    proc = subprocess.Popen(
        ["ffmpeg", "-v", "error", "-i", path, "-vf", vf,
         "-f", "rawvideo", "-pix_fmt", "rgb24", "-"],
        stdout=subprocess.PIPE,
    )
    frame_bytes = width * height * 3
    assert proc.stdout is not None
    finished = False
    try:
        while True:
            buf = proc.stdout.read(frame_bytes)
            if len(buf) < frame_bytes:
                finished = True
                break
            yield np.frombuffer(buf, np.uint8).reshape(height, width, 3)
    finally:
        proc.stdout.close()
        rc = proc.wait()
        # A mid-stream decode failure ends the pipe early with a nonzero
        # exit; swallowing it would save a silently-truncated feature file
        # (the legacy bug cleanup_truncated exists to mop up). Only raise on
        # normal exhaustion — a consumer abandoning the generator kills the
        # pipe and a nonzero rc is expected then.
        if finished and rc != 0:
            raise RuntimeError(
                f"ffmpeg frame decode failed for {path} (exit {rc}); "
                "refusing to emit a truncated frame sequence"
            )


def load_audio(path: str, sr: int = 22050) -> np.ndarray:
    """Decode to mono float32 waveform at the given rate (the reference's
    22.05 kHz pipeline rate, audio_feature_extractor.py:80,121)."""
    out = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", path, "-ac", "1", "-ar", str(sr),
         "-f", "f32le", "-"],
        capture_output=True, check=True,
    )
    return np.frombuffer(out.stdout, np.float32).copy()


def chunk_waveform(wave: np.ndarray, sr: int) -> np.ndarray:
    """Split into zero-padded 1-second chunks [T, sr] (reference chunking,
    audio_feature_extractor.py:127-136)."""
    n = int(np.ceil(len(wave) / sr)) if len(wave) else 0
    out = np.zeros((n, sr), np.float32)
    for i in range(n):
        c = wave[i * sr : (i + 1) * sr]
        out[i, : len(c)] = c
    return out
