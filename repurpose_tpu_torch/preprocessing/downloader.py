"""Parallel yt-dlp video downloader with retry/backoff and resume: a copy of
``repurpose_tpu/preprocessing/downloader.py`` (host code).

Capability parity with the reference's VideoDownloaderYTDLP
(preprocessing/video_downloader_ytdlp.py:37-492): <=240p mp4 format
selection (:107,:175), ThreadPoolExecutor workers with rate limiting
(:379-417), exponential backoff with jitter (:282-322), bot-detection
cool-off (:249-256), cookies support, partial-download cleanup (:475-492),
and JSON progress for resume (:88-98). yt-dlp is an optional dependency —
constructing the downloader without it raises a clear error; a fake ydl
passed as ``ydl_factory`` drives it in the tests.
"""

from __future__ import annotations

import glob
import logging
import os
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Sequence

from repurpose_tpu_torch.preprocessing.progress import ProgressTracker, categorize_error

logger = logging.getLogger(__name__)

FORMAT_240P = "worstvideo[height>=240][ext=mp4]+worstaudio/worst[height>=240][ext=mp4]/worst[ext=mp4]/worst"


class VideoDownloader:
    def __init__(
        self,
        output_dir: str,
        max_workers: int = 3,
        max_retries: int = 3,
        rate_limit_s: float = 1.0,
        cookies_file: str | None = None,
        ydl_factory: Callable | None = None,
    ):
        self.output_dir = output_dir
        self.max_workers = max_workers
        self.max_retries = max_retries
        self.rate_limit_s = rate_limit_s
        self.cookies_file = cookies_file
        os.makedirs(output_dir, exist_ok=True)
        self._rate_lock = threading.Lock()
        self._last_start = 0.0
        self._bot_cooloff_until = 0.0
        if ydl_factory is None:
            try:
                import yt_dlp  # type: ignore

                def ydl_factory(opts):
                    return yt_dlp.YoutubeDL(opts)

            except ImportError as e:
                raise ImportError(
                    "yt-dlp is not installed; pass ydl_factory= or install it"
                ) from e
        self._ydl_factory = ydl_factory

    def _opts(self, video_id: str) -> dict:
        opts = {
            "format": FORMAT_240P,
            "outtmpl": os.path.join(self.output_dir, f"{video_id}.%(ext)s"),
            "quiet": True,
            "no_warnings": True,
            "retries": 0,  # retry policy is ours
            "merge_output_format": "mp4",
        }
        if self.cookies_file:
            opts["cookiefile"] = self.cookies_file
        return opts

    def video_path(self, video_id: str) -> str:
        """Existing video file for the id in any downloadable container
        (.mp4/.webm/.mkv — the '/worst' fallback format can be a single
        non-mp4 stream that merge_output_format does not remux), else the
        canonical .mp4 target path."""
        from repurpose_tpu_torch.preprocessing.media import find_video_file

        return find_video_file(self.output_dir, video_id)

    def _cleanup_partial(self, video_id: str) -> None:
        for p in glob.glob(os.path.join(self.output_dir, f"{video_id}.*.part")) + glob.glob(
            os.path.join(self.output_dir, f"{video_id}.*.ytdl")
        ):
            try:
                os.remove(p)
            except OSError:
                pass

    def _throttle(self) -> None:
        with self._rate_lock:
            wait = max(
                self._last_start + self.rate_limit_s - time.time(),
                self._bot_cooloff_until - time.time(),
            )
            if wait > 0:
                time.sleep(wait)
            self._last_start = time.time()

    def download_one(self, video_id: str) -> None:
        """Download with exponential backoff + jitter; raises on final failure."""
        url = f"https://www.youtube.com/watch?v={video_id}"
        last_err: Exception | None = None
        for attempt in range(self.max_retries):
            self._throttle()
            try:
                with self._ydl_factory(self._opts(video_id)) as ydl:
                    ydl.download([url])
                return
            except Exception as e:  # categorize; only retry transient failures
                last_err = e
                cat = categorize_error(str(e))
                self._cleanup_partial(video_id)
                if cat.value == "bot_detection":
                    self._bot_cooloff_until = time.time() + 60.0
                if not cat.retryable or attempt == self.max_retries - 1:
                    raise
                backoff = (2**attempt) + random.uniform(0, 1)
                logger.info("retry %s in %.1fs (%s)", video_id, backoff, cat.value)
                time.sleep(backoff)
        raise last_err  # pragma: no cover

    def download_dataset(
        self, video_ids: Sequence[str], tracker: ProgressTracker | None = None
    ) -> dict:
        """Parallel download of all ids not already done; returns summary."""
        tracker = tracker or ProgressTracker(
            os.path.join(self.output_dir, "download_progress.json"), len(video_ids)
        )
        todo = []
        for v in video_ids:
            if os.path.exists(self.video_path(v)):
                if not tracker.is_done(v):
                    tracker.mark_completed(v)
                continue
            # 'completed' status with the file gone (raw-video cleanup,
            # partial disk wipe): re-download rather than skipping forever —
            # the extractors' _resumable re-runs on missing OUTPUT the same
            # way. Failed entries still respect the retryability policy.
            if tracker.is_done(v) or tracker.should_retry(v):
                todo.append(v)
        with ThreadPoolExecutor(max_workers=self.max_workers) as pool:
            futures = {pool.submit(self.download_one, v): v for v in todo}
            for fut in as_completed(futures):
                vid = futures[fut]
                try:
                    fut.result()
                    tracker.mark_completed(vid)
                except Exception as e:
                    tracker.mark_failed(vid, str(e))
        return tracker.summary()
