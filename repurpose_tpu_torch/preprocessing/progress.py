"""Thread-safe progress tracking with an error taxonomy and JSON resume state:
a copy of ``repurpose_tpu/preprocessing/progress.py`` (host code).

Capability parity with the reference's ProgressTracker
(preprocessing/progress_tracker.py:15-249): per-video status, error
categorization with retryability policy (:89-97), per-category counts and
examples, ETA estimation, and a persisted JSON state file each extractor uses
to resume (visual_feature_extractor_clip.py:47-57 and equivalents).
"""

from __future__ import annotations

import enum
import json
import os
import threading
import time
from typing import Dict


class ErrorCategory(enum.Enum):
    PRIVATE = "private"
    DELETED = "deleted"
    ACCOUNT_TERMINATED = "account_terminated"
    FORMAT_UNAVAILABLE = "format_unavailable"
    COPYRIGHT = "copyright"
    BOT_DETECTION = "bot_detection"
    NETWORK = "network"
    UNKNOWN = "unknown"

    @property
    def retryable(self) -> bool:
        """Non-retryable = the reference's permanent-failure set — private/
        deleted/terminated/copyright ONLY (progress_tracker.py:89-97).
        format_unavailable IS retried there: yt-dlp format lists vary per
        request/client, so those failures are often transient."""
        return self not in (
            ErrorCategory.PRIVATE, ErrorCategory.DELETED,
            ErrorCategory.ACCOUNT_TERMINATED, ErrorCategory.COPYRIGHT,
        )


_PATTERNS = [
    (ErrorCategory.PRIVATE, ("private video", "sign in if you've been granted")),
    (ErrorCategory.DELETED, ("video unavailable", "has been removed", "no longer available")),
    (ErrorCategory.ACCOUNT_TERMINATED, ("account associated", "terminated")),
    (ErrorCategory.FORMAT_UNAVAILABLE, ("requested format", "no video formats")),
    (ErrorCategory.COPYRIGHT, ("copyright",)),
    (ErrorCategory.BOT_DETECTION, ("confirm you're not a bot", "sign in to confirm", "429")),
    (ErrorCategory.NETWORK, ("timed out", "connection", "network", "unable to download")),
]


def categorize_error(message: str) -> ErrorCategory:
    msg = message.lower()
    for cat, pats in _PATTERNS:
        if any(p in msg for p in pats):
            return cat
    return ErrorCategory.UNKNOWN


class ProgressTracker:
    """Tracks {video_id: status} with persistence; statuses are
    'completed' | 'failed:<category>' | 'in_progress'."""

    def __init__(self, state_path: str, total: int = 0, quiet: bool = True):
        self.state_path = state_path
        self.total = total
        self.quiet = quiet
        self._lock = threading.Lock()
        self._t0 = time.time()
        self.status: Dict[str, str] = {}
        self.errors: Dict[str, list] = {}
        if os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    data = json.load(f)
                self.status = data.get("status", {})
                self.errors = data.get("errors", {})
            except Exception:
                pass
        # statuses resumed from a previous session are NOT this session's
        # throughput — ETA rates only marks made since _t0. A counter (not a
        # baseline diff) so retries that FLIP an already-terminal status
        # (failed->completed, re-download of a deleted file) still count.
        self._session_marks = 0

    # -- queries ---------------------------------------------------------------

    def is_done(self, video_id: str) -> bool:
        return self.status.get(video_id) == "completed"

    def should_retry(self, video_id: str) -> bool:
        s = self.status.get(video_id, "")
        if not s.startswith("failed:"):
            return not self.is_done(video_id)
        return ErrorCategory(s.split(":", 1)[1]).retryable

    @property
    def completed(self) -> int:
        return sum(1 for s in self.status.values() if s == "completed")

    @property
    def failed(self) -> int:
        return sum(1 for s in self.status.values() if s.startswith("failed"))

    def eta_seconds(self) -> float | None:
        done = self.completed + self.failed
        if self._session_marks <= 0 or not self.total:
            return None
        rate = self._session_marks / max(time.time() - self._t0, 1e-9)
        return (self.total - done) / rate

    # -- updates ----------------------------------------------------------------

    def mark_completed(self, video_id: str) -> None:
        with self._lock:
            self.status[video_id] = "completed"
            self._session_marks += 1
            self._save_locked()
            self._print_locked()

    def mark_failed(self, video_id: str, error: str) -> None:
        cat = categorize_error(error)
        with self._lock:
            self.status[video_id] = f"failed:{cat.value}"
            self._session_marks += 1
            self.errors.setdefault(cat.value, [])
            if len(self.errors[cat.value]) < 5:  # keep a few examples
                self.errors[cat.value].append({"video_id": video_id, "error": error[:300]})
            self._save_locked()
            self._print_locked()

    def _save_locked(self) -> None:
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"status": self.status, "errors": self.errors}, f)
        os.replace(tmp, self.state_path)

    def _print_locked(self) -> None:
        if self.quiet:
            return
        eta = self.eta_seconds()
        eta_s = f" eta {eta/60:.1f}m" if eta else ""
        print(
            f"\rprogress: {self.completed} ok, {self.failed} failed"
            f"/{self.total}{eta_s}", end="", flush=True,
        )

    def summary(self) -> dict:
        cats: Dict[str, int] = {}
        for s in self.status.values():
            if s.startswith("failed:"):
                cats[s.split(":", 1)[1]] = cats.get(s.split(":", 1)[1], 0) + 1
        return {
            "completed": self.completed,
            "failed": self.failed,
            "by_category": cats,
            "examples": self.errors,
        }
