"""Offline preprocessing of the port: download -> visual / audio / text
feature extraction, the counterpart of ``repurpose_tpu/preprocessing/``.

Host orchestration around the port's extractors
(``repurpose_tpu_torch.extractors``), with the reference's fault tolerance
(retry taxonomy, JSON progress and resume, chunked fan-out). The external
tools (yt-dlp, ffmpeg, whisper, transformers' tokenizers) are optional and
imported where a stage needs them.
"""

from repurpose_tpu_torch.preprocessing.progress import ErrorCategory, ProgressTracker  # noqa: F401
