"""Per-modality feature extraction drivers, video files -> per-second .npy:
the port of ``repurpose_tpu/preprocessing/extract.py``.

- visual: frames buffer into large batches for one CLIP encoder call (the
  reference encodes frame at a time, visual_feature_extractor_clip.py:
  184-199);
- audio: all 1-second chunks of a video batch through CNN14 (the reference
  rebuilds PANNs per video and loops chunks, audio_feature_extractor.py:
  125-142); without a checkpoint, the classical-DSP fallback;
- text: transcribe -> bin -> embed in one pass (the reference needs two,
  text_feature_extractor.py:310-386), the bins of a video one padded batch.

Every driver is resumable through ``ProgressTracker`` and writes a .npy of
shape (T_seconds, dim) per video, in the layout the dataset reads
({dir}/{youtube_id}.npy). The extractors run on ``device`` (CUDA by
default; it raises without a card). The JAX drivers pad each batch to a
fixed size for XLA; these do not, and a row's result does not depend on it.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.preprocessing.media import (
    chunk_waveform,
    find_video_file,
    frames_1fps,
    load_audio,
)
from repurpose_tpu_torch.preprocessing.progress import ProgressTracker

logger = logging.getLogger(__name__)


def _resumable(kind: str):
    """Wrap a per-video extractor into a dataset-level resumable driver."""

    def run(
        extract_fn: Callable[[str], np.ndarray],
        video_ids: Sequence[str],
        video_dir: str,
        out_dir: str,
        tracker: ProgressTracker | None = None,
    ) -> dict:
        os.makedirs(out_dir, exist_ok=True)
        tracker = tracker or ProgressTracker(
            os.path.join(out_dir, f"{kind}_progress.json"), len(video_ids)
        )
        for vid in video_ids:
            out_path = os.path.join(out_dir, f"{vid}.npy")
            if tracker.is_done(vid) and os.path.exists(out_path):
                continue
            src = find_video_file(video_dir, vid)
            if not os.path.exists(src):
                tracker.mark_failed(vid, "video file missing")
                continue
            try:
                feats = extract_fn(src)
                if feats.ndim != 2 or feats.shape[0] == 0:
                    raise ValueError(f"bad feature shape {feats.shape}")
                np.save(out_path, feats)
                tracker.mark_completed(vid)
            except Exception as e:
                logger.warning("%s extraction failed for %s: %s", kind, vid, e)
                tracker.mark_failed(vid, str(e))
        return tracker.summary()

    return run


def _load(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    model.load_state_dict(dict(params), strict=True)
    return model.eval()


class VisualExtractor:
    """video -> (T, 512) CLIP ViT-B/32 embeddings, 1 frame/s, L2-normalised.
    ``params``: the encoder's state dict (``convert_hf_clip_vision``)."""

    def __init__(self, params: Mapping, batch_size: int = 128,
                 compute_dtype: str = "bfloat16", device: str | torch.device = "cuda"):
        from repurpose_tpu_torch.extractors.clip_vit import (
            CLIP_IMAGE_MEAN,
            CLIP_IMAGE_STD,
            CLIPVisionEncoder,
        )

        self.device = resolve_device(device)
        self.model = _load(CLIPVisionEncoder(compute_dtype=compute_dtype, device=self.device),
                           params)
        self.batch_size = batch_size
        self._mean, self._std = CLIP_IMAGE_MEAN, CLIP_IMAGE_STD

    @torch.inference_mode()
    def _encode(self, batch: np.ndarray) -> np.ndarray:
        return self.model(torch.from_numpy(batch).to(self.device)).cpu().numpy()

    def extract(self, video_path: str) -> np.ndarray:
        out, buf = [], []

        def flush():
            if buf:
                batch = (np.stack(buf).astype(np.float32) / 255.0 - self._mean) / self._std
                out.append(self._encode(batch))
                buf.clear()

        for frame in frames_1fps(video_path):
            buf.append(frame)
            if len(buf) == self.batch_size:
                flush()
        flush()
        if not out:
            return np.zeros((0, 512), np.float32)
        return np.concatenate(out).astype(np.float32)

    def run(self, video_ids, video_dir, out_dir, tracker=None) -> dict:
        return _resumable("visual")(self.extract, video_ids, video_dir, out_dir, tracker)


class AudioExtractor:
    """video -> (T, 2048) CNN14 embeddings, one 1-s chunk per second.

    ``params``: CNN14's state dict (``convert_panns_cnn14``). With
    ``params=None`` it takes the classical DSP features instead (MFCC /
    chroma / contrast / tonnetz zero-padded to 2048: the reference's librosa
    fallback, audio_feature_extractor.py:159-239, in
    ``extractors.fallback_audio``), which run on the host."""

    def __init__(self, params: Mapping | None, batch_size: int = 512, sr: int = 22050,
                 compute_dtype: str = "bfloat16", device: str | torch.device = "cuda"):
        self.batch_size = batch_size
        self.sr = sr
        self.device = resolve_device(device)
        self.model = None
        if params is not None:
            from repurpose_tpu_torch.extractors.cnn14 import CNN14

            self.model = _load(CNN14(compute_dtype=compute_dtype, device=self.device), params)

    @torch.inference_mode()
    def _embed(self, chunks: np.ndarray) -> np.ndarray:
        from repurpose_tpu_torch.extractors.cnn14 import embed_waveform_chunks

        return embed_waveform_chunks(self.model, torch.from_numpy(chunks).to(self.device)
                                     ).cpu().numpy()

    def extract(self, video_path: str) -> np.ndarray:
        if self.model is None:
            from repurpose_tpu_torch.extractors.fallback_audio import fallback_features

            return fallback_features(load_audio(video_path, self.sr), self.sr)
        chunks = chunk_waveform(load_audio(video_path, self.sr), self.sr)
        outs = [self._embed(chunks[i : i + self.batch_size])
                for i in range(0, len(chunks), self.batch_size)]
        if not outs:
            return np.zeros((0, 2048), np.float32)
        return np.concatenate(outs).astype(np.float32)

    def run(self, video_ids, video_dir, out_dir, tracker=None) -> dict:
        return _resumable("audio")(self.extract, video_ids, video_dir, out_dir, tracker)


_WS_RE = re.compile(r"\s+")
_SPECIAL_RE = re.compile(r"[^\w\s\.\,\!\?\-\']")


def clean_text(text: str) -> str:
    """Reference text normalisation (text_feature_extractor.py:185-196):
    collapse whitespace, drop everything but word chars / whitespace /
    ``. , ! ? - '``, then strip."""
    if not text:
        return ""
    return _SPECIAL_RE.sub("", _WS_RE.sub(" ", text)).strip()


def bin_transcript_per_second(
    segments: Sequence[dict], duration_s: int, word_level: bool = False
) -> list[str]:
    """Per-second text bins, reference-exact (text_feature_extractor.py:341-357):
    a segment overlaps second ``s`` iff ``start <= s < end``; each overlapping
    segment's text is clean_text'd, joined with spaces in segment order, and
    the joined string clean_text'd again; '' marks silent (zero-vector)
    seconds. O(S + T): integer second-ranges per segment.

    ``word_level=True`` (needs segments carrying ``words`` from the
    cross-attention aligner, whisper_align.py) bins each WORD into the
    seconds its [start, end) span overlaps. Segments without words fall back
    to segment-level binning."""
    texts: list[list[str]] = [[] for _ in range(duration_s)]
    for seg in segments:
        if word_level and seg.get("words"):
            for w in seg["words"]:
                ws, we = float(w.get("start", 0)), float(w.get("end", 0))
                lo = max(int(np.floor(ws)), 0)
                hi = min(int(np.ceil(we)) if we > ws else lo + 1, duration_s)
                cleaned = clean_text(w.get("word", ""))
                for s in range(lo, hi):
                    texts[s].append(cleaned)
            continue
        start = float(seg.get("start", 0))
        end = float(seg.get("end", 0))
        lo = max(int(np.ceil(start)), 0)  # smallest integer s with s >= start
        hi = min(int(np.ceil(end)), duration_s)  # integers s < end are < ceil(end)
        cleaned = clean_text(seg.get("text", ""))
        for s in range(lo, hi):
            texts[s].append(cleaned)
    return [clean_text(" ".join(ts)) if ts else "" for ts in texts]


class TextExtractor:
    """transcript segments -> (T, 384) MiniLM embeddings (zero rows for
    silent seconds). ``params``: MiniLM's state dict (``convert_hf_bert``);
    ``tokenizer``: a callable with the HF tokenizer's signature (host)."""

    def __init__(self, params: Mapping, tokenizer, batch_size: int = 256, max_tokens: int = 64,
                 device: str | torch.device = "cuda"):
        from repurpose_tpu_torch.extractors.minilm import MiniLMEncoder

        self.device = resolve_device(device)
        self.model = _load(MiniLMEncoder(device=self.device), params)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_tokens = max_tokens

    @torch.inference_mode()
    def _encode(self, ids: np.ndarray, mask: np.ndarray) -> np.ndarray:
        return self.model(torch.from_numpy(np.asarray(ids, np.int64)).to(self.device),
                          torch.from_numpy(np.asarray(mask, np.int64)).to(self.device)
                          ).cpu().numpy()

    def embed_bins(self, bins: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(bins), 384), np.float32)
        nonempty = [(i, b) for i, b in enumerate(bins) if b]
        for j in range(0, len(nonempty), self.batch_size):
            chunk = nonempty[j : j + self.batch_size]
            enc = self.tokenizer(
                [b for _, b in chunk], padding="max_length", truncation=True,
                max_length=self.max_tokens, return_tensors="np",
            )
            emb = self._encode(enc["input_ids"], enc["attention_mask"])
            for (i, _), e in zip(chunk, emb):
                out[i] = e
        return out

    @staticmethod
    def _transcribe_whisperx(audio_path: str) -> list[dict]:
        """WhisperX transcription with word-level alignment (the reference's
        primary ASR path, text_feature_extractor.py:129-160): base model,
        then the language's alignment model refines segment timestamps.
        Optional dependency: callers fall back to plain whisper."""
        import whisperx  # type: ignore

        device = "cuda" if torch.cuda.is_available() else "cpu"
        model = whisperx.load_model("base", device)
        audio = whisperx.load_audio(audio_path)
        result = model.transcribe(audio)
        model_a, metadata = whisperx.load_align_model(
            language_code=result["language"], device=device
        )
        aligned = whisperx.align(result["segments"], model_a, metadata, audio, device)
        return [
            {"start": s["start"], "end": s["end"], "text": s["text"]}
            for s in aligned["segments"]
        ]

    @staticmethod
    def transcribe(
        audio_path: str, cache_path: str | None = None, backend: str = "auto",
        asr=None, word_timestamps: bool = False,
    ) -> list[dict]:
        """ASR with transcript JSON caching (the reference caches transcripts,
        text_feature_extractor.py:198-236). ``backend``: "auto" tries WhisperX
        and falls back to plain whisper (the reference's try/except chain,
        text_feature_extractor.py:292-300); "whisperx" / "whisper" force one.
        Passing ``asr`` (an ``extractors.whisper_torch.WhisperASR``)
        transcribes with the port's Whisper instead."""
        import json

        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                cached = json.load(f)
            if (
                word_timestamps
                and asr is not None
                and cached
                and not any("words" in s for s in cached)
            ):
                # a cache without words would no-op word_timestamps=True
                logger.info(
                    "transcript cache %s lacks word timestamps; re-transcribing",
                    cache_path,
                )
            else:
                return cached
        segments = None
        if asr is not None:
            segments = asr.transcribe_file(audio_path, word_timestamps=word_timestamps)
        if segments is None and backend in ("auto", "whisperx"):
            try:
                segments = TextExtractor._transcribe_whisperx(audio_path)
            except Exception as e:
                if backend == "whisperx":
                    raise
                logger.info("whisperx unavailable/failed (%s); whisper fallback", e)
        if segments is None:
            try:
                import whisper  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "neither whisperx nor openai-whisper installed; provide "
                    "cached transcripts instead"
                ) from e
            model = whisper.load_model("base")
            result = model.transcribe(audio_path)
            segments = [
                {"start": s["start"], "end": s["end"], "text": s["text"]}
                for s in result["segments"]
            ]
        if cache_path:
            with open(cache_path, "w") as f:
                json.dump(segments, f)
        return segments
