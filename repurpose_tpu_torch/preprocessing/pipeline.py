"""Preprocessing orchestrator, dataset JSON -> downloaded videos -> per-second
feature .npy files for the three modalities: the port of
``repurpose_tpu/preprocessing/pipeline.py``.

The reference's PreprocessingPipeline (preprocessing/main_preprocessing.py:
17-338): ordered steps [download, visual, audio, text] per dataset and a
feature-completeness verifier (--verify, :268-314). The extractors are the
port's modules on ``device`` in large batches; their weights load from local
checkpoint files (HF / PANNs formats) through the converters, and nothing is
fetched; text runs transcribe -> bin -> embed in one pass.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device

logger = logging.getLogger(__name__)

STEPS = ("download", "visual", "audio", "text")


@dataclass
class PreprocessConfig:
    video_dir: str = "data/videos"
    visual_dir: str = "data/video_clip_features"
    audio_dir: str = "data/audio_pann_features"
    text_dir: str = "data/caption_features"
    transcript_dir: str = "data/transcripts"
    clip_checkpoint: str = ""  # HF CLIPVisionModelWithProjection dir/file
    panns_checkpoint: str = ""  # PANNs Cnn14 .pth
    minilm_checkpoint: str = ""  # HF all-MiniLM-L6-v2 dir
    whisper_checkpoint: str = ""  # HF whisper dir -> the port's ASR (else host whisper)
    whisper_auto_language: bool = False  # per-video language detection
    whisper_beam_size: int = 1  # > 1: batched beam search (host default: 5)
    whisper_word_timestamps: bool = False  # cross-attention word aligner +
    # word-level per-second binning
    download_workers: int = 3
    visual_batch: int = 128
    audio_batch: int = 512
    text_batch: int = 256
    cookies_file: str | None = None


def load_video_ids(dataset_json: str) -> list[str]:
    with open(dataset_json) as f:
        entries = json.load(f)
    return sorted({e["youtube_id"] for e in entries})


class PreprocessingPipeline:
    """The steps on ``device`` (CUDA by default; it raises without a card)."""

    def __init__(self, cfg: PreprocessConfig, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        for d in (cfg.video_dir, cfg.visual_dir, cfg.audio_dir, cfg.text_dir,
                  cfg.transcript_dir):
            os.makedirs(d, exist_ok=True)

    # -- weights ---------------------------------------------------------------

    @staticmethod
    def _load_state_dict(path: str, weights_only: bool = True) -> dict:
        """State dict from a torch .pth / .bin file, a .safetensors file, or an
        HF checkpoint DIRECTORY (model.safetensors, read where the
        ``safetensors`` package is installed, else pytorch_model.bin); a
        ``{"model": ...}`` checkpoint is unwrapped. Values are numpy arrays
        (safetensors) or CPU tensors (torch.load); the converters take
        either."""
        if os.path.isdir(path):
            st = os.path.join(path, "model.safetensors")
            bin_path = os.path.join(path, "pytorch_model.bin")
            use_st = os.path.exists(st) and (_have_safetensors() or not os.path.exists(bin_path))
            path = st if use_st else bin_path
        if path.endswith(".safetensors"):
            from safetensors.numpy import load_file

            return dict(load_file(path))
        ckpt = torch.load(path, map_location="cpu", weights_only=weights_only)
        sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
        return dict(sd)

    def _clip_params(self) -> dict:
        from repurpose_tpu_torch.extractors.clip_vit import (
            CLIPVisionConfig,
            convert_hf_clip_vision,
        )

        return convert_hf_clip_vision(self._load_state_dict(self.cfg.clip_checkpoint),
                                      CLIPVisionConfig())

    def _panns_params(self) -> dict:
        from repurpose_tpu_torch.extractors.cnn14 import convert_panns_cnn14

        return convert_panns_cnn14(
            self._load_state_dict(self.cfg.panns_checkpoint, weights_only=False)
        )

    def _minilm(self):
        from transformers import AutoTokenizer

        from repurpose_tpu_torch.extractors.minilm import MiniLMConfig, convert_hf_bert

        tok = AutoTokenizer.from_pretrained(self.cfg.minilm_checkpoint)
        sd = self._load_state_dict(self.cfg.minilm_checkpoint)
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}
        return convert_hf_bert(sd, MiniLMConfig()), tok

    def _asr(self):
        """The port's Whisper ASR from ``whisper_checkpoint``, or None (the
        host whisper / whisperx path)."""
        if not self.cfg.whisper_checkpoint:
            return None
        from repurpose_tpu_torch.extractors.whisper_torch import WhisperASR

        return WhisperASR.from_hf_dir(
            self.cfg.whisper_checkpoint,
            auto_language=self.cfg.whisper_auto_language,
            beam_size=self.cfg.whisper_beam_size,
            device=self.device,
        )

    # -- steps ------------------------------------------------------------------

    def run_download(self, video_ids: Sequence[str]) -> dict:
        from repurpose_tpu_torch.preprocessing.downloader import VideoDownloader

        dl = VideoDownloader(
            self.cfg.video_dir,
            max_workers=self.cfg.download_workers,
            cookies_file=self.cfg.cookies_file,
        )
        return dl.download_dataset(video_ids)

    def run_visual(self, video_ids: Sequence[str]) -> dict:
        from repurpose_tpu_torch.preprocessing.extract import VisualExtractor

        ex = VisualExtractor(self._clip_params(), batch_size=self.cfg.visual_batch,
                             device=self.device)
        return ex.run(video_ids, self.cfg.video_dir, self.cfg.visual_dir)

    def run_audio(self, video_ids: Sequence[str]) -> dict:
        from repurpose_tpu_torch.preprocessing.extract import AudioExtractor

        ex = AudioExtractor(self._panns_params(), batch_size=self.cfg.audio_batch,
                            device=self.device)
        return ex.run(video_ids, self.cfg.video_dir, self.cfg.audio_dir)

    def run_text(self, video_ids: Sequence[str]) -> dict:
        from repurpose_tpu_torch.preprocessing.extract import (
            TextExtractor,
            _resumable,
            bin_transcript_per_second,
        )
        from repurpose_tpu_torch.preprocessing.media import probe_duration

        params, tok = self._minilm()
        ex = TextExtractor(params, tok, batch_size=self.cfg.text_batch, device=self.device)
        asr = self._asr()
        word_level = bool(asr) and self.cfg.whisper_word_timestamps

        def extract_text(src: str) -> np.ndarray:
            vid = os.path.splitext(os.path.basename(src))[0]
            segments = ex.transcribe(
                src, os.path.join(self.cfg.transcript_dir, f"{vid}.json"),
                asr=asr, word_timestamps=word_level,
            )
            # floor, the reference's int(actual_duration)
            # (text_feature_extractor.py:309)
            duration = int(probe_duration(src))
            bins = bin_transcript_per_second(segments, duration, word_level=word_level)
            return ex.embed_bins(bins)

        # the visual / audio driver: is_done skipping, missing-file
        # categorisation and the bad-feature-shape guard (a 0-second video
        # fails instead of saving a (0, 384) file marked completed)
        return _resumable("text")(
            extract_text, video_ids, self.cfg.video_dir, self.cfg.text_dir
        )

    def process_dataset(self, dataset_json: str, steps: Sequence[str] = STEPS) -> dict:
        # validate the whole list before running anything: a typo in a later
        # step must not surface only after hours of earlier steps
        bad = [s for s in steps if s not in STEPS]
        if bad:
            raise ValueError(f"unknown steps {bad}; valid: {STEPS}")
        video_ids = load_video_ids(dataset_json)
        logger.info("processing %d videos from %s", len(video_ids), dataset_json)
        results = {}
        for step in steps:
            logger.info("step: %s", step)
            results[step] = getattr(self, f"run_{step}")(video_ids)
        return results

    # -- verification ----------------------------------------------------------

    def verify_features(self, dataset_json: str) -> dict:
        """Completeness scan (the reference's --verify,
        main_preprocessing.py:268-314): per modality, which videos have a
        loadable 2-D non-empty .npy."""
        video_ids = load_video_ids(dataset_json)
        dirs = {
            "visual": self.cfg.visual_dir,
            "audio": self.cfg.audio_dir,
            "text": self.cfg.text_dir,
        }
        report: dict = {"total": len(video_ids)}
        complete = set(video_ids)
        for mod, d in dirs.items():
            ok, missing, corrupt = [], [], []
            for vid in video_ids:
                p = os.path.join(d, f"{vid}.npy")
                if not os.path.exists(p):
                    missing.append(vid)
                    continue
                try:
                    arr = np.load(p, mmap_mode="r", allow_pickle=False)
                    if arr.ndim != 2 or arr.shape[0] == 0:
                        corrupt.append(vid)
                    else:
                        ok.append(vid)
                except Exception:
                    corrupt.append(vid)
            report[mod] = {"ok": len(ok), "missing": len(missing), "corrupt": len(corrupt)}
            complete &= set(ok)
        report["complete_all_modalities"] = len(complete)
        return report


def _have_safetensors() -> bool:
    try:
        import safetensors  # noqa: F401
    except ImportError:
        return False
    return True
