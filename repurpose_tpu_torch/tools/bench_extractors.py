"""Feature-extractor throughput on the card: the port of root
``bench_extractors.py``.

    python -m repurpose_tpu_torch.tools.bench_extractors [JSON_PATH] [--device cuda|cpu]

Items per second of each extractor at the published widths with random
weights from a numpy seed (architecture throughput, independent of
checkpoints): CLIP ViT-B/32 frames (one per video-second), CNN14 audio
seconds (22 050-sample chunks), MiniLM-L6 sentences of 64 tokens,
Whisper-base ASR audio-seconds (30 s chunks, the decode capped at 64
positions, greedy and beam 5) and the word aligner (the alignment matrix
and the DTW). Each time is the median of ``REPEATS`` (Whisper:
``WHISPER_REPEATS``) runs after a warm-up, each run ended by
``torch.cuda.synchronize``. The last line is the JSON line of the root
tool, with the card's name and power limit in ``detail``; ``vs_baseline``
divides by ``A100_REFERENCE``, the JAX tool's analytic A100 denominator for
the reference pipeline (BASELINE.md), not a measurement. Writes no
``BENCHMARK.json``. ``--device cpu`` gives host-clock times of the CPU
path, which say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.extractors.clip_vit import CLIPVisionConfig, CLIPVisionEncoder
from repurpose_tpu_torch.extractors.cnn14 import CNN14, CNN14Config, embed_waveform_chunks
from repurpose_tpu_torch.extractors.minilm import MiniLMConfig, MiniLMEncoder
from repurpose_tpu_torch.extractors.whisper_align import WhisperAligner
from repurpose_tpu_torch.extractors.whisper_torch import (
    N_SAMPLES,
    WhisperConfig,
    WhisperDecoder,
    WhisperEncoder,
    beam_decode,
    greedy_decode,
    log_mel_whisper,
)
from repurpose_tpu_torch.native import dtw_path
from repurpose_tpu_torch.tools import device_line

#: The JAX tool's analytic A100 denominator for the reference pipeline, in
#: items/s (root bench_extractors.py; BASELINE.md "Extractor throughput"):
#: the reference runs every model batch-1 in eager torch. Not a measurement.
A100_REFERENCE = {
    "clip_frames_per_s": 125.0,
    "cnn14_audio_s_per_s": 94.0,
    "whisper_audio_s_per_s": 100.0,
    "minilm_sentences_per_s": 250.0,
}

CLIP_CONFIG = CLIPVisionConfig()
CLIP_BATCH = 256
CNN14_CONFIG = CNN14Config()
CNN14_BATCH = 512
CHUNK_SAMPLES = 22050  # one video-second of the pipeline's audio
MINILM_CONFIG = MiniLMConfig()
MINILM_BATCH, MINILM_TOKENS = 512, 64
WHISPER_CONFIG = WhisperConfig(max_target_positions=64)  # <= 61 tokens a chunk
WHISPER_CHUNKS = 8  # 30 s chunks a batch: 4 min of audio
ALIGN_TOKENS = 40  # text tokens a chunk for the aligner
REPEATS = 10
WHISPER_REPEATS = 3
COMPOSITE = ("clip_frames_per_s", "cnn14_audio_s_per_s", "whisper_audio_s_per_s",
             "minilm_sentences_per_s")


def random_weights(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded random weights in place: normal with std 1/sqrt(fan_in) for
    matrices, convolutions and tables, zero biases, unit scales."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() >= 2:
                std = 1.0 / np.sqrt(np.prod(p.shape[1:]))
                p.copy_(torch.from_numpy(rng.normal(0.0, std, p.shape).astype(np.float32)))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
    return module.eval()


def _median_s(fn, device: torch.device, n: int) -> float:
    """Median over ``n`` synchronised runs of ``fn``, after one warm-up run."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def composite_video_seconds_per_s(rates: dict) -> float:
    """One corpus video-second needs one CLIP frame, one CNN14 second, 1/30
    of a Whisper chunk and at most one MiniLM sentence, in series on one
    device (the root tool's formula)."""
    return 1.0 / sum(1.0 / rates[k] for k in COMPOSITE)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.tools.bench_extractors")
    p.add_argument("json_path", nargs="?", default=None, help="also write the line here")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


@torch.inference_mode()
def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    line_dev = device_line(dev)
    print(line_dev, flush=True)
    rng = np.random.default_rng(0)
    rates: dict = {"device": line_dev.removeprefix("device: ")}

    def put(key: str, items: int, seconds: float, label: str) -> None:
        rates[key] = round(items / seconds, 1)
        print(f"{label}: {items / seconds:,.1f} ({seconds * 1e3:.2f} ms a batch)", flush=True)

    # CLIP ViT-B/32: one frame = one video-second of the visual stream
    clip = random_weights(CLIPVisionEncoder(CLIP_CONFIG, "bfloat16", device=dev), 0)
    size = CLIP_CONFIG.image_size
    imgs = torch.from_numpy(rng.normal(0, 1, (CLIP_BATCH, size, size, 3)).astype(np.float32)
                            ).to(dev)
    put("clip_frames_per_s", CLIP_BATCH, _median_s(lambda: clip(imgs), dev, REPEATS),
        f"CLIP ViT-B/32 frames/s (batch {CLIP_BATCH})")

    # CNN14: one 22 050-sample chunk = one video-second of the audio stream
    cnn = random_weights(CNN14(CNN14_CONFIG, "bfloat16", device=dev), 1)
    waves = torch.from_numpy(rng.normal(0, 0.1, (CNN14_BATCH, CHUNK_SAMPLES)).astype(np.float32)
                             ).to(dev)
    put("cnn14_audio_s_per_s", CNN14_BATCH,
        _median_s(lambda: embed_waveform_chunks(cnn, waves), dev, REPEATS),
        f"CNN14 audio-seconds/s (batch {CNN14_BATCH})")

    # MiniLM: one sentence = one transcribed video-second of the text stream
    mlm = random_weights(MiniLMEncoder(MINILM_CONFIG, device=dev), 2)
    ids = torch.from_numpy(rng.integers(0, MINILM_CONFIG.vocab_size,
                                        (MINILM_BATCH, MINILM_TOKENS))).to(dev)
    mask = torch.ones_like(ids)
    put("minilm_sentences_per_s", MINILM_BATCH, _median_s(lambda: mlm(ids, mask), dev, REPEATS),
        f"MiniLM-L6 sentences/s (batch {MINILM_BATCH} x {MINILM_TOKENS} tokens)")

    # Whisper-base ASR: audio-seconds/s; the decode sequential, capped at 64
    wcfg = WHISPER_CONFIG
    wenc = random_weights(WhisperEncoder(wcfg, "bfloat16", device=dev), 3)
    wdec = random_weights(WhisperDecoder(wcfg, "bfloat16", device=dev), 4)
    wav = torch.from_numpy(rng.normal(0, 0.1, (WHISPER_CHUNKS, N_SAMPLES)).astype(np.float32)
                           ).to(dev)
    prompt = (wcfg.sot, wcfg.lang_begin, wcfg.transcribe)
    audio_s = WHISPER_CHUNKS * 30

    def encode():
        return wenc(log_mel_whisper(wav, n_mels=wcfg.n_mels))

    put("whisper_audio_s_per_s", audio_s,
        _median_s(lambda: greedy_decode(wdec, encode(), prompt), dev, WHISPER_REPEATS),
        f"Whisper-base ASR audio-seconds/s (batch {WHISPER_CHUNKS} x 30 s, "
        f"<= {wcfg.max_target_positions - len(prompt)} tokens a chunk)")
    put("whisper_beam5_audio_s_per_s", audio_s,
        _median_s(lambda: beam_decode(wdec, encode(), prompt, 5), dev, WHISPER_REPEATS),
        "Whisper-base ASR beam=5 audio-seconds/s")

    # the word aligner: the teacher-forced alignment matrix and the DTW, the
    # per-chunk cost of word_timestamps=True on top of ASR
    aligner = WhisperAligner(wdec, prompt)
    rows = [list(range(100, 100 + ALIGN_TOKENS))] * WHISPER_CHUNKS

    def align():
        for m in aligner.align_block(rows, encode(), [N_SAMPLES] * WHISPER_CHUNKS):
            dtw_path(-m)

    put("aligner_audio_s_per_s", audio_s, _median_s(align, dev, WHISPER_REPEATS),
        f"Word aligner aligned audio-seconds/s ({ALIGN_TOKENS} tokens a chunk, with the DTW)")

    vps = composite_video_seconds_per_s(rates)
    a100 = composite_video_seconds_per_s(A100_REFERENCE)
    rates["video_seconds_per_s_per_chip"] = round(vps, 1)
    rates["a100_video_seconds_per_s"] = round(a100, 1)
    rates["vs_a100"] = round(vps / a100, 2)
    line = {
        "metric": "preprocess_video_seconds_per_s_per_chip",
        "value": rates["video_seconds_per_s_per_chip"],
        "unit": "video-seconds/s/chip",
        "vs_baseline": rates["vs_a100"],
        "detail": rates,
    }
    print(json.dumps(line), flush=True)
    if args.json_path:
        with open(args.json_path, "w") as f:
            json.dump(line, f, indent=1)
    return line


if __name__ == "__main__":
    main()
