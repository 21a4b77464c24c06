"""Classical-DSP audio features, the no-model fallback path: the port of
``repurpose_tpu/extractors/fallback_audio.py`` (numpy on the host).

When no CNN14 checkpoint is given, each 1-second window yields
mean-over-frames MFCC(13) + chroma(12) + spectral-contrast(7) + tonnetz(6)
= 38 dims, zero-padded to the 2048-d slot of the audio stream (the
reference's librosa fallback, audio_feature_extractor.py:159-239; close in
spirit, not bit-identical to librosa: PARITY.md). The power spectrogram is
the port's ``stft_power`` on CPU tensors: this is host work.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repurpose_tpu_torch.extractors.audio_frontend import mel_filterbank, stft_power

FALLBACK_DIM = 2048
_STFT_BATCH = 512  # windows per STFT call


def _dct_ii_ortho(x: np.ndarray, n_out: int) -> np.ndarray:
    """Orthonormal DCT-II along axis 0 (librosa MFCC convention)."""
    from scipy.fft import dct

    return dct(x, type=2, axis=0, norm="ortho")[:n_out]


@functools.lru_cache(maxsize=4)
def _chroma_map(sr: int, n_fft: int, tuning_hz: float = 440.0) -> np.ndarray:
    """[n_bins, 12] map folding FFT bins onto pitch classes."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    out = np.zeros((len(freqs), 12))
    valid = freqs > 20.0
    midi = 69 + 12 * np.log2(np.maximum(freqs, 1e-9) / tuning_hz)
    pc = np.mod(np.round(midi), 12).astype(int)
    for i in np.nonzero(valid)[0]:
        out[i, pc[i]] = 1.0
    return out


@functools.lru_cache(maxsize=1)
def _tonnetz_basis() -> np.ndarray:
    """[6, 12] tonal centroid transform (Harte et al. 2006)."""
    pc = np.arange(12)
    r = [1.0, 1.0, 0.5]
    angles = [7.0 * np.pi / 6.0 * pc, 3.0 * np.pi / 2.0 * pc, 2.0 * np.pi / 3.0 * pc]
    basis = []
    for rad, ang in zip(r, angles):
        basis.append(rad * np.sin(ang))
        basis.append(rad * np.cos(ang))
    return np.stack(basis)


@functools.lru_cache(maxsize=2)
def _mel_fb(sr: int, n_fft: int) -> np.ndarray:
    return mel_filterbank(sr=sr, n_fft=n_fft, fmin=0.0, fmax=sr / 2)


def _power(windows: np.ndarray) -> np.ndarray:
    """[N, samples] windows -> [N, frames, bins] power, on the CPU."""
    return stft_power(torch.from_numpy(np.ascontiguousarray(windows, np.float32))).numpy()


def fallback_features_window(window: np.ndarray, sr: int = 22050) -> np.ndarray:
    """One 1-second window -> 2048-d feature vector (38 informative dims)."""
    return _features_from_power(_power(window[None])[0].T, sr)


def _features_from_power(spec: np.ndarray, sr: int) -> np.ndarray:
    """[bins, frames] power spectrogram of one window -> 2048-d vector."""
    n_fft = 1024

    # MFCC(13): DCT of log-mel.
    mel = _mel_fb(sr, n_fft).T @ spec
    logmel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    mfcc = _dct_ii_ortho(logmel, 13).mean(axis=1)

    # chroma(12): pitch-class folding, per-frame max-normalized.
    chroma = _chroma_map(sr, n_fft).T @ spec
    chroma = chroma / np.maximum(chroma.max(axis=0, keepdims=True), 1e-10)
    chroma_mean = chroma.mean(axis=1)

    # spectral contrast(7): 6 octave bands + top band, peak - valley in dB.
    freqs = np.linspace(0, sr / 2, spec.shape[0])
    edges = 200.0 * (2.0 ** np.arange(0, 7))
    edges = np.concatenate([[0.0], edges[edges < sr / 2], [sr / 2]])
    contrast = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        band = spec[(freqs >= lo) & (freqs < hi)]
        if band.shape[0] == 0:
            contrast.append(0.0)
            continue
        band_db = 10.0 * np.log10(np.maximum(band, 1e-10))
        q = max(1, int(0.02 * band.shape[0]))
        srt = np.sort(band_db, axis=0)
        contrast.append(float((srt[-q:].mean() - srt[:q].mean())))
    contrast = np.asarray(contrast[:7])
    contrast = np.pad(contrast, (0, 7 - len(contrast)))

    # tonnetz(6): tonal centroids of L1-normalized chroma.
    cn = chroma_mean / max(chroma_mean.sum(), 1e-10)
    tonnetz = _tonnetz_basis() @ cn

    vec = np.concatenate([mfcc, chroma_mean, contrast, tonnetz]).astype(np.float32)
    out = np.zeros(FALLBACK_DIM, np.float32)
    out[: len(vec)] = vec[:FALLBACK_DIM]
    return out


def fallback_features(wave: np.ndarray, sr: int = 22050) -> np.ndarray:
    """Full waveform -> (T_seconds, 2048) fallback features (1-s windows,
    zero-padded tail: the reference windowing, audio_feature_extractor.py:
    188-199). The STFT runs over blocks of ``_STFT_BATCH`` windows; the
    per-window feature math is host numpy."""
    n = int(np.ceil(len(wave) / sr)) if len(wave) else 0
    out = np.zeros((n, FALLBACK_DIM), np.float32)
    if n == 0:
        return out
    padded = np.zeros(n * sr, np.float32)
    padded[: len(wave)] = wave
    windows = padded.reshape(n, sr)
    for start in range(0, n, _STFT_BATCH):
        power = _power(windows[start : start + _STFT_BATCH])  # [B, frames, bins]
        for i in range(power.shape[0]):
            out[start + i] = _features_from_power(power[i].T, sr)
    return out
