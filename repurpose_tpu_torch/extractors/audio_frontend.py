"""Waveform -> log-mel spectrogram in PyTorch (the CNN14 input stage): the
port of ``repurpose_tpu/extractors/audio_frontend.py``.

The PANNs frontend (torchlibrosa Spectrogram: n_fft 1024, hop 320, periodic
Hann, center=True reflect pad, power; LogmelFilterBank: sr 32000, 64 mels,
fmin 50, fmax 14000, Slaney norm, ref 1.0, amin 1e-10, top_db None). The
pipeline feeds it audio at 22 050 Hz unresampled while the filterbank stays
built for 32 kHz, as the reference does (PARITY.md).

``stft_power`` frames with a reflect pad and ``unfold`` and transforms with
``torch.fft.rfft``, the JAX framing exactly; ``torch.stft`` is not used.
The filterbank helpers are numpy, copied from the JAX module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 32000
N_FFT = 1024
HOP = 320
N_MELS = 64
FMIN = 50.0
FMAX = 14000.0
AMIN = 1e-10


def hann_window(n: int) -> np.ndarray:
    """Periodic (fftbins) Hann, as librosa/torchlibrosa use."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    hz = m * f_sp
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)


def mel_filterbank(
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = N_MELS,
    fmin: float = FMIN,
    fmax: float = FMAX,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_fft//2+1, n_mels]
    (librosa.filters.mel semantics, which PANNs uses)."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(
        _hz_to_mel_slaney(np.array(fmin)), _hz_to_mel_slaney(np.array(fmax)), n_mels + 2
    )
    hz_pts = _mel_to_hz_slaney(mel_pts)
    weights = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # [freq, mel]


def stft_power(wave: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP) -> torch.Tensor:
    """[B, L] float32 waveform -> [B, frames, n_fft//2+1] float32 power
    spectrogram (center=True: a reflect pad of n_fft // 2 on each side;
    frames every ``hop`` samples; periodic Hann)."""
    pad = n_fft // 2
    x = F.pad(wave.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # [B, frames, n_fft]
    win = torch.from_numpy(hann_window(n_fft)).to(x.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    return (spec.real**2 + spec.imag**2).float()


def logmel(wave: torch.Tensor, mel_fb: torch.Tensor | None = None) -> torch.Tensor:
    """[B, L] waveform -> [B, frames, n_mels] log-mel (ref=1, amin=1e-10,
    top_db=None: PANNs LogmelFilterBank settings)."""
    if mel_fb is None:
        mel_fb = torch.from_numpy(mel_filterbank()).to(wave.device)
    mel = torch.matmul(stft_power(wave), mel_fb)
    return 10.0 * torch.log10(torch.clamp(mel, min=AMIN))
