"""The port's audio frontends against the JAX package's on the CPU: the
PANNs STFT / log-mel (``extractors/audio_frontend.py``), Whisper's log-mel
(``log_mel_whisper``) and the classical-DSP fallback features
(``extractors/fallback_audio.py``), on seeded waves."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.extractors import audio_frontend as jaf
from repurpose_tpu.extractors import fallback_audio as jfb
from repurpose_tpu.extractors import whisper_jax as wj
from repurpose_tpu_torch.extractors import audio_frontend as taf
from repurpose_tpu_torch.extractors import fallback_audio as tfb
from repurpose_tpu_torch.extractors import whisper_torch as wt

# Power: relative 1e-5, with a floor of 1e-6 of the largest bin (bins near 0
# are sums that cancel, where two FFTs differ relatively). Logs: 1e-4.
POWER_RTOL, POWER_FLOOR, LOG_ATOL = 1e-5, 1e-6, 1e-4


def _waves(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 22050.0
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000, shape[:-1])[..., None] * t)
    return (tone + rng.normal(0, 0.1, shape)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, dict(sr=16000, n_fft=400, n_mels=80, fmin=0.0, fmax=8000.0),
                                dict(sr=22050, n_fft=1024, fmin=0.0, fmax=11025.0)],
                         ids=["panns", "whisper", "fallback"])
def test_mel_filterbank_equals_jax(kw):
    np.testing.assert_array_equal(taf.mel_filterbank(**kw), jaf.mel_filterbank(**kw))


def test_hann_window_equals_jax():
    np.testing.assert_array_equal(taf.hann_window(1024), jaf.hann_window(1024))


@pytest.mark.parametrize("n_fft,hop,length", [(1024, 320, 22050), (1024, 320, 7777),
                                              (400, 160, 16000)])
def test_stft_power_matches_jax(n_fft, hop, length):
    wave = _waves(n_fft + length, (3, length))
    want = np.asarray(jaf.stft_power(jnp.asarray(wave), n_fft=n_fft, hop=hop))
    got = taf.stft_power(torch.from_numpy(wave), n_fft=n_fft, hop=hop).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=POWER_RTOL, atol=POWER_FLOOR * want.max())


def test_logmel_matches_jax():
    wave = _waves(5, (3, 22050))
    want = np.asarray(jaf.logmel(jnp.asarray(wave)))
    got = taf.logmel(torch.from_numpy(wave)).numpy()
    assert got.shape == (3, 69, 64)
    np.testing.assert_allclose(got, want, atol=LOG_ATOL, rtol=0)


def test_log_mel_whisper_matches_jax():
    wave = _waves(6, (2, wt.N_SAMPLES)) * np.float32(0.5)
    wave[1, wt.N_SAMPLES // 3:] = 0.0  # a chunk padded with silence
    want = np.asarray(wj.log_mel_whisper(jnp.asarray(wave)))
    got = wt.log_mel_whisper(torch.from_numpy(wave)).numpy()
    assert got.shape == (2, 3000, 80)
    np.testing.assert_allclose(got, want, atol=LOG_ATOL, rtol=0)


def test_fallback_features_match_jax():
    """The fallback's 38 informative dims from the port's STFT against the
    JAX one's, on a tone + noise wave with a ragged tail (3.4 windows)."""
    sr = 22050
    wave = _waves(7, (int(3.4 * sr),))
    want = jfb.fallback_features(wave, sr)
    got = tfb.fallback_features(wave, sr)
    assert got.shape == want.shape == (4, 2048)
    assert not got[:, 38:].any()
    # MFCC, chroma, contrast and tonnetz are sums and logs of the power:
    # 1e-4 relative to each dimension's scale
    scale = np.abs(want).max(axis=0, keepdims=True) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tfb.fallback_features_window(wave[:sr], sr), got[0],
                               atol=1e-5 * np.abs(got[0]).max(), rtol=0)
