"""PANNs CNN14 audio embedder in PyTorch (inference): the port of
``repurpose_tpu/extractors/cnn14.py``.

log-mel [B, T, 64] -> BN over mel bins -> 6 conv blocks (two 3x3 conv + BN
+ ReLU each, channels 64..2048, 2x2 average pool after blocks 1-5) -> mean
over mel -> (max + mean) over time -> fc1 + ReLU = the 2048-d embedding.
BatchNorms are folded into per-channel affines when weights are converted.

Layout: the JAX module is NHWC with time as H and mel as W; here NCHW
``[B, C, T, mel]``, so the pools, the mel mean (dim 3) and the time
max + mean (dim 2) keep the same axes. ``fc1`` runs in float32 on a
float32 cast, as in the JAX module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repurpose_tpu_torch.extractors.audio_frontend import logmel
from repurpose_tpu_torch.extractors.layers import as_tensor, compute_dtype


@dataclass(frozen=True)
class CNN14Config:
    n_mels: int = 64
    embed_dim: int = 2048
    channels: tuple = (64, 128, 256, 512, 1024, 2048)


class _Affine(nn.Module):
    """Folded BatchNorm: y = x * weight + bias per channel on ``dim``, in
    x's dtype."""

    def __init__(self, features: int, dim: int, device=None):
        super().__init__()
        self.dim = dim
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1] * x.dim()
        shape[self.dim] = -1
        return x * self.weight.to(x.dtype).view(shape) + self.bias.to(x.dtype).view(shape)


class _ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, pool: bool, device=None):
        super().__init__()
        self.pool = pool
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False, device=device)
        self.bn1 = _Affine(out_ch, 1, device)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False, device=device)
        self.bn2 = _Affine(out_ch, 1, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = torch.relu(bn(F.conv2d(x, conv.weight.to(x.dtype), padding=1)))
        return F.avg_pool2d(x, 2) if self.pool else x


class CNN14(nn.Module):
    """log-mel [B, T, n_mels] -> embedding [B, embed_dim] (float32)."""

    def __init__(self, cfg: CNN14Config = CNN14Config(), compute_dtype: str = "bfloat16",
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.bn0 = _Affine(cfg.n_mels, -1, device)
        in_ch = 1
        for i, ch in enumerate(cfg.channels):
            setattr(self, f"block{i + 1}",
                    _ConvBlock(in_ch, ch, i < len(cfg.channels) - 1, device))
            in_ch = ch
        self.fc1 = nn.Linear(in_ch, cfg.embed_dim, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.bn0(mel.to(compute_dtype(self.compute_dtype)))[:, None]  # [B, 1, T, mel]
        for i in range(len(self.cfg.channels)):
            x = getattr(self, f"block{i + 1}")(x)
        x = x.mean(dim=3)  # over mel -> [B, C, T']
        x = x.amax(dim=2) + x.mean(dim=2)  # max + mean over time
        return torch.relu(self.fc1(x.float()))


@torch.inference_mode()
def embed_waveform_chunks(model: CNN14, wave_chunks: torch.Tensor) -> torch.Tensor:
    """[N, samples] 1-second chunks -> [N, embed_dim] embeddings, on the
    model's device."""
    return model(logmel(wave_chunks))


def _fold_bn(sd: Mapping, name: str, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    gamma, beta, mean, var = (
        np.asarray(as_tensor(sd[f"{name}.{k}"]), np.float64)
        for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return (torch.from_numpy(scale.astype(np.float32)),
            torch.from_numpy(bias.astype(np.float32)))


def convert_panns_cnn14(sd: Mapping, cfg: CNN14Config = CNN14Config()) -> dict:
    """PANNs Cnn14 checkpoint state dict (numpy or torch; raw
    ``torch.load(ckpt)['model']`` or with a ``module.`` DataParallel prefix)
    -> the state dict of ``CNN14`` (BatchNorms folded, float32)."""
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    out: dict = {}

    def affine(port: str, panns: str) -> None:
        out[f"{port}.weight"], out[f"{port}.bias"] = _fold_bn(sd, panns)

    affine("bn0", "bn0")
    for i in range(1, len(cfg.channels) + 1):
        blk = f"conv_block{i}"
        for j in (1, 2):
            out[f"block{i}.conv{j}.weight"] = as_tensor(sd[f"{blk}.conv{j}.weight"])
            affine(f"block{i}.bn{j}", f"{blk}.bn{j}")
    out["fc1.weight"] = as_tensor(sd["fc1.weight"])
    out["fc1.bias"] = as_tensor(sd["fc1.bias"])
    return out
