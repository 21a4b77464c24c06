"""Layers the extractors share, with the JAX modules' rounding points: a
Dense that runs in its input's dtype, a LayerNorm in float32, and attention
whose scores and softmax are float32."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """A Linear run in its input's dtype: the float32 weight (and bias) cast
    where used, as a Flax ``Dense(dtype=x.dtype)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32 with a float32 result, as a Flax
    ``LayerNorm(dtype=float32)``; callers cast back where the JAX module
    does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
              bias: torch.Tensor | None = None, scale: bool = False,
              return_weights: bool = False):
    """``[B, T, d]`` projected q / k / v -> ``[B, Tq, d]``: float32 scores
    (products of the inputs' values, summed in float32), divided by
    sqrt(Dh) when ``scale``, plus ``bias``; a float32 softmax, rounded to
    v's dtype for the product with v. ``return_weights`` also returns the
    float32 weights ``[B, H, Tq, Tk]``."""
    b, tq, d = q.shape
    dh = d // heads
    qh = q.reshape(b, tq, heads, dh).transpose(1, 2).float()
    kh = k.reshape(b, k.shape[1], heads, dh).transpose(1, 2).float()
    vh = v.reshape(b, v.shape[1], heads, dh).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if scale:
        s = s / math.sqrt(dh)  # the float32 root, as the JAX modules divide
    if bias is not None:
        s = s + bias
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(w.to(v.dtype), vh).transpose(1, 2).reshape(b, tq, d)
    return (out, w) if return_weights else out


def compute_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> bf16, anything else float32 (the JAX modules' rule)."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def as_tensor(x) -> torch.Tensor:
    """A checkpoint array (numpy or torch) as a contiguous float32 CPU tensor."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", torch.float32).contiguous()
    import numpy as np

    return torch.from_numpy(np.array(x, dtype=np.float32))
