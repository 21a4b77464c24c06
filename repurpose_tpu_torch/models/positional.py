"""Sinusoidal positional encoding (``repurpose_tpu/models/positional.py``).

pe[t, 2i] = sin(t * exp(-2i * ln(10000) / d)), pe[t, 2i+1] = cos(...), in
float32 — the reference's table (models/MMCTransformer.py:9-22).
"""

from __future__ import annotations

import math

import torch


def sinusoidal_positional_encoding(
    seq_len: int, d_model: int, device: str | torch.device = "cpu"
) -> torch.Tensor:
    """Return the [seq_len, d_model] float32 PE table."""
    position = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    angles = position * div_term[None, :]
    pe = torch.zeros((seq_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : (d_model // 2)])
    return pe
