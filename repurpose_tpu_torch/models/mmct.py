"""MMCT — the multimodal temporal transformer (``repurpose_tpu/models/mmct.py``).

Early fusion of the three per-second streams (CLIP 512 + PANNs 2048 + SBERT
384) by concatenation, input projection + LayerNorm, sinusoidal PE, the pre-LN
encoder, the encoder norm, a feature map, and two heads:

- ``cls``: per-second engagement logit [B, T, 1];
- ``reg``: per-second (left, right) boundary offsets [B, T, 2], non-negative.

Module and parameter names are the reference MMCTransformer's
(models/MMCTransformer.py:25-96), so its state dicts load strictly. Numerics
are the JAX model's: bf16 Dense layers on float32 parameters, float32
LayerNorms cast back to the compute dtype (the input norm stays float32 until
the PE is added), the heads' last Dense in float32, and the PE gathered by
``positions`` on packed batches. Dropout (``ModelConfig.dropout``) sits where
the JAX model has it: in the encoder layers, after the feature map's ReLU and
after each head hidden ReLU; it is active in ``model.train()`` only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models.encoder import LN_EPS, Dropout, Encoder, layer_norm, linear
from repurpose_tpu_torch.models.positional import sinusoidal_positional_encoding


class MMCTOutput(NamedTuple):
    cls_logits: torch.Tensor  # [B, T, 1] float32
    offsets: torch.Tensor  # [B, T, 2] float32, non-negative
    feats: torch.Tensor  # [B, T, d_model] compute dtype


class _Head(nn.Module):
    """LN -> Dense(hidden) -> relu -> drop -> Dense(hidden) -> relu -> drop ->
    Dense(out), with the reference's Sequential indices (0 norm, 1 and 4
    hidden, 3 and 6 dropout, 7 out)."""

    def __init__(self, cfg: ModelConfig, out_dim: int, final_relu: bool):
        super().__init__()
        self.cfg = cfg
        self.final_relu = final_relu
        self.add_module("0", nn.LayerNorm(cfg.d_model, eps=LN_EPS))
        self.add_module("1", nn.Linear(cfg.d_model, cfg.hidden_dim))
        self.add_module("3", Dropout(cfg.dropout))
        self.add_module("4", nn.Linear(cfg.hidden_dim, cfg.hidden_dim))
        self.add_module("6", Dropout(cfg.dropout))
        self.add_module("7", nn.Linear(cfg.hidden_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self._modules
        dtype = x.dtype
        y = layer_norm(x, m["0"]).to(dtype)
        y = m["3"](torch.relu(linear(y, m["1"], dtype)))
        y = m["6"](torch.relu(linear(y, m["4"], dtype)))
        y = linear(y, m["7"], torch.float32)
        if self.final_relu:
            y = torch.relu(y) if self.cfg.reg_activation == "relu" else F.softplus(y)
        return y


class _PositionalEncoding(nn.Module):
    """Holds the reference's ``positional_encoding.pe`` buffer [1, max_len, d]."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(cfg.max_len, cfg.d_model)[None]
        )

    def table(self, t: int) -> torch.Tensor:
        if t <= self.pe.shape[1]:
            return self.pe[0, :t]
        return sinusoidal_positional_encoding(t, self.pe.shape[2], self.pe.device)


class MMCT(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.input_projection = nn.Linear(cfg.concat_dim, d)
        self.input_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.positional_encoding = _PositionalEncoding(cfg)
        self.multimodal_encoder = Encoder(cfg)
        self.encoder_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.feature_map = nn.Sequential(
            nn.Linear(d, d), nn.LayerNorm(d, eps=LN_EPS), nn.ReLU(), Dropout(cfg.dropout)
        )
        self.cls_head = _Head(cfg, 1, final_relu=False)
        self.reg_head = _Head(cfg, 2, final_relu=True)

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Draw every dropout mask from ``generator`` (a torch.Generator on
        the model's device)."""
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32

    def forward(
        self,
        visual: torch.Tensor,  # [B, T, vis_dim]
        audio: torch.Tensor,  # [B, T, aud_dim]
        text: torch.Tensor,  # [B, T, text_dim]
        mask: torch.Tensor,  # [B, T] bool — True on real timesteps
        seg_ids: torch.Tensor | None = None,  # [B, T] int32 — sequence packing
        positions: torch.Tensor | None = None,  # [B, T] int — position within video
    ) -> MMCTOutput:
        """``seg_ids``/``positions`` select the sequence-packed forward:
        block-diagonal attention per video and a PE restarting at each
        video's own t=0, so a packed video gets the values it would unpacked."""
        cfg = self.cfg
        dtype = self.compute_dtype
        streams = {"visual": visual, "audio": audio, "text": text}
        x = torch.cat([streams[m].to(dtype) for m in cfg.modalities], dim=-1)
        x = layer_norm(linear(x, self.input_projection, dtype), self.input_norm)
        pe = self.positional_encoding.table(x.shape[1])
        x = (x + (pe[None] if positions is None else pe[positions.long()])).to(dtype)
        if seg_ids is not None:
            seg_ids = seg_ids.to(torch.int32)

        x = self.multimodal_encoder(x, mask, seg_ids)
        x = layer_norm(x, self.encoder_norm).to(dtype)

        fmap, fnorm, _, fdrop = self.feature_map
        f = fdrop(torch.relu(layer_norm(linear(x, fmap, dtype), fnorm).to(dtype)))
        return MMCTOutput(
            cls_logits=self.cls_head(f), offsets=self.reg_head(f), feats=f
        )
