"""Pre-LN transformer encoder (``repurpose_tpu/models/encoder.py``).

Parameters carry the reference MMCTransformer's state-dict names
(``multimodal_encoder.layers.{i}.self_attn.in_proj_weight`` ...), so
reference checkpoints load strictly. Numerics follow the JAX model:

- parameters are float32 and cast to the compute dtype at use (bf16 Dense);
- LayerNorms compute in float32 and are cast back to the compute dtype;
- the packed QKV projection's output is split into q/k/v views that go to
  the attention kernel without a copy;
- dropout where the JAX encoder has it: after the attention output
  projection, after the FFN ReLU and after the FFN output (none on the
  attention weights, which the fused kernels do not expose). It is active in
  ``model.train()`` only, with masks from the generator that
  ``MMCT.set_dropout_generator`` hands out.

Rematerialisation (``ModelConfig.remat``) is not ported: the training entry
points raise for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.ops.attention import select_attention_impl

LN_EPS = 1e-5


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Flax ``nn.LayerNorm(dtype=float32)``: float32 in, float32 out."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: zero each element with probability ``p`` and scale
    the rest by 1/(1-p), in train mode only. The masks come from
    ``generator`` (None: torch's default generator)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class SelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention in torch MHA's parameter layout."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)
        self.attn = select_attention_impl(cfg.attention_impl, cfg.attn_softmax_dtype)

    def forward(self, x, key_valid, seg_ids=None):
        b, t, d = x.shape
        h = self.cfg.num_heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (z.view(b, t, h, d // h) for z in qkv.split(d, dim=-1))
        out = self.attn(q, k, v, key_valid, seg_ids=seg_ids)
        return linear(out.reshape(b, t, d), self.out_proj, x.dtype)


class EncoderLayer(nn.Module):
    """x + Drop(SA(LN1(x))); x + Drop(FFN(LN2(x))) — pre-LN residual block
    (dropout module names as in torch's TransformerEncoderLayer)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = SelfAttention(cfg)
        self.linear1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.linear2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.norm1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.dropout1 = Dropout(cfg.dropout)  # attention output
        self.dropout = Dropout(cfg.dropout)  # FFN hidden
        self.dropout2 = Dropout(cfg.dropout)  # FFN output

    def forward(self, x, key_valid, seg_ids=None):
        dtype = x.dtype
        y = layer_norm(x, self.norm1).to(dtype)
        x = x + self.dropout1(self.self_attn(y, key_valid, seg_ids))
        y = layer_norm(x, self.norm2).to(dtype)
        y = self.dropout(torch.relu(linear(y, self.linear1, dtype)))
        return x + self.dropout2(linear(y, self.linear2, dtype))


class Encoder(nn.Module):
    """Stack of pre-LN layers (reference: 16, models/MMCTransformer.py:51-55)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(cfg) for _ in range(cfg.self_num_layers))

    def forward(self, x, key_valid, seg_ids=None):
        for layer in self.layers:
            x = layer(x, key_valid, seg_ids)
        return x
