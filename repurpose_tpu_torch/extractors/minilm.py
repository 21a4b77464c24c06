"""MiniLM-L6 sentence encoder (all-MiniLM-L6-v2) in PyTorch: the port of
``repurpose_tpu/extractors/minilm.py``.

Per-second transcript bins -> 384-d sentence embeddings (the reference's
text extractor, text_feature_extractor.py:338-376), all bins of a video as
one padded batch. HF BertModel: 6 layers, width 384, 12 heads, erf GELU,
learned positions, post-LN (eps 1e-12); masked keys get a -1e9 bias; mean
pooling over valid tokens in float32, then L2 norm (the
sentence-transformers recipe). Tokenising stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repurpose_tpu_torch.extractors.layers import (
    Dense,
    LayerNorm32,
    as_tensor,
    attention,
    compute_dtype,
)


@dataclass(frozen=True)
class MiniLMConfig:
    vocab_size: int = 30522
    width: int = 384
    layers: int = 6
    heads: int = 12
    intermediate: int = 1536
    max_position: int = 512
    type_vocab: int = 2
    ln_eps: float = 1e-12


class _BertLayer(nn.Module):
    def __init__(self, cfg: MiniLMConfig, device=None):
        super().__init__()
        d = cfg.width
        self.heads = cfg.heads
        self.q = Dense(d, d, device=device)
        self.k = Dense(d, d, device=device)
        self.v = Dense(d, d, device=device)
        self.attn_out = Dense(d, d, device=device)
        self.attn_ln = LayerNorm32(d, eps=cfg.ln_eps, device=device)
        self.ffn_in = Dense(d, cfg.intermediate, device=device)
        self.ffn_out = Dense(cfg.intermediate, d, device=device)
        self.ffn_ln = LayerNorm32(d, eps=cfg.ln_eps, device=device)

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor) -> torch.Tensor:
        o = attention(self.q(x), self.k(x), self.v(x), self.heads, bias=key_bias, scale=True)
        x = self.attn_ln(x + self.attn_out(o)).to(x.dtype)
        y = self.ffn_out(F.gelu(self.ffn_in(x)))
        return self.ffn_ln(x + y).to(x.dtype)


class MiniLMEncoder(nn.Module):
    """(input_ids, attention_mask [B, T]) -> L2-normalised embeddings
    [B, width] (float32)."""

    def __init__(self, cfg: MiniLMConfig = MiniLMConfig(), compute_dtype: str = "float32",
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.tok_embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.width, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_position, cfg.width, device=device))
        self.type_embed = nn.Parameter(torch.zeros(cfg.type_vocab, cfg.width, device=device))
        self.embed_ln = LayerNorm32(cfg.width, eps=cfg.ln_eps, device=device)
        for i in range(cfg.layers):
            setattr(self, f"layer_{i}", _BertLayer(cfg, device))

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                token_type_ids: torch.Tensor | None = None) -> torch.Tensor:
        t = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.tok_embed[input_ids] + self.pos_embed[:t][None] + self.type_embed[token_type_ids]
        x = self.embed_ln(x).to(compute_dtype(self.compute_dtype))
        mask = attention_mask.bool()
        key_bias = torch.where(mask, 0.0, -1e9)[:, None, None, :]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, key_bias)
        m = mask[..., None].float()
        pooled = (x.float() * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
        return pooled / torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)


def convert_hf_bert(sd: Mapping, cfg: MiniLMConfig) -> dict:
    """HF ``BertModel`` state dict (numpy or torch; a ``bert.`` prefix is
    the caller's to strip) -> the state dict of ``MiniLMEncoder``."""
    out: dict = {
        "tok_embed": as_tensor(sd["embeddings.word_embeddings.weight"]),
        "pos_embed": as_tensor(sd["embeddings.position_embeddings.weight"]),
        "type_embed": as_tensor(sd["embeddings.token_type_embeddings.weight"]),
    }

    def copy(port: str, hf: str) -> None:
        out[f"{port}.weight"] = as_tensor(sd[f"{hf}.weight"])
        out[f"{port}.bias"] = as_tensor(sd[f"{hf}.bias"])

    copy("embed_ln", "embeddings.LayerNorm")
    for i in range(cfg.layers):
        e = f"encoder.layer.{i}."
        for port, hf in (("q", "attention.self.query"), ("k", "attention.self.key"),
                         ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                         ("attn_ln", "attention.output.LayerNorm"),
                         ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense"),
                         ("ffn_ln", "output.LayerNorm")):
            copy(f"layer_{i}.{port}", e + hf)
    return out
