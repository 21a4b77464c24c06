"""CLIP ViT-B/32 image encoder in PyTorch: the port of
``repurpose_tpu/extractors/clip_vit.py``.

CLIP ViT-B/32 ``encode_image`` followed by L2 normalisation, one frame a
second (the reference's visual extractor, visual_feature_extractor_clip.py:
171-201), encoded in large batches. 32x32 patch embed (no bias) on 224x224
-> 49 patches + class token + learned positions, ``ln_pre``, a pre-LN
transformer (12 layers, width 768, 12 heads, QuickGELU), ``ln_post`` on the
class token, a projection (no bias) to 512.

Rounding points as the JAX module: LayerNorms in float32, cast back to the
compute dtype inside the blocks; float32 scores and softmax; ``ln_post`` and
the projection in float32. Images are NHWC, as the JAX module takes them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
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

# The normalisation CLIP's preprocessing uses.
CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    projection_dim: int = 512
    ln_eps: float = 1e-5

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Block(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, device=None):
        super().__init__()
        d = cfg.width
        self.heads = cfg.heads
        self.ln1 = LayerNorm32(d, eps=cfg.ln_eps, device=device)
        self.qkv = Dense(d, 3 * d, device=device)
        self.attn_out = Dense(d, d, device=device)
        self.ln2 = LayerNorm32(d, eps=cfg.ln_eps, device=device)
        self.mlp_fc = Dense(d, d * cfg.mlp_ratio, device=device)
        self.mlp_proj = Dense(d * cfg.mlp_ratio, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv(self.ln1(x).to(x.dtype)).chunk(3, dim=-1)
        x = x + self.attn_out(attention(q, k, v, self.heads, scale=True))
        y = self.mlp_fc(self.ln2(x).to(x.dtype))
        return x + self.mlp_proj(quick_gelu(y))


class CLIPVisionEncoder(nn.Module):
    """images [B, H, W, 3] (normalised, NHWC) -> L2-normalised embeddings
    [B, projection_dim] (float32)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 compute_dtype: str = "bfloat16", device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        w = cfg.width
        self.patch_embed = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                                     bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.zeros(w, device=device))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_patches + 1, w, device=device))
        self.ln_pre = LayerNorm32(w, eps=cfg.ln_eps, device=device)
        for i in range(cfg.layers):
            setattr(self, f"block_{i}", _Block(cfg, device))
        self.ln_post = LayerNorm32(w, eps=cfg.ln_eps, device=device)
        self.proj = nn.Linear(w, cfg.projection_dim, bias=False, device=device)

    def forward(self, images: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        cfg = self.cfg
        dtype = compute_dtype(self.compute_dtype)
        x = images.to(dtype).permute(0, 3, 1, 2)
        x = F.conv2d(x, self.patch_embed.weight.to(dtype), stride=cfg.patch_size)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # [B, patches, width], row-major patches
        cls = self.class_embedding.to(dtype).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dtype)
        x = self.ln_pre(x).to(dtype)
        for i in range(cfg.layers):
            x = getattr(self, f"block_{i}")(x)
        emb = self.proj(self.ln_post(x[:, 0]))
        if normalize:  # the reference L2-normalises features (:196-198)
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb


def preprocess_frames(frames: np.ndarray) -> np.ndarray:
    """uint8 RGB [B, H, W, 3] -> CLIP-normalised float32 [B, 224, 224, 3]:
    bicubic resize of the shorter side to 224 and a centre crop, with PIL
    (imported here), in torchvision's integer conventions (the long side
    truncates, the crop origin rounds) as CLIP's ``_transform`` does."""
    from PIL import Image

    out = np.empty((len(frames), 224, 224, 3), np.float32)
    for i, f in enumerate(frames):
        im = Image.fromarray(f)
        w, h = im.size
        if w <= h:
            nw, nh = 224, int(224 * h / w)
        else:
            nw, nh = int(224 * w / h), 224
        im = im.resize((nw, nh), Image.BICUBIC)
        w, h = im.size
        left = int(round((w - 224) / 2.0))
        top = int(round((h - 224) / 2.0))
        im = im.crop((left, top, left + 224, top + 224))
        out[i] = np.asarray(im, np.float32) / 255.0
    return (out - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def convert_hf_clip_vision(sd: Mapping, cfg: CLIPVisionConfig) -> dict:
    """HF ``CLIPVisionModelWithProjection`` state dict (numpy or torch) ->
    the state dict of ``CLIPVisionEncoder`` (float32); q, k and v are
    stacked into ``qkv``."""
    p = "vision_model."
    out: dict = {
        "patch_embed.weight": as_tensor(sd[f"{p}embeddings.patch_embedding.weight"]),
        "class_embedding": as_tensor(sd[f"{p}embeddings.class_embedding"]).reshape(-1),
        "position_embedding": as_tensor(sd[f"{p}embeddings.position_embedding.weight"]),
        "proj.weight": as_tensor(sd["visual_projection.weight"]),
    }

    def copy(port: str, hf: str) -> None:
        out[f"{port}.weight"] = as_tensor(sd[f"{hf}.weight"])
        out[f"{port}.bias"] = as_tensor(sd[f"{hf}.bias"])

    copy("ln_pre", f"{p}pre_layrnorm")  # (sic) the HF attribute's name
    copy("ln_post", f"{p}post_layernorm")
    for i in range(cfg.layers):
        e = f"{p}encoder.layers.{i}."
        b = f"block_{i}"
        for kind in ("weight", "bias"):
            out[f"{b}.qkv.{kind}"] = torch.cat(
                [as_tensor(sd[f"{e}self_attn.{n}_proj.{kind}"]) for n in "qkv"])
        copy(f"{b}.ln1", f"{e}layer_norm1")
        copy(f"{b}.ln2", f"{e}layer_norm2")
        copy(f"{b}.attn_out", f"{e}self_attn.out_proj")
        copy(f"{b}.mlp_fc", f"{e}mlp.fc1")
        copy(f"{b}.mlp_proj", f"{e}mlp.fc2")
    return out
