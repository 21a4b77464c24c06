"""Bottleneck-token fusion variant (``repurpose_tpu/models/bottleneck.py``,
``fusion: bottleneck``; MBT, "Attention Bottlenecks for Multimodal Fusion",
PAPERS.md): the modalities exchange information only through
``N_BOTTLENECK`` shared tokens.

- a ``UniModalEncoder`` per modality (``max(text_num_layers, 1)`` layers);
- ``max(cross_num_layers, 1)`` fusion rounds: each modality self-attends over
  [its tokens ; the bottleneck tokens] (``fuse_{i}_{modality}``, an
  ``EncoderLayer``), and the three bottleneck updates are averaged, as
  ``sum(updates) / 3`` in the order visual, audio, text, into the shared
  tokens of the next round;
- the mean of the three streams, then MMCT's feature map and cls / reg heads.

``bottleneck_tokens`` [8, d_model] are drawn from a normal of std 0.02 (the
JAX init), not Xavier (``init_weights``). The attention is plain einsum, as
in ``cross_modal.py``; a packed batch raises (``require_unpacked``).
"""

from __future__ import annotations

import torch
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models.cross_modal import EncoderLayer, FusionVariant
from repurpose_tpu_torch.models.mmct import MMCTOutput

N_BOTTLENECK = 8
MODALITIES = ("visual", "audio", "text")


class MMCTBottleneck(FusionVariant):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.bottleneck_tokens = nn.Parameter(torch.empty(N_BOTTLENECK, cfg.d_model))
        self.num_rounds = max(cfg.cross_num_layers, 1)
        for i in range(self.num_rounds):
            for m in MODALITIES:
                self.add_module(f"fuse_{i}_{m}", EncoderLayer(cfg))

    def forward(self, visual: torch.Tensor, audio: torch.Tensor, text: torch.Tensor,
                mask: torch.Tensor) -> MMCTOutput:
        streams = self.encode(visual, audio, text, mask)
        b, t = mask.shape
        bn = self.bottleneck_tokens.to(self.compute_dtype)[None].expand(b, -1, -1)
        ext_valid = torch.cat(
            [mask, torch.ones(b, N_BOTTLENECK, dtype=torch.bool, device=mask.device)], dim=1)
        for i in range(self.num_rounds):
            updates = []
            for m in MODALITIES:
                joint = getattr(self, f"fuse_{i}_{m}")(torch.cat([streams[m], bn], dim=1),
                                                       ext_valid)
                streams[m] = joint[:, :t]
                updates.append(joint[:, t:])
            bn = sum(updates) / len(updates)
        fused = (streams["visual"] + streams["audio"] + streams["text"]) / 3.0
        return self.heads(fused)
