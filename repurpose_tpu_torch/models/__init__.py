"""Model factory of the port."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models.convert import (  # noqa: F401
    load_reference_checkpoint,
    state_dict_from_jax_params,
)
from repurpose_tpu_torch.models.mmct import MMCT, MMCTOutput  # noqa: F401


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """The JAX init from a numpy seed: Xavier-uniform matrices (Flax's
    ``xavier_uniform`` over a kernel [in, out] is the same law over torch's
    [out, in]), zero biases, unit LayerNorm scales."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 2:
                fan_out, fan_in = p.shape
                lim = np.sqrt(6.0 / (fan_in + fan_out))
                p.copy_(torch.from_numpy(
                    rng.uniform(-lim, lim, p.shape).astype(np.float32)
                ))
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


def build_model(
    cfg: ModelConfig, device: str | torch.device = "cuda", seed: int = 0
) -> MMCT:
    """The concat-fusion MMCT on ``device``, in eval mode, with weights drawn
    by ``init_weights(seed)``; load a state dict over them to serve trained
    weights. Raises for CUDA when no card is visible."""
    if cfg.fusion != "concat":
        raise NotImplementedError(
            f"fusion={cfg.fusion!r} is not ported yet (ROADMAP.md, Queue 1 item 10)"
        )
    dev = resolve_device(device)
    model = MMCT(cfg)
    init_weights(model, seed)
    return model.to(dev).eval()
