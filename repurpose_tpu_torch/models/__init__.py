"""Model factory of the port: the concat-fusion MMCT (the default, the
reference's model) and the fusion variants ``MMCTCross`` (``fusion:
cross``) and ``MMCTBottleneck`` (``fusion: bottleneck``)."""

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
    [out, in]), zero biases, unit LayerNorm scales, and the bottleneck
    variant's ``bottleneck_tokens`` from a normal of std 0.02."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "bottleneck_tokens":
                p.copy_(torch.from_numpy(rng.normal(0.0, 0.02, p.shape).astype(np.float32)))
            elif p.ndim == 2:
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
    cfg: ModelConfig, device: str | torch.device = "cuda", seed: int = 0, mesh=None
) -> nn.Module:
    """The model ``cfg.fusion`` names (the concat-fusion MMCT, ``MMCTCross``
    or ``MMCTBottleneck``) on ``device``, in eval mode, with weights drawn
    by ``init_weights(seed)``; load a state dict over them to serve trained
    weights. Raises for CUDA when no card is visible. On a ``mesh`` whose
    ``model`` axis is > 1 the MMCT is this rank's tensor-parallel shard of
    the same weights (``parallel/sharding.py``); a fusion variant is built
    whole on every model rank (replicated over ``model``), as in one
    process. The JAX rule shards only its attention's ``out`` row-parallel,
    which keeps the one-process values too. ``attention_impl="ring"`` needs
    the ``mesh``: its ``seq`` axis carries the MMCT's ring."""
    dev = resolve_device(device)
    if cfg.fusion == "concat" and mesh is not None and mesh.size("model") > 1:
        from repurpose_tpu_torch.parallel.sharding import shard_state_dict

        full = MMCT(cfg)
        init_weights(full, seed)
        model = MMCT(cfg, mesh)
        model.load_state_dict(shard_state_dict(full.state_dict(), mesh), strict=True)
        return model.to(dev).eval()
    if cfg.fusion == "cross":
        from repurpose_tpu_torch.models.cross_modal import MMCTCross

        model = MMCTCross(cfg)
    elif cfg.fusion == "bottleneck":
        from repurpose_tpu_torch.models.bottleneck import MMCTBottleneck

        model = MMCTBottleneck(cfg)
    else:
        model = MMCT(cfg, mesh)
    if cfg.fusion != "concat":
        # the variant is whole on every model rank: a name the tensor-parallel
        # rule matched would be cut into shards by the checkpoint, the
        # gradient norm and shard_state_dict while the module holds it whole
        from repurpose_tpu_torch.parallel.sharding import param_sharding_rule

        matched = [n for n, _ in model.named_parameters() if param_sharding_rule(n) is not None]
        if matched:
            raise ValueError(
                f"fusion={cfg.fusion!r} is replicated over the model axis, but the "
                f"tensor-parallel rule (parallel/sharding.py) would shard its parameters "
                f"{matched[:4]}{' ...' if len(matched) > 4 else ''}: rename them or narrow "
                "the rule")
    init_weights(model, seed)
    return model.to(dev).eval()


def require_unpacked(model: nn.Module) -> None:
    """Raises ValueError for a fusion variant, which takes no sequence-packed
    batch (no ``seg_ids`` / ``positions``), as the JAX variants take none."""
    fusion = model.cfg.fusion
    if fusion != "concat":
        raise ValueError(
            f"fusion={fusion!r} takes no sequence-packed batch (no seg_ids / positions, "
            "as in the JAX package): set pack_sequences: false, or serve with pack=False"
        )
