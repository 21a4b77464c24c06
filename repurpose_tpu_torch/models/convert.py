"""Weights across frameworks.

The port's modules carry the reference MMCTransformer's names, so a reference
state dict (``.pth``, or ``tests/golden/*.npz`` ``sd/*``) loads strictly with
no conversion. ``state_dict_from_jax_params`` carries weights the other way,
from the JAX package's param pytree (numpy leaves) to the port: it is the
port's own copy of the mapping in ``export_reference_state_dict``
(repurpose_tpu/models/torch_convert.py:150-184). Flax kernels are
``[in, out]``; torch's Linear weights ``[out, in]``, hence the transposes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repurpose_tpu_torch.models.positional import sinusoidal_positional_encoding


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _ln(sd: dict, name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def state_dict_from_jax_params(params: Mapping, max_len: int = 5000) -> dict:
    """JAX MMCT params (numpy leaves) -> the port's state dict (float32)."""
    d_model = np.asarray(params["input_projection"]["kernel"]).shape[1]
    sd: dict = {}
    _lin(sd, "input_projection", params["input_projection"])
    _ln(sd, "input_norm", params["input_norm"])
    sd["positional_encoding.pe"] = sinusoidal_positional_encoding(max_len, d_model)[None]
    n_layers = len(params["encoder"])
    for i in range(n_layers):
        p = f"multimodal_encoder.layers.{i}"
        layer = params["encoder"][f"layer_{i}"]
        sd[f"{p}.self_attn.in_proj_weight"] = _t(np.asarray(layer["attn"]["qkv"]["kernel"]).T)
        sd[f"{p}.self_attn.in_proj_bias"] = _t(layer["attn"]["qkv"]["bias"])
        _lin(sd, f"{p}.self_attn.out_proj", layer["attn"]["out"])
        _lin(sd, f"{p}.linear1", layer["linear1"])
        _lin(sd, f"{p}.linear2", layer["linear2"])
        _ln(sd, f"{p}.norm1", layer["norm1"])
        _ln(sd, f"{p}.norm2", layer["norm2"])
    _ln(sd, "encoder_norm", params["encoder_norm"])
    _lin(sd, "feature_map.0", params["feature_map"])
    _ln(sd, "feature_map.1", params["feature_norm"])
    for head in ("cls_head", "reg_head"):
        _ln(sd, f"{head}.0", params[head]["norm"])
        _lin(sd, f"{head}.1", params[head]["dense_0"])
        _lin(sd, f"{head}.4", params[head]["dense_1"])
        _lin(sd, f"{head}.7", params[head]["out"])
    return sd


def load_reference_checkpoint(path: str) -> dict:
    """The model state dict of a reference ``.pth`` checkpoint (main.py:513-531
    schema: weights under the 'model' key), on the CPU."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
