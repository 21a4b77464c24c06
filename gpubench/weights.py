"""The benchmark's weights: the MMCT's leaves under the reference
MMCTransformer's state-dict names (models/MMCTransformer.py:25-96 of the
published code), drawn from the run's seed on the run's device.

The law is the port's own initialisation (``init_weights`` in
``repurpose_tpu_torch/models/__init__.py``): Xavier-uniform matrices, zero
biases, unit LayerNorm scales, and the sinusoidal positional table as the
``positional_encoding.pe`` buffer. All matrices come from one
``torch.rand`` call, cut into leaves. The same weights go to the program
(a strict ``load_state_dict``) and to the plain reference, which makes them
again from the same seed.

A served model is a trained one, whose heads put clip bounds tens of
seconds apart and scores on both sides of the decode's threshold; random
heads put them a fraction of a second apart, so that no candidate passes
the decode's duration gate and Soft-NMS has nothing to do. A serving cell
therefore gives the heads' law (``served_weights``): each head's last
layer is rescaled, output by output, so that over the first video of the
pool the float32 reference's outputs before the final ReLU have the
law's mean and spread. The law is the same for every seed, so every seed
asks the same of the decode and of Soft-NMS.
"""

from __future__ import annotations

import math

import torch


def leaf_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every tensor of the concat-fusion MMCT's state dict,
    from the configuration's ``model`` section ``m``."""
    d, ff, hid = m["d_model"], m["d_ff"], m["hidden_dim"]
    concat = m["vis_dim"] + m["aud_dim"] + m["text_dim"]
    s: dict[str, tuple[int, ...]] = {
        "input_projection.weight": (d, concat), "input_projection.bias": (d,),
        "input_norm.weight": (d,), "input_norm.bias": (d,),
        "positional_encoding.pe": (1, m["max_len"], d),
    }
    for i in range(m["self_num_layers"]):
        p = f"multimodal_encoder.layers.{i}."
        s.update({
            p + "self_attn.in_proj_weight": (3 * d, d), p + "self_attn.in_proj_bias": (3 * d,),
            p + "self_attn.out_proj.weight": (d, d), p + "self_attn.out_proj.bias": (d,),
            p + "linear1.weight": (ff, d), p + "linear1.bias": (ff,),
            p + "linear2.weight": (d, ff), p + "linear2.bias": (d,),
            p + "norm1.weight": (d,), p + "norm1.bias": (d,),
            p + "norm2.weight": (d,), p + "norm2.bias": (d,),
        })
    s.update({
        "encoder_norm.weight": (d,), "encoder_norm.bias": (d,),
        "feature_map.0.weight": (d, d), "feature_map.0.bias": (d,),
        "feature_map.1.weight": (d,), "feature_map.1.bias": (d,),
    })
    for head, out in (("cls_head", 1), ("reg_head", 2)):
        s.update({
            f"{head}.0.weight": (d,), f"{head}.0.bias": (d,),
            f"{head}.1.weight": (hid, d), f"{head}.1.bias": (hid,),
            f"{head}.4.weight": (hid, hid), f"{head}.4.bias": (hid,),
            f"{head}.7.weight": (out, hid), f"{head}.7.bias": (out,),
        })
    return s


def positional_table(t: int, d: int, device) -> torch.Tensor:
    """[t, d] float32: pe[t, 2i] = sin(t / 10000^(2i/d)), pe[t, 2i+1] = cos."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((t, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def make_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of seed ``seed`` on ``device``, float32."""
    shapes = leaf_shapes(m)
    mats = [n for n, s in shapes.items() if len(s) == 2]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    u = torch.rand(sum(math.prod(shapes[n]) for n in mats), generator=gen, device=device)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in shapes.items():
        if name == "positional_encoding.pe":
            out[name] = positional_table(shape[1], shape[2], device)[None]
        elif len(shape) == 2:
            n = math.prod(shape)
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (u[at : at + n].view(shape) * 2.0 - 1.0) * lim
            at += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


CALIBRATION_POSITIONS = 1024
LIFT = 1000.0  # lifts the regression head above its ReLU while it is read


@torch.no_grad()
def served_weights(m: dict, seed: int, device, law: dict, features: dict) -> dict:
    """``make_weights`` with the heads set to ``law`` ({"cls" | "reg":
    {"mean": mu, "std": sigma}}) over ``features`` (one video's streams,
    numpy [T, dim]; module docstring)."""
    from gpubench.reference import model as ref

    w = make_weights(m, seed, device)
    w["reg_head.7.bias"].fill_(LIFT)
    t = min(CALIBRATION_POSITIONS, *(len(a) for a in features.values()))
    x = {k: torch.from_numpy(a[:t]).to(device)[None] for k, a in features.items()}
    cls, off = ref.forward(w, m, x["visual"], x["audio"], x["text"],
                           torch.ones((1, t), dtype=torch.bool, device=device),
                           torch.zeros((1, t), dtype=torch.long, device=device),
                           torch.arange(t, device=device)[None])
    raw = {"cls": cls[0][:, None], "reg": off[0] - LIFT}
    for head, target in law.items():
        z = raw[head]
        gain = target["std"] / z.std(dim=0).clamp(min=1e-6)
        name = f"{head}_head.7"
        w[name + ".weight"] *= gain[:, None]
        w[name + ".bias"] = target["mean"] - gain * z.mean(dim=0)
    return w
