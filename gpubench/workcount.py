"""The benchmark's work counter: the operations and bytes that given inputs
need, worked out from their shapes and lengths, never from what the program
happens to launch. A later kernel that skips or fuses work reads against
the same yardstick.

The attention's arithmetic is the one ``chip_smoke.py`` states its bounds
in (allowed (query, key) pairs at 989 TFLOP/s against 3.35 TB/s), written
anew here: only pairs inside one video and inside its length are allowed,
4 * Dh operations a pair and head forward (q k^T and p v), 10 * Dh backward
(the recomputed scores, dv, dp, dq and dk), each input byte read once and
each output byte written once.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the 700 W limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

BF16 = 2
F32 = 4


def _dims(m: dict):
    d, ff, hid = m["d_model"], m["d_ff"], m["hidden_dim"]
    concat = m["vis_dim"] + m["aud_dim"] + m["text_dim"]
    return d, ff, hid, concat, m["self_num_layers"], m["num_heads"], d // m["num_heads"]


def linear_flops_per_position(m: dict) -> dict[str, float]:
    """Forward operations of one position's matrix products, by block:
    the input projection, the encoder layers (qkv, out, the FFN), the
    feature map with the classification head, and the regression head."""
    d, ff, hid, concat, layers, _, _ = _dims(m)
    head = 2 * (d * hid + hid * hid)
    return {
        "input": 2.0 * concat * d,
        "encoder": 2.0 * layers * (3 * d * d + d * d + 2 * d * ff),
        "cls": 2.0 * d * d + head + 2 * hid * 1,
        "reg": head + 2 * hid * 2,
    }


def attention_pair_flops(m: dict) -> float:
    """Forward operations of one allowed pair over all heads of one layer."""
    _, _, _, _, _, heads, dh = _dims(m)
    return 4.0 * dh * heads


def forward_flops(lengths, m: dict) -> float:
    """Forward operations of the MMCT over videos of these lengths."""
    per = sum(linear_flops_per_position(m).values())
    layers = m["self_num_layers"]
    return sum(per * t + layers * attention_pair_flops(m) * t * t for t in lengths)


def train_flops(lengths, m: dict) -> float:
    """Operations of one training pass (forward and backward) over videos of
    these lengths: a matrix product costs 3x its forward (the input's and the
    weight's gradient), the input projection 2x (its input needs none), the
    regression head 1x (no loss reaches it); the attention 4 * Dh forward
    and 8 * Dh backward a pair and head. Remat's recompute is not counted."""
    lin = linear_flops_per_position(m)
    per = 2 * lin["input"] + 3 * (lin["encoder"] + lin["cls"]) + lin["reg"]
    layers = m["self_num_layers"]
    pair = 3 * attention_pair_flops(m)
    return sum(per * t + layers * pair * t * t for t in lengths)


def attention_needed(rows, m: dict, backward: bool) -> tuple[float, float]:
    """(operations, bytes) that the attention of all layers needs for one
    pass over ``rows`` (each row a list of the video lengths laid in it),
    forward and, with ``backward``, backward too. Bytes: q, k, v read and o
    (bf16) and the float32 log-sum-exp written forward; q, k, v, o, do and
    the log-sum-exp read and dq, dk, dv written backward; over the valid
    positions of each row."""
    _, _, _, _, layers, heads, dh = _dims(m)
    pairs = sum(t * t for row in rows for t in row)
    positions = sum(t for row in rows for t in row)
    vec = positions * heads * dh * BF16
    lse = positions * heads * F32
    flops = 4.0 * dh * heads * pairs
    nbytes = 4 * vec + lse
    if backward:
        flops += 10.0 * dh * heads * pairs
        nbytes += 5 * vec + lse + 3 * vec
    return layers * flops, layers * float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
