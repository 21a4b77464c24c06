"""The work counter of the cross-modal model (``fusion: cross``,
``gpubench/reference/cross.py``), as ``gpubench/workcount.py`` is the
MMCT's: operations and bytes from the inputs' shapes and lengths, never
from what the program launches.

Per video second of an unpacked row of t seconds: three stream encoders
(a projection MLP, ``text_num_layers`` layers each), ``cross_num_layers``
blocks on the visual stream whose cross-attention's keys and values are
the context's 2 t rows, the feature map and the heads. Attention pairs:
t * t for each self-attention (3 * ``text_num_layers`` + ``cross_num_layers``
of them) and 2 t * t for each cross-attention.
"""

from __future__ import annotations

from gpubench.workcount import BF16, F32, PEAK_BF16_FLOPS, least_seconds  # noqa: F401


def _dims(m: dict):
    d, ff, hid, heads = m["d_model"], m["d_ff"], m["hidden_dim"], m["num_heads"]
    return (d, ff, hid, heads, d // heads, max(m["text_num_layers"], 1),
            max(m["cross_num_layers"], 1))


def linear_flops_per_position(m: dict) -> dict[str, float]:
    """Forward operations of one second's matrix products, by block: the
    projections' first Linear (``input``, from the features), the rest of
    the stream encoders, the cross blocks (the context's k and v at two
    rows a second), the feature map with the classification head, and the
    regression head."""
    d, ff, hid, _, _, n_uni, n_cross = _dims(m)
    layer = 4 * d * d + 2 * d * ff
    head = 2 * (d * hid + hid * hid)
    return {
        "input": 2.0 * ff * (m["vis_dim"] + m["aud_dim"] + m["text_dim"]),
        "streams": 2.0 * 3 * (ff * d + n_uni * layer),
        "cross": 2.0 * n_cross * (layer + 2 * d * d + 2 * 2 * d * d),
        "cls": 2.0 * d * d + head + 2 * hid * 1,
        "reg": head + 2 * hid * 2,
    }


def pair_multiple(m: dict) -> int:
    """Attention pairs of all layers for a video of t seconds, over t * t."""
    _, _, _, _, _, n_uni, n_cross = _dims(m)
    return 3 * n_uni + n_cross + 2 * n_cross


def train_flops(lengths, m: dict) -> float:
    """Operations of one training pass (forward and backward) over videos of
    these lengths, counted as ``gpubench/workcount.py:train_flops`` counts
    the MMCT's: a matrix product 3x its forward, the first Linear of each
    projection 2x (its input needs no gradient), the regression head 1x (no
    loss reaches it); the attention 4 * Dh forward and 8 * Dh backward a
    pair and head."""
    _, _, _, heads, dh, _, _ = _dims(m)
    lin = linear_flops_per_position(m)
    per = 2 * lin["input"] + 3 * (lin["streams"] + lin["cross"] + lin["cls"]) + lin["reg"]
    pair = 3 * 4.0 * dh * heads * pair_multiple(m)
    return sum(per * t + pair * t * t for t in lengths)


def cross_attention_needed(ids: dict, m: dict) -> tuple[float, float]:
    """(operations, bytes) that one ``attention.cross`` record's work needs,
    from its counts (``pairs``, ``queries``, ``keys``: valid ones, over
    every row; a self-attention's are t * t, t and t) and whether it is the
    ``backward``: 4 * Dh operations a pair
    and head forward, 10 * Dh backward (the recomputed scores, dv, dp, dq
    and dk); bytes: q, k, v read and o (bf16) and the float32 log-sum-exp
    written forward; q, k, v, o, do and the log-sum-exp read and dq, dk, dv
    written backward, each once."""
    _, _, _, heads, dh, _, _ = _dims(m)
    vec = heads * dh * BF16
    lse = ids["queries"] * heads * F32
    if ids["backward"]:
        return 10.0 * dh * heads * ids["pairs"], (4 * ids["queries"] + 4 * ids["keys"]) * vec + lse
    return 4.0 * dh * heads * ids["pairs"], (2 * ids["queries"] + 2 * ids["keys"]) * vec + lse


def attention_least_seconds(lengths, m: dict) -> float:
    """The least time of the work of every attention of training passes
    (forward and backward) over unpacked rows of these valid lengths:
    3 * ``text_num_layers`` + ``cross_num_layers`` self-attentions over t
    keys and ``cross_num_layers`` cross-attentions over the context's 2 t,
    each counted as ``cross_attention_needed`` counts a record."""
    _, _, _, _, _, n_uni, n_cross = _dims(m)
    total = 0.0
    for t in lengths:
        for blocks, layers in ((1, 3 * n_uni + n_cross), (2, n_cross)):
            for backward in (0, 1):
                ids = dict(pairs=blocks * t * t, queries=t, keys=blocks * t, backward=backward)
                total += layers * least_seconds(*cross_attention_needed(ids, m))
    return total
