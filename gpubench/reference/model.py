"""The MMCT in plain PyTorch, written for the benchmark from the published
model's description (models/MMCTransformer.py:25-96 of
github.com/YosubShin/Repurpose): concatenated per-second features, input
projection and LayerNorm, the sinusoidal table added at each video's own
positions, 16 pre-LN encoder layers (multi-head self-attention, ReLU FFN),
the encoder norm, a feature map (Linear, LayerNorm, ReLU) and two heads
(LayerNorm, Linear, ReLU, Linear, ReLU, Linear; the regression head ends in
a ReLU). It imports nothing of the program.

- Precision ``float32``: every product in float32 with TF32 off, as the
  configuration's plain reference. ``fp8``: the control, one step below
  the configuration's bfloat16 activations and bfloat16 softmax interior:
  every matrix product's operands (activations, weights, q, k, v and the
  softmax's probabilities) and the softmax's scores and exponentials
  rounded to float8 e4m3 with one scale per tensor, and the gradient
  flowing into each product rounded to float8 e5m2 likewise before its
  backward; products and sums in float32.
- Attention: scores in float32, a -1e9 bias on keys that are padding or
  belong to another video of the row (sequence packing), computed in blocks
  of queries; under autograd each block is recomputed in the backward, so
  a 32768-position row fits.
- Dropout: ``drops`` (a ``DropStream``) draws every mask, in the order the
  layers use them, as ``torch.rand(shape) < 1 - p`` from one generator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gpubench.weights import positional_table

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LN_EPS = 1e-5
NEG = -1e9
BLOCK_ELEMENTS = 1 << 28  # scores held at once: heads x query block x keys
FP8_MAX = 448.0


def _scaled(fmt, top):
    def q(x: torch.Tensor) -> torch.Tensor:
        scale = x.abs().amax().clamp(min=1e-30) / top
        return (x / scale).to(fmt).float() * scale
    return q


# (operands of the forward products, gradients flowing into them), each
# tensor scaled by its largest magnitude: float8 as its training recipe
# takes it (e4m3 forward, e5m2 backward)
PRECISIONS = {
    "fp8": (_scaled(torch.float8_e4m3fn, 448.0), _scaled(torch.float8_e5m2, 57344.0)),
}


class _GradRound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


def rounder(precision: str):
    """(r, gr): ``r`` rounds a product's operand, passing the gradient on
    unchanged; ``gr`` marks a product's result, whose incoming gradient is
    rounded before the product's backward uses it. Identities in
    float32."""
    if precision == "float32":
        return (lambda x: x), (lambda x: x)
    if precision not in PRECISIONS:
        raise ValueError(f"bad precision {precision!r}")
    fwd, bwd = PRECISIONS[precision]

    def r(x: torch.Tensor) -> torch.Tensor:
        return x + (fwd(x.detach()) - x).detach()

    return r, (lambda y: _GradRound.apply(y, bwd))


class DropStream:
    """Dropout masks in draw order from ``generator`` (None: no dropout)."""

    def __init__(self, p: float, generator: torch.Generator | None):
        self.p = p
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.generator is None or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), device=x.device))


def _ln(x, w, name):
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], LN_EPS)


def _attend_block(q, k, v, seg_q, seg_k, valid_k, rr, interior):
    r, gr = rr
    allowed = valid_k[None, :] & (seg_q[:, None] == seg_k[None, :])
    s = gr(torch.einsum("qhd,khd->hqk", r(q), r(k))) * (q.shape[-1] ** -0.5)
    bias = torch.where(allowed, 0.0, NEG)[None]
    if interior:  # the softmax's scores and exponentials rounded too
        s = r(s) + bias
        e = r(torch.exp(s - s.amax(dim=-1, keepdim=True)))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s + bias, dim=-1)
    return gr(torch.einsum("hqk,khd->qhd", r(p), r(v)))


def attention(q, k, v, valid, seg, rr, interior=False):
    """q, k, v [B, T, H, Dh] float32; a key is allowed where it is valid
    and in the query's own video (``seg``). ``interior``: the softmax's
    scores and exponentials go through the rounding too."""
    b, t, h, _ = q.shape
    qb = max(1, min(t, BLOCK_ELEMENTS // (h * t)))
    rows = []
    for i in range(b):
        blocks = []
        for s in range(0, t, qb):
            args = (q[i, s : s + qb], k[i], v[i], seg[i, s : s + qb], seg[i], valid[i])
            if torch.is_grad_enabled():
                blocks.append(torch.utils.checkpoint.checkpoint(
                    _attend_block, *args, rr, interior, use_reentrant=False))
            else:
                blocks.append(_attend_block(*args, rr, interior))
        rows.append(torch.cat(blocks))
    return torch.stack(rows)


def forward(w: dict, m: dict, visual, audio, text, valid, seg, positions,
            drops: DropStream | None = None, precision: str = "float32"):
    """(cls logits [B, T], offsets [B, T, 2]) of rows of videos; ``seg``
    [B, T] the video of each position within its row (-1 on padding),
    ``positions`` [B, T] each position's second within its video."""
    rr = rounder(precision)
    r, gr = rr
    drop = drops if drops is not None else (lambda x: x)

    def lin(x, name):
        return gr(F.linear(r(x), r(w[name + ".weight"]), w[name + ".bias"]))

    d, heads = m["d_model"], m["num_heads"]
    x = torch.cat([visual, audio, text], dim=-1).float()
    x = _ln(lin(x, "input_projection"), w, "input_norm")
    pe = positional_table(int(positions.max()) + 1, d, x.device)
    x = x + pe[positions]
    b, t, _ = x.shape
    for i in range(m["self_num_layers"]):
        p = f"multimodal_encoder.layers.{i}."
        y = _ln(x, w, p + "norm1")
        qkv = gr(F.linear(r(y), r(w[p + "self_attn.in_proj_weight"]),
                          w[p + "self_attn.in_proj_bias"]))
        q, k, v = (z.reshape(b, t, heads, d // heads) for z in qkv.split(d, dim=-1))
        a = attention(q, k, v, valid, seg, rr, precision != "float32").reshape(b, t, d)
        x = x + drop(lin(a, p + "self_attn.out_proj"))
        y = _ln(x, w, p + "norm2")
        y = drop(torch.relu(lin(y, p + "linear1")))
        x = x + drop(lin(y, p + "linear2"))
    x = _ln(x, w, "encoder_norm")
    f = drop(torch.relu(_ln(lin(x, "feature_map.0"), w, "feature_map.1")))

    def head(name):
        y = _ln(f, w, name + ".0")
        y = drop(torch.relu(lin(y, name + ".1")))
        y = drop(torch.relu(lin(y, name + ".4")))
        return lin(y, name + ".7")

    cls = head("cls_head")[..., 0]
    offsets = torch.relu(head("reg_head"))
    return cls, offsets


def focal_loss_sum(logits, labels, valid, alpha: float = 0.7, gamma: float = 2.0):
    """Sigmoid focal loss (RetinaNet) summed over valid positions."""
    x, y = logits.float(), labels.float()
    p = torch.sigmoid(x)
    ce = F.binary_cross_entropy_with_logits(x, y, reduction="none")
    p_t = p * y + (1 - p) * (1 - y)
    loss = (alpha * y + (1 - alpha) * (1 - y)) * ce * (1 - p_t) ** gamma
    return (loss * valid.float()).sum()
