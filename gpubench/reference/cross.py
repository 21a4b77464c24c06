"""The cross-modal fusion model (``fusion: cross``) in plain PyTorch, written
for the benchmark from the published transformer library
(models/transformer.py of github.com/YosubShin/Repurpose: ``UniModalEncoder``,
``EncoderLayer``, ``CrossSelfEncoderLayer``; ``text_num_layers`` and
``cross_num_layers`` of configs/Repurpose.yaml:29-30). It imports nothing of
the program.

- Three stream encoders (visual, audio, text), each: a projection MLP
  (Linear to d_ff, ReLU, Linear to d_model), the sinusoidal table from
  position 0, and ``text_num_layers`` pre-LN layers (x + drop(MHA(LN x));
  x + drop(FFN(LN x))), the multi-head attention with explicit q, k, v and
  out projections;
- ``cross_num_layers`` blocks on the visual stream, with the published
  norm-in-residual quirk: x + drop(self(LN1 x)); x = LN2 x;
  x + drop(cross(x, [audio ; text])); x = LN3 x; x + drop(FFN(x)), the FFN
  with a dropout after its ReLU;
- the feature map (Linear, LayerNorm, ReLU, dropout) and the two heads of
  the MMCT (``gpubench/reference/model.py``).

Precision, dropout and blocked attention as ``model.py``: every product in
float32 with TF32 off, or the float8 control (``PRECISIONS``); masks drawn
in the order the layers use them from one generator; scores in float32,
the context's two key runs (the audio's, then the text's) each masked by
the video's own valid seconds, computed in blocks of queries and
recomputed in the backward, so that a 32768-position row and its 65536
context keys fit.

``weights`` draws the state dict under the program's names with the
port's initialisation law from one ``torch.rand``; ``follow`` is the
training reference of ``gpubench/reference/train.py`` on this model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from gpubench.reference import model as ref
from gpubench.reference import train as ref_train
from gpubench.weights import positional_table

STREAMS = (("visual", "vis_dim"), ("audio", "aud_dim"), ("text", "text_dim"))


def _attention_shapes(p: str, d: int) -> dict[str, tuple[int, ...]]:
    return {f"{p}.{n}.{kind}": ((d, d) if kind == "weight" else (d,))
            for n in ("q", "k", "v", "out") for kind in ("weight", "bias")}


def _norm_shapes(p: str, d: int) -> dict[str, tuple[int, ...]]:
    return {f"{p}.weight": (d,), f"{p}.bias": (d,)}


def _ffn_shapes(p: str, d: int, ff: int) -> dict[str, tuple[int, ...]]:
    return {f"{p}.lin1.weight": (ff, d), f"{p}.lin1.bias": (ff,),
            f"{p}.lin2.weight": (d, ff), f"{p}.lin2.bias": (d,)}


def leaf_shapes(m: dict) -> dict[str, tuple[int, ...]]:
    """Name -> shape of every parameter of the cross-modal model, from the
    configuration's ``model`` section ``m``."""
    d, ff, hid = m["d_model"], m["d_ff"], m["hidden_dim"]
    s: dict[str, tuple[int, ...]] = {}
    for stream, dim in STREAMS:
        p = f"{stream}_encoder"
        s.update({f"{p}.proj.fc1.weight": (ff, m[dim]), f"{p}.proj.fc1.bias": (ff,),
                  f"{p}.proj.fc2.weight": (d, ff), f"{p}.proj.fc2.bias": (d,)})
        for i in range(max(m["text_num_layers"], 1)):
            q = f"{p}.layer_{i}"
            s.update({**_norm_shapes(q + ".ln1", d), **_attention_shapes(q + ".self_attn", d),
                      **_norm_shapes(q + ".ln2", d), **_ffn_shapes(q + ".ffn", d, ff)})
    for i in range(max(m["cross_num_layers"], 1)):
        q = f"cross_{i}"
        s.update({**_norm_shapes(q + ".ln1", d), **_attention_shapes(q + ".self_attn", d),
                  **_norm_shapes(q + ".ln2", d), **_attention_shapes(q + ".cross_attn", d),
                  **_norm_shapes(q + ".ln3", d), **_ffn_shapes(q + ".ffn", d, ff)})
    s.update({"feature_map.weight": (d, d), "feature_map.bias": (d,),
              **_norm_shapes("feature_norm", d)})
    for head, out in (("cls_head", 1), ("reg_head", 2)):
        s.update({**_norm_shapes(f"{head}.0", d),
                  f"{head}.1.weight": (hid, d), f"{head}.1.bias": (hid,),
                  f"{head}.4.weight": (hid, hid), f"{head}.4.bias": (hid,),
                  f"{head}.7.weight": (out, hid), f"{head}.7.bias": (out,)})
    return s


def weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The state dict of seed ``seed`` on ``device``, float32: Xavier-uniform
    matrices cut from one ``torch.rand``, zero biases, unit LayerNorm
    scales (the port's ``init_weights`` law)."""
    shapes = leaf_shapes(m)
    mats = [n for n, s in shapes.items() if len(s) == 2]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    u = torch.rand(sum(math.prod(shapes[n]) for n in mats), generator=gen, device=device)
    out: dict[str, torch.Tensor] = {}
    at = 0
    for name, shape in shapes.items():
        if len(shape) == 2:
            n = math.prod(shape)
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = (u[at : at + n].view(shape) * 2.0 - 1.0) * lim
            at += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def _attend_block(q, k, v, valid_k, rr, interior):
    r, gr = rr
    s = gr(torch.einsum("qhd,khd->hqk", r(q), r(k))) * (q.shape[-1] ** -0.5)
    bias = torch.where(valid_k, 0.0, ref.NEG)[None, None]
    if interior:  # the softmax's scores and exponentials rounded too
        s = r(s) + bias
        e = r(torch.exp(s - s.amax(dim=-1, keepdim=True)))
        p = e / e.sum(dim=-1, keepdim=True)
    else:
        p = torch.softmax(s + bias, dim=-1)
    return gr(torch.einsum("hqk,khd->qhd", r(p), r(v)))


def attention(q, k, v, valid_k, rr, interior=False):
    """q [B, Tq, H, Dh], k and v [B, Tk, H, Dh] float32; a key is allowed
    where ``valid_k`` [B, Tk] holds. Blocks of queries, recomputed in the
    backward under autograd."""
    b, tq, h, _ = q.shape
    qb = max(1, min(tq, ref.BLOCK_ELEMENTS // (h * k.shape[1])))
    rows = []
    for i in range(b):
        blocks = []
        for s in range(0, tq, qb):
            args = (q[i, s : s + qb], k[i], v[i], valid_k[i])
            if torch.is_grad_enabled():
                blocks.append(torch.utils.checkpoint.checkpoint(
                    _attend_block, *args, rr, interior, use_reentrant=False))
            else:
                blocks.append(_attend_block(*args, rr, interior))
        rows.append(torch.cat(blocks))
    return torch.stack(rows)


def forward(w: dict, m: dict, visual, audio, text, valid, drops=None,
            precision: str = "float32"):
    """(cls logits [B, T], offsets [B, T, 2]) of unpacked rows: each row one
    video from position 0, ``valid`` [B, T] its seconds."""
    rr = ref.rounder(precision)
    r, gr = rr
    interior = precision != "float32"
    drop = drops if drops is not None else (lambda x: x)
    d, heads = m["d_model"], m["num_heads"]

    def lin(x, name):
        return gr(F.linear(r(x), r(w[name + ".weight"]), w[name + ".bias"]))

    def ln(x, name):
        return ref._ln(x, w, name)

    def mha(x, ctx, ctx_valid, p):
        b, tq, tk = x.shape[0], x.shape[1], ctx.shape[1]
        q = lin(x, p + ".q").reshape(b, tq, heads, d // heads)
        k = lin(ctx, p + ".k").reshape(b, tk, heads, d // heads)
        v = lin(ctx, p + ".v").reshape(b, tk, heads, d // heads)
        return lin(attention(q, k, v, ctx_valid, rr, interior).reshape(b, tq, d), p + ".out")

    def ffn(x, p, inner):
        y = torch.relu(lin(x, p + ".lin1"))
        return lin(drop(y) if inner else y, p + ".lin2")

    t = valid.shape[1]
    pe = positional_table(t, d, valid.device)
    streams = {}
    for stream, _ in STREAMS:
        p = f"{stream}_encoder"
        feats = {"visual": visual, "audio": audio, "text": text}[stream].float()
        x = lin(torch.relu(lin(feats, p + ".proj.fc1")), p + ".proj.fc2") + pe
        for i in range(max(m["text_num_layers"], 1)):
            q = f"{p}.layer_{i}"
            y = ln(x, q + ".ln1")
            x = x + drop(mha(y, y, valid, q + ".self_attn"))
            x = x + drop(ffn(ln(x, q + ".ln2"), q + ".ffn", False))
        streams[stream] = x
    context = torch.cat([streams["audio"], streams["text"]], dim=1)
    context_valid = torch.cat([valid, valid], dim=1)  # the two key runs, masked explicitly
    x = streams["visual"]
    for i in range(max(m["cross_num_layers"], 1)):
        q = f"cross_{i}"
        y = ln(x, q + ".ln1")
        x = x + drop(mha(y, y, valid, q + ".self_attn"))
        x = ln(x, q + ".ln2")
        x = x + drop(mha(x, context, context_valid, q + ".cross_attn"))
        x = ln(x, q + ".ln3")
        x = x + drop(ffn(x, q + ".ffn", True))
    f = drop(torch.relu(ln(lin(x, "feature_map"), "feature_norm")))

    def head(name):
        y = ln(f, name + ".0")
        y = drop(torch.relu(lin(y, name + ".1")))
        y = drop(torch.relu(lin(y, name + ".4")))
        return lin(y, name + ".7")

    cls = head("cls_head")[..., 0]
    offsets = torch.relu(head("reg_head"))
    return cls, offsets


def follow(corpus: dict, cfg: dict, seed: int, w0: dict, steps: int, device,
           precision: str = "float32") -> dict:
    """``gpubench/reference/train.py:follow`` on this model: the first
    ``steps`` training steps from ``w0`` (unpacked rows), each step's loss,
    the first step's classification logits at its valid positions, each
    leaf's first gradient as Adam gets it, and the parameters after."""
    m, tc = cfg["model"], cfg["train"]
    lengths = [ref_train.video_length(e) for e in corpus["entries"]]
    plan = ref_train.epoch_plan(lengths, seed, 0, tc)
    total = tc["epochs"] * len(plan)
    w = {k: v.detach().clone().requires_grad_() for k, v in w0.items()}
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in w.items()}
    losses, first_grad, first_logits = [], None, None
    for s in range(steps):
        t, rows = plan[s]
        x = ref_train.build_rows(corpus, t, rows, tc["batch_size"], device)
        drops = ref.DropStream(m["dropout"], ref_train.dropout_generator(seed, s, device))
        cls, _ = forward(w, m, x["visual"], x["audio"], x["text"], x["valid"], drops, precision)
        norm = float(x["videos"]) if tc["loss_norm"] == "batch_size" else float(tc["batch_size"])
        loss = ref.focal_loss_sum(cls, x["labels"], x["valid"]) / norm
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        if first_logits is None:
            first_logits = cls.detach()[x["valid"]]
        lr = tc["lr"] * 0.5 * (1.0 + math.cos(math.pi * min(s, total) / total))
        with torch.no_grad():
            seen = {}
            for (k, p), g in zip(w.items(), grads):
                if g is None:  # no loss reaches this leaf: Adam leaves it be
                    continue
                g = g + tc["weight_decay"] * p
                seen[k] = g.clone()
                m1, m2 = moments[k]
                m1.mul_(ref_train.BETAS[0]).add_(g, alpha=1 - ref_train.BETAS[0])
                m2.mul_(ref_train.BETAS[1]).addcmul_(g, g, value=1 - ref_train.BETAS[1])
                c1, c2 = 1 - ref_train.BETAS[0] ** (s + 1), 1 - ref_train.BETAS[1] ** (s + 1)
                p.sub_(lr / c1 * m1 / (m2.sqrt() / math.sqrt(c2) + ref_train.EPS))
        if first_grad is None:
            first_grad = seen
        del x, cls, grads
    return {"losses": losses, "first_logits": first_logits, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in w.items()}}
