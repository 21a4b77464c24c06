"""The cross-modal model's whole attention's share of its roofline in the
training cells: the least time of the work of all its attentions in the
traced steps (the self-attentions over t keys and the cross-attentions
over the context's 2 t, from the rows' valid lengths;
``gpubench/workcount_cross.py``) over the CUDA-event time of the program's
``attention`` and ``attention.cross`` device spans. Nothing where the
program records no ``attention.cross`` span (a model without the
cross-attention, or a program without that span)."""

from gpubench import workcount_cross
from gpubench.program import in_stretch, spans


def read(ctx):
    recs = in_stretch(ctx, "train")
    cross = spans(recs, "attention.cross")
    attn = spans(recs, "attention") + cross
    if not cross or not ctx.get("rows") or any(r.device_s is None for r in attn):
        return None
    lengths = [t for rows in ctx["rows"] for r in rows for t in r]
    least = workcount_cross.attention_least_seconds(lengths, ctx["model"])
    return 100.0 * least / sum(r.device_s for r in attn)
