"""The cross-modal model's operations (forward and backward) of the steps
in the traced stretch, from its work counter (``gpubench/workcount_cross.py``),
over the stretch times the card's 989 TFLOP/s (the cross-modal training
cells)."""

from gpubench import workcount_cross
from gpubench.readers import traced


def read(ctx):
    tr = traced(ctx, "train")
    if tr is None or not ctx.get("videos"):
        return None
    lengths = [t for rows in ctx["rows"] for r in rows for t in r]
    flops = workcount_cross.train_flops(lengths, ctx["model"])
    return 100.0 * flops / (tr.window_s * workcount_cross.PEAK_BF16_FLOPS)
