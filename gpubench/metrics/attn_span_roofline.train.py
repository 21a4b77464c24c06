"""The attention's share of its roofline in the training cells, timed by
the program: the least time of the work the traced steps' attention needs
(``attn_roofline.train``'s, from the work counter) over the card's time
inside the program's ``attention`` device spans (the autograd Function's
forward, remat's recompute and backward, whatever kernels run them)."""

from gpubench import workcount
from gpubench.program import in_stretch, spans


def read(ctx):
    attn = spans(in_stretch(ctx, "train"), "attention")
    if not attn or not ctx.get("rows") or any(r.device_s is None for r in attn):
        return None
    least = sum(workcount.least_seconds(*workcount.attention_needed(rows, ctx["model"], True))
                for rows in ctx["rows"])
    return 100.0 * least / sum(r.device_s for r in attn)
