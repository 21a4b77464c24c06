"""The training loop's time blocked on the loader's queue in the traced
stretch, over its steps (the program's ``loader.wait`` spans; the train
cells)."""

from gpubench.program import in_stretch, seconds, spans


def read(ctx):
    waits = spans(in_stretch(ctx, "train"), "loader.wait")
    if not waits or not ctx.get("rows"):
        return None
    return 1e3 * sum(seconds(r) for r in waits) / len(ctx["rows"])
