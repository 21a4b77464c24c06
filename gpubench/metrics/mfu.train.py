"""The model operations (forward and backward, remat's recompute not counted) of the steps in the traced
stretch, from the benchmark's work counter, over the stretch times the
card's 989 TFLOP/s (the train cells)."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
