"""The forward operations of the videos answered in the traced
stretch, from the benchmark's work counter, over the stretch times the
card's 989 TFLOP/s (the serve cells)."""

from gpubench.readers import mfu


def read(ctx):
    return mfu(ctx, "serve")
