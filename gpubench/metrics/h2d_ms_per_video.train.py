"""Device time of the host-to-device copies (``Memcpy HtoD``) in the traced
stretch, over the videos trained in it (the train cells)."""

from gpubench.readers import h2d_ms_per_video


def read(ctx):
    return h2d_ms_per_video(ctx, "train")
