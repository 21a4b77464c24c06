"""The host's time in decode and Soft-NMS, the Soft-NMS loop's reads of its
done flags included, over the videos decoded in the traced stretch (the
program's ``infer.decode`` spans; the serve cells)."""

from gpubench.program import in_stretch, ms_per


def read(ctx):
    return ms_per(in_stretch(ctx, "serve"), "infer.decode", "videos")
