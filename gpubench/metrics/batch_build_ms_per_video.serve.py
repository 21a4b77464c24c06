"""The host's time padding or packing the batches of the traced stretch,
over their videos (the program's ``infer.batch_build`` spans; the serve
cells)."""

from gpubench.program import in_stretch, ms_per


def read(ctx):
    return ms_per(in_stretch(ctx, "serve"), "infer.batch_build", "videos")
