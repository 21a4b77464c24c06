"""The loader worker's time building the batches of the traced stretch,
over their videos (the program's ``loader.load`` spans; the train
cells)."""

from gpubench.program import in_stretch, ms_per


def read(ctx):
    return ms_per(in_stretch(ctx, "train"), "loader.load", "videos")
