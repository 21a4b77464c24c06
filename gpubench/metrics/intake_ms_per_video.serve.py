"""The handler threads' time loading and checking the videos of the
requests in the traced stretch, over those videos (the program's
``serve.intake`` spans; the serve cells)."""

from gpubench.program import in_stretch, ms_per


def read(ctx):
    return ms_per(in_stretch(ctx, "serve"), "serve.intake", "videos")
