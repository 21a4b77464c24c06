"""The videos a drain of the daemon scored, over the drains of the traced
stretch (the ``videos`` of the program's ``serve.drain`` spans; the serve
cells)."""

from gpubench.program import in_stretch, spans


def read(ctx):
    drains = spans(in_stretch(ctx, "serve"), "serve.drain")
    return sum(r.ids["videos"] for r in drains) / len(drains) if drains else None
