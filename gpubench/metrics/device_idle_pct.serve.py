"""The share of the traced stretch in which no kernel, copy or memset ran
on the card (the serve cells)."""

from gpubench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "serve")
