"""The mean wait of a request in the traced stretch from its enqueue to the
start of the drain that scores it (the program's ``serve.queue_wait``
spans; the serve cells)."""

from gpubench.program import in_stretch, seconds, spans


def read(ctx):
    waits = spans(in_stretch(ctx, "serve"), "serve.queue_wait")
    return 1e3 * sum(seconds(r) for r in waits) / len(waits) if waits else None
