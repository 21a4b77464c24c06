"""What the per-layer readers (``gpubench/metrics/<metric>.py``) share.

A reader gets the traced stretch (``trace``, a ``gpubench.trace.Trace``),
the configuration's ``model`` section and what the cell's driver counted in the
stretch: ``kind`` ("serve" or "train"), ``videos``, and the video lengths
(``lengths`` of the videos answered; ``rows``, each step's rows of video
lengths). It returns the metric, or None where the stretch holds nothing
for it to read: no trace, no device activity, no video, no kernel of its
layer. A share of a roofline or of a peak is never made up as 0.
"""

from __future__ import annotations

import re

from gpubench import workcount

ATTENTION_KERNEL = re.compile(r"\bflash_\w+")


def traced(ctx: dict, kind: str):
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or not tr.device_events() or tr.window_s <= 0:
        return None
    return tr


def idle_pct(ctx: dict, kind: str):
    tr = traced(ctx, kind)
    return None if tr is None else 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def h2d_ms_per_video(ctx: dict, kind: str):
    tr = traced(ctx, kind)
    if tr is None or not ctx.get("videos"):
        return None
    s = tr.device_seconds(lambda n: n.startswith("Memcpy HtoD"))
    return 1e3 * s / ctx["videos"] if s > 0 else None


def mfu(ctx: dict, kind: str):
    tr = traced(ctx, kind)
    if tr is None or not ctx.get("videos"):
        return None
    m = ctx["model"]
    if kind == "serve":
        flops = workcount.forward_flops(ctx["lengths"], m)
    else:
        flops = workcount.train_flops([t for rows in ctx["rows"] for r in rows for t in r], m)
    return 100.0 * flops / (tr.window_s * workcount.PEAK_BF16_FLOPS)


def attn_roofline(ctx: dict, kind: str):
    """The least time of the attention's needed work over the device time
    of the kernels named ``flash_*``."""
    tr = traced(ctx, kind)
    if tr is None or not ctx.get("rows"):
        return None
    spent = tr.device_seconds(lambda n: ATTENTION_KERNEL.search(n) is not None)
    if spent <= 0:
        return None
    least = sum(workcount.least_seconds(*workcount.attention_needed(rows, ctx["model"], True))
                for rows in ctx["rows"])
    return 100.0 * least / spent
