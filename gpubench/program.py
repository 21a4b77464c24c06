"""What the readers of the program's own records share.

While a traced run's profiler is on, the port records spans where its
work happens (``repurpose_tpu_torch.utils.profiling``: a span's start and
end, its thread and ids, stamped with ``time.time_ns()``, the clock the
trace's events carry; a device span's time between its CUDA events). A reader keeps the records whose end lies inside the traced
stretch, and returns None where there are none: the run was not traced,
the stretch ran nothing on the card (a rehearsal on the CPU reports no
program time, as it reports no device time), or the program does not record
that span.
"""

from __future__ import annotations


def in_stretch(ctx: dict, kind: str) -> list:
    """The program's records that end inside the stretch of a ``kind`` cell."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or tr is None or tr.window_s <= 0 or not ran_on_card(tr):
        return []
    from repurpose_tpu_torch.utils import profiling

    read = getattr(profiling, "records", None)
    if read is None:  # the program of an older checkout has no recorder
        return []
    a, b = tr.span
    return [r for r in read() if a <= r.end_ns * 1e-9 <= b]


def ran_on_card(tr) -> bool:
    """Whether the traced stretch ran a kernel, copy or memset on the card."""
    return bool(tr.device_events())


def spans(recs: list, name: str) -> list:
    return [r for r in recs if r.name == name]


def seconds(r) -> float:
    return (r.end_ns - r.start_ns) * 1e-9


def ms_per(recs: list, name: str, key: str):
    """Milliseconds of the spans ``name`` over the sum of their ids' ``key``;
    None where there is nothing to divide."""
    got = spans(recs, name)
    n = sum(r.ids.get(key, 0) for r in got)
    if not n:
        return None
    return 1e3 * sum(seconds(r) for r in got) / n
