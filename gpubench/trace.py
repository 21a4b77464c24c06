"""The traced stretch of a ``--trace 1`` run: one ``torch.profiler`` window
(CPU and CUDA activity) over a steady stretch of the measured window, its
events reduced to plain records, and the sums the per-layer readers and
the result line's ``breakdown`` take from them.

The stretch is marked by a ``record_function`` span that opens after a
``torch.cuda.synchronize()`` and closes after another, so every device
interval of the stretch's work lies inside the span, and the span's
length is the traced window.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

SPAN = "gpubench.stretch"
TOP = 10
SHORT_GAP_S = 20e-6  # gaps shorter than this are launch latency, summed apart
SHORT_LABEL = "gaps under 20 us between device operations"
SCAN = 20000  # host events searched back for the one covering a gap


@dataclass
class Event:
    name: str
    device: bool  # ran on the card (a kernel, a copy, a memset)
    start: float  # seconds, on the profiler's clock
    end: float


@dataclass
class Trace:
    """The stretch's events, with the span it was taken over."""

    events: list[Event] = field(default_factory=list)
    span: tuple[float, float] = (0.0, 0.0)
    wall_s: float = 0.0

    @property
    def window_s(self) -> float:
        return self.span[1] - self.span[0]

    def device_events(self) -> list[Event]:
        a, b = self.span
        return [e for e in self.events if e.device and e.end > a and e.start < b]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device intervals inside the span."""
        a, b = self.span
        out: list[list[float]] = []
        for e in sorted(self.device_events(), key=lambda e: e.start):
            s, t = max(e.start, a), min(e.end, b)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def device_seconds(self, match) -> float:
        """Device time of the events whose name ``match`` accepts."""
        return sum(e.end - e.start for e in self.device_events() if match(e.name))

    def top_device_ops(self) -> list[list]:
        by: dict[str, float] = {}
        for e in self.device_events():
            by[e.name] = by.get(e.name, 0.0) + (e.end - e.start)
        return [[_short(n), s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:TOP]]

    def idle_gaps(self) -> list[list]:
        """Idle time of the card, summed by what the host was doing: each
        gap between device intervals is labelled by the innermost host
        operation that covers its midpoint."""
        a, b = self.span
        busy = self.busy_intervals()
        edges = [a] + [x for iv in busy for x in iv] + [b]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = sorted((e for e in self.events if not e.device and e.name != SPAN),
                      key=lambda e: e.start)
        starts = [e.start for e in host]
        by: dict[str, float] = {}
        for s, t in gaps:
            if t - s < SHORT_GAP_S:
                label = SHORT_LABEL
            else:
                # host operations nest, so the innermost one covering the
                # midpoint is the covering one that started last
                mid = 0.5 * (s + t)
                label = "no host operation recorded"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - SCAN, -1), -1):
                    if host[j].end >= mid:
                        label = host[j].name
                        break
            by[label] = by.get(label, 0.0) + (t - s)
        return [[_short(n), s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:TOP]]


def _short(name: str) -> str:
    return name if len(name) <= 160 else name[:157] + "..."


def _attr(ev, *names):
    for n in names:
        f = getattr(ev, n, None)
        if f is not None:
            return f() if callable(f) else f
    raise AttributeError(f"profiler event has none of {names}")


def _from_kineto(prof) -> list[Event]:
    """The profile's events. A ``record_function`` span is also mirrored on
    the device's timeline under the same name; such a mirror is no device
    work and is dropped."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        try:
            start = _attr(ev, "start_ns") * 1e-9
            dur = _attr(ev, "duration_ns") * 1e-9
        except AttributeError:
            start = _attr(ev, "start_us") * 1e-6
            dur = _attr(ev, "duration_us") * 1e-6
        dev = str(_attr(ev, "device_type")).split(".")[-1].upper()
        out.append(Event(str(_attr(ev, "name")), dev == "CUDA", start, start + dur))
    host = {e.name for e in out if not e.device}
    return [e for e in out if not (e.device and e.name in host)]


def _all_threads():
    """Kineto's setting that records every thread's host operations (the
    daemon's scorer and handler threads, the loader's worker), where this
    PyTorch has it; else None, and only the main thread's are recorded."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class Stretch:
    """Profiles what runs between ``start()`` and ``stop()``."""

    def __init__(self, kind: str):
        self.kind = kind
        self._prof = None
        self._span = None
        self._spans = None
        self.trace: Trace | None = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        from gpubench.spans import recorded

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts, record_shapes=False,
                             experimental_config=_all_threads())
        self._prof.__enter__()
        self._spans = recorded(self.kind)
        self._spans.__enter__()
        self._span = record_function(SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> Trace:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self._spans.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = _from_kineto(self._prof)
        spans = [e for e in events if e.name == SPAN and not e.device]
        span = (spans[0].start, spans[0].end) if spans else (
            min(e.start for e in events), max(e.end for e in events))
        self.trace = Trace(events=events, span=span, wall_s=wall)
        self._prof = None
        return self.trace
