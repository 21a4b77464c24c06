"""Profiling, and the program's own spans
(``repurpose_tpu/utils/profiling.py`` on ``torch.profiler`` instead of
``jax.profiler``).

- ``trace(logdir)``: a context manager that records the CPU side and, on a
  card, the CUDA side of what runs inside it, and writes a Chrome trace
  (``trace.json``, for Perfetto or ``chrome://tracing``) and the operator
  table by CPU time (``ops.txt``) into ``logdir``; the profile object is
  yielded for callers that read ``key_averages()`` themselves;
- the recorder: ``span(name, **ids)`` records where a layer of the program
  starts and ends, ``stamp()`` and ``waited(name, since)`` a wait that
  starts on one thread and ends on another, ``device_span(name, x)`` the
  device time of the work the body queues, and ``records()`` returns what
  was recorded; ``annotate(name)`` is a span whose trace event keeps the
  bare ``name``.

The recorder is on only while a ``torch.profiler`` session is active (the
profiler sets and clears ``torch.autograd.profiler._is_profiler_enabled``).
Off, ``span``, ``annotate`` and ``device_span`` return one shared
do-nothing context and ``stamp`` and ``waited`` return at once: no clock
read, no allocation, no ``record_function``, no device event. On:

- a span is stamped with ``time.time_ns()`` at its start and end, with the
  thread that ran it and its ids (the ``videos`` it handled), and its
  body runs inside ``record_function("repurpose:<name>")``, so that the
  trace names the program's layer. Kineto stamps its events in nanoseconds
  of the Unix epoch as ``time.time_ns()`` does, so a record and the trace
  share one clock and a reader can cut the records to a stretch of the
  trace;
- ``device_span`` is a span with a pair of
  ``torch.cuda.Event(enable_timing=True)`` around the body, taken only when
  ``x`` is a CUDA tensor. Nothing waits for the events: their
  elapsed time is read by ``records()``, after the caller's own
  synchronisation, and is None for a pair the card has not reached yet;
- records go into a bounded in-memory buffer (the newest ``KEPT``); nothing
  is written to disk.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Iterator, NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

KEPT = 1 << 17  # records kept; the oldest are dropped beyond it


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[profile]:
    """Profiles the body, the card's activity too where a card is visible."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=False) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=50))


class Record(NamedTuple):
    """One span. Times are ``time.time_ns()`` stamps; a device span has the
    seconds between its events in ``device_s`` (None until they are
    reached)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    ids: dict
    device_s: float | None = None


_records: deque = deque(maxlen=KEPT)
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "ids", "events", "label", "_rf", "_t0")

    def __init__(self, name: str, ids: dict, events=None, label: str | None = None):
        self.name, self.ids, self.events = name, ids, events
        self.label = f"repurpose:{name}" if label is None else label

    def __enter__(self):
        self._t0 = time.time_ns()
        if self.events is not None:
            self.events[0].record()
        self._rf = record_function(self.label)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        if self.events is not None:
            self.events[1].record()
        rec = Record(self.name, self._t0, time.time_ns(), threading.get_ident(), self.ids)
        _records.append(rec if self.events is None else (rec, self.events))
        return False


def span(name: str, **ids):
    """Records the body as a span of the layer ``name`` while recording is on."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, ids)


def annotate(name: str):
    """``span(name)`` named ``name`` in the trace, without the prefix."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, {}, label=name)


def stamp() -> int | None:
    """``time.time_ns()`` while recording is on, else None: the start of a
    wait that ``waited`` records where it ends, on another thread maybe."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return time.time_ns()


def waited(name: str, since: int | None) -> None:
    """Records a span of ``name`` from the stamp ``since`` to now, while
    recording is on and ``since`` was stamped with it on."""
    if since is None or not _autograd_profiler._is_profiler_enabled:
        return
    _records.append(Record(name, since, time.time_ns(), threading.get_ident(), {}))


def device_span(name: str, x: torch.Tensor):
    """``span(name)`` that also times on the card the work the body queues
    on the current stream, while recording is on and ``x`` is on CUDA;
    elsewhere it records nothing."""
    if not _autograd_profiler._is_profiler_enabled or not x.is_cuda:
        return _OFF
    return _Span(name, {}, (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True)))


def records() -> list[Record]:
    """What was recorded, oldest first, device spans with their device time."""
    out = []
    for r in list(_records):
        if type(r) is tuple:  # a device span: (record, its events)
            r, (a, b) = r
            r = r._replace(device_s=a.elapsed_time(b) * 1e-3 if b.query() else None)
        out.append(r)
    return out


def clear() -> None:
    """Drops every record."""
    _records.clear()
