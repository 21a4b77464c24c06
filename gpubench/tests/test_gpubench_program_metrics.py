"""The readers of the program's own records (``gpubench/program.py`` and
the metrics that use it): what they keep of the records, and what a traced
tiny rehearsal of each cell on the CPU prints from the spans its program
really recorded, with the look for work on the card answered yes (on the
CPU the stretch runs nothing on a card, so the readers report nothing, as
``test_gpubench_rehearsal.py`` holds)."""

from __future__ import annotations

import math

import pytest
import torch

from gpubench import program
from gpubench.tests import tiny
from gpubench.trace import Event, Trace
from repurpose_tpu_torch.utils import profiling

CELLS = ("serve-daemon-mixed", "train-long-32768")

# all but the attention's device spans, which need CUDA events
PROGRAM_METRICS = {
    "serve-daemon-mixed": {"queue_wait_ms.serve", "videos_per_drain.serve",
                           "intake_ms_per_video.serve", "batch_build_ms_per_video.serve",
                           "decode_ms_per_video.serve"},
    "train-long-32768": {"loader_wait_ms_per_step.train", "loader_ms_per_video.train"},
}


@pytest.fixture
def one_thread():
    """Torch on one thread: the tiny steps then run many to a stretch, where
    several test processes sharing the CPU can otherwise leave one slow step,
    and no epoch's start, whose loader builds the batches, inside it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_prints_the_programs_metrics(tmp_path, monkeypatch, one_thread, cell):
    monkeypatch.setattr(program, "ran_on_card", lambda tr: True)
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, cell, trace=1)
    assert rc == 0, text
    assert set(line["metrics"]) == PROGRAM_METRICS[cell]
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and math.isfinite(m["value"]), (name, m)
    if cell == "serve-daemon-mixed":  # a drain scores one request or more
        least = tiny.SIZES[cell]["traffic"]["videos_per_request"][0]
        assert line["metrics"]["videos_per_drain.serve"]["value"] >= least


def _rec(name, start_s, end_s, **ids):
    return profiling.Record(name, int(start_s * 1e9), int(end_s * 1e9), 0, ids)


RECS = [_rec("infer.decode", 9.0, 9.9, videos=4),     # ends before the stretch
        _rec("infer.decode", 10.0, 10.5, videos=2),
        _rec("infer.decode", 11.0, 11.2, videos=3),
        _rec("infer.decode", 11.9, 12.1, videos=5)]   # ends after it
CARD = [Event("kernel", True, 10.1, 10.2)]


@pytest.mark.parametrize("events, kind, kept", [
    (CARD, "serve", RECS[1:3]),
    ([], "serve", []),          # nothing ran on the card
    (CARD, "train", []),        # a reader of another kind of cell
])
def test_in_stretch_keeps_the_records_that_end_inside(monkeypatch, events, kind, kept):
    monkeypatch.setattr(profiling, "records", lambda: RECS)
    ctx = {"kind": "serve", "trace": Trace(events=events, span=(10.0, 12.0))}
    assert program.in_stretch(ctx, kind) == kept


def test_ms_per_divides_the_spans_by_their_ids():
    got = program.ms_per(RECS[1:3], "infer.decode", "videos")
    assert got == pytest.approx(1e3 * (0.5 + 0.2) / 5)
    assert program.ms_per(RECS[1:3], "infer.batch_build", "videos") is None
