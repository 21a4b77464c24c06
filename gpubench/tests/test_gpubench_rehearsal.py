"""Tiny-width rehearsals of each cell on the CPU, the look for a card
skipped: the run prints a result line of the documented shape with
``correct`` true; the float8 control at the same size is judged wrong; and
the run, with the timed path broken underneath in each way the cell can
be, comes out not correct. Every judgment here is made with the limits
the cell's workload file commits (set from chip runs at the cells' sizes,
PERF.md)."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import control, run
from gpubench.tests import tiny

CELLS = ("serve-daemon-mixed", "train-long-32768")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
WORKLOADS = run.WORKLOADS


def committed_limits(cell: str) -> dict:
    return json.loads((WORKLOADS / f"{cell}.json").read_text())["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_correct_result_line(tmp_path, monkeypatch, cell):
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, cell)
    assert rc == 0, text
    assert list(line) == KEYS
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {"serve-daemon-mixed": {"serve_videos_per_s", "serve_p95_ms", "setup_s"}}.get(
        cell, {"train_videos_per_s", "train_peak_gib", "setup_s"})
    assert set(line["metrics"]) == names
    assert all(m["value"] >= 0 for m in line["metrics"].values())
    limits = committed_limits(cell)
    assert {k: c["limit"] for k, c in line["compared"].items()} == limits
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])


def test_traced_rehearsal_carries_the_trace_keys(tmp_path, monkeypatch):
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, "train-long-32768", trace=1)
    assert rc == 0, text
    assert list(line) == KEYS[:5] + ["breakdown", "compared"]
    assert line["device"]["window_s"] > 0
    # no card, so no device time: every reader finds nothing to read
    assert line["metrics"] == {}
    assert line["device"]["busy_s"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_float8_control_is_judged_wrong(tmp_path, cell):
    bench, _ = tiny.write(tmp_path, cell)
    raw = json.loads(open(bench["configs"][0]["file"]).read())
    wl = json.loads((tmp_path / "workloads" / f"{cell}.json").read_text())
    got = control.readings(wl, raw, 5, torch.device("cpu"), tmp_path / "s")
    limits = committed_limits(cell)
    assert any(got["fp8"][k] > v for k, v in limits.items()), got["fp8"]


def _altered_scores(monkeypatch):
    """An answer altered where it is produced: every served score moved."""
    from repurpose_tpu_torch import infer

    unpack = infer._unpack

    def altered(*a, **k):
        out = unpack(*a, **k)
        for r in out:
            r["scores"] = r["scores"] + 0.01
        return out

    monkeypatch.setattr(infer, "_unpack", altered)


def _half_the_videos(monkeypatch):
    """Half of each drain's videos left out: their results are empty."""
    from repurpose_tpu_torch.infer import InferencePipeline

    score = InferencePipeline.score_videos

    def half(self, videos, **k):
        keep = len(videos) - len(videos) // 2
        out = score(self, videos[:keep], **k)
        return out + [{**out[0], "video_id": str(v["video_id"])} for v in videos[keep:]]

    monkeypatch.setattr(InferencePipeline, "score_videos", half)


def _state_unchanged(monkeypatch):
    """A step that returns its state unchanged: Adam takes no step."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _altered_loss(monkeypatch):
    """An answer altered where it is produced: the loss scaled."""
    from repurpose_tpu_torch.train import step

    loss = step.masked_cls_loss
    monkeypatch.setattr(step, "masked_cls_loss", lambda *a, **k: 1.05 * loss(*a, **k))


FAULTS = [
    ("serve-daemon-mixed", _altered_scores),
    ("serve-daemon-mixed", _half_the_videos),
    ("train-long-32768", _state_unchanged),
    ("train-long-32768", _altered_loss),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, cell)
    assert rc == 0, text
    assert line["correct"] is False, line["compared"]
