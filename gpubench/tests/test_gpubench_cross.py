"""Tiny-width rehearsals on the CPU of the cell that the cross-modal
configuration brought: it prints a result line with ``correct`` true under
the limits its workload file commits; the cross-modal model's float8
control (``gpubench.control_cross``) is judged wrong; and its run, with the
timed path broken underneath, comes out not correct. Then the work counter
of the model's whole attention.

The cross-modal training cell rehearses in float32: at these widths bf16
moves a leaf's change over the three followed steps by up to 0.21 of the
median leaf's (seed 5: ``audio_encoder.proj.fc2.weight``), past the
``update_gap`` limit set from readings at the cell's own widths (PERF.md
section 2), while float32 holds every compared number under 1e-5, which
checks the wiring of the driver and the reference."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import control_cross, run, workcount_cross
from gpubench.tests import tiny
from gpubench.tests.test_gpubench_rehearsal import KEYS, _altered_loss, _state_unchanged

SIZES = {
    "train-cross-long-32768": {"traffic": {"videos": 3,
                                           "lengths": {"bucket": 256, "fill": [1.0, 0.8]}},
                               "buckets": [128, 256]},
}
NAMES = {"train-cross-long-32768": {"train_videos_per_s", "train_peak_gib", "setup_s"}}


@pytest.fixture(autouse=True)
def sizes(monkeypatch):
    for cell, size in SIZES.items():
        monkeypatch.setitem(tiny.SIZES, cell, size)
    write = tiny.write

    def float32_training(tmp, cell):
        bench, entry = write(tmp, cell)
        if cell == "train-cross-long-32768":
            path = bench["configs"][0]["file"]
            raw = json.loads(open(path).read())
            raw["tpu"]["compute_dtype"] = raw["model"]["attn_softmax_dtype"] = "float32"
            open(path, "w").write(json.dumps(raw))
        return bench, entry

    monkeypatch.setattr(tiny, "write", float32_training)


def committed_limits(cell: str) -> dict:
    return json.loads((run.WORKLOADS / f"{cell}.json").read_text())["limits"]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_rehearsal_prints_a_correct_result_line(tmp_path, monkeypatch, cell):
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, cell)
    assert rc == 0, text
    assert list(line) == KEYS
    assert line["correct"] is True, line["compared"]
    assert set(line["metrics"]) == NAMES[cell]
    assert {k: c["limit"] for k, c in line["compared"].items()} == committed_limits(cell)


def test_traced_rehearsal_reads_nothing_without_a_card(tmp_path, monkeypatch):
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, "train-cross-long-32768", trace=1)
    assert rc == 0, text
    assert line["metrics"] == {} and line["device"]["busy_s"] == 0


def test_float8_control_is_judged_wrong(tmp_path):
    cell = "train-cross-long-32768"
    bench, _ = tiny.write(tmp_path, cell)
    raw = json.loads(open(bench["configs"][0]["file"]).read())
    wl = json.loads((tmp_path / "workloads" / f"{cell}.json").read_text())
    got = control_cross.readings(wl, raw, 5, torch.device("cpu"), tmp_path / "s")
    assert any(got["fp8"][k] > v for k, v in committed_limits(cell).items()), got["fp8"]


@pytest.mark.parametrize("fault", [_state_unchanged, _altered_loss])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    rc, line, text = tiny.run_tiny(tmp_path, monkeypatch, "train-cross-long-32768")
    assert rc == 0, text
    assert line["correct"] is False, line["compared"]


@pytest.mark.parametrize("t", [4096, 29127])
def test_the_whole_attention_counts_every_layer(t):
    """12 self-attentions over t * t pairs and 3 cross-attentions over 2 t * t
    at the published widths: 14 * Dh operations a pair and head (forward and
    backward), compute-bound at these lengths."""
    m = json.loads((run.ROOT / "gpubench/configs/repurpose-cross-long.json").read_text())["model"]
    dh, heads = m["d_model"] // m["num_heads"], m["num_heads"]
    pairs = (3 * m["text_num_layers"] + m["cross_num_layers"] + 2 * m["cross_num_layers"]) * t * t
    want = 14.0 * dh * heads * pairs / workcount_cross.PEAK_BF16_FLOPS
    assert workcount_cross.attention_least_seconds([t], m) == pytest.approx(want, rel=1e-12)
