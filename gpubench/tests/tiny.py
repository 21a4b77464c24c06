"""A tiny copy of the benchmark for the CPU tests: the cells' workloads and
configurations at small widths and lengths, written to a directory of the
test's own, and a run of a cell through ``gpubench.run.run_cell`` on the
CPU (the look for a card skipped)."""

from __future__ import annotations

import argparse
import copy
import io
import json
import contextlib
from pathlib import Path

import torch

from gpubench import run

ROOT = Path(__file__).resolve().parents[2]

TINY_MODEL = {"vis_dim": 16, "aud_dim": 24, "text_dim": 8, "d_model": 32, "self_num_layers": 2,
              "num_heads": 4, "d_ff": 64, "hidden_dim": 16, "max_len": 256}
SIZES = {
    "serve-daemon-mixed": {"traffic": {"pool": 6, "lengths": {"quantiles": [40, 60, 90, 120]},
                                       "warmup_requests": 2, "videos_per_request": [2, 3]},
                           "buckets": [64, 128]},
    "train-long-32768": {"traffic": {"videos": 3, "lengths": {"bucket": 256, "fill": [1.0, 0.8]}},
                         "buckets": [128, 256]},
}


def write(tmp: Path, cell: str) -> tuple[dict, dict]:
    """A BENCHMARK.json-shaped dict and the cell's entry, for a tiny copy of
    ``cell`` under ``tmp``, with the workload's committed limits."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["workloads"] if c["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    raw = json.loads((ROOT / conf["file"]).read_text())
    wl = json.loads((run.WORKLOADS / f"{cell}.json").read_text())
    size = SIZES[cell]
    raw["model"].update(TINY_MODEL)
    raw["tpu"]["buckets"] = size["buckets"]
    for k, v in size["traffic"].items():
        wl["traffic"][k] = v
    if "warmup_steps" in wl:
        wl["warmup_steps"] = 4
    (tmp / "workloads").mkdir(exist_ok=True)
    (tmp / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
    conf = copy.deepcopy(conf)
    conf["file"] = str(tmp / f"{entry['config']}.json")
    Path(conf["file"]).write_text(json.dumps(raw))
    bench["configs"] = [conf]
    return bench, entry


def run_tiny(tmp: Path, monkeypatch, cell: str, seed: int = 5, seconds: float = 1.0,
             trace: int = 0) -> tuple[int, dict | None, str]:
    """(exit code, the result line, standard output) of one tiny run."""
    bench, entry = write(tmp, cell)
    monkeypatch.setattr(run, "WORKLOADS", tmp / "workloads")
    monkeypatch.setenv("TMPDIR", str(tmp))
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.run_cell(args, bench, entry, torch.device("cpu"))
    text = out.getvalue()
    lines = text.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), text
