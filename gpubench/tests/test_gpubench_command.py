"""The command fails, and prints no result, without a CUDA card; a card
test runs one short cell where there is one."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def command(*extra, env=None):
    return subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "serve-daemon-mixed", "--seed",
         "4294967311", "--seconds", "2", *extra], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, **(env or {})})


def test_fails_without_a_card():
    out = command("--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_unknown_cell_fails():
    out = subprocess.run([sys.executable, "-m", "gpubench", "--workload", "nope", "--seed", "1",
                          "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_short_cell_on_the_card(card):
    out = command("--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
