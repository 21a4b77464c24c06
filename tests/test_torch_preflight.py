"""``python -m repurpose_tpu_torch.preflight`` on the CPU: every check runs
and passes with ``--device cpu``, a check made to fail turns the exit code
to 1 with a FAIL line, and the JSON lists every check."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repurpose_tpu_torch import preflight

ROOT = Path(__file__).resolve().parent.parent


def test_preflight_passes_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "preflight.json"
    assert preflight.main(["--device", "cpu", "--output-json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "=== preflight summary ===" in text and "[FAIL]" not in text
    results = json.loads(out.read_text())
    assert [r["check"] for r in results] == [name for name, _ in preflight.CHECKS]
    assert all(r["passed"] for r in results)


def test_a_failed_check_fails_the_run(monkeypatch, capsys):
    def broken(dev):
        raise RuntimeError("made to fail")

    checks = [(n, broken if n == "reduced model + train step" else f)
              for n, f in preflight.CHECKS]
    monkeypatch.setattr(preflight, "CHECKS", checks)
    assert preflight.main(["--device", "cpu"]) == 1
    text = capsys.readouterr().out
    assert "[FAIL] reduced model + train step: RuntimeError: made to fail" in text
    assert text.count("[PASS]") == len(checks) - 1


def test_preflight_module_exits_by_its_checks():
    proc = subprocess.run([sys.executable, "-m", "repurpose_tpu_torch.preflight", "--device",
                           "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[PASS] collective self-check: gloo all_reduce=1" in proc.stdout


def test_preflight_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    proc = subprocess.run([sys.executable, "-m", "repurpose_tpu_torch.preflight"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
