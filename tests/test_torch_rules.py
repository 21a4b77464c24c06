"""Rules the port keeps: what it imports, where it runs, and how the smoke
script behaves on a machine without a card."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repurpose_tpu.config import load_config as jax_load_config
from repurpose_tpu_torch.config import ModelConfig, TestConfig, load_config

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "repurpose_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
NEVER = {"jax", "flax", "optax", "repurpose_tpu"}
# not on the card's machine: imported only inside the function that needs them
NOT_AT_TOP = {"yaml", "sklearn", "matplotlib"}


def _imports(node):
    if isinstance(node, ast.Import):
        return [a.name.split(".")[0] for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module.split(".")[0]]
    return []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_jax_package(path):
    tree = ast.parse(path.read_text())
    anywhere = {m for node in ast.walk(tree) for m in _imports(node)}
    assert not anywhere & NEVER, f"{path.name} imports {anywhere & NEVER}"
    top = {m for node in tree.body for m in _imports(node)}
    assert not top & NOT_AT_TOP, f"{path.name} imports {top & NOT_AT_TOP} at top level"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model

    cfg = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                      num_heads=2, d_ff=32, hidden_dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    sd = build_model(cfg, "cpu").state_dict()
    with pytest.raises(RuntimeError, match="CUDA"):
        InferencePipeline(cfg, sd, TestConfig())


@pytest.mark.parametrize("tool", ["bench_attention_fwd", "bench_int8_matmul",
                                  "bench_extractors"])
def test_bench_tool_entry_points_raise_without_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    import importlib

    module = importlib.import_module(f"repurpose_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


@pytest.mark.parametrize("cli", ["serve", "campaign"])
def test_serving_and_campaign_entry_points_raise_without_cuda(cli, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    import importlib

    module = importlib.import_module(f"repurpose_tpu_torch.{cli}")
    argv = ["--config_path", str(ROOT / "configs" / "repurpose.yaml")]
    if cli == "campaign":
        argv += ["--smoke", "2", "--report", str(tmp_path / "report.json")]
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(argv)
    assert list(tmp_path.iterdir()) == []  # nothing written before the raise


@pytest.mark.parametrize("argv", [["--dataset", "ds.json"], ["--dataset", "ds.json", "--verify"],
                                  ["--split", "ds.json"], ["--fanout", "2"]],
                         ids=["dataset", "verify", "split", "fanout"])
def test_preprocess_cli_raises_without_cuda(argv, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from repurpose_tpu_torch.preprocess import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert list(tmp_path.iterdir()) == []  # nothing written before the raise


def test_extraction_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    from repurpose_tpu_torch.extractors.whisper_torch import WhisperASR, WhisperConfig
    from repurpose_tpu_torch.preprocessing.extract import (
        AudioExtractor,
        TextExtractor,
        VisualExtractor,
    )
    from repurpose_tpu_torch.preprocessing.pipeline import PreprocessConfig, PreprocessingPipeline

    for make in (lambda: VisualExtractor({}), lambda: AudioExtractor(None),
                 lambda: TextExtractor({}, tokenizer=None),
                 lambda: WhisperASR(WhisperConfig(), {}, {}, tokenizer=None),
                 lambda: WhisperASR.from_hf_dir(str(tmp_path)),
                 lambda: PreprocessingPipeline(PreprocessConfig(video_dir=str(tmp_path / "v")))):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert not (tmp_path / "v").exists()


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr  # stopped before building anything


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_load_config_matches_the_jax_package():
    path = ROOT / "configs" / "repurpose.yaml"
    assert load_config(str(path)).to_dict() == jax_load_config(str(path)).to_dict()
