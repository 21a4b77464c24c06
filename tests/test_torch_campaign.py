"""The port's accuracy campaign (``python -m repurpose_tpu_torch.campaign``)
on the CPU, against root ``campaign.py``, and ``write_synthetic_dataset``
against the JAX writer.

- ``--smoke 5 --torch_ckpt X.pth`` on the port and on root ``campaign.py``
  with the same ``.pth`` (JAX-initialised weights through the port's
  ``models/convert.py``) and a float32 config: each threshold's mean agrees
  within 1e-6 (per-video fractions of float32 scores; both sides take the
  same decode and Soft-NMS), and the port's packed cross-check passes at
  its exact gate;
- the scan gate stops a split with a missing feature, and a pickled
  ``.npy`` counts as corrupt (it is never unpickled);
- a stage-2 error leaves the report on disk with the scan and the error;
- the packed gate: 2 / videos per threshold under bf16, exact under float32;
- ``--smoke`` leaves no temporary directory behind;
- ``main`` raises without CUDA unless ``--device cpu``.
"""

import json
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JaxModelConfig
from repurpose_tpu.config import load_config as jax_load_config
from repurpose_tpu.data.synthetic import write_synthetic_dataset as jax_write
from repurpose_tpu.models import MMCT as JaxMMCT
from repurpose_tpu_torch import campaign
from repurpose_tpu_torch.config import ModelConfig, load_config
from repurpose_tpu_torch.data.synthetic import write_synthetic_dataset
from repurpose_tpu_torch.models import state_dict_from_jax_params

ROOT = Path(__file__).resolve().parent.parent

TINY_YAML = """
model:
  vis_dim: 8
  aud_dim: 12
  text_dim: 6
  d_model: 32
  self_num_layers: 1
  num_heads: 2
train:
  seed: 11
  batch_size: 2
test_cfg:
  pre_nms_topk: 16
  pre_nms_thresh: 0.2
  duration_thresh: 1
  duration_thresh_max: 90
  max_seg_per_min: 2.0
  nms_sigma: 0.5
  min_score: 0.01
tpu:
  buckets: [64, 128]
  compute_dtype: float32
  attention_impl: xla
  matmul_precision: highest
"""


def _root_campaign():
    sys.path.insert(0, str(ROOT))
    try:
        return __import__("campaign")
    finally:
        sys.path.remove(str(ROOT))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(config path, .pth) of JAX-initialised weights whose offsets span
    about 20 s, so that decoded clips overlap the synthetic ground truth."""
    tmp = tmp_path_factory.mktemp("campaign")
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    params = jax.device_get(
        JaxMMCT(jax_load_config(str(cfg_path)).model).init_params(jax.random.key(6)))
    params["reg_head"]["out"]["bias"] = np.full((2,), 10.0, np.float32)
    ckpt = tmp / "tiny.pth"
    torch.save({"model": state_dict_from_jax_params(params), "epoch": 0, "loss": 0.0}, ckpt)
    return str(cfg_path), str(ckpt)


def test_smoke_matches_root_campaign(tiny, tmp_path, monkeypatch, capsys):
    cfg_path, ckpt = tiny
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # root's smoke split stays here
    port_report, root_report = tmp_path / "port.json", tmp_path / "root.json"
    assert campaign.main(["--config_path", cfg_path, "--smoke", "5", "--torch_ckpt", ckpt,
                          "--device", "cpu", "--report", str(port_report)]) == 0
    monkeypatch.setattr(sys, "argv", ["campaign.py", "--config_path", cfg_path, "--smoke",
                                      "5", "--torch_ckpt", ckpt, "--report",
                                      str(root_report)])
    _root_campaign().main()
    got, want = json.loads(port_report.read_text()), json.loads(root_report.read_text())
    assert got["eval_entries"] == want["eval_entries"] == 5
    assert got["feature_scan"] == want["feature_scan"]
    for t, v in want["precision_at_tiou"].items():
        assert abs(got["precision_at_tiou"][t] - v) <= 1e-6, (t, got, want)
    assert sum(got["precision_at_tiou"].values()) > 0  # the comparison holds hits
    check = got["packed_crosscheck"]
    assert check["passed"] and check["tolerance_per_threshold"] == campaign.EXACT_TOL
    assert got["torch_version"] == torch.__version__ and got["device"] == "cpu"
    assert "error" not in got


def test_smoke_leaves_no_temp_dir(tiny, tmp_path, monkeypatch):
    cfg_path, ckpt = tiny
    scratch = tmp_path / "tmp"
    scratch.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(scratch))
    assert campaign.main(["--config_path", cfg_path, "--smoke", "3", "--torch_ckpt", ckpt,
                          "--device", "cpu", "--no-crosscheck",
                          "--report", str(tmp_path / "r.json")]) == 0
    assert list(scratch.iterdir()) == []


def _params(cfg_path):
    from repurpose_tpu_torch.models import build_model

    return build_model(load_config(cfg_path).model, "cpu", seed=0).state_dict()


def test_scan_gate_and_pickled_features(tiny, tmp_path):
    cfg_path, _ = tiny
    cfg = load_config(cfg_path)
    split = write_synthetic_dataset(str(tmp_path / "split"), [70, 90, 110], cfg.model, seed=3)
    ids = [e["youtube_id"] for e in json.load(open(split.label_path))]
    (Path(split.audio_path) / f"{ids[0]}.npy").unlink()  # missing
    np.save(Path(split.text_path) / f"{ids[1]}.npy",
            np.array([{"not": "features"}], dtype=object), allow_pickle=True)  # pickled
    scan = campaign.scan_features(split)
    assert scan["videos"] == 3 and scan["complete_all_modalities"] == 1
    assert scan["audio"]["missing_ids"] == [ids[0]]
    assert scan["text"]["corrupt_ids"] == [ids[1]] and scan["text"]["ok"] == 2
    report = tmp_path / "r.json"
    import dataclasses

    with pytest.raises(SystemExit, match="feature scan failed"):
        campaign.run_campaign(dataclasses.replace(cfg, test_dataset=split),
                              _params(cfg_path), str(report), device="cpu")
    written = json.loads(report.read_text())
    assert written["feature_scan"] == scan and "precision_at_tiou" not in written


def test_report_survives_a_stage_two_error(tiny, tmp_path, monkeypatch):
    cfg_path, _ = tiny
    cfg = load_config(cfg_path)
    split = write_synthetic_dataset(str(tmp_path / "split"), [70, 90], cfg.model, seed=3)
    from repurpose_tpu_torch import inference

    def boom(*a, **k):
        raise RuntimeError("injected stage-2 failure")

    monkeypatch.setattr(inference, "evaluate_dataset", boom)
    report = tmp_path / "r.json"
    import dataclasses

    with pytest.raises(RuntimeError, match="injected"):
        campaign.run_campaign(dataclasses.replace(cfg, test_dataset=split),
                              _params(cfg_path), str(report), device="cpu")
    written = json.loads(report.read_text())
    assert written["feature_scan"]["complete_all_modalities"] == 2
    assert written["error"] == "RuntimeError: injected stage-2 failure"


@pytest.mark.parametrize("dtype,flip,passes", [
    ("bfloat16", 1, True), ("bfloat16", 3, False), ("float32", 1, False),
    ("float32", 0, True)])
def test_packed_gate_tolerates_boundary_videos_only_in_bf16(tiny, tmp_path, monkeypatch,
                                                            dtype, flip, passes):
    """Packed scores that flip ``flip`` of 10 videos' precision at one
    threshold: bf16 allows 2 / 10 per threshold, float32 none."""
    import dataclasses

    from repurpose_tpu_torch import inference
    from repurpose_tpu_torch.train.loop import TIOU_THRESHOLDS

    cfg_path, _ = tiny
    cfg = load_config(cfg_path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype=dtype))
    split = write_synthetic_dataset(str(tmp_path / "split"), [70] * 10, cfg.model, seed=3)

    def fake(ds, cfg, params, batch_size=None, pack=False, device="cuda"):
        per = {t: [1.0] * 10 for t in TIOU_THRESHOLDS}
        if pack:
            per[0.7] = [0.0] * flip + [1.0] * (10 - flip)
        return [], {}, per

    monkeypatch.setattr(inference, "evaluate_dataset", fake)
    report = tmp_path / "r.json"
    run = lambda: campaign.run_campaign(dataclasses.replace(cfg, test_dataset=split),  # noqa
                                        {}, str(report), device="cpu")
    if passes:
        run()
    else:
        with pytest.raises(SystemExit, match="packed cross-check diverged"):
            run()
    check = json.loads(report.read_text())["packed_crosscheck"]
    assert check["passed"] is passes
    assert check["abs_delta_by_threshold"]["0.7"] == pytest.approx(flip / 10)
    assert check["tolerance_per_threshold"] == (0.2 if dtype == "bfloat16" else 1e-6)


def test_write_synthetic_dataset_is_byte_identical_to_the_jax_writer(tmp_path):
    dims = dict(vis_dim=8, aud_dim=12, text_dim=6)
    durations = [61, 150, 97]
    got = write_synthetic_dataset(str(tmp_path / "port"), durations, ModelConfig(**dims), seed=9)
    want = jax_write(str(tmp_path / "jax"), durations, JaxModelConfig(**dims), seed=9)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 3 * len(durations) + 1
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for field in ("label_path", "video_path", "audio_path", "text_path"):
        assert Path(getattr(got, field)).relative_to(tmp_path / "port") == \
            Path(getattr(want, field)).relative_to(tmp_path / "jax")


def test_main_needs_cuda_unless_asked_for_the_cpu(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    cfg_path, ckpt = tiny
    report = tmp_path / "r.json"
    with pytest.raises(RuntimeError, match="CUDA"):
        campaign.main(["--config_path", cfg_path, "--smoke", "2", "--report", str(report)])
    assert not report.exists()
