"""The port's long-video serving slice and its inference CLI on the CPU,
against the JAX package.

- The whole slice: the JAX ``InferencePipeline`` with the Pallas attention
  (interpret mode) and its thresholds patched so that buckets 128 / 256 / 512
  reach the dense, the stream and the HBM forward kernels (packed: the dense
  packed, the packed-stream and the packed HBM kernel), against the port's
  pipeline with its own ``STREAM_MAX_T`` patched to 128, so that 256 and 512
  take the streaming forward's plain version. Same weights, and the same
  positional table on both sides (the two ``sin`` implementations differ in
  the last bits of a float32 angle). float32: cls logits within 1e-4, kept
  labels equal, scores within 1e-4 and segments within 2e-3 (the tolerances
  of tests/test_torch_infer.py).
- The CLI (``python -m repurpose_tpu_torch.inference``) against root
  ``inference.evaluate_dataset`` on one ``.pth``: precision@tIoU equal at
  every threshold (1e-9), manifests equal up to their printed rounding.
- ``--torch_ckpt`` on the reference's trained golden checkpoint, the
  long-video config, and the positional table at T = 32768 (1e-3, the
  measured float32 difference of the two ``sin`` implementations there).
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repurpose_tpu.ops.flash_attention as fa
from repurpose_tpu.config import ModelConfig as JaxModelConfig
from repurpose_tpu.config import TestConfig as JaxTestConfig
from repurpose_tpu.config import load_config as jax_load_config
from repurpose_tpu.data.synthetic import SyntheticDataset as JaxSyntheticDataset
from repurpose_tpu.infer import InferencePipeline as JaxPipeline
from repurpose_tpu.models import MMCT as JaxMMCT
from repurpose_tpu.models.positional import (
    sinusoidal_positional_encoding as jax_positional_encoding,
)
from repurpose_tpu.models.torch_convert import (
    load_reference_checkpoint as jax_load_reference_checkpoint,
)
from repurpose_tpu.models.torch_convert import save_reference_checkpoint
from repurpose_tpu.utils.export import results_to_manifest as jax_results_to_manifest
from repurpose_tpu_torch import inference as cli
from repurpose_tpu_torch.config import (
    Config,
    DatasetConfig,
    ModelConfig,
    TestConfig,
    TrainConfig,
    load_config,
)
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import state_dict_from_jax_params
from repurpose_tpu_torch.models.positional import sinusoidal_positional_encoding
from repurpose_tpu_torch.ops import flash_attention as port_fa
from repurpose_tpu_torch.utils.export import ffmpeg_cut_commands, results_to_manifest

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_DIR = ROOT / "tests" / "golden"

MODEL = dict(
    vis_dim=32, aud_dim=64, text_dim=16, d_model=64, self_num_layers=2, num_heads=4,
    d_ff=128, hidden_dim=32, dropout=0.0, compute_dtype="float32",
    matmul_precision="highest", attn_softmax_dtype="float32",
)
SERVE = dict(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
             duration_thresh_max=90, max_seg_per_min=1.0)
LONG_BUCKETS = (128, 256, 512)  # configs/longvideo.yaml's ladder at a quarter of 2048


def _root_module(name):
    sys.path.insert(0, str(ROOT))
    try:
        return __import__(name)
    finally:
        sys.path.remove(str(ROOT))


def _patch_long_t(monkeypatch):
    """T > 128 takes the streaming forward on both sides; on the JAX side
    T > 256 the HBM kernel, every block 64."""
    for name in ("STREAM_K_BLOCK", "HBM_FWD_K_BLOCK", "PACKED_K_BLOCK",
                 "DEFAULT_Q_BLOCK", "PACKED_Q_BLOCK"):
        monkeypatch.setattr(fa, name, 64)
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    monkeypatch.setattr(fa, "HBM_STREAM_T", 256)
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)


def _videos(seed, lengths):
    rng = np.random.default_rng(seed)
    return [
        {"visual": rng.normal(0, 1, (t, MODEL["vis_dim"])).astype(np.float32),
         "audio": rng.normal(0, 1, (t, MODEL["aud_dim"])).astype(np.float32),
         "text": rng.normal(0, 1, (t, MODEL["text_dim"])).astype(np.float32),
         "video_id": f"vid{i}"}
        for i, t in enumerate(lengths)
    ]


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline with the Pallas attention, port pipeline), same weights
    and positional table, raw outputs on."""
    jcfg = JaxModelConfig(**MODEL, attention_impl="pallas_full")
    params = JaxMMCT(jcfg).init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), params)
    sd = state_dict_from_jax_params(params)
    sd["positional_encoding.pe"] = torch.from_numpy(
        np.array(jax_positional_encoding(5000, MODEL["d_model"])))[None]
    want = JaxPipeline(jcfg, params, JaxTestConfig(**SERVE), raw_outputs=True)
    got = InferencePipeline(ModelConfig(**MODEL, attention_impl="pallas_full"), sd,
                            TestConfig(**SERVE), raw_outputs=True, device="cpu")
    return want, got


def _same_results(got, want):
    assert sum(len(r["labels"]) for r in want) > 0
    for a, b in zip(got, want, strict=True):
        assert a["video_id"] == b["video_id"] and a["duration"] == b["duration"]
        np.testing.assert_allclose(a["raw_logits"], b["raw_logits"], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
        np.testing.assert_allclose(a["segments"], b["segments"], atol=2e-3)


@pytest.mark.parametrize("pack", [False, True])
def test_long_video_slice_matches_jax_dense_stream_and_hbm_kernels(monkeypatch, pipelines,
                                                                   pack):
    """Buckets 128 / 256 / 512 at batch 2: one bucket per attention window."""
    _patch_long_t(monkeypatch)
    want_pipe, got_pipe = pipelines
    videos = _videos(4, [100, 200, 450, 60, 300, 129])
    kw = dict(buckets=LONG_BUCKETS, batch_size=2, pack=pack)
    _same_results(got_pipe.score_videos(videos, **kw), want_pipe.score_videos(videos, **kw))


@pytest.mark.parametrize("bucket", [256, 512])
def test_long_video_slice_shared_packed_rows_match_jax(monkeypatch, pipelines, bucket):
    """One bucket, short videos: packed rows hold several videos, so the
    packed-stream (256) and packed HBM (512) kernels sweep bounded ranges."""
    _patch_long_t(monkeypatch)
    want_pipe, got_pipe = pipelines
    videos = _videos(5, [90, 17, 140, 61, 33, 120, 75])
    kw = dict(buckets=(bucket,), batch_size=2, pack=True)
    _same_results(got_pipe.score_videos(videos, **kw), want_pipe.score_videos(videos, **kw))


# -- the CLI ------------------------------------------------------------------


def _tiny_yaml(tmp_path, buckets=LONG_BUCKETS) -> str:
    import yaml

    model = {k: v for k, v in MODEL.items() if k != "matmul_precision"}
    raw = {
        "model": model,
        "train": {"seed": 7, "batch_size": 1},
        "test_cfg": SERVE,
        "tpu": {"buckets": list(buckets), "attention_impl": "auto",
                "matmul_precision": "highest", "remat": True,
                "mesh": {"data": -1, "model": 1, "seq": 1}},
    }
    path = tmp_path / "tiny_long.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A reference-schema .pth of random JAX weights, with its config path."""
    tmp_path = tmp_path_factory.mktemp("tiny_ckpt")
    cfg_path = _tiny_yaml(tmp_path)
    jcfg = jax_load_config(cfg_path)
    params = JaxMMCT(jcfg.model).init_params(jax.random.key(3))
    ckpt = str(tmp_path / "tiny.pth")
    save_reference_checkpoint(ckpt, jax.device_get(params), jcfg.model)
    return cfg_path, ckpt


def _precision_lines(out: str) -> dict:
    lines = [x for x in out.splitlines() if x.startswith(("precision@tIoU=", "mean precision"))]
    assert len(lines) == 6, out
    return {x.split(":")[0]: float(x.split(":")[1]) for x in lines}


@pytest.mark.parametrize("pack", [False, True])
def test_cli_matches_root_inference_evaluate_dataset(monkeypatch, tmp_path, capsys,
                                                     tiny_ckpt, pack):
    """``--synthetic 6`` on long-video-style buckets, batch 1: the port CLI
    (streaming plain version past T = 128) against root inference.py's
    evaluate_dataset (plain attention) on the same .pth."""
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)
    cfg_path, ckpt = tiny_ckpt
    export = str(tmp_path / "clips.json")
    argv = ["--config_path", cfg_path, "--synthetic", "6", "--torch_ckpt", ckpt,
            "--device", "cpu", "--export", export] + (["--pack"] if pack else [])
    assert cli.main(argv) == 0
    got = _precision_lines(capsys.readouterr().out)

    jax_cli = _root_module("inference")
    jcfg = jax_load_config(cfg_path)
    durations = np.random.default_rng(0).integers(60, jcfg.train.buckets[-1], 6).tolist()
    ds = JaxSyntheticDataset(durations, jcfg.model, seed=3)
    results, offsets, per_thr = jax_cli.evaluate_dataset(
        ds, jcfg, jax_load_reference_checkpoint(ckpt, jcfg.model), pack=pack)
    want = {f"precision@tIoU={t}": float(np.mean(v)) for t, v in per_thr.items()}
    want["mean precision@tIoU"] = float(np.mean(list(want.values())))
    assert got == pytest.approx({k: round(v, 4) for k, v in want.items()}, abs=1e-9)

    clips = json.load(open(export))
    want_clips = jax_results_to_manifest(results, time_offsets=offsets)
    assert len(clips) == len(want_clips) > 0
    for a, b in zip(clips, want_clips):
        assert (a["video_id"], a["rank"]) == (b["video_id"], b["rank"])
        for key, tol in (("start", 0.011), ("end", 0.011), ("score", 2e-4)):
            assert abs(a[key] - b[key]) <= tol, (a, b)


def test_export_functions_equal_the_jax_package():
    rng = np.random.default_rng(1)
    results = [{"video_id": f"v{i}", "duration": 300, "time_offset": 12.0 * i,
                "segments": rng.uniform(-5, 320, (n, 2)).astype(np.float32),
                "scores": rng.uniform(0, 1, n).astype(np.float32)}
               for i, n in enumerate([0, 3, 7])]
    for kw in ({}, {"min_score": 0.3}, {"clamp_start": False}):
        got = results_to_manifest(results, **kw)
        assert got == jax_results_to_manifest(results, **kw)
    from repurpose_tpu.utils.export import ffmpeg_cut_commands as jax_cut

    clips = results_to_manifest(results)
    assert ffmpeg_cut_commands(clips, "in dir", "out") == jax_cut(clips, "in dir", "out")


def _golden_dataset(tmp_path):
    """The golden eval batch as an on-disk split: label JSON and .npy files."""
    data = np.load(GOLDEN_DIR / "tiny_trained.npz")
    meta = json.load(open(GOLDEN_DIR / "tiny_trained_decode.json"))
    dirs = {m: tmp_path / m for m in ("visual", "audio", "text")}
    for d in dirs.values():
        d.mkdir()
    entries = []
    for i, r in enumerate(meta["results"]):
        n = int(data["eval/lens"][i])
        for m, d in dirs.items():
            np.save(d / f"{r['video_id']}.npy", data[f"eval/{m}"][i, :n])
        gt = meta["gt_segments"][i]
        entries.append({"youtube_id": r["video_id"], "timeRange": [0, n],
                        "timeRangeOffset": [0, n], "segments": gt, "segmentsOffset": gt,
                        "coverage": 0.0})
    (tmp_path / "test.json").write_text(json.dumps(entries))
    split = DatasetConfig(label_path=str(tmp_path / "test.json"),
                          video_path=str(dirs["visual"]), audio_path=str(dirs["audio"]),
                          text_path=str(dirs["text"]))
    return split, meta


@pytest.mark.parametrize("pack", [False, True])
def test_cli_torch_ckpt_reproduces_the_reference_golden(tmp_path, capsys, pack):
    """The reference's trained tiny_trained.pth through ``run``: kept segments,
    scores and precision@tIoU of tiny_trained_decode.json."""
    split, meta = _golden_dataset(tmp_path)
    tiny = {k: v for k, v in MODEL.items() if k not in ("hidden_dim", "dropout")}
    cfg = Config(test_dataset=split, model=ModelConfig(**tiny, dropout=0.0),
                 train=TrainConfig(buckets=(128,), batch_size=2),
                 test_cfg=TestConfig(**meta["test_cfg"]))
    argv = ["--torch_ckpt", str(GOLDEN_DIR / "tiny_trained.pth"), "--device", "cpu"]
    means = cli.run(cfg, cli.parse_args(argv + (["--pack"] if pack else [])))
    got = _precision_lines(capsys.readouterr().out)
    for t in cli.TIOU_THRESHOLDS:
        want = float(np.mean([r["tiou"][str(t)] for r in meta["results"]]))
        assert means[t] == pytest.approx(want, abs=1e-6)
        assert got[f"precision@tIoU={t}"] == round(want, 4)

    params = cli.load_params(cli.parse_args(argv), cfg)
    results, _, _ = cli.evaluate_dataset(cli.build_dataset(cfg, 0), cfg, params, pack=pack,
                                         device="cpu")
    for r, g in zip(results, meta["results"], strict=True):
        assert r["video_id"] == g["video_id"]
        np.testing.assert_allclose(np.sort(r["scores"])[::-1], np.sort(g["scores"])[::-1],
                                   atol=1e-4)
        order, g_order = np.argsort(-r["scores"]), np.argsort(-np.asarray(g["scores"]))
        np.testing.assert_allclose(r["segments"][order], np.asarray(g["segments"])[g_order],
                                   atol=2e-3)


def test_cli_export_torch_writes_the_loaded_weights(tmp_path, capsys, tiny_ckpt):
    cfg_path, ckpt = tiny_ckpt
    out = str(tmp_path / "out.pth")
    assert cli.main(["--config_path", cfg_path, "--torch_ckpt", ckpt,
                     "--export_torch", out]) == 0
    assert "exported reference-schema checkpoint" in capsys.readouterr().out
    want = torch.load(ckpt, map_location="cpu", weights_only=True)["model"]
    got = torch.load(out, map_location="cpu", weights_only=True)["model"]
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], torch.as_tensor(want[k])) for k in want)


def test_cli_resume_reads_the_port_trainer_checkpoint(tmp_path, capsys, tiny_ckpt):
    """``--resume`` loads the model of the port trainer's latest checkpoint."""
    from repurpose_tpu_torch.models import build_model, load_reference_checkpoint
    from repurpose_tpu_torch.train.checkpoint import Checkpointer
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer

    cfg_path, ckpt = tiny_ckpt
    cfg = load_config(cfg_path)
    sd = load_reference_checkpoint(ckpt)
    ckpts = Checkpointer(str(tmp_path / "ckpt"))
    for step, seed in ((1, 5), (3, None)):  # the latest step is read
        model = build_model(cfg.model, "cpu", seed=seed or 0)
        if seed is None:
            model.load_state_dict(sd)
        ckpts.save(step, TrainState(model, make_optimizer(model, cfg.train, 1)[0], step))
    args = cli.parse_args(["--resume", str(tmp_path / "ckpt")])
    got = cli.load_params(args, cfg)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    random = cli.load_params(cli.parse_args([]), cfg)
    want = build_model(cfg.model, "cpu", seed=cfg.train.seed).state_dict()
    assert all(torch.equal(random[k], want[k]) for k in want)


def test_cli_defaults_to_cuda_and_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config_path", _tiny_yaml(tmp_path), "--synthetic", "2"])


# -- config and positional table ------------------------------------------------


def test_longvideo_config_matches_the_jax_package():
    """configs/longvideo.yaml: the same model, train and test fields as the
    JAX load_config (remat and the mesh load; inference ignores them), and
    chip_smoke.py's Python-built copy equals it."""
    path = str(ROOT / "configs" / "longvideo.yaml")
    cfg = load_config(path)
    assert cfg.to_dict() == jax_load_config(path).to_dict()
    assert cfg.train.buckets == (2048, 4096, 8192, 16384, 32768)
    assert cfg.train.batch_size == 1 and cfg.model.remat
    assert _root_module("chip_smoke").longvideo_config() == cfg


def test_synthetic_videos_are_the_jax_clis():
    """--synthetic N draws durations in [60, buckets[-1]) as inference.py does,
    into the same synthetic corpus."""
    path = str(ROOT / "configs" / "longvideo.yaml")
    narrow = dict(vis_dim=2, aud_dim=3, text_dim=2)
    cfg = load_config(path)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **narrow))
    got = cli.build_dataset(cfg, 4)
    jcfg = jax_load_config(path)
    durations = np.random.default_rng(0).integers(60, 32768, 4).tolist()
    want = JaxSyntheticDataset(durations, dataclasses.replace(jcfg.model, **narrow), seed=3)
    assert got.lengths() == want.lengths() and max(got.lengths()) > 2048
    for a, b in zip(got.samples, want.samples):
        assert a["video_id"] == b["video_id"] and a["gt_segments"] == b["gt_segments"]
        np.testing.assert_array_equal(a["visual"], b["visual"])


def test_positional_table_at_32768_matches_jax_within_float32_angle_rounding():
    """Measured: 6e-5 below position 2048, 2.4e-4 at 4096-8192, 9.8e-4 at
    16384-32768 (the ulp of a float32 angle near 32768 is 0.004, which the
    two ``sin`` implementations reduce differently)."""
    got = sinusoidal_positional_encoding(32768, 512).numpy()
    want = np.asarray(jax_positional_encoding(32768, 512))
    err = np.abs(got - want)
    print(f"max |PE - JAX PE|: {err[:2048].max():.3g} below 2048, {err.max():.3g} overall")
    assert err[:2048].max() <= 1e-4
    assert err.max() <= 1e-3
