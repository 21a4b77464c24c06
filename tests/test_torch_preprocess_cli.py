"""``python -m repurpose_tpu_torch.preprocess --device cpu`` against root
``preprocess.py`` (the JAX package's CLI), as subprocesses: ``--split``,
``--verify``, a ``--dataset`` run of the text step at MiniLM-L6's published
widths (random weights in an HF directory with a local BERT tokenizer,
cached transcripts, a fake ``ffprobe``), and ``--fanout``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

F32_ATOL = 1e-5  # the text step's embeddings, float32, port against JAX


def _run(argv, env=None, cwd=ROOT, jax=False):
    cmd = ([sys.executable, os.path.join(ROOT, "preprocess.py")] if jax
           else [sys.executable, "-m", "repurpose_tpu_torch.preprocess", "--device", "cpu"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **(env or {}))
    return subprocess.run(cmd + argv, capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=300)


def _json(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def test_split_matches_root_preprocess(tmp_path):
    src = tmp_path / "train.json"
    src.write_text(json.dumps([{"youtube_id": f"v{i}"} for i in range(7)]))
    outs = {}
    for name, jax in (("port", False), ("jax", True)):
        proc = _run(["--split", str(src), "--chunk-size", "3", "--out", str(tmp_path / name)],
                    jax=jax)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.strip() == f"wrote 3 chunks to {tmp_path / name}"
        outs[name] = {p: (tmp_path / name / p).read_text()
                      for p in sorted(os.listdir(tmp_path / name))}
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 4  # 3 chunks + manifest


def _text_dataset(tmp_path):
    """Two videos (fake files for ffprobe), their cached transcripts, and an
    HF MiniLM directory: seeded random weights at the published widths under
    BertModel's names, and a BERT tokenizer over a local vocabulary."""
    from repurpose_tpu_torch.extractors.minilm import MiniLMConfig

    videos = tmp_path / "videos"
    videos.mkdir()
    transcripts = tmp_path / "transcripts"
    transcripts.mkdir()
    segments = {
        "va": [{"start": 0.0, "end": 2.5, "text": "hello world"},
               {"start": 2.5, "end": 5.0, "text": "again, hello!"}],
        "vb": [{"start": 1.2, "end": 3.7, "text": "more words here"}],
    }
    durations = {"va": 6, "vb": 4}
    for vid, dur in durations.items():
        chip_smoke.write_fake_video(str(videos / f"{vid}.mp4"), dur, seed=0)
        (transcripts / f"{vid}.json").write_text(json.dumps(segments[vid]))
    ckpt = tmp_path / "minilm"
    ckpt.mkdir()
    (ckpt / "vocab.txt").write_text("\n".join([
        "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "hello", "world", "again", ",", "!",
        "more", "words", "here"]) + "\n")
    (ckpt / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "BertTokenizer", "do_lower_case": True, "model_max_length": 512}))
    sd = chip_smoke.random_checkpoint(chip_smoke.hf_bert_shapes(MiniLMConfig()), 0)
    torch.save(sd, ckpt / "pytorch_model.bin")
    dataset = tmp_path / "ds.json"
    dataset.write_text(json.dumps([{"youtube_id": v} for v in durations]))
    return dataset, videos, transcripts, ckpt, durations


def test_dataset_run_and_verify_match_root_preprocess(tmp_path):
    """``--dataset ... --steps text`` then ``--verify``, each CLI with its own
    config (YAML for the root one, JSON for the port's): the same summaries,
    the same report, the text features within float32 tolerance."""
    dataset, videos, transcripts, ckpt, durations = _text_dataset(tmp_path)
    env = {"PATH": chip_smoke.install_fake_ffmpeg(str(tmp_path / "bin"))}
    out = {}
    for name, jax in (("port", False), ("jax", True)):
        cfg = dict(video_dir=str(videos), transcript_dir=str(transcripts),
                   minilm_checkpoint=str(ckpt),
                   **{k: str(tmp_path / name / k) for k in ("visual_dir", "audio_dir",
                                                           "text_dir")})
        path = tmp_path / f"{name}.{'yaml' if jax else 'json'}"
        path.write_text(json.dumps(cfg))  # JSON is YAML too
        result = _json(_run(["--dataset", str(dataset), "--steps", "text", "--config",
                             str(path)], env, jax=jax))
        report = _json(_run(["--dataset", str(dataset), "--verify", "--config", str(path)],
                            env, jax=jax))
        feats = {v: np.load(os.path.join(cfg["text_dir"], f"{v}.npy")) for v in durations}
        out[name] = (result, report, feats)
    (result, report, feats), (jresult, jreport, jfeats) = out["port"], out["jax"]
    assert result == jresult and result["text"]["completed"] == 2
    assert report == jreport and report["text"] == {"ok": 2, "missing": 0, "corrupt": 0}
    for vid, dur in durations.items():
        assert feats[vid].shape == (dur, 384) and np.abs(feats[vid]).sum() > 0
        np.testing.assert_allclose(feats[vid], jfeats[vid], atol=F32_ATOL, rtol=0)


def test_fanout_dry_run_names_the_port_cli(tmp_path):
    from repurpose_tpu_torch.preprocessing.tools import split_dataset

    src = tmp_path / "train.json"
    src.write_text(json.dumps([{"youtube_id": f"v{i}"} for i in range(3)]))
    split_dataset(str(src), str(tmp_path / "chunks"), chunk_size=2)
    env = {k: v for k, v in os.environ.items() if k != "REPURPOSE_FANOUT_WORKER"}
    proc = subprocess.run(
        [sys.executable, "-m", "repurpose_tpu_torch.preprocess", "--device", "cpu", "--fanout",
         "2", "--splits-dir", str(tmp_path / "chunks"), "--dry-run", "--steps", "visual"],
        capture_output=True, text=True, env=dict(env, PYTHONPATH=ROOT), cwd=ROOT, timeout=300)
    summary = _json(proc)
    assert summary["would_run"] == 2
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("DRY RUN")]
    assert len(lines) == 2
    assert all("-m repurpose_tpu_torch.preprocess" in ln and "--device cpu" in ln
               and "preprocess.py" not in ln for ln in lines)


@pytest.mark.parametrize("argv,error", [
    ([], "--dataset is required"), (["--verify"], "--dataset is required"),
    (["--fanout", "2", "--splits-dir", "/nonexistent"], "no all chunk files"),
], ids=["nothing", "verify", "no-chunks"])
def test_usage_errors(argv, error, capsys):
    from repurpose_tpu_torch.preprocess import main

    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", *argv])
    assert exc.value.code == 2 and error in capsys.readouterr().err
