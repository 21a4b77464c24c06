"""The port's preprocessing (``repurpose_tpu_torch/preprocessing/``) against
the JAX package's on the CPU: media through a fake ``ffmpeg`` on PATH,
progress, the downloader with a fake ``ydl``, the tools, the fan-out with a
fake worker, text binning on the reference golden, the text extractor's
host ASR fallbacks, and the extractor bench at shrunken constants. The
drivers end to end are in test_torch_preprocess_drivers.py, the CLI in
test_torch_preprocess_cli.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repurpose_tpu.preprocessing import downloader as jdl
from repurpose_tpu.preprocessing import extract as jex
from repurpose_tpu.preprocessing import media as jmedia
from repurpose_tpu.preprocessing import pipeline as jpipe
from repurpose_tpu.preprocessing import progress as jprog
from repurpose_tpu.preprocessing import tools as jtools
from repurpose_tpu_torch.extractors import clip_vit as tclip
from repurpose_tpu_torch.extractors import cnn14 as tcnn
from repurpose_tpu_torch.extractors import minilm as tmini
from repurpose_tpu_torch.extractors import whisper_torch as wt
from repurpose_tpu_torch.preprocessing import downloader as tdl
from repurpose_tpu_torch.preprocessing import extract as tex
from repurpose_tpu_torch.preprocessing import fanout as tfan
from repurpose_tpu_torch.preprocessing import media as tmedia
from repurpose_tpu_torch.preprocessing import pipeline as tpipe
from repurpose_tpu_torch.preprocessing import progress as tprog
from repurpose_tpu_torch.preprocessing import tools as ttools

from one_torch_thread import one_torch_thread  # noqa: F401  (autouse)
from test_media import SHIM_TEMPLATE  # the media tests' fake ffmpeg / ffprobe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def media_shim(tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for kind in ("ffmpeg", "ffprobe"):
        p = bin_dir / kind
        p.write_text(SHIM_TEMPLATE.format(python=sys.executable, kind=kind))
        p.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.delenv("FAKE_FF_MODE", raising=False)
    monkeypatch.delenv("FAKE_FF_ARGV_LOG", raising=False)
    return monkeypatch


def test_media_through_the_fake_ffmpeg_matches_jax(media_shim, tmp_path):
    assert tmedia.have_ffmpeg() is True
    assert tmedia.probe_duration("clip.mp4") == jmedia.probe_duration("clip.mp4") == 123.456
    media_shim.setenv("FAKE_FF_FRAMES", "5")
    got = list(tmedia.frames_1fps("clip.mp4", width=16, height=8))
    want = list(jmedia.frames_1fps("clip.mp4", width=16, height=8))
    assert len(got) == 5 and all((g == w).all() for g, w in zip(got, want))
    np.testing.assert_array_equal(tmedia.load_audio("clip.mp4", sr=22050),
                                  jmedia.load_audio("clip.mp4", sr=22050))
    media_shim.setenv("FAKE_FF_MODE", "midstream_fail")
    media_shim.setenv("FAKE_FF_FRAMES", "2")
    gen = tmedia.frames_1fps("clip.mp4", width=16, height=8)
    next(gen), next(gen)
    with pytest.raises(RuntimeError, match="truncated frame sequence"):
        next(gen)
    media_shim.setenv("FAKE_FF_MODE", "fail")
    with pytest.raises(subprocess.CalledProcessError):
        tmedia.load_audio("clip.mp4")
    with pytest.raises(subprocess.CalledProcessError):
        tmedia.probe_duration("clip.mp4")
    for name in ("v.webm", "v.mp4"):
        (tmp_path / name).write_bytes(b"x")
        assert tmedia.find_video_file(str(tmp_path), "v") == jmedia.find_video_file(
            str(tmp_path), "v") == str(tmp_path / name)
    wave = np.arange(10, dtype=np.float32)
    np.testing.assert_array_equal(tmedia.chunk_waveform(wave, 4), jmedia.chunk_waveform(wave, 4))


@pytest.mark.parametrize("msg", [
    "ERROR: Private video. Sign in if you've been granted access",
    "Video unavailable. This video has been removed",
    "account associated with this video has been terminated",
    "requested format is not available", "blocked due to copyright claim",
    "Sign in to confirm you're not a bot", "urlopen error timed out", "something exotic",
])
def test_error_categories_match_jax(msg):
    got, want = tprog.categorize_error(msg), jprog.categorize_error(msg)
    assert got.value == want.value and got.retryable == want.retryable


def test_progress_tracker_persistence(tmp_path):
    path = str(tmp_path / "progress.json")
    t1 = tprog.ProgressTracker(path, total=3)
    t1.mark_completed("a")
    t1.mark_failed("b", "Private video")
    t1.mark_failed("c", "connection reset")
    t2 = tprog.ProgressTracker(path, total=3)
    assert t2.is_done("a") and not t2.should_retry("b") and t2.should_retry("c")
    assert t2.summary() == jprog.ProgressTracker(path, total=3).summary()
    assert t2.summary()["by_category"] == {"private": 1, "network": 1}


class _FakeYDL:
    """Scriptable yt-dlp stand-in: outcomes[video_id] = exceptions / None per
    attempt."""

    outcomes: dict = {}
    attempts: dict = {}
    out_dir: str = ""

    def __init__(self, opts):
        self.opts = opts

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def download(self, urls):
        vid = urls[0].split("v=")[1]
        n = _FakeYDL.attempts.get(vid, 0)
        _FakeYDL.attempts[vid] = n + 1
        plan = _FakeYDL.outcomes.get(vid, [None])
        result = plan[min(n, len(plan) - 1)]
        if result is not None:
            raise result
        with open(os.path.join(_FakeYDL.out_dir, f"{vid}.mp4"), "w") as f:
            f.write("x")


@pytest.mark.parametrize("module", [tdl, jdl], ids=["port", "jax"])
def test_downloader_with_a_fake_ydl(module, tmp_path, monkeypatch):
    """Success, resume, a transient failure retried, a permanent one not; the
    port's summaries equal the JAX downloader's."""
    monkeypatch.setattr(module.time, "sleep", lambda s: None)
    _FakeYDL.outcomes = {"v2": [RuntimeError("connection timed out"), None],
                         "v3": [RuntimeError("Private video")]}
    _FakeYDL.attempts = {}
    _FakeYDL.out_dir = str(tmp_path)
    dl = module.VideoDownloader(str(tmp_path), max_workers=2, max_retries=3, rate_limit_s=0.0,
                                ydl_factory=_FakeYDL)
    summary = dl.download_dataset(["v1", "v2", "v3"])
    assert (summary["completed"], summary["failed"]) == (2, 1)
    assert summary["by_category"] == {"private": 1}
    assert _FakeYDL.attempts == {"v1": 1, "v2": 2, "v3": 1}
    before = dict(_FakeYDL.attempts)
    assert dl.download_dataset(["v1", "v2", "v3"])["completed"] == 2
    assert _FakeYDL.attempts == before  # resumed: nothing fetched again
    assert dl._opts("v1") == {**jdl.VideoDownloader(
        str(tmp_path), ydl_factory=_FakeYDL)._opts("v1")}


def test_downloader_needs_yt_dlp_or_a_factory(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    with pytest.raises(ImportError, match="yt-dlp"):
        tdl.VideoDownloader(str(tmp_path))


def test_tools_match_jax(tmp_path):
    entries = [{"youtube_id": f"v{i}"} for i in range(7)]
    src = tmp_path / "train.json"
    src.write_text(json.dumps(entries))
    got = ttools.split_dataset(str(src), str(tmp_path / "a"), chunk_size=3)
    want = jtools.split_dataset(str(src), str(tmp_path / "b"), chunk_size=3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        assert open(g).read() == open(w).read()
    for d in ("vis", "aud", "txt"):
        (tmp_path / d).mkdir()
    np.save(tmp_path / "vis" / "a.npy", np.zeros((100, 4), np.float32))
    np.save(tmp_path / "aud" / "a.npy", np.zeros((100, 8), np.float32))
    np.save(tmp_path / "txt" / "a.npy", np.zeros((50, 2), np.float32))
    dirs = [str(tmp_path / d) for d in ("vis", "aud", "txt")]
    report = ttools.inspect_features(["a", "missing"], *dirs)
    assert report == jtools.inspect_features(["a", "missing"], *dirs)
    assert report["mismatched"] == ["a"]
    d = tmp_path / "feats"
    d.mkdir()
    np.save(d / "good.npy", np.zeros((120, 4), np.float32))
    np.save(d / "trunc.npy", np.zeros((1800, 4), np.float32))
    (d / "visual_progress.json").write_text(json.dumps(
        {"status": {"good": "completed", "trunc": "completed"}, "errors": {}}))
    assert ttools.cleanup_truncated([str(d)], dry_run=True)["count"] == 1
    out = ttools.cleanup_truncated([str(d)])
    assert out["count"] == 1 and not (d / "trunc.npy").exists() and (d / "good.npy").exists()
    assert "trunc" not in json.loads((d / "visual_progress.json").read_text())["status"]


def test_verify_features_matches_jax(tmp_path):
    kw = {k: str(tmp_path / k) for k in ("video_dir", "visual_dir", "audio_dir", "text_dir",
                                         "transcript_dir")}
    port = tpipe.PreprocessingPipeline(tpipe.PreprocessConfig(**kw), device="cpu")
    ds = tmp_path / "ds.json"
    ds.write_text(json.dumps([{"youtube_id": v} for v in ("a", "b", "c")]))
    for d in ("visual_dir", "audio_dir", "text_dir"):
        np.save(os.path.join(kw[d], "a.npy"), np.zeros((10, 4), np.float32))
    np.save(os.path.join(kw["visual_dir"], "b.npy"), np.zeros((0, 4), np.float32))
    with open(os.path.join(kw["audio_dir"], "b.npy"), "w") as f:
        f.write("not a .npy")
    report = port.verify_features(str(ds))
    assert report == jpipe.PreprocessingPipeline(jpipe.PreprocessConfig(**kw)).verify_features(
        str(ds))
    assert report["visual"] == {"ok": 1, "missing": 1, "corrupt": 1}
    assert report["complete_all_modalities"] == 1
    with pytest.raises(ValueError, match="unknown steps"):
        port.process_dataset(str(ds), ["visual", "vsiual"])


def test_text_binning_and_clean_text_match_the_golden():
    with open(os.path.join(ROOT, "tests", "golden", "text_binning.json")) as f:
        cases = json.load(f)
    assert len(cases) >= 8
    for c in cases:
        assert tex.bin_transcript_per_second(c["segments"], c["duration"]) == c["bins"]
    for text in ("  multi\n\nline\t text  ", "it's a—dash; test: 50% off @home",
                 "Hello,   WORLD!!", "@#$%^&*", ""):
        assert tex.clean_text(text) == jex.clean_text(text)
    segments = [{"start": 0.5, "end": 4.0, "text": "alpha beta gamma",
                 "words": [{"word": "alpha", "start": 0.5, "end": 0.9},
                           {"word": "beta", "start": 1.2, "end": 2.8},
                           {"word": "gamma", "start": 3.1, "end": 3.4}]}]
    for word_level in (False, True):
        assert (tex.bin_transcript_per_second(segments, 5, word_level)
                == jex.bin_transcript_per_second(segments, 5, word_level))


# -- fan-out ---------------------------------------------------------------------------

FAKE_WORKER = """\
import json, os, sys
chunk = sys.argv[1]
with open(os.environ["FAKE_ARGV_LOG"], "a") as f:
    f.write(json.dumps(sys.argv[1:]) + "\\n")
entries = json.load(open(chunk))
sys.exit(1 if any(e.get("fail") for e in entries) else 0)
"""


@pytest.fixture
def splits(tmp_path, monkeypatch):
    entries = [{"youtube_id": f"vid{i}"} for i in range(5)]
    entries[3]["fail"] = True  # lands in train chunk 1
    src = tmp_path / "train.json"
    src.write_text(json.dumps(entries))
    ttools.split_dataset(str(src), str(tmp_path / "chunks"), chunk_size=2)
    worker = tmp_path / "fake_worker.py"
    worker.write_text(FAKE_WORKER)
    argv_log = tmp_path / "argv.jsonl"
    argv_log.touch()
    monkeypatch.setenv(tfan.WORKER_ENV, f"{sys.executable} {worker} {{chunk}}")
    monkeypatch.setenv("FAKE_ARGV_LOG", str(argv_log))
    return tmp_path / "chunks", argv_log


def test_fanout_markers_resume_and_retry(splits):
    chunks_dir, argv_log = splits
    chunks = tfan.find_chunks(str(chunks_dir), "train")
    assert len(chunks) == 3 and tfan.find_chunks(str(chunks_dir), "val") == []
    s = tfan.run_fanout(chunks, ["visual"], workers=2)
    assert (s["requested"], s["succeeded"], s["failed"]) == (3, 2, 1)
    assert json.loads((chunks_dir / "train_chunk_0001_FAILED").read_text())["rc"] == 1
    assert {json.loads(line)[0] for line in argv_log.read_text().splitlines()} == set(chunks)
    argv_log.write_text("")
    s = tfan.run_fanout(chunks, ["visual"])
    assert s["run"] == 0 and s["skipped"] == 3 and argv_log.read_text() == ""
    s = tfan.run_fanout(chunks, ["visual"], retry_failed=True, limit=2)
    assert (s["requested"], s["run"], s["failed"], s["skipped"]) == (3, 1, 1, 1)


def test_default_worker_is_the_port_cli(splits, monkeypatch, capsys):
    """Without the override the worker is ``python -m
    repurpose_tpu_torch.preprocess`` with ``--device`` passed through, never
    root ``preprocess.py``; a dry run prints it and runs nothing."""
    chunks_dir, argv_log = splits
    monkeypatch.delenv(tfan.WORKER_ENV)
    chunk = str(chunks_dir / "train_chunk_0000.json")
    cmd = tfan._worker_cmd(chunk, ["visual", "audio"], "cfg.json", "cpu")
    assert cmd == [sys.executable, "-m", "repurpose_tpu_torch.preprocess", "--dataset", chunk,
                   "--steps", "visual", "audio", "--device", "cpu", "--config", "cfg.json"]
    assert not any(a.endswith("preprocess.py") for a in cmd)
    assert tfan._worker_env()["PYTHONPATH"].split(os.pathsep)[0] == ROOT
    s = tfan.run_fanout([chunk], ["visual"], dry_run=True, device="cpu")
    assert s["would_run"] == 1 and argv_log.read_text() == ""
    out = capsys.readouterr().out
    assert "-m repurpose_tpu_torch.preprocess" in out and "--device cpu" in out


def test_fanout_runs_the_port_cli_as_its_worker(splits, monkeypatch, tmp_path):
    """The real default worker on a chunk whose videos are missing: each
    worker starts the port's CLI on the CPU, which records the failures and
    exits 0, and the fan-out writes SUCCESS markers."""
    chunks_dir, _ = splits
    monkeypatch.delenv(tfan.WORKER_ENV)
    monkeypatch.chdir(tmp_path)  # -m finds the package through PYTHONPATH
    chunk = str(chunks_dir / "train_chunk_0002.json")
    s = tfan.run_fanout([chunk], ["download"], device="cpu")
    log = open(s["results"][0]["log"]).read()
    assert s["failed"] == 1 and "yt-dlp is not installed" in log, log[-2000:]
    assert log.startswith(f"+ {sys.executable} -m repurpose_tpu_torch.preprocess")


def test_text_extractor_whisperx_path_is_the_jax_ones(tmp_path, monkeypatch):
    """The whisperx backend: the reference's call sequence, the segments
    cached (a second call runs no ASR)."""
    import types

    calls = []
    fake = types.ModuleType("whisperx")
    fake.load_model = lambda name, device: types.SimpleNamespace(transcribe=lambda audio: (
        calls.append("transcribe"),
        {"language": "en", "segments": [{"start": 0.0, "end": 2.0, "text": "raw"}]})[1])
    fake.load_audio = lambda p: (calls.append("load_audio"), "AUDIO")[1]
    fake.load_align_model = lambda language_code, device: (
        calls.append(f"align_model:{language_code}"), ("ALIGN", {}))[1]
    fake.align = lambda segs, model_a, metadata, audio, device: (
        calls.append("align"),
        {"segments": [{"start": 0.1, "end": 1.9, "text": "aligned", "words": []}]})[1]
    monkeypatch.setitem(sys.modules, "whisperx", fake)
    cache = tmp_path / "t.json"
    segments = tex.TextExtractor.transcribe("fake.wav", str(cache), backend="whisperx")
    assert segments == [{"start": 0.1, "end": 1.9, "text": "aligned"}]
    assert calls == ["load_audio", "transcribe", "align_model:en", "align"]
    calls.clear()
    assert tex.TextExtractor.transcribe("fake.wav", str(cache), backend="whisperx") == segments
    assert calls == []
    monkeypatch.setitem(sys.modules, "whisper", None)
    with pytest.raises(ImportError, match="neither whisperx nor openai-whisper"):
        tex.TextExtractor.transcribe("fake.wav", None, backend="whisper")


def test_bench_extractors_prints_its_line_on_the_cpu(monkeypatch, capsys):
    from repurpose_tpu_torch.tools import bench_extractors as be

    for name, value in dict(
            CLIP_CONFIG=tclip.CLIPVisionConfig(image_size=64, patch_size=32, width=32, layers=1,
                                               heads=2, projection_dim=16), CLIP_BATCH=2,
            CNN14_CONFIG=tcnn.CNN14Config(embed_dim=32, channels=(4, 8, 8, 16, 16, 32)),
            CNN14_BATCH=2,
            MINILM_CONFIG=tmini.MiniLMConfig(vocab_size=100, width=32, layers=1, heads=2,
                                             intermediate=64, max_position=16),
            MINILM_BATCH=2, MINILM_TOKENS=8,
            WHISPER_CONFIG=wt.WhisperConfig(d_model=16, enc_layers=1, dec_layers=1, heads=2,
                                            d_ff=32, max_target_positions=12),
            WHISPER_CHUNKS=1, ALIGN_TOKENS=4, REPEATS=1, WHISPER_REPEATS=1).items():
        monkeypatch.setattr(be, name, value)
    line = be.main(["--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == line
    assert last["metric"] == "preprocess_video_seconds_per_s_per_chip"
    assert last["unit"] == "video-seconds/s/chip" and last["detail"]["device"].startswith("cpu")
    for key in ("clip_frames_per_s", "cnn14_audio_s_per_s", "minilm_sentences_per_s",
                "whisper_audio_s_per_s", "whisper_beam5_audio_s_per_s",
                "aligner_audio_s_per_s", "video_seconds_per_s_per_chip"):
        assert last["detail"][key] > 0, key
    assert last["detail"]["a100_video_seconds_per_s"] == round(
        be.composite_video_seconds_per_s(be.A100_REFERENCE), 1)
