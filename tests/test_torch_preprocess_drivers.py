"""The port's three extraction drivers (``preprocessing/extract.py``) and
pipeline steps end to end against the JAX package's on the CPU: the same
tiny weights, videos read through a fake ``ffmpeg`` / ``ffprobe`` on PATH
(``chip_smoke.install_fake_ffmpeg``), the .npy files compared."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repurpose_tpu.extractors import clip_vit as jclip
from repurpose_tpu.extractors import cnn14 as jcnn
from repurpose_tpu.extractors import minilm as jmini
from repurpose_tpu.extractors import whisper_jax as wj
from repurpose_tpu.preprocessing import extract as jex
from repurpose_tpu.preprocessing import pipeline as jpipe
from repurpose_tpu_torch.extractors import clip_vit as tclip
from repurpose_tpu_torch.extractors import cnn14 as tcnn
from repurpose_tpu_torch.extractors import minilm as tmini
from repurpose_tpu_torch.extractors import whisper_torch as wt
from repurpose_tpu_torch.models.convert import extractor_state_dict_from_jax_params
from repurpose_tpu_torch.preprocessing import extract as tex
from repurpose_tpu_torch.preprocessing import pipeline as tpipe

from one_torch_thread import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

F32_ATOL = 1e-5  # the drivers' .npy files, float32, port against JAX

CLIP_CFG = dict(image_size=224, patch_size=32, width=32, layers=1, heads=2, projection_dim=16)
CNN_CFG = dict(n_mels=64, embed_dim=32, channels=(4, 8, 8, 16, 16, 32))
BERT_CFG = dict(width=384, layers=1, heads=12, intermediate=64, max_position=64)
VIDEOS = {"va": 3, "vb": 5}


def _jax_params(module, *example):
    params = jax.tree.map(np.asarray, module.init(jax.random.key(0), *example)["params"])
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map_with_path(  # non-trivial norms and biases
        lambda path, x: x + rng.normal(0, 0.05, x.shape).astype(np.float32)
        if path[-1].key in ("scale", "bias") else x, params)


class _Pipelines:
    """The JAX and the port pipeline on the same tiny weights, with the
    model classes patched to the tiny configs and the checkpoints handed in."""

    def __init__(self, tmp_path, monkeypatch, tiny):
        hf, jcfg, enc_p, dec_p = tiny
        jclip_cls = functools.partial(jclip.CLIPVisionEncoder,
                                      jclip.CLIPVisionConfig(**CLIP_CFG))
        jcnn_cls = functools.partial(jcnn.CNN14, jcnn.CNN14Config(**CNN_CFG))
        jmini_cls = functools.partial(jmini.MiniLMEncoder, jmini.MiniLMConfig(**BERT_CFG))
        for mod, name, cls in ((jclip, "CLIPVisionEncoder", jclip_cls), (jcnn, "CNN14", jcnn_cls),
                               (jmini, "MiniLMEncoder", jmini_cls)):
            monkeypatch.setattr(mod, name, cls)
        monkeypatch.setattr(tclip, "CLIPVisionEncoder", functools.partial(
            tclip.CLIPVisionEncoder, tclip.CLIPVisionConfig(**CLIP_CFG)))
        monkeypatch.setattr(tcnn, "CNN14", functools.partial(tcnn.CNN14,
                                                             tcnn.CNN14Config(**CNN_CFG)))
        monkeypatch.setattr(tmini, "MiniLMEncoder", functools.partial(
            tmini.MiniLMEncoder, tmini.MiniLMConfig(**BERT_CFG)))
        clip_p = _jax_params(jclip_cls(compute_dtype="float32"), jnp.zeros((1, 224, 224, 3)))
        cnn_p = _jax_params(jcnn_cls(compute_dtype="float32"), jnp.zeros((1, 69, 64)))
        mini_p = _jax_params(jmini_cls(), jnp.zeros((1, 8), jnp.int32),
                             jnp.ones((1, 8), jnp.int32))
        tok = chip_smoke.StubTokenizer()
        jasr = wj.WhisperASR(jcfg, enc_p, dec_p, tok, max_chunk_batch=2)
        wcfg = wt.config_from_hf(hf.config.to_dict())
        enc_sd, dec_sd = wt.convert_hf_whisper(hf.state_dict(), wcfg)
        tasr = wt.WhisperASR(wcfg, enc_sd, dec_sd, tok, max_chunk_batch=2, device="cpu")
        monkeypatch.setattr(wj.WhisperASR, "from_hf_dir", classmethod(lambda cls, *a, **k: jasr))
        carry = extractor_state_dict_from_jax_params

        def dirs(tag):
            return {k: str(tmp_path / tag / k) for k in (
                "visual_dir", "audio_dir", "text_dir", "transcript_dir")}

        video_dir = tmp_path / "videos"
        video_dir.mkdir()
        for i, (vid, dur) in enumerate(VIDEOS.items()):
            chip_smoke.write_fake_video(str(video_dir / f"{vid}.mp4"), dur, seed=i)
        common = dict(video_dir=str(video_dir), whisper_checkpoint="given")

        class J(jpipe.PreprocessingPipeline):
            def _clip_params(self):
                return clip_p

            def _panns_params(self):
                return cnn_p

            def _minilm(self):
                return mini_p, tok

        class T(tpipe.PreprocessingPipeline):
            def _clip_params(self):
                return carry(clip_p)

            def _panns_params(self):
                return carry(cnn_p)

            def _minilm(self):
                return carry(mini_p), tok

            def _asr(self):
                return tasr

        self.jax = J(jpipe.PreprocessConfig(**common, **dirs("jax")))
        self.port = T(tpipe.PreprocessConfig(**common, **dirs("port")), device="cpu")
        monkeypatch.setenv("PATH", chip_smoke.install_fake_ffmpeg(str(tmp_path / "bin")))


def test_drivers_match_jax_end_to_end(tmp_path, monkeypatch, tiny):
    """visual, audio and text (Whisper ASR -> bins -> MiniLM) through both
    pipelines on videos read by the fake ffmpeg, float32: the same summaries,
    the same transcripts, .npy files within the embeddings' tolerance."""
    p = _Pipelines(tmp_path, monkeypatch, tiny)
    for step in ("visual", "audio", "text"):
        # the JAX drivers run float32 here too (their default is bf16 for
        # CLIP and CNN14): the port's driver takes the same argument
        if step in ("visual", "audio"):
            cls = {"visual": (jex.VisualExtractor, tex.VisualExtractor),
                   "audio": (jex.AudioExtractor, tex.AudioExtractor)}[step]
            for c in cls:
                monkeypatch.setattr(c, "__init__", functools.partialmethod(
                    c.__init__, compute_dtype="float32"))
        want = getattr(p.jax, f"run_{step}")(list(VIDEOS))
        got = getattr(p.port, f"run_{step}")(list(VIDEOS))
        assert got == want and got["completed"] == len(VIDEOS), (step, got)
        d = {"visual": "visual_dir", "audio": "audio_dir", "text": "text_dir"}[step]
        for vid, dur in VIDEOS.items():
            g = np.load(os.path.join(getattr(p.port.cfg, d), f"{vid}.npy"))
            w = np.load(os.path.join(getattr(p.jax.cfg, d), f"{vid}.npy"))
            assert g.shape == w.shape and g.shape[0] == dur, (step, vid)
            np.testing.assert_allclose(g, w, atol=F32_ATOL, rtol=0, err_msg=f"{step} {vid}")
    for vid in VIDEOS:
        with open(os.path.join(p.port.cfg.transcript_dir, f"{vid}.json")) as f:
            got = json.load(f)
        with open(os.path.join(p.jax.cfg.transcript_dir, f"{vid}.json")) as f:
            assert got == json.load(f) and got
    # the bf16 drivers (the default) run too, within a cosine of the JAX bf16
    got = tex.AudioExtractor(p.port._panns_params(), device="cpu").extract(
        os.path.join(p.port.cfg.video_dir, "vb.mp4"))
    want = jex.AudioExtractor(p.jax._panns_params()).extract(
        os.path.join(p.jax.cfg.video_dir, "vb.mp4"))
    cos = (got * want).sum(-1) / np.linalg.norm(got, axis=-1) / np.linalg.norm(want, axis=-1)
    assert cos.min() >= 0.999


def test_audio_fallback_driver_matches_jax(tmp_path, monkeypatch):
    """Without a CNN14 checkpoint both drivers take the DSP features."""
    monkeypatch.setenv("PATH", chip_smoke.install_fake_ffmpeg(str(tmp_path / "bin")))
    chip_smoke.write_fake_video(str(tmp_path / "v.mp4"), 3, seed=5)
    got = tex.AudioExtractor(None, device="cpu").extract(str(tmp_path / "v.mp4"))
    want = jex.AudioExtractor(None).extract(str(tmp_path / "v.mp4"))
    assert got.shape == (3, 2048)
    scale = np.abs(want).max(axis=0, keepdims=True) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, rtol=0)


