"""The port's CLIP ViT, CNN14 and MiniLM extractors against the JAX
package's on the CPU: the same weights (the JAX params carried across by
``extractor_state_dict_from_jax_params``), float32 and bf16; the HF / PANNs
converters against the JAX converters array for array; and the HF models
themselves. Tiny configs, as ``tests/test_extractors.py`` builds them."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.extractors import clip_vit as jclip
from repurpose_tpu.extractors import cnn14 as jcnn
from repurpose_tpu.extractors import minilm as jmini
from repurpose_tpu_torch.extractors import clip_vit as tclip
from repurpose_tpu_torch.extractors import cnn14 as tcnn
from repurpose_tpu_torch.extractors import minilm as tmini
from repurpose_tpu_torch.models.convert import extractor_state_dict_from_jax_params

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

# float32: max |port - JAX| on the L2-normalised embeddings (CNN14's are not
# normalised; its tiny config's are below 1). bf16 against JAX bf16: the
# two round the same products at different points (a fused bias add, the
# pooling sums), so each row's cosine is held instead, >= 0.999.
F32_ATOL = 1e-5
BF16_COS = 0.999

CLIP_CFG = dict(image_size=32, patch_size=16, width=64, layers=2, heads=4, projection_dim=48)
BERT_CFG = dict(vocab_size=120, width=32, layers=2, heads=4, intermediate=64, max_position=40)
CNN_CFG = dict(n_mels=64, embed_dim=64, channels=(8, 16, 32, 64, 128, 256))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cos_rows(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.linalg.norm(a, axis=-1) / np.linalg.norm(b, axis=-1)


def _clip_case(seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**CLIP_CFG), compute_dtype="float32")
    params = _np(jm.init(jax.random.key(seed), jnp.asarray(imgs))["params"])
    # non-trivial LayerNorm affines and biases (init leaves them 1 / 0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.05, x.shape).astype(np.float32)
        if path[-1].key in ("scale", "bias") else x, params)
    return imgs, params


def _jax_clip(params, imgs, dtype):
    jm = jclip.CLIPVisionEncoder(jclip.CLIPVisionConfig(**CLIP_CFG), compute_dtype=dtype)
    return np.asarray(jm.apply({"params": params}, jnp.asarray(imgs)))


def _port(cls, cfg_cls, cfg, params, dtype):
    m = cls(cfg_cls(**cfg), compute_dtype=dtype)
    m.load_state_dict(extractor_state_dict_from_jax_params(params), strict=True)
    return m.eval()


def _minilm_case(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 120, (3, 16))
    mask = np.ones((3, 16), np.int64)
    mask[0, 10:] = 0
    mask[2, 3:] = 0
    jm = jmini.MiniLMEncoder(jmini.MiniLMConfig(**BERT_CFG))
    params = _np(jm.init(jax.random.key(seed), jnp.asarray(ids), jnp.asarray(mask))["params"])
    return ids, mask, params


def _jax_minilm(params, ids, mask, dtype):
    jm = jmini.MiniLMEncoder(jmini.MiniLMConfig(**BERT_CFG), compute_dtype=dtype)
    return np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))


class _TorchCnn14(torch.nn.Module):
    """Minimal torch replica of PANNs Cnn14 after the frontend (the layout of
    a PANNs checkpoint, as tests/test_extractors.py builds it)."""

    def __init__(self, n_mels=64, channels=CNN_CFG["channels"], embed=64):
        super().__init__()
        self.bn0 = torch.nn.BatchNorm2d(n_mels)
        in_ch = 1
        for i, ch in enumerate(channels, 1):
            blk = torch.nn.Module()
            blk.conv1 = torch.nn.Conv2d(in_ch, ch, 3, padding=1, bias=False)
            blk.bn1 = torch.nn.BatchNorm2d(ch)
            blk.conv2 = torch.nn.Conv2d(ch, ch, 3, padding=1, bias=False)
            blk.bn2 = torch.nn.BatchNorm2d(ch)
            setattr(self, f"conv_block{i}", blk)
            in_ch = ch
        self.fc1 = torch.nn.Linear(channels[-1], embed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.5)
                    m.running_var.uniform_(0.5, 2.0)

    def forward(self, mel):  # [B, T, mel]
        x = mel[:, None]
        x = self.bn0(x.transpose(1, 3)).transpose(1, 3)
        for i in range(1, 7):
            blk = getattr(self, f"conv_block{i}")
            x = torch.relu(blk.bn1(blk.conv1(x)))
            x = torch.relu(blk.bn2(blk.conv2(x)))
            if i < 6:
                x = torch.nn.functional.avg_pool2d(x, (2, 2))
        x = x.mean(dim=3)
        x = x.max(dim=2).values + x.mean(dim=2)
        return torch.relu(self.fc1(x))


def _panns_sd(seed=2):
    torch.manual_seed(seed)
    return {f"module.{k}": v for k, v in _TorchCnn14().eval().state_dict().items()}


def _jax_cnn14(params, wave, dtype):
    jm = jcnn.CNN14(jcnn.CNN14Config(**CNN_CFG), compute_dtype=dtype)
    from repurpose_tpu.extractors.audio_frontend import logmel

    return np.asarray(jm.apply({"params": params}, logmel(jnp.asarray(wave))))


def _waves(seed=3):
    return np.random.default_rng(seed).normal(0, 0.3, (3, 22050)).astype(np.float32)


def test_clip_matches_jax_float32_and_bf16():
    imgs, params = _clip_case()
    m = _port(tclip.CLIPVisionEncoder, tclip.CLIPVisionConfig, CLIP_CFG, params, "float32")
    got = m(torch.from_numpy(imgs)).detach().numpy()
    np.testing.assert_allclose(got, _jax_clip(params, imgs, "float32"), atol=F32_ATOL, rtol=0)
    m.compute_dtype = "bfloat16"
    got16 = m(torch.from_numpy(imgs)).detach().numpy()
    assert _cos_rows(got16, _jax_clip(params, imgs, "bfloat16")).min() >= BF16_COS


def test_minilm_matches_jax_float32_and_bf16():
    ids, mask, params = _minilm_case()
    m = _port(tmini.MiniLMEncoder, tmini.MiniLMConfig, BERT_CFG, params, "float32")
    got = m(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, _jax_minilm(params, ids, mask, "float32"), atol=F32_ATOL,
                               rtol=0)
    m.compute_dtype = "bfloat16"
    got16 = m(torch.from_numpy(ids), torch.from_numpy(mask)).detach().numpy()
    assert _cos_rows(got16, _jax_minilm(params, ids, mask, "bfloat16")).min() >= BF16_COS


def test_cnn14_matches_jax_float32_and_bf16():
    """On waveforms: the port's log-mel and CNN14 against the JAX
    ``logmel`` and CNN14, PANNs weights converted by each framework."""
    params = _np(jcnn.convert_panns_cnn14(
        {k: v.numpy() for k, v in _panns_sd().items()}))
    wave = _waves()
    m = _port(tcnn.CNN14, tcnn.CNN14Config, CNN_CFG, params, "float32")
    with torch.no_grad():
        got = tcnn.embed_waveform_chunks(m, torch.from_numpy(wave)).numpy()
    want = _jax_cnn14(params, wave, "float32")
    assert want.max() > 0
    np.testing.assert_allclose(got, want, atol=F32_ATOL * max(1.0, np.abs(want).max()), rtol=0)
    m.compute_dtype = "bfloat16"
    with torch.no_grad():
        got16 = tcnn.embed_waveform_chunks(m, torch.from_numpy(wave)).numpy()
    assert _cos_rows(got16, _jax_cnn14(params, wave, "bfloat16")).min() >= BF16_COS


def _assert_same_state(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def _hf_clip(seed=0):
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    return CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=64, intermediate_size=256, num_hidden_layers=2, num_attention_heads=4,
        image_size=32, patch_size=16, projection_dim=48, hidden_act="quick_gelu")).eval()


def _hf_bert(seed=1):
    from transformers import BertConfig, BertModel

    torch.manual_seed(seed)
    return BertModel(BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, max_position_embeddings=40, layer_norm_eps=1e-12),
        add_pooling_layer=False).eval()


def test_hf_route_equals_jax_route_array_for_array():
    """HF -> port and HF -> JAX -> carried across give the same arrays, for
    CLIP, MiniLM and PANNs CNN14 (checkpoint tensors or numpy arrays in)."""
    hf = _hf_clip().state_dict()
    cfg = tclip.CLIPVisionConfig(**CLIP_CFG)
    port = tclip.convert_hf_clip_vision(hf, cfg)
    via_jax = extractor_state_dict_from_jax_params(jclip.convert_hf_clip_vision(
        {k: v.numpy() for k, v in hf.items()}, jclip.CLIPVisionConfig(**CLIP_CFG)))
    _assert_same_state(port, via_jax)
    tclip.CLIPVisionEncoder(cfg).load_state_dict(port, strict=True)

    hf = _hf_bert().state_dict()
    port = tmini.convert_hf_bert({k: v.numpy() for k, v in hf.items()},
                                 tmini.MiniLMConfig(**BERT_CFG))
    via_jax = extractor_state_dict_from_jax_params(jmini.convert_hf_bert(
        {k: v.numpy() for k, v in hf.items()}, jmini.MiniLMConfig(**BERT_CFG)))
    _assert_same_state(port, via_jax)

    sd = _panns_sd()
    port = tcnn.convert_panns_cnn14(sd)
    via_jax = extractor_state_dict_from_jax_params(jcnn.convert_panns_cnn14(
        {k: v.numpy() for k, v in sd.items()}))
    _assert_same_state(port, via_jax)


def test_clip_and_minilm_match_the_hf_models():
    hf = _hf_clip()
    rng = np.random.default_rng(0)
    imgs = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy())).image_embeds
        want = (want / want.norm(dim=-1, keepdim=True)).numpy()
        m = tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(**CLIP_CFG), "float32")
        m.load_state_dict(tclip.convert_hf_clip_vision(hf.state_dict(), m.cfg))
        np.testing.assert_allclose(m(torch.from_numpy(imgs)).numpy(), want, atol=2e-5, rtol=0)

    hf = _hf_bert()
    ids = torch.from_numpy(rng.integers(0, 120, (2, 16)))
    mask = torch.ones((2, 16), dtype=torch.long)
    mask[0, 10:] = 0
    with torch.no_grad():
        hidden = hf(input_ids=ids, attention_mask=mask).last_hidden_state
        mf = mask[..., None].float()
        want = (hidden * mf).sum(1) / mf.sum(1)
        want = (want / want.norm(dim=-1, keepdim=True)).numpy()
        m = tmini.MiniLMEncoder(tmini.MiniLMConfig(**BERT_CFG))
        m.load_state_dict(tmini.convert_hf_bert(hf.state_dict(), m.cfg))
        np.testing.assert_allclose(m(ids, mask).numpy(), want, atol=2e-5, rtol=0)


def test_cnn14_matches_the_panns_replica():
    tm = _TorchCnn14().eval()
    mel = np.random.default_rng(4).normal(0, 3, (2, 64, 64)).astype(np.float32)
    m = tcnn.CNN14(tcnn.CNN14Config(**CNN_CFG), "float32")
    m.load_state_dict(tcnn.convert_panns_cnn14(tm.state_dict()))
    with torch.no_grad():
        np.testing.assert_allclose(m(torch.from_numpy(mel)).numpy(),
                                   tm(torch.from_numpy(mel)).numpy(), atol=3e-4, rtol=1e-4)


def test_preprocess_frames_equals_jax():
    frames = np.random.default_rng(6).integers(0, 255, (2, 240, 320, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tclip.preprocess_frames(frames),
                                  jclip.preprocess_frames(frames))
    tall = frames.transpose(0, 2, 1, 3).copy()
    np.testing.assert_array_equal(tclip.preprocess_frames(tall), jclip.preprocess_frames(tall))


@pytest.mark.parametrize("kind", ["clip", "bert", "panns", "whisper"])
def test_smoke_checkpoint_names_are_the_published_ones(kind, tiny):
    """``chip_smoke.py`` phase 18 writes random checkpoints by name and shape
    (no transformers on the card's machine): every name is the real model's,
    with its shape, and the port's converter loads them strictly."""
    from repurpose_tpu_torch.extractors import whisper_torch as wt

    if kind == "clip":
        real = _hf_clip().state_dict()
        shapes = chip_smoke.hf_clip_vision_shapes(tclip.CLIPVisionConfig(**CLIP_CFG))
        convert = lambda sd: tclip.convert_hf_clip_vision(  # noqa: E731
            sd, tclip.CLIPVisionConfig(**CLIP_CFG))
        module = tclip.CLIPVisionEncoder(tclip.CLIPVisionConfig(**CLIP_CFG))
    elif kind == "bert":
        real = _hf_bert().state_dict()
        shapes = chip_smoke.hf_bert_shapes(tmini.MiniLMConfig(**BERT_CFG))
        convert = lambda sd: tmini.convert_hf_bert(sd, tmini.MiniLMConfig(**BERT_CFG))  # noqa: E731
        module = tmini.MiniLMEncoder(tmini.MiniLMConfig(**BERT_CFG))
    elif kind == "panns":
        real = _TorchCnn14().state_dict()
        shapes = chip_smoke.panns_cnn14_shapes(tcnn.CNN14Config(**CNN_CFG))
        convert = tcnn.convert_panns_cnn14
        module = tcnn.CNN14(tcnn.CNN14Config(**CNN_CFG))
    else:
        hf, cfg, _, _ = tiny
        real = hf.state_dict()
        wcfg = wt.WhisperConfig(**dataclasses.asdict(cfg))
        shapes = chip_smoke.hf_whisper_shapes(wcfg)
        assert wt.config_from_hf(chip_smoke.hf_whisper_config(wcfg)) == wcfg
        convert = lambda sd: wt.convert_hf_whisper(sd, wcfg)  # noqa: E731
        module = None
    for name, shape in shapes.items():
        assert tuple(real[name].shape) == tuple(shape), name
    sd = chip_smoke.random_checkpoint(shapes, 0)
    if module is None:
        enc, dec = convert(sd)
        wt.WhisperEncoder(wcfg).load_state_dict(enc, strict=True)
        wt.WhisperDecoder(wcfg).load_state_dict(dec, strict=True)
    else:
        module.load_state_dict(convert(sd), strict=True)
