"""The port's word aligner (``extractors/whisper_align.py``) and DTW
(``native.dtw_path``: root ``csrc/dtw.cc`` built for the host, and the numpy
fallback) against the JAX package's on the CPU, and the host cases of
``tests/test_whisper_align.py`` run on the port."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu import native as jnative
from repurpose_tpu.extractors import whisper_align as jal
from repurpose_tpu.extractors import whisper_jax as wj
from repurpose_tpu_torch import native
from repurpose_tpu_torch.extractors import whisper_align as tal
from repurpose_tpu_torch.extractors import whisper_torch as wt

from one_torch_thread import one_torch_thread  # noqa: F401  (autouse)

# The alignment matrix standardises each frame column of near-uniform
# cross-attention weights (~1/1500 each) by its std over the token rows,
# which magnifies float32 rounding: on test_alignment_matrix_matches_jax's
# inputs the JAX result itself is 1.8e-5 off the same computation in
# float64 (the port 1.7e-5, measured on the CPU). 5e-5 holds the port to
# the reference's own precision; a wrong head, mask or filter is off by 0.1+.
ATOL = 5e-5


class Tok:
    def decode(self, ids):
        return "".join(f" w{i}" for i in ids)


@pytest.fixture(scope="module")
def port(tiny):
    hf, _, _, _ = tiny
    cfg = wt.config_from_hf(hf.config.to_dict())
    enc_sd, dec_sd = wt.convert_hf_whisper(hf.state_dict(), cfg)
    dec = wt.WhisperDecoder(cfg)
    dec.load_state_dict(dec_sd, strict=True)
    return cfg, dec.eval(), enc_sd, dec_sd


def test_dtw_native_and_numpy_equal_jax():
    """Every path of 60 seeded matrices (and ones with ties and a single row
    or column) equal to the JAX package's ``dtw_path``, from both routes."""
    assert native.host_library("dtw") is not None, "csrc/dtw.cc did not build"
    rng = np.random.default_rng(0)
    cases = [rng.normal(0, 1, (int(rng.integers(1, 25)), int(rng.integers(1, 35))))
             for _ in range(60)]
    cases += [np.zeros((4, 6)), np.ones((1, 7)), np.ones((5, 1)),
              np.round(rng.normal(0, 1, (9, 12)))]
    for cost in cases:
        cost = cost.astype(np.float32)
        want = jnative.dtw_path(cost)
        for got in (native.dtw_path(cost), native._dtw_numpy(cost)):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    empty = native.dtw_path(np.zeros((0, 3), np.float32))
    assert empty[0].size == empty[1].size == 0


def test_dtw_host_library_is_keyed_by_its_source():
    lib = native.host_library("dtw")
    assert lib is native.host_library("dtw")
    built = [p.name for p in native.BUILD.glob("dtw-*.so")]
    assert built and all(len(n) == len("dtw-") + 16 + len(".so") for n in built)


def _head_w(cfg, heads):
    w = np.zeros((cfg.dec_layers, cfg.heads), np.float32)
    for layer, head in heads:
        w[layer, head] = 1.0 / len(heads)
    return w


def test_alignment_matrix_matches_jax(tiny, port):
    _, jcfg, _, dec_p = tiny
    cfg, dec, _, _ = port
    rng = np.random.default_rng(11)
    b, l, s = 2, 10, cfg.max_source_positions
    enc = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, 1000, (b, l))
    token_valid = np.ones((b, l), bool)
    token_valid[1, 7:] = False
    frame_valid = np.ones((b, s), bool)
    frame_valid[0, 300:] = False
    head_w = _head_w(cfg, tal.default_alignment_heads(cfg))
    want = np.asarray(wj.WhisperDecoder(jcfg).apply(
        {"params": dec_p}, jnp.asarray(toks.astype(np.int32)), jnp.asarray(enc),
        jnp.asarray(token_valid), jnp.asarray(frame_valid), jnp.asarray(head_w),
        method=wj.WhisperDecoder.alignment_matrix))
    with torch.no_grad():
        got = dec.alignment_matrix(torch.from_numpy(toks), torch.from_numpy(enc),
                                   torch.from_numpy(token_valid), torch.from_numpy(frame_valid),
                                   torch.from_numpy(head_w)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_median_filter_matches_jax():
    x = np.random.default_rng(1).normal(0, 1, (2, 3, 40)).astype(np.float32)
    for width_in in (2, 3, 40):
        np.testing.assert_array_equal(
            wt._median_filter_last(torch.from_numpy(x[..., :width_in]), 7).numpy(),
            np.asarray(wj._median_filter_last(jnp.asarray(x[..., :width_in]), 7)))


def test_align_block_matches_jax(tiny, port):
    """Rows of 3 and 0 text tokens, one overlong, content shorter than a
    chunk: the same matrices as the JAX aligner (whose rows it pads to a
    64-token bucket)."""
    _, jcfg, _, dec_p = tiny
    cfg, dec, _, _ = port
    rng = np.random.default_rng(14)
    enc = rng.normal(0, 1, (3, cfg.max_source_positions, cfg.d_model)).astype(np.float32)
    prompt = (cfg.sot, cfg.lang_begin, cfg.transcribe)
    rows = [[5, 6, 7], [], list(range(5, 5 + 2 * cfg.max_target_positions))]
    content = [480_000, 123_456, 1]
    heads = [(0, 1), (1, 0)]
    jaligner = jal.WhisperAligner(wj.WhisperDecoder(jcfg), {"params": dec_p}, prompt, heads)
    aligner = tal.WhisperAligner(dec, prompt, heads)
    assert aligner.text_budget == jaligner.text_budget
    np.testing.assert_array_equal(aligner.head_w.numpy(), np.asarray(jaligner._head_w))
    want = jaligner.align_block(rows, jnp.asarray(enc), content)
    got = aligner.align_block(rows, torch.from_numpy(enc), content)
    assert [m.shape for m in got] == [m.shape for m in want]
    assert got[0].shape[0] == 4 and got[1].shape[0] == 1
    assert got[2].shape[0] == aligner.text_budget + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("beam,seconds,block", [(1, 65.0, 4), (2, 35.0, 1)])
def test_transcribe_words_match_jax(tiny, port, beam, seconds, block):
    """``transcribe_wave(word_timestamps=True)``: the same segments and words
    (times and text) as the JAX WhisperASR, greedy on 65 s in one block and
    beam 2 on 35 s in a block a chunk."""
    _, jcfg, enc_p, dec_p = tiny
    cfg, _, enc_sd, dec_sd = port
    wave = np.random.default_rng(13).normal(0, 0.1, int(16000 * seconds)).astype(np.float32)
    want = wj.WhisperASR(jcfg, enc_p, dec_p, Tok(), max_chunk_batch=block,
                         beam_size=beam).transcribe_wave(wave, word_timestamps=True)
    got = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), max_chunk_batch=block, beam_size=beam,
                        device="cpu").transcribe_wave(wave, word_timestamps=True)
    assert sum(len(s["words"]) for s in want) > 0
    assert got == want


# -- the host cases of tests/test_whisper_align.py, on the port -----------------------

VOCAB = {1: " hello", 2: " wor", 3: "ld", 4: "!", 5: " there"}


def _decode(ids):
    return "".join(VOCAB.get(i, "") for i in ids)


@pytest.mark.parametrize("tokens,decode,want", [
    ([1, 2, 3, 4, 5], _decode, [("hello", 1), ("world!", 3), ("there", 1)]),
    ([1, 2, 3, 4, 5], lambda ids: "".join({1: "你", 2: "好", 3: "世", 4: "界", 5: " ok"}[i]
                                          for i in ids),
     [("你", 1), ("好", 1), ("世", 1), ("界", 1), ("ok", 1)]),
    ([1, 2, 3], lambda ids: {(1,): "�", (1, 2): "好", (3,): "了"}[tuple(ids)],
     [("好", 2), ("了", 1)]),
    ([1, 2, 3], lambda ids: "".join({1: "hi", 2: "ไ", 3: "ป"}[i] for i in ids),
     [("hi", 1), ("ไ", 1), ("ป", 1)]),
    ([1, 2, 3], lambda ids: "".join({1: "\U00020BB7", 2: "\U00020BB7", 3: "好"}[i] for i in ids),
     [("\U00020BB7", 1), ("\U00020BB7", 1), ("好", 1)]),
    ([1, 6, 5, 6], lambda ids: "".join({1: " a", 5: " b", 6: "  "}[i] for i in ids),
     None),  # whitespace-only tokens fold into a neighbour: counts still sum
], ids=["bpe", "cjk", "multibyte", "thai", "ext-b", "whitespace"])
def test_split_words_cases(tokens, decode, want):
    got = tal.split_words(tokens, decode)
    assert got == jal.split_words(tokens, decode)
    assert sum(n for _, n in got) == len(tokens)
    if want is not None:
        assert got == want


def test_words_from_matrix_and_attach_words():
    spans = [(0, 3), (3, 6), (6, 8), (8, 10)]  # rows: tok0, tok1, tok2, eot
    matrix = np.full((4, 10), -5.0, np.float32)
    for r, (a, b) in enumerate(spans):
        matrix[r, a:b] = 5.0
    words = tal.words_from_matrix(matrix, [1, 2, 3], _decode, offset_s=30.0)
    assert words == jal.words_from_matrix(matrix, [1, 2, 3], _decode, offset_s=30.0)
    assert [(w["word"], w["start"], w["end"]) for w in words] == [
        ("hello", 30.0, 30.06), ("world", 30.06, 30.16)]
    assert tal.words_from_matrix(matrix, [1, 2], _decode) == []  # rows mismatch
    segments = [{"start": 0.0, "end": 2.0, "text": "hello", "tokens": [1]},
                {"start": 2.0, "end": 4.0, "text": "world", "tokens": [2, 3]}]
    tal.attach_words(segments, words)
    assert [[w["word"] for w in s["words"]] for s in segments] == [["hello"], ["world"]]
    assert all("_n_tokens" not in w for s in segments for w in s["words"])


@pytest.mark.parametrize("kwargs,want", [
    (dict(name="openai/whisper-small.en"), "small.en"),
    (dict(name="whisper-large"), "large-v2"),
    (dict(cfg="base"), "base"),
    (dict(name="custom", cfg=dict(d_model=96, dec_layers=2)), None),
    (dict(name="distil-large-v3", cfg=dict(d_model=1280, dec_layers=2, heads=20,
                                           vocab_size=51866, n_mels=128)), None),
    (dict(name="openai/whisper-large", cfg=dict(d_model=1280, enc_layers=32, dec_layers=32,
                                                heads=20, vocab_size=51866, n_mels=128)),
     "large-v3"),
    (dict(name="whisper-large-v1", cfg=dict(d_model=1280, enc_layers=32, dec_layers=32,
                                            heads=20, vocab_size=51865, n_mels=80)),
     "large-v1"),
], ids=["small.en", "large", "dims", "unknown", "distil", "v3-dims", "v1-name"])
def test_resolve_alignment_heads_cases(kwargs, want):
    def both(cfg_kw):
        if cfg_kw is None:
            return None, None
        if cfg_kw == "base":
            return wt.WhisperConfig(), wj.WhisperJaxConfig()
        return wt.WhisperConfig(**cfg_kw), wj.WhisperJaxConfig(**cfg_kw)

    tcfg, jcfg = both(kwargs.get("cfg"))
    got = tal.resolve_alignment_heads(name=kwargs.get("name"), cfg=tcfg)
    assert got == jal.resolve_alignment_heads(name=kwargs.get("name"), cfg=jcfg)
    assert got == (None if want is None else list(tal.PUBLISHED_ALIGNMENT_HEADS[want]))


def test_resolve_heads_from_generation_config(tmp_path):
    d = tmp_path / "whisper-base"
    d.mkdir()
    (d / "generation_config.json").write_text(json.dumps({"alignment_heads": [[1, 2], [3, 4]]}))
    assert tal.resolve_alignment_heads(path=str(d)) == [(1, 2), (3, 4)]
    bad = tmp_path / "ckpt-small"
    bad.mkdir()
    (bad / "generation_config.json").write_text(json.dumps(["oops"]))
    assert tal.resolve_alignment_heads(path=str(bad)) == list(
        tal.PUBLISHED_ALIGNMENT_HEADS["small"])
    assert tal.PUBLISHED_ALIGNMENT_HEADS == jal.PUBLISHED_ALIGNMENT_HEADS


def test_aligner_head_weights(port):
    cfg, dec, _, _ = port
    w = tal.WhisperAligner(dec, (cfg.sot,), [(0, 1), (1, 0)]).head_w.numpy()
    assert w[0, 1] > 0 and w[1, 0] > 0 and (w > 0).sum() == 2 and np.isclose(w.sum(), 1.0)
    w = tal.WhisperAligner(dec, (cfg.sot,)).head_w.numpy()
    assert dataclasses.asdict(cfg)["dec_layers"] == 2 and (w[1] > 0).all() and not w[0].any()
