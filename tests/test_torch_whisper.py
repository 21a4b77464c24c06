"""The port's Whisper (``extractors/whisper_torch.py``) against the JAX
package's ``whisper_jax.py`` on the CPU, on the same weights: the session's
tiny HF Whisper (``tiny`` in tests/conftest.py: d_model 16, 2 + 2 layers,
the full 51865 vocab, 24 target positions), converted by each framework.

Float32 tolerances: the encoder and the logits within 1e-5 of JAX (the two
sum in other orders); decoded tokens, timestamp masks and segments equal.
"""

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.extractors import whisper_jax as wj
from repurpose_tpu_torch.extractors import whisper_torch as wt

from one_torch_thread import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
NEAR_NEG = -1e8  # a logit masked by the rules (-1e9)


class Tok:
    def decode(self, ids):
        return "".join(f" w{i}" for i in ids)


@pytest.fixture(scope="module")
def port(tiny):
    """(cfg, encoder, decoder, enc_sd, dec_sd) of the port, from the same HF
    model as the JAX params."""
    hf, jcfg, _, _ = tiny
    cfg = wt.config_from_hf(hf.config.to_dict())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    enc_sd, dec_sd = wt.convert_hf_whisper(hf.state_dict(), cfg)
    enc = wt.WhisperEncoder(cfg)
    enc.load_state_dict(enc_sd, strict=True)
    dec = wt.WhisperDecoder(cfg)
    dec.load_state_dict(dec_sd, strict=True)
    return cfg, enc.eval(), dec.eval(), enc_sd, dec_sd


def _enc_states(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, cfg.max_source_positions, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("vocab", [51864, 51865, 51866])
def test_config_from_hf_mapping_matches_jax(vocab):
    from transformers import WhisperConfig

    hf = WhisperConfig(vocab_size=vocab, num_mel_bins=8, d_model=16, encoder_layers=2,
                       decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
                       encoder_ffn_dim=32, decoder_ffn_dim=32, max_target_positions=24)
    want = dataclasses.asdict(wj.config_from_hf(hf))
    assert dataclasses.asdict(wt.config_from_hf(hf.to_dict())) == want
    assert dataclasses.asdict(wt.config_from_hf(hf)) == want
    # a config.json leaving fields out takes HF's defaults
    assert (dataclasses.asdict(wt.config_from_hf({"vocab_size": vocab}))
            == dataclasses.asdict(wj.config_from_hf(WhisperConfig(vocab_size=vocab))))


def test_encoder_matches_jax(tiny, port):
    _, jcfg, enc_p, _ = tiny
    cfg, enc, _, _, _ = port
    mel = np.random.default_rng(0).normal(0, 1, (2, 3000, cfg.n_mels)).astype(np.float32)
    want = np.asarray(wj.WhisperEncoder(jcfg).apply({"params": enc_p}, jnp.asarray(mel)))
    with torch.no_grad():
        got = enc(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_teacher_forced_logits_match_jax(tiny, port):
    _, jcfg, _, dec_p = tiny
    cfg, _, dec, _, _ = port
    rng = np.random.default_rng(1)
    enc = _enc_states(cfg, 2, 1)
    toks = rng.integers(0, 1000, (2, 7))
    want = np.asarray(wj.WhisperDecoder(jcfg).apply(
        {"params": dec_p}, jnp.asarray(toks.astype(np.int32)), jnp.asarray(enc)))
    with torch.no_grad():
        got = dec(torch.from_numpy(toks), torch.from_numpy(enc)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cached_step_matches_teacher_forced_and_jax(tiny, port):
    """The KV-cached step (what the decode loops run) against the port's
    teacher-forced pass and against the JAX step, position by position."""
    _, jcfg, _, dec_p = tiny
    cfg, _, dec, _, _ = port
    enc = _enc_states(cfg, 2, 2)
    toks = np.random.default_rng(2).integers(0, 1000, (2, 6))
    jdec = wj.WhisperDecoder(jcfg)
    cross_j = jdec.apply({"params": dec_p}, jnp.asarray(enc),
                         method=wj.WhisperDecoder.precompute_cross)
    shape = (2, cfg.dec_layers, cfg.max_target_positions, cfg.d_model)
    kv_j = (jnp.zeros(shape), jnp.zeros(shape))
    with torch.no_grad():
        full = dec(torch.from_numpy(toks), torch.from_numpy(enc)).numpy()
        cross = dec.precompute_cross(torch.from_numpy(enc))
        kv = dec.new_cache(2)
        for pos in range(toks.shape[1]):
            got = dec.step(torch.from_numpy(toks[:, pos]), pos, kv, cross).numpy()
            want, kv_j = jdec.apply({"params": dec_p}, jnp.asarray(toks[:, pos].astype(np.int32)),
                                    jnp.int32(pos), kv_j, cross_j, method=wj.WhisperDecoder.step)
            np.testing.assert_allclose(got, full[:, pos], atol=ATOL, rtol=0)
            np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _token_states(cfg, n, l, p, rng):
    """Rows of prompt + a seeded mix of text and (rising) timestamp tokens."""
    ts0 = cfg.timestamp_begin
    tokens = np.full((n, l), cfg.eot, np.int64)
    tokens[:, :p] = (cfg.sot, cfg.lang_begin, cfg.transcribe)[:p]
    for r in range(n):
        ts = ts0 + int(rng.integers(0, 40))
        for j in range(p, l):
            if rng.random() < 0.4:
                ts += int(rng.integers(0, 3))
                tokens[r, j] = ts
            else:
                tokens[r, j] = int(rng.integers(0, cfg.eot))
    return tokens


def test_timestamp_rules_match_jax_bit_for_bit(port):
    """``_rules_for_position`` (hence ``_apply_timestamp_rules``) against
    JAX on seeded logits and token states at every position, the first
    sampled one and the len(seq) < 2 clause included: the same mask, the
    same values."""
    cfg = port[0]
    jcfg = wj.WhisperJaxConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(3)
    p, l, n = 3, 12, 6
    tokens = _token_states(cfg, n, l, p, rng)
    suppress_t = torch.from_numpy(wt._suppress_mask(cfg))
    suppress_j = jnp.asarray(wj._suppress_mask(jcfg))
    np.testing.assert_array_equal(wt._suppress_mask(cfg), wj._suppress_mask(jcfg))
    for pos in range(p - 1, l - 1):
        logits = rng.normal(0, 3, (n, cfg.vocab_size)).astype(np.float32)
        # timestamps likely on some rows, text on others: both rule branches
        logits[: n // 2, cfg.timestamp_begin:] += 4.0
        want = np.asarray(wj._rules_for_position(jnp.asarray(logits), jnp.asarray(tokens),
                                                 jnp.int32(pos), p, jcfg, suppress_j))
        got = wt._rules_for_position(torch.from_numpy(logits), torch.from_numpy(tokens), pos, p,
                                     cfg, suppress_t).numpy()
        np.testing.assert_array_equal(got <= NEAR_NEG, want <= NEAR_NEG)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("with_ts", [False, True], ids=["no_ts", "ts"])
@pytest.mark.parametrize("w", [0, 1, 2, 5], ids=["greedy", "beam1", "beam2", "beam5"])
def test_decodes_match_jax_token_for_token(tiny, port, w, with_ts):
    _, jcfg, _, dec_p = tiny
    cfg, _, dec, _, _ = port
    enc = _enc_states(cfg, 3, 4)
    prompt = (cfg.sot, cfg.lang_begin, cfg.transcribe)
    jdec = wj.WhisperDecoder(jcfg)
    if w == 0:
        want = wj.greedy_decode(jdec, {"params": dec_p}, jnp.asarray(enc), prompt, with_ts)
        got = wt.greedy_decode(dec, torch.from_numpy(enc), prompt, with_ts)
    else:
        want = wj.beam_decode(jdec, {"params": dec_p}, jnp.asarray(enc), prompt, w, with_ts)
        got = wt.beam_decode(dec, torch.from_numpy(enc), prompt, w, with_ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_detect_language_and_no_speech_match_jax(tiny, port):
    hf, jcfg, enc_p, dec_p = tiny
    cfg, _, _, enc_sd, dec_sd = port
    jasr = wj.WhisperASR(jcfg, enc_p, dec_p, Tok())
    asr = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), device="cpu")
    wave = np.random.default_rng(17).normal(0, 0.1, 16000 * 5).astype(np.float32)
    lang, prob = asr.detect_language(wave)
    jlang, jprob = jasr.detect_language(wave)
    assert lang == jlang and prob == pytest.approx(jprob, abs=1e-6)
    enc = asr.encode_waves(np.pad(wave, (0, wt.N_SAMPLES - len(wave)))[None])
    jenc = jasr._encode(wj.log_mel_whisper(
        jnp.asarray(np.pad(wave, (0, wt.N_SAMPLES - len(wave)))[None]), n_mels=jcfg.n_mels))
    np.testing.assert_allclose(asr._no_speech_probs(enc, asr.prompt),
                               np.asarray(jasr._no_speech_probs(jenc, jasr.prompt)),
                               atol=1e-6, rtol=0)


def test_no_speech_gate_and_empty_audio(port, monkeypatch):
    """Threshold 0 gates every chunk, None keeps them; zero-length audio
    returns [] (the JAX module's test, on the port)."""
    cfg, _, _, enc_sd, dec_sd = port
    ts0 = cfg.timestamp_begin
    row = [cfg.sot, cfg.lang_begin, cfg.transcribe, ts0, 5, ts0 + 100, cfg.eot]

    def fake_greedy(decoder, enc, prompt, with_timestamps=True):
        out = torch.full((enc.shape[0], cfg.max_target_positions), cfg.eot)
        out[:, : len(row)] = torch.tensor(row)
        return out

    monkeypatch.setattr(wt, "greedy_decode", fake_greedy)
    wave = np.random.default_rng(5).normal(0, 0.1, 16000 * 3).astype(np.float32)
    asr = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), device="cpu")
    assert asr.transcribe_wave(np.zeros(0, np.float32)) == []
    assert asr.transcribe_wave(wave) == [
        {"start": 0.0, "end": 2.0, "text": "w5", "tokens": [5]}]
    gated = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), no_speech_threshold=0.0, device="cpu")
    assert gated.transcribe_wave(wave) == []


def test_tokens_to_segments_matches_jax(port):
    cfg = port[0]
    jcfg = wj.WhisperJaxConfig(**dataclasses.asdict(cfg))
    ts0 = cfg.timestamp_begin
    rows = [
        [cfg.sot, cfg.lang_begin, cfg.transcribe, ts0, 5, 6, ts0 + 100, ts0 + 100, 7,
         ts0 + 200, cfg.eot],
        [ts0 + 20, 8, 9, ts0 + 50, ts0 + 60, 3],  # unterminated last segment
        [ts0, ts0 + 5, cfg.eot],  # an empty-text pair
        [],
    ]
    for row in rows:
        for offset in (0.0, 30.0):
            got = wt.tokens_to_segments(np.asarray(row, np.int64), cfg, Tok().decode, offset)
            assert got == wj.tokens_to_segments(np.asarray(row, np.int32), jcfg, Tok().decode,
                                                offset)


@pytest.mark.parametrize("beam,seconds,block", [(1, 65.0, 4), (3, 35.0, 1)])
def test_transcribe_wave_matches_jax(tiny, port, beam, seconds, block):
    """The same segments as the JAX WhisperASR: greedy on 65 s (3 chunks in
    one block, which the JAX ASR pads to 4 rows) and beam 3 on 35 s (2
    chunks, a block each: the chunk offsets)."""
    _, jcfg, enc_p, dec_p = tiny
    cfg, _, _, enc_sd, dec_sd = port
    wave = np.random.default_rng(6).normal(0, 0.1, int(16000 * seconds)).astype(np.float32)
    want = wj.WhisperASR(jcfg, enc_p, dec_p, Tok(), max_chunk_batch=block,
                         beam_size=beam).transcribe_wave(wave)
    got = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), max_chunk_batch=block, beam_size=beam,
                        device="cpu").transcribe_wave(wave)
    assert want and got == want


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_from_hf_dir_without_transformers(tiny, port, tmp_path, monkeypatch, fmt):
    """A saved tiny checkpoint (config.json + model.safetensors, or
    pytorch_model.bin) loads with ``transformers`` unimportable when the
    tokenizer is handed in, and equals the directly converted model."""
    hf, _, _, _ = tiny
    cfg, enc, dec, _, _ = port
    d = tmp_path / "whisper-tiny-random"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf.config.to_dict()))
    sd = {k: v.detach().clone().contiguous() for k, v in hf.state_dict().items()}
    if fmt == "safetensors":
        from safetensors.torch import save_file

        sd.pop("proj_out.weight")  # tied to the token table
        save_file(sd, str(d / "model.safetensors"))
    else:
        torch.save(sd, d / "pytorch_model.bin")
    monkeypatch.setitem(sys.modules, "transformers", None)
    asr = wt.WhisperASR.from_hf_dir(str(d), tokenizer=Tok(), compute_dtype="float32",
                                    device="cpu")
    assert asr.cfg == cfg and asr.prompt == (cfg.sot, cfg.lang_begin, cfg.transcribe)
    for got, want in ((asr.encoder, enc), (asr.decoder, dec)):
        for k, v in want.state_dict().items():
            torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    with pytest.raises(ImportError):  # the tokenizer is the one thing it would import
        wt.WhisperASR.from_hf_dir(str(d), device="cpu")


def test_from_hf_dir_prefers_the_bin_without_safetensors(tiny, tmp_path, monkeypatch):
    """Where the ``safetensors`` package is missing (the card's machine), a
    directory holding both files loads ``pytorch_model.bin``."""
    from repurpose_tpu_torch.preprocessing.pipeline import PreprocessingPipeline

    hf = tiny[0]
    (tmp_path / "model.safetensors").write_bytes(b"not read")
    torch.save(hf.state_dict(), tmp_path / "pytorch_model.bin")
    monkeypatch.setitem(sys.modules, "safetensors", None)
    sd = PreprocessingPipeline._load_state_dict(str(tmp_path))
    assert sorted(sd) == sorted(hf.state_dict())


def test_english_only_prompt_and_bf16_decode(tiny, port):
    """*.en layouts take the bare <|sot|> prompt; the bf16 path (from_hf_dir's
    default) runs the whole cached decode with word timestamps."""
    cfg, _, _, enc_sd, dec_sd = port
    en = wt.config_from_hf({"vocab_size": 51864, "num_mel_bins": 8, "d_model": 16,
                            "encoder_layers": 2, "decoder_layers": 2,
                            "encoder_attention_heads": 2, "encoder_ffn_dim": 32,
                            "max_target_positions": 24})
    assert en.n_langs == 0 and en.eot == 50256
    dec_en = {k: (v[:51864] if k == "tok_embed" else v) for k, v in dec_sd.items()}
    assert wt.WhisperASR(en, enc_sd, dec_en, Tok(), device="cpu").prompt == (en.sot,)
    asr = wt.WhisperASR(cfg, enc_sd, dec_sd, Tok(), compute_dtype="bfloat16", device="cpu")
    wave = np.random.default_rng(21).normal(0, 0.1, 16000 * 3).astype(np.float32)
    assert isinstance(asr.transcribe_wave(wave, word_timestamps=True), list)
