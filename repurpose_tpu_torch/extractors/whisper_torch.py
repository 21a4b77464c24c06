"""Whisper ASR in PyTorch: encoder, KV-cached decoder, timestamp-aware greedy
and beam decoding, the log-mel frontend and an HF weight converter. The
port of ``repurpose_tpu/extractors/whisper_jax.py``.

The reference transcribes on the host with WhisperX / whisper
(preprocessing/text_feature_extractor.py:129-160). Here the whole loop (30 s
chunk log-mels, the encoder, a batched decode with OpenAI's timestamp rules)
runs on the card, all 30 s chunks of a video in one batch. Weights convert
from any HF Whisper checkpoint (``convert_hf_whisper``; ``from_hf_dir``
reads ``config.json`` as a plain mapping, so no ``transformers`` is needed
but for a tokenizer that is not handed in).

The JAX decode loops are ``lax.while_loop``s over fixed ``[B, L]`` buffers
with an early exit; here they are Python loops over a preallocated KV cache
``[B, layers, L, d]`` whose step attends to the positions written so far
(the JAX step masks the rest with -1e9, which weighs them exactly 0). The
rules are kept: predictions at prompt positions are discarded, EOT ends a
row only after the prompt, rows are padded with EOT. ``beam_decode`` keeps
openai's BeamSearchDecoder bookkeeping (the beam folded into the batch,
top-2W of W*V candidates, a first-come finished pool capped at W,
back-pointers gathered with the KV caches, the final pick by score over
length).
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.extractors.audio_frontend import mel_filterbank, stft_power
from repurpose_tpu_torch.extractors.layers import (
    Dense,
    LayerNorm32,
    as_tensor,
    attention,
    compute_dtype,
)

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_S  # 480_000
N_FRAMES = N_SAMPLES // HOP  # 3000
TIME_PER_TOKEN = 0.02  # one timestamp token = 20 ms
NEG = -1e9


@dataclass(frozen=True)
class WhisperConfig:
    """Dims follow HF WhisperConfig; defaults are whisper-base. Token ids are
    the multilingual layout (vocab 51865); English-only checkpoints override
    (``config_from_hf``)."""

    vocab_size: int = 51865
    n_mels: int = N_MELS
    d_model: int = 512
    enc_layers: int = 6
    dec_layers: int = 6
    heads: int = 8
    d_ff: int = 2048
    max_source_positions: int = 1500
    max_target_positions: int = 448
    # special tokens (multilingual vocab layout)
    eot: int = 50257
    sot: int = 50258
    lang_begin: int = 50259  # <|en|>; 99 language tokens follow
    n_langs: int = 99
    translate: int = 50358
    transcribe: int = 50359
    no_speech: int = 50362
    no_timestamps: int = 50363
    timestamp_begin: int = 50364  # <|0.00|>
    max_initial_timestamp_index: int = 50  # 1.0 s (openai decoding default)

    @property
    def d_head(self) -> int:
        return self.d_model // self.heads


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed encoder position signal (openai whisper/model.py)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


class _EncLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_ln = LayerNorm32(d, device=device)
        self.q = Dense(d, d, device=device)
        self.k = Dense(d, d, bias=False, device=device)
        self.v = Dense(d, d, device=device)
        self.attn_out = Dense(d, d, device=device)
        self.final_ln = LayerNorm32(d, device=device)
        self.fc1 = Dense(d, cfg.d_ff, device=device)
        self.fc2 = Dense(cfg.d_ff, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.self_ln(x).to(x.dtype)
        q = self.q(h) * (self.cfg.d_head**-0.5)
        x = x + self.attn_out(attention(q, self.k(h), self.v(h), self.cfg.heads))
        h = self.final_ln(x).to(x.dtype)
        return x + self.fc2(F.gelu(self.fc1(h)))


class WhisperEncoder(nn.Module):
    """log-mel [B, T=3000, n_mels] -> audio states [B, 1500, d] in the
    compute dtype."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig(), compute_dtype: str = "float32",
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        d = cfg.d_model
        self.conv1 = nn.Conv1d(cfg.n_mels, d, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, device=device)
        self.pos_embed = nn.Parameter(
            torch.from_numpy(_sinusoids(cfg.max_source_positions, d)).to(device))
        for i in range(cfg.enc_layers):
            setattr(self, f"layer_{i}", _EncLayer(cfg, device))
        self.ln = LayerNorm32(d, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        dtype = compute_dtype(self.compute_dtype)
        x = mel.to(dtype).transpose(1, 2)  # [B, n_mels, T]
        x = F.gelu(F.conv1d(x, self.conv1.weight.to(dtype), self.conv1.bias.to(dtype),
                            padding=1))
        x = F.gelu(F.conv1d(x, self.conv2.weight.to(dtype), self.conv2.bias.to(dtype),
                            stride=2, padding=1))
        x = x.transpose(1, 2)  # [B, 1500, d]
        x = x + self.pos_embed[: x.shape[1]].to(dtype)
        for i in range(self.cfg.enc_layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.ln(x).to(dtype)


class _DecLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, device=None):
        super().__init__()
        d = cfg.d_model
        self.cfg = cfg
        self.self_ln = LayerNorm32(d, device=device)
        self.sq = Dense(d, d, device=device)
        self.sk = Dense(d, d, bias=False, device=device)
        self.sv = Dense(d, d, device=device)
        self.s_out = Dense(d, d, device=device)
        self.cross_ln = LayerNorm32(d, device=device)
        self.cq = Dense(d, d, device=device)
        self.ck = Dense(d, d, bias=False, device=device)
        self.cv = Dense(d, d, device=device)
        self.c_out = Dense(d, d, device=device)
        self.final_ln = LayerNorm32(d, device=device)
        self.fc1 = Dense(d, cfg.d_ff, device=device)
        self.fc2 = Dense(cfg.d_ff, d, device=device)

    def cross_kv(self, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.ck(enc), self.cv(enc)

    def _cross_and_mlp(self, x, ck, cv, cross_bias=None, return_cross_weights=False):
        cfg = self.cfg
        h = self.cross_ln(x).to(x.dtype)
        q = self.cq(h) * (cfg.d_head**-0.5)
        out = attention(q, ck, cv, cfg.heads, bias=cross_bias,
                        return_weights=return_cross_weights)
        out, w = out if return_cross_weights else (out, None)
        x = x + self.c_out(out)
        h = self.final_ln(x).to(x.dtype)
        return x + self.fc2(F.gelu(self.fc1(h))), w

    def forward(self, x, enc, causal_bias, cross_bias=None, return_cross_weights=False):
        cfg = self.cfg
        h = self.self_ln(x).to(x.dtype)
        q = self.sq(h) * (cfg.d_head**-0.5)
        x = x + self.s_out(attention(q, self.sk(h), self.sv(h), cfg.heads, bias=causal_bias))
        ck, cv = self.cross_kv(enc)
        x, w = self._cross_and_mlp(x, ck, cv, cross_bias, return_cross_weights)
        return (x, w) if return_cross_weights else x

    def step(self, x, pos: int, k_cache, v_cache, ck, cv):
        """x [B, 1, d] at position ``pos``; writes this position's self K / V
        into ``k_cache`` / ``v_cache`` ``[B, L, d]`` (views of the decoder's
        cache) and attends to positions 0..pos."""
        cfg = self.cfg
        h = self.self_ln(x).to(x.dtype)
        q = self.sq(h) * (cfg.d_head**-0.5)
        k_cache[:, pos] = self.sk(h)[:, 0]
        v_cache[:, pos] = self.sv(h)[:, 0]
        x = x + self.s_out(attention(q, k_cache[:, : pos + 1], v_cache[:, : pos + 1], cfg.heads))
        return self._cross_and_mlp(x, ck, cv)[0]


def _causal_bias(l: int, device) -> torch.Tensor:
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=device))
    return torch.where(causal, 0.0, NEG)[None, None]


class WhisperDecoder(nn.Module):
    """Teacher-forced forward (``forward``), the cross K / V computed once
    (``precompute_cross``) and the KV-cached single step (``step``) of the
    decode loops, and the word aligner's ``alignment_matrix``."""

    def __init__(self, cfg: WhisperConfig = WhisperConfig(), compute_dtype: str = "float32",
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = compute_dtype
        self.tok_embed = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.d_model, device=device))
        self.pos_embed = nn.Parameter(
            torch.zeros(cfg.max_target_positions, cfg.d_model, device=device))
        for i in range(cfg.dec_layers):
            setattr(self, f"layer_{i}", _DecLayer(cfg, device))
        self.ln = LayerNorm32(cfg.d_model, device=device)

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.compute_dtype)

    @property
    def layers(self) -> list[_DecLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.dec_layers)]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        l = tokens.shape[1]
        return (self.tok_embed[tokens] + self.pos_embed[:l][None]).to(self.dtype)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        # the final LayerNorm's float32 output against the float32 table
        return torch.matmul(self.ln(x), self.tok_embed.t())

    def forward(self, tokens: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
        """tokens [B, L] int, enc [B, S, d] -> logits [B, L, vocab] float32."""
        x = self._embed(tokens)
        bias = _causal_bias(tokens.shape[1], tokens.device)
        enc = enc.to(self.dtype)
        for layer in self.layers:
            x = layer(x, enc, bias)
        return self._logits(x)

    def precompute_cross(self, enc: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        enc = enc.to(self.dtype)
        return [layer.cross_kv(enc) for layer in self.layers]

    def new_cache(self, b: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Zeroed self-attention K / V caches [B, layers, L, d]."""
        cfg = self.cfg
        shape = (b, cfg.dec_layers, cfg.max_target_positions, cfg.d_model)
        dev = self.tok_embed.device
        return (torch.zeros(shape, dtype=self.dtype, device=dev),
                torch.zeros(shape, dtype=self.dtype, device=dev))

    def step(self, token: torch.Tensor, pos: int, self_kv, cross_kv) -> torch.Tensor:
        """token [B] at position ``pos``; ``self_kv`` K / V [B, layers, L, d],
        written in place at ``pos``. Returns the logits [B, vocab]."""
        k_all, v_all = self_kv
        x = (self.tok_embed[token] + self.pos_embed[pos])[:, None, :].to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.step(x, pos, k_all[:, i], v_all[:, i], *cross_kv[i])
        return self._logits(x)[:, 0]

    def alignment_matrix(self, tokens, enc, token_valid, frame_valid, head_w) -> torch.Tensor:
        """Teacher-forced pass -> [B, L, S] float32 token/frame alignment
        similarity (the word aligner's DTW input, whisper_align.py): per
        selected cross-attention head, softmax over the content frames,
        standardise each frame column over the real token rows (population
        std), median-filter (width 7, reflect) along frames, then average
        heads with ``head_w`` [layers, heads]; layer by layer, so one
        [B, H, L, S] weight tensor is live at a time."""
        b, l = tokens.shape
        x = self._embed(tokens)
        bias = _causal_bias(l, tokens.device)
        enc = enc.to(self.dtype)
        fbias = torch.where(frame_valid, 0.0, NEG)[:, None, None, :]
        tmask = token_valid.float()[:, None, :, None]  # [B, 1, L, 1]
        denom = torch.clamp(tmask.sum(dim=2, keepdim=True), min=1.0)
        acc = torch.zeros((b, l, enc.shape[1]), dtype=torch.float32, device=enc.device)
        for li, layer in enumerate(self.layers):
            x, w = layer(x, enc, bias, cross_bias=fbias, return_cross_weights=True)
            mean = (w * tmask).sum(dim=2, keepdim=True) / denom
            var = ((w - mean).square() * tmask).sum(dim=2, keepdim=True) / denom
            wn = _median_filter_last((w - mean) * torch.rsqrt(var + 1e-9), 7)
            acc = acc + torch.einsum("bhls,h->bls", wn, head_w[li])
        return acc


def _median_filter_last(x: torch.Tensor, width: int) -> torch.Tensor:
    """Sliding median over the last axis, reflect-padded (the median_filter
    of openai-whisper's timing module)."""
    half = width // 2
    if x.shape[-1] <= half:
        return x
    xp = torch.cat([x[..., 1 : half + 1].flip(-1), x, x[..., -half - 1 : -1].flip(-1)], dim=-1)
    windows = xp.unfold(-1, width, 1)  # [..., S, width]
    return windows.sort(dim=-1).values[..., half]


# -- timestamp rules and decoding ------------------------------------------------------


def _suppress_mask(cfg: WhisperConfig) -> np.ndarray:
    """Tokens never emitted during transcription: specials and language tags
    (openai's SuppressTokens cover more vocabulary-specific ids; the
    structural ones matter for segment extraction)."""
    m = np.zeros(cfg.vocab_size, bool)
    ids = [
        cfg.sot, cfg.translate, cfg.transcribe, cfg.no_speech, cfg.no_timestamps,
        # <|startoflm|> / <|startofprev|>: openai's default suppress list
        cfg.translate + 2, cfg.translate + 3,
    ]
    m[[i for i in ids if i < cfg.vocab_size]] = True
    # every language-tag slot up to <|translate|>, in both prompt layouts
    m[cfg.lang_begin : min(cfg.translate, cfg.vocab_size)] = True
    return m


def _apply_timestamp_rules(
    logits: torch.Tensor,  # [B, V] float32
    last_tok: torch.Tensor,  # [B] previous emitted token
    penult_tok: torch.Tensor,  # [B] token before that
    max_ts: torch.Tensor,  # [B] highest timestamp token emitted so far
    has_ts: torch.Tensor,  # [B] any timestamp emitted yet
    is_first: bool,  # the first sampled position
    cfg: WhisperConfig,
    suppress: torch.Tensor,  # [V] bool
) -> torch.Tensor:
    """OpenAI ApplyTimestampRules (whisper/decoding.py), over the batch."""
    ts0 = cfg.timestamp_begin
    ids = torch.arange(cfg.vocab_size, device=logits.device)
    is_ts = ids >= ts0

    logits = logits.masked_fill(suppress[None], NEG)
    last_is_ts = last_tok >= ts0
    penult_is_ts = penult_tok >= ts0
    # after the first of a timestamp pair: only a timestamp (or EOT) may follow
    force_ts = last_is_ts & ~penult_is_ts
    block_text = force_ts[:, None] & ~is_ts[None] & (ids != cfg.eot)[None]
    # after a completed pair: next must be text (no third timestamp)
    block_ts_pair = (last_is_ts & penult_is_ts)[:, None] & is_ts[None]
    # monotonicity: equality with the running max only while pairing, else
    # strictly greater (openai's "prevent infinite looping")
    thresh = torch.where(has_ts, torch.where(force_ts, max_ts, max_ts + 1),
                         torch.full_like(max_ts, ts0))
    block_ts_low = is_ts[None] & (ids[None] < thresh[:, None])
    logits = logits.masked_fill(block_text | block_ts_pair | block_ts_low, NEG)

    if is_first:  # a timestamp <= max_initial_timestamp, nothing else (EOT included)
        cap = ts0 + cfg.max_initial_timestamp_index
        logits = logits.masked_fill((~is_ts | (ids > cap))[None], NEG)

    # sum-probability rule: if p(any timestamp) > max p(text), force a timestamp
    logp = torch.log_softmax(logits, dim=-1)
    ts_logp = torch.logsumexp(logp.masked_fill(~is_ts[None], NEG), dim=-1)
    max_text = logp.masked_fill(is_ts[None], NEG).amax(dim=-1)
    force = (ts_logp > max_text)[:, None] & ~is_ts[None]
    return logits.masked_fill(force, NEG)


def _rules_for_position(logits, tokens, pos: int, p: int, cfg: WhisperConfig, suppress):
    """Timestamp rules for the prediction made at ``pos`` from ``tokens``
    [N, L] (prompt + sampled + EOT padding), prompt length ``p``.

    openai's rules read the SAMPLED sequence only: with no sampled token yet
    the "last" slot reads as non-timestamp (sot), and with fewer than two
    sampled tokens the "penultimate" slot reads as a timestamp (the
    ``len(seq) < 2`` clause of ApplyTimestampRules)."""
    n, l = tokens.shape
    ar = torch.arange(l, device=tokens.device)[None]
    emitted_ts = (tokens >= cfg.timestamp_begin) & (ar >= p) & (ar <= pos)
    last = tokens[:, pos] if pos >= p else torch.full((n,), cfg.sot, device=tokens.device)
    penult = (tokens[:, max(pos - 1, 0)] if pos >= p + 1
              else torch.full((n,), cfg.timestamp_begin, device=tokens.device))
    max_ts = torch.where(emitted_ts, tokens, cfg.timestamp_begin).amax(dim=1)
    return _apply_timestamp_rules(logits, last, penult, max_ts, emitted_ts.any(dim=1),
                                  pos == p - 1, cfg, suppress)


def _prompt_tokens(decoder: WhisperDecoder, rows: int, prompt: Sequence[int], device):
    tokens = torch.full((rows, decoder.cfg.max_target_positions), decoder.cfg.eot,
                        dtype=torch.long, device=device)
    tokens[:, : len(prompt)] = torch.tensor(prompt, dtype=torch.long)
    return tokens


DONE_CHECK_EVERY = 8  # decode steps between host reads of the early-exit test


@torch.inference_mode()
def greedy_decode(decoder: WhisperDecoder, enc: torch.Tensor, prompt: Sequence[int],
                  with_timestamps: bool = True) -> torch.Tensor:
    """Batched greedy decode -> tokens [B, max_target_positions] (prompt
    included; rows padded with EOT after their end). The loop ends once every
    row has ended; the test is read on the host every ``DONE_CHECK_EVERY``
    steps (a row that has ended writes EOT, so steps past the end change no
    token)."""
    cfg = decoder.cfg
    b, l, p = enc.shape[0], cfg.max_target_positions, len(prompt)
    suppress = torch.from_numpy(_suppress_mask(cfg)).to(enc.device)
    cross_kv = decoder.precompute_cross(enc)
    self_kv = decoder.new_cache(b)
    tokens = _prompt_tokens(decoder, b, prompt, enc.device)
    done = torch.zeros(b, dtype=torch.bool, device=enc.device)
    for pos in range(l - 1):
        logits = decoder.step(tokens[:, pos], pos, self_kv, cross_kv)
        if pos + 1 < p:  # prompt territory: the prediction is discarded
            continue
        if with_timestamps:
            logits = _rules_for_position(logits, tokens, pos, p, cfg, suppress)
        nxt = torch.where(done, cfg.eot, logits.argmax(dim=-1))
        done |= nxt == cfg.eot
        tokens[:, pos + 1] = nxt
        if (pos + 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
    return tokens


@torch.inference_mode()
def beam_decode(decoder: WhisperDecoder, enc: torch.Tensor, prompt: Sequence[int],
                beam_size: int = 5, with_timestamps: bool = True) -> torch.Tensor:
    """Batched beam search -> best tokens [B, max_target_positions].

    The beam is folded into the batch ([B*W] rows through the KV-cached
    step). Each step extends every live hypothesis, takes the top-2W of the
    W*V candidates per element, refills the beam with the best W non-EOT
    candidates, moves EOT candidates ranked at or above the W-th live one
    into a first-come finished pool capped at W (openai BeamSearchDecoder's
    bookkeeping), and gathers tokens and KV caches along the back-pointers.
    The final pick maximises score / sampled length excluding EOT (openai's
    MaximumLikelihoodRanker), the finished pool padded with the best live
    hypothesis when it holds fewer than W. Ends once every element holds W
    finished hypotheses (read every ``DONE_CHECK_EVERY`` steps)."""
    cfg = decoder.cfg
    dev = enc.device
    b, w, v, l, p = enc.shape[0], beam_size, cfg.vocab_size, cfg.max_target_positions, len(prompt)
    suppress = torch.from_numpy(_suppress_mask(cfg)).to(dev)
    cross_kv = decoder.precompute_cross(enc.repeat_interleave(w, dim=0))  # beam-minor
    k_cache, v_cache = decoder.new_cache(b * w)
    tokens = _prompt_tokens(decoder, b * w, prompt, dev)
    # only beam 0 is live at the first sampling step (the beams are copies
    # until then: without this the top-W would be W duplicates)
    scores = torch.full((b, w), NEG, device=dev)
    scores[:, 0] = 0.0
    fin_scores = torch.full((b, w), NEG, device=dev)
    fin_tokens = torch.full((b, w, l), cfg.eot, dtype=torch.long, device=dev)
    fin_lengths = torch.ones((b, w), device=dev)
    fin_count = torch.zeros(b, dtype=torch.long, device=dev)
    k2 = min(2 * w, v)
    rows = torch.arange(b, device=dev)[:, None]
    j = torch.arange(w, device=dev)[None]
    for pos in range(l - 1):
        # steps past the last finished hypothesis change neither the pool nor
        # the pick (the live one is admitted only to a pool short of W)
        if pos % DONE_CHECK_EVERY == 0 and bool((fin_count >= w).all()):
            break
        logits = decoder.step(tokens[:, pos], pos, (k_cache, v_cache), cross_kv)
        if pos + 1 < p:  # prompt phase: the beams are identical, nothing scored
            continue
        if with_timestamps:
            logits = _rules_for_position(logits, tokens, pos, p, cfg, suppress)
        cand = scores[:, :, None] + torch.log_softmax(logits, dim=-1).view(b, w, v)
        top_s, top_i = torch.topk(cand.view(b, w * v), k2)
        src, tok = top_i // v, top_i % v
        is_eot = tok == cfg.eot
        # live refill: the best W non-EOT candidates
        lsel_s, lsel_i = torch.topk(top_s.masked_fill(is_eot, NEG), w)
        live_src, live_tok = src.gather(1, lsel_i), tok.gather(1, lsel_i)
        # finished candidates: EOT extensions at or above the W-th live one,
        # in candidate-score order
        fin_cand_s = torch.where(is_eot & (top_s >= lsel_s[:, w - 1 : w]), top_s, NEG)
        fsel_s, fsel_i = torch.topk(fin_cand_s, k2)
        fin_src = src.gather(1, fsel_i)
        cand_tokens = tokens.view(b, w, l)[rows, fin_src]  # [B, k2, L]
        cand_tokens[:, :, pos + 1] = cfg.eot
        # first-come fill: slot j takes new candidate j - fin_count while slots
        # remain and the candidate is valid; entries are never evicted
        new_idx = torch.clamp(j - fin_count[:, None], 0, k2 - 1)
        incoming_s = fsel_s.gather(1, new_idx)
        take_new = (j >= fin_count[:, None]) & (incoming_s > NEG / 2)
        fin_scores = torch.where(take_new, incoming_s, fin_scores)
        fin_tokens = torch.where(take_new[:, :, None], cand_tokens[rows, new_idx], fin_tokens)
        # openai's ranker length excludes the EOT token
        fin_lengths = torch.where(take_new, float(max(pos + 1 - p, 1)), fin_lengths)
        fin_count = torch.clamp(fin_count + (fsel_s > NEG / 2).sum(dim=1), max=w)
        # gather along the back-pointers (the caches up to this position)
        flat = (rows * w + live_src).view(-1)
        tokens = tokens[flat]
        k_cache[:, :, : pos + 1] = k_cache[flat, :, : pos + 1]
        v_cache[:, :, : pos + 1] = v_cache[flat, :, : pos + 1]
        tokens[:, pos + 1] = live_tok.reshape(-1)
        scores = lsel_s
    # finalize: admit the best live hypothesis when the pool holds fewer than
    # W (at budget exhaustion every live one has the same length, so this is
    # argmax-equal to openai's padding with all of them)
    live_best = scores.argmax(dim=1)
    arange_b = torch.arange(b, device=dev)
    live_tokens = tokens.view(b, w, l)[arange_b, live_best]
    fb_scores = torch.where(fin_count < w, scores[arange_b, live_best], NEG)
    fin_scores = torch.cat([fin_scores, fb_scores[:, None]], dim=1)
    fin_tokens = torch.cat([fin_tokens, live_tokens[:, None]], dim=1)
    fin_lengths = torch.cat([fin_lengths, torch.full((b, 1), float(max(l - p, 1)), device=dev)],
                            dim=1)
    best = (fin_scores / fin_lengths).argmax(dim=1)
    return fin_tokens[arange_b, best]


# -- log-mel frontend ----------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _whisper_mel_fb(n_mels: int = N_MELS) -> np.ndarray:
    return mel_filterbank(sr=SAMPLE_RATE, n_fft=N_FFT, n_mels=n_mels, fmin=0.0,
                          fmax=SAMPLE_RATE / 2)


def log_mel_whisper(wave: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """[B, 480000] 16 kHz waveform -> [B, 3000, n_mels] Whisper log-mel
    (openai whisper/audio.py log_mel_spectrogram: log10, a per-item dynamic
    range clamp to 8, (x + 4) / 4; the last STFT frame dropped)."""
    power = stft_power(wave, n_fft=N_FFT, hop=HOP)[:, :-1]  # [B, 3000, 201]
    fb = torch.from_numpy(_whisper_mel_fb(n_mels)).to(power.device)
    log_spec = torch.log10(torch.clamp(torch.matmul(power, fb), min=1e-10))
    cap = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(log_spec, cap) + 4.0) / 4.0


# -- weight conversion ----------------------------------------------------------------


def convert_hf_whisper(sd: Mapping, cfg: WhisperConfig) -> tuple[dict, dict]:
    """HF WhisperModel / WhisperForConditionalGeneration state dict (numpy or
    torch; keys with or without the leading ``model.``) -> the state dicts of
    (``WhisperEncoder``, ``WhisperDecoder``). ``proj_out`` is tied to
    ``decoder.embed_tokens`` in every released Whisper and is not read."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def copy(out: dict, port: str, hf: str, bias: bool = True) -> None:
        out[f"{port}.weight"] = as_tensor(sd[f"{hf}.weight"])
        if bias:
            out[f"{port}.bias"] = as_tensor(sd[f"{hf}.bias"])

    enc: dict = {"pos_embed": as_tensor(sd["encoder.embed_positions.weight"])}
    copy(enc, "conv1", "encoder.conv1")
    copy(enc, "conv2", "encoder.conv2")
    copy(enc, "ln", "encoder.layer_norm")
    for i in range(cfg.enc_layers):
        p, e = f"encoder.layers.{i}.", f"layer_{i}."
        copy(enc, e + "self_ln", p + "self_attn_layer_norm")
        copy(enc, e + "q", p + "self_attn.q_proj")
        copy(enc, e + "k", p + "self_attn.k_proj", bias=False)
        copy(enc, e + "v", p + "self_attn.v_proj")
        copy(enc, e + "attn_out", p + "self_attn.out_proj")
        copy(enc, e + "final_ln", p + "final_layer_norm")
        copy(enc, e + "fc1", p + "fc1")
        copy(enc, e + "fc2", p + "fc2")

    dec: dict = {
        "tok_embed": as_tensor(sd["decoder.embed_tokens.weight"]),
        "pos_embed": as_tensor(sd["decoder.embed_positions.weight"]),
    }
    copy(dec, "ln", "decoder.layer_norm")
    for i in range(cfg.dec_layers):
        p, e = f"decoder.layers.{i}.", f"layer_{i}."
        copy(dec, e + "self_ln", p + "self_attn_layer_norm")
        copy(dec, e + "sq", p + "self_attn.q_proj")
        copy(dec, e + "sk", p + "self_attn.k_proj", bias=False)
        copy(dec, e + "sv", p + "self_attn.v_proj")
        copy(dec, e + "s_out", p + "self_attn.out_proj")
        copy(dec, e + "cross_ln", p + "encoder_attn_layer_norm")
        copy(dec, e + "cq", p + "encoder_attn.q_proj")
        copy(dec, e + "ck", p + "encoder_attn.k_proj", bias=False)
        copy(dec, e + "cv", p + "encoder_attn.v_proj")
        copy(dec, e + "c_out", p + "encoder_attn.out_proj")
        copy(dec, e + "final_ln", p + "final_layer_norm")
        copy(dec, e + "fc1", p + "fc1")
        copy(dec, e + "fc2", p + "fc2")
    return enc, dec


# HF WhisperConfig's defaults for the fields read below (transformers'
# configuration_whisper.py), for a config.json that leaves one out.
HF_CONFIG_DEFAULTS = {
    "vocab_size": 51865, "num_mel_bins": 80, "d_model": 384, "encoder_layers": 4,
    "decoder_layers": 4, "encoder_attention_heads": 6, "encoder_ffn_dim": 1536,
    "max_source_positions": 1500, "max_target_positions": 448,
}


def config_from_hf(hf_cfg: Mapping | Any) -> WhisperConfig:
    """An HF Whisper config (the mapping of its ``config.json``, or an object
    with the same attributes) -> ``WhisperConfig`` (dims + vocab layout).

    The two released vocab layouts (multilingual 51865+, English-only 51864)
    pin <|endoftext|>; generic HF constructors default eos_token_id to 50256
    regardless, so the vocab size is the more reliable signal. The specials
    follow the language-tag block (openai whisper/tokenizer.py): 99 slots in
    the original vocabs, 100 in large-v3's 51866 (<|yue|>), which shifts
    every special by one. n_langs=0 marks English-only checkpoints, trained
    with the bare <|startoftranscript|> prompt."""
    def get(name: str):
        if isinstance(hf_cfg, Mapping):
            return hf_cfg.get(name, HF_CONFIG_DEFAULTS[name])
        return getattr(hf_cfg, name)

    vocab = get("vocab_size")
    multilingual = vocab >= 51865
    eot = 50257 if multilingual else 50256
    sot = eot + 1
    lang_slots = 100 if vocab >= 51866 else 99
    translate = sot + 1 + lang_slots
    return WhisperConfig(
        vocab_size=vocab,
        n_mels=get("num_mel_bins"),
        d_model=get("d_model"),
        enc_layers=get("encoder_layers"),
        dec_layers=get("decoder_layers"),
        heads=get("encoder_attention_heads"),
        d_ff=get("encoder_ffn_dim"),
        max_source_positions=get("max_source_positions"),
        max_target_positions=get("max_target_positions"),
        eot=eot,
        sot=sot,
        lang_begin=sot + 1,
        n_langs=lang_slots if multilingual else 0,
        translate=translate,
        transcribe=translate + 1,
        no_speech=translate + 4,
        no_timestamps=translate + 5,
        timestamp_begin=translate + 6,
    )


# -- segment extraction and chunked transcription -------------------------------------


def tokens_to_segments(tokens: np.ndarray, cfg: WhisperConfig, decode_text,
                       offset_s: float = 0.0) -> list[dict]:
    """<|t0|> text <|t1|> pairs of one decoded row (prompt included or not)
    -> [{start, end, text, tokens}] (whisper's segment structure, what
    bin_transcript_per_second consumes; "tokens" carries the text token ids
    for the word aligner)."""
    ts0 = cfg.timestamp_begin
    segments: list[dict] = []
    start: float | None = None
    text_ids: list[int] = []
    for tok in np.asarray(tokens).tolist():
        if tok == cfg.eot:
            break
        if tok >= ts0:
            t = (tok - ts0) * TIME_PER_TOKEN + offset_s
            if start is None:
                start = t
            else:
                text = decode_text(text_ids).strip()
                if text:
                    segments.append({"start": start, "end": t, "text": text,
                                     "tokens": list(text_ids)})
                start = None
                text_ids = []
        elif tok < cfg.eot and start is not None:
            text_ids.append(tok)
    if start is not None and text_ids:
        # unterminated final segment: close at the chunk boundary
        text = decode_text(text_ids).strip()
        if text:
            segments.append({"start": start, "end": offset_s + CHUNK_S, "text": text,
                             "tokens": list(text_ids)})
    return segments


class WhisperASR:
    """Host orchestration: waveform -> 30 s chunks -> batched encode and
    decode on ``device`` -> timestamped segments.

    ``enc_params`` / ``dec_params`` are the encoder's and decoder's state
    dicts (``convert_hf_whisper``, or carried across from the JAX params).
    ``tokenizer`` needs only ``decode(ids) -> str``; ``lang_id`` picks the
    language token (default <|en|>). ``no_speech_threshold`` (e.g. openai's
    0.6) drops a chunk's segments when P(<|nospeech|>) at the sot position
    exceeds it; opt-in, and without openai's extra avg_logprob test.
    ``device`` defaults to CUDA and raises without a card."""

    def __init__(
        self,
        cfg: WhisperConfig,
        enc_params: Mapping,
        dec_params: Mapping,
        tokenizer,
        lang_id: int | None = None,
        compute_dtype: str = "float32",
        max_chunk_batch: int = 16,
        alignment_heads: Sequence[tuple[int, int]] | None = None,
        auto_language: bool = False,
        beam_size: int = 1,
        no_speech_threshold: float | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.no_speech_threshold = no_speech_threshold
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.beam_size = beam_size
        self.max_chunk_batch = max_chunk_batch
        self.encoder = WhisperEncoder(cfg, compute_dtype, device=self.device)
        self.encoder.load_state_dict(dict(enc_params), strict=True)
        self.decoder = WhisperDecoder(cfg, compute_dtype, device=self.device)
        self.decoder.load_state_dict(dict(dec_params), strict=True)
        self.encoder.eval()
        self.decoder.eval()
        lang = lang_id if lang_id is not None else cfg.lang_begin  # <|en|>
        self.prompt = (cfg.sot, lang, cfg.transcribe) if cfg.n_langs else (cfg.sot,)
        self.alignment_heads = alignment_heads
        self._auto_lang = auto_language and cfg.n_langs > 0
        self._aligner = None

    @property
    def aligner(self):
        """The cross-attention word aligner (whisper_align.py), built at first
        use."""
        if self._aligner is None:
            from repurpose_tpu_torch.extractors.whisper_align import WhisperAligner

            self._aligner = WhisperAligner(self.decoder, self.prompt, self.alignment_heads)
        return self._aligner

    @torch.inference_mode()
    def encode_waves(self, chunks: np.ndarray) -> torch.Tensor:
        """[N, 480000] 16 kHz chunks -> encoder states [N, 1500, d]."""
        wave = torch.from_numpy(np.ascontiguousarray(chunks, np.float32)).to(self.device)
        return self.encoder(log_mel_whisper(wave, n_mels=self.cfg.n_mels))

    @torch.inference_mode()
    def detect_language(self, wave_16k: np.ndarray) -> tuple[int, float]:
        """(language token id, probability) from the first 30 s of audio:
        openai's detect_language, one decoder step on <|sot|> with the
        softmax over the language tokens. English-only checkpoints return
        (<|en|> slot, 1.0)."""
        cfg = self.cfg
        if not cfg.n_langs:
            return cfg.lang_begin, 1.0
        wave = np.zeros(N_SAMPLES, np.float32)
        wave[: min(len(wave_16k), N_SAMPLES)] = wave_16k[:N_SAMPLES]
        enc = self.encode_waves(wave[None])
        sot = torch.tensor([[cfg.sot]], device=self.device)
        logits = self.decoder(sot, enc)[0, 0]
        lang_slice = torch.softmax(logits[cfg.lang_begin : cfg.lang_begin + cfg.n_langs], dim=-1)
        idx = int(lang_slice.argmax())
        return cfg.lang_begin + idx, float(lang_slice[idx])

    @classmethod
    def from_hf_dir(
        cls,
        path: str,
        tokenizer=None,
        lang_id: int | None = None,
        compute_dtype: str = "bfloat16",
        max_chunk_batch: int = 16,
        alignment_heads: Sequence[tuple[int, int]] | None = None,
        auto_language: bool = False,
        beam_size: int = 1,
        device: str | torch.device = "cuda",
    ) -> "WhisperASR":
        """Build from a local HF Whisper checkpoint directory (config.json +
        model.safetensors / pytorch_model.bin [+ tokenizer files]). Nothing is
        fetched. ``config.json`` is read as a plain mapping; ``transformers``
        is imported only for a tokenizer that is not handed in."""
        device = resolve_device(device)
        with open(os.path.join(path, "config.json")) as f:
            cfg = config_from_hf(json.load(f))
        from repurpose_tpu_torch.preprocessing.pipeline import PreprocessingPipeline

        enc_p, dec_p = convert_hf_whisper(PreprocessingPipeline._load_state_dict(path), cfg)
        if alignment_heads is None:
            # the published per-checkpoint head list; None falls back to the
            # top-half heads in the aligner
            from repurpose_tpu_torch.extractors.whisper_align import resolve_alignment_heads

            alignment_heads = resolve_alignment_heads(path=path, cfg=cfg)
        if tokenizer is None:
            from transformers import WhisperTokenizer

            tokenizer = WhisperTokenizer.from_pretrained(path, local_files_only=True)
            if lang_id is None:
                lid = tokenizer.convert_tokens_to_ids("<|en|>")
                lang_id = lid if lid is not None and lid >= 0 else None
        return cls(cfg, enc_p, dec_p, tokenizer, lang_id=lang_id,
                   compute_dtype=compute_dtype, max_chunk_batch=max_chunk_batch,
                   alignment_heads=alignment_heads, auto_language=auto_language,
                   beam_size=beam_size, device=device)

    @torch.inference_mode()
    def _no_speech_probs(self, enc: torch.Tensor, prompt: tuple[int, ...]) -> np.ndarray:
        """Per-row P(<|nospeech|>) at the sot position (openai decoding.py
        reads the first forward's logits at sot_index): one teacher-forced
        pass over the prompt."""
        toks = torch.tensor(prompt, device=self.device)[None].expand(enc.shape[0], -1)
        probs = torch.softmax(self.decoder(toks, enc)[:, 0].float(), dim=-1)
        return probs[:, self.cfg.no_speech].cpu().numpy()

    def transcribe_file(self, path: str, word_timestamps: bool = False) -> list[dict]:
        """Video / audio file -> segments (ffmpeg decodes at 16 kHz on the host)."""
        from repurpose_tpu_torch.preprocessing.media import load_audio

        return self.transcribe_wave(load_audio(path, sr=SAMPLE_RATE),
                                    word_timestamps=word_timestamps)

    def transcribe_wave(self, wave_16k: np.ndarray, word_timestamps: bool = False) -> list[dict]:
        """Mono float waveform at 16 kHz -> [{start, end, text, tokens}], the
        chunks decoded ``max_chunk_batch`` at a time. With ``word_timestamps``
        each segment also carries ``words: [{word, start, end}]`` from the
        cross-attention DTW aligner (whisper_align.py)."""
        from repurpose_tpu_torch.extractors.whisper_align import attach_words, words_from_matrix

        if len(wave_16k) == 0:
            # zero-length audio: an all-zero chunk would invite Whisper's
            # silence hallucinations into the transcript
            return []
        prompt = self.prompt
        if self._auto_lang:
            lang, _ = self.detect_language(wave_16k)
            prompt = (self.cfg.sot, lang, self.cfg.transcribe)
        n = len(wave_16k)
        n_chunks = max(1, -(-n // N_SAMPLES))
        padded = np.zeros(n_chunks * N_SAMPLES, np.float32)
        padded[:n] = wave_16k
        chunks = padded.reshape(n_chunks, N_SAMPLES)
        segments: list[dict] = []
        for i in range(0, n_chunks, self.max_chunk_batch):
            block = chunks[i : i + self.max_chunk_batch]
            enc = self.encode_waves(block)
            if self.beam_size > 1:
                tokens = beam_decode(self.decoder, enc, prompt, self.beam_size).cpu().numpy()
            else:
                tokens = greedy_decode(self.decoder, enc, prompt).cpu().numpy()
            gated = np.zeros(len(block), bool)
            if self.no_speech_threshold is not None:
                gated = self._no_speech_probs(enc, prompt) > self.no_speech_threshold
            block_segments = [
                [] if gated[j] else tokens_to_segments(
                    tokens[j], self.cfg, self.tokenizer.decode, offset_s=(i + j) * float(CHUNK_S))
                for j in range(len(block))
            ]
            if word_timestamps and any(seg for segs in block_segments for seg in segs):
                # one aligned pass over the block, each row clamped to the
                # aligner's token budget so words match matrix rows
                rows_text = [[t for seg in segs for t in seg["tokens"]][: self.aligner.text_budget]
                             for segs in block_segments]
                content = [max(min(n - (i + j) * N_SAMPLES, N_SAMPLES), 1)
                           for j in range(len(block))]
                mats = self.aligner.align_block(rows_text, enc, content,
                                                prompt=(*prompt, self.cfg.no_timestamps))
                for j in range(len(block)):
                    words = words_from_matrix(mats[j], rows_text[j], self.tokenizer.decode,
                                              offset_s=(i + j) * float(CHUNK_S))
                    attach_words(block_segments[j], words)
            for segs in block_segments:
                segments.extend(segs)
        return segments
