"""Word-level timestamps from Whisper's own cross-attention: the port of
``repurpose_tpu/extractors/whisper_align.py`` (the replacement for the
reference's WhisperX forced aligner, text_feature_extractor.py:129-160).

1. teacher-force the decoded text tokens and read the alignment heads'
   cross-attention: ``WhisperDecoder.alignment_matrix`` returns the finished
   [tokens, frames] similarity (softmax over content frames, per-head column
   standardisation, median filter, head average), on the card;
2. DTW the negated matrix for the monotonic token/frame path: root
   ``csrc/dtw.cc`` built for the host (``native.dtw_path``), with the numpy
   fallback the JAX package has too;
3. group tokens into words and read each word's start / end from the path's
   jump times (20 ms per encoder position).

Alignment heads: ``resolve_alignment_heads`` takes the checkpoint's
published list from its ``generation_config.json``, else from the bundled
``PUBLISHED_ALIGNMENT_HEADS`` table of the openai/whisper-* releases;
checkpoints matched by neither fall back to every head of the top half of
the decoder layers (openai's own fallback), which gives blunter timings.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repurpose_tpu_torch.extractors.whisper_torch import (
    HOP,
    N_SAMPLES,
    WhisperConfig,
    WhisperDecoder,
)
from repurpose_tpu_torch.native import dtw_path

SAMPLES_PER_POSITION = HOP * 2  # one encoder position = 2 mel frames = 20 ms
TIME_PER_POSITION = 0.02


def default_alignment_heads(cfg: WhisperConfig) -> list[tuple[int, int]]:
    """All heads of the top half of decoder layers (openai-whisper's fallback
    when a checkpoint ships no alignment-head dump)."""
    return [
        (layer, head)
        for layer in range(cfg.dec_layers // 2, cfg.dec_layers)
        for head in range(cfg.heads)
    ]


# (decoder layer, head) pairs whose cross-attention tracks the audio position,
# per released openai checkpoint — the values HF republishes in each model's
# generation_config.json ("alignment_heads"), decoded from openai-whisper's
# _ALIGNMENT_HEADS blobs. Using the dumped heads instead of the top-half
# fallback is what WhisperX-quality timing needs (the fallback averages in
# many heads that attend elsewhere, blurring the DTW ridge).
PUBLISHED_ALIGNMENT_HEADS: dict[str, tuple[tuple[int, int], ...]] = {
    "tiny": ((2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)),
    "tiny.en": ((1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)),
    "base": ((3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)),
    "base.en": ((3, 3), (4, 7), (5, 1), (5, 5), (5, 7)),
    "small": (
        (5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
        (9, 9), (10, 5),
    ),
    "small.en": (
        (6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7), (9, 0),
        (9, 4), (9, 8), (9, 10),
    ),
    "medium": ((13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)),
    "medium.en": (
        (11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0), (16, 4),
        (16, 9), (17, 12), (17, 14), (18, 7), (18, 10), (18, 15), (20, 0),
        (20, 3), (20, 9), (20, 14), (21, 12),
    ),
    "large-v1": (
        (9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11), (22, 17),
        (23, 2), (23, 15),
    ),
    "large-v2": (
        (10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15), (17, 16),
        (18, 4), (18, 11), (18, 19), (19, 11), (21, 2), (21, 3), (22, 3),
        (22, 9), (22, 12), (23, 5), (23, 7), (23, 13), (25, 5), (26, 1),
        (26, 12), (27, 15),
    ),
    "large-v3": (
        (7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14), (19, 11),
        (21, 4), (24, 1), (25, 6),
    ),
    "large-v3-turbo": ((2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)),
}

# (d_model, decoder layers, vocab size, mel bins) -> checkpoint name; .en
# variants differ from multilingual only in vocab (51864 vs 51865), v3-family
# in mels (128) and vocab (51866). large-v1 and large-v2 share dims — v2 wins
# the dims lookup (it superseded v1 as openai's "large"); pass
# alignment_heads explicitly or name the directory "...large-v1" to override.
_DIMS_TO_NAME: dict[tuple[int, int, int, int], str] = {
    (384, 4, 51865, 80): "tiny",
    (384, 4, 51864, 80): "tiny.en",
    (512, 6, 51865, 80): "base",
    (512, 6, 51864, 80): "base.en",
    (768, 12, 51865, 80): "small",
    (768, 12, 51864, 80): "small.en",
    (1024, 24, 51865, 80): "medium",
    (1024, 24, 51864, 80): "medium.en",
    (1280, 32, 51865, 80): "large-v2",
    (1280, 32, 51866, 128): "large-v3",
    (1280, 4, 51866, 128): "large-v3-turbo",
}

# name -> canonical dims, for rejecting a NAME match that contradicts the
# checkpoint's actual architecture (e.g. a large-v3 checkpoint in a dir
# named "whisper-large" must not get v2's heads just because both have
# 32 layers x 20 heads). large-v1 shares v2's dims (the one true ambiguity).
_NAME_TO_DIMS: dict[str, tuple[int, int, int, int]] = {
    v: k for k, v in _DIMS_TO_NAME.items()
}
_NAME_TO_DIMS["large-v1"] = (1280, 32, 51865, 80)


def resolve_alignment_heads(
    path: str | None = None,
    cfg: WhisperConfig | None = None,
    name: str | None = None,
) -> list[tuple[int, int]] | None:
    """Best-available alignment heads for a checkpoint, or None (caller falls
    back to ``default_alignment_heads``). Precedence:

    1. ``generation_config.json`` in the HF directory (authoritative — HF
       ships the openai dump there);
    2. checkpoint name match (directory basename or explicit ``name``,
       e.g. "whisper-base.en") against the bundled table;
    3. model-dimension match (unique per release except large-v1/v2).

    When ``cfg`` is given, any resolved list whose (layer, head) pairs don't
    fit the actual architecture is REJECTED (returns None -> top-half-heads
    fallback) — e.g. a distil-whisper directory named "*large-v3*" matches
    the name table but has 2 decoder layers; indexing (7, 0) would crash.
    """
    import json
    import os
    import re

    def _fits(heads_list):
        if cfg is None:
            return heads_list
        ok = all(
            0 <= l < cfg.dec_layers and 0 <= h < cfg.heads
            for l, h in heads_list
        )
        return heads_list if ok else None

    if path is not None:
        gc = os.path.join(path, "generation_config.json")
        if os.path.exists(gc):
            try:
                with open(gc) as f:
                    data = json.load(f)
                heads = data.get("alignment_heads") if isinstance(data, dict) else None
                if heads:
                    resolved = _fits([(int(l), int(h)) for l, h in heads])
                    if resolved:
                        return resolved
            except (ValueError, OSError, TypeError):
                pass
    dims = (
        None if cfg is None
        else (cfg.d_model, cfg.dec_layers, cfg.vocab_size, cfg.n_mels)
    )
    candidates = []
    if name:
        candidates.append(name)
    if path:
        candidates.append(os.path.basename(os.path.normpath(path)))
    for cand in candidates:
        m = re.search(r"(tiny|base|small|medium|large(?:-v\d+)?(?:-turbo)?)(\.en)?",
                      cand.lower())
        if m:
            key = m.group(1) + (m.group(2) or "")
            if key == "large":
                # bare "large" is an openai alias whose target moved over
                # the releases (v1 -> v2 -> v3); when dims are known the
                # consistency check below picks the real release, this
                # default only decides the cfg-less case
                key = "large-v2"
            if key in PUBLISHED_ALIGNMENT_HEADS:
                expected = _NAME_TO_DIMS.get(key)
                if dims is not None and expected is not None and expected != dims:
                    continue  # name contradicts the architecture; trust dims
                resolved = _fits(list(PUBLISHED_ALIGNMENT_HEADS[key]))
                if resolved:
                    return resolved
    if dims is not None:
        key = _DIMS_TO_NAME.get(dims)
        if key is not None:
            return _fits(list(PUBLISHED_ALIGNMENT_HEADS[key]))
    return None


# Scripts written without inter-word spaces (openai-whisper treats zh/ja/th/
# lo/my/yue as such and splits words per decoded unicode character there):
# CJK ideographs (+ext A, compat), kana, Thai, Lao, Myanmar.
_NO_SPACE_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0xF900, 0xFAFF),  # CJK ideographs
    (0x20000, 0x2EBEF), (0x2F800, 0x2FA1F), (0x30000, 0x3134F),  # ext B..G
    (0x3040, 0x309F), (0x30A0, 0x30FF),  # hiragana, katakana
    (0x0E00, 0x0E7F), (0x0E80, 0x0EFF), (0x1000, 0x109F),  # Thai, Lao, Myanmar
)


def _no_space_script(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _NO_SPACE_RANGES)


def split_words(
    tokens: Sequence[int], decode: Callable[[list[int]], str]
) -> list[tuple[str, int]]:
    """Group text tokens into words -> [(word, n_tokens)], preserving order.

    Uses incremental decoding (a new word starts when the decoded piece opens
    with whitespace), so it works with byte-level BPE vocabularies where a
    single token can be a partial UTF-8 sequence; a piece that decodes to the
    replacement character joins the current word. Spaceless scripts (CJK,
    Thai, Lao, Myanmar) split at every TOKEN-RUN seam between their
    characters instead of only at whitespace — each singly-tokenized ideogram
    gets its own timestamp rather than one blob per whitespace run. Timing
    granularity is the token: a single BPE token that decodes to multiple
    ideograms stays one word (openai's per-character splitter has the same
    floor — sub-token timestamps would be fabricated)."""
    toks = list(tokens)

    # Stage 1 (openai split_tokens_on_unicode): tokens -> complete decoded
    # units. A unit is the smallest token run whose incremental decode piece
    # is UTF-8 complete (doesn't end in U+FFFD) — so a character split across
    # byte-level BPE tokens becomes ONE unit carrying ALL its tokens, instead
    # of a stale replacement char attributed to the previous word.
    units: list[tuple[str, int]] = []
    start = 0
    # unit-LOCAL decode (openai split_tokens_on_unicode decodes only the
    # open unit's tokens): byte-level BPE pieces concatenate, so decoding
    # toks[start:i+1] equals the corresponding slice of the full decode —
    # and the full-prefix alternative is O(n^2) tokenizer work per chunk
    # (measured 97k cumulative tokens for one 440-token chunk).
    for i in range(len(toks)):
        piece = decode(toks[start : i + 1])
        if piece == "" or not piece.endswith("�"):
            units.append((piece, i + 1 - start))
            start = i + 1
    if start < len(toks):  # trailing incomplete bytes lump into a final unit
        units.append((decode(toks[start:]), len(toks) - start))

    # Stage 2 (split_tokens_on_spaces): units -> words. A new word starts at
    # leading whitespace, or at a spaceless-script seam (CJK/Thai/Lao/Myanmar
    # — each ideogram is its own word, openai's behavior for zh/ja/th/lo/my).
    words: list[tuple[str, int]] = []
    cur_text, cur_n = "", 0
    pending = 0  # tokens of whitespace-only runs, folded into a neighbor

    def flush() -> None:
        # Token counts must sum to len(tokens) — the aligner indexes jump
        # times by cumulative token position, so a dropped whitespace-only
        # "word" would shift every later word's timing. Fold such runs into
        # the next word (or the previous one at end-of-sequence).
        nonlocal cur_text, cur_n, pending
        if cur_text.strip():
            words.append((cur_text.strip(), cur_n + pending))
            pending = 0
        else:
            pending += cur_n
        cur_text, cur_n = "", 0

    for piece, n_tok in units:
        stripped = piece.strip()
        starts_new = piece.startswith((" ", "\n", "\t")) and stripped != ""
        if not starts_new and stripped and cur_text.strip():
            if _no_space_script(stripped[0]) or _no_space_script(
                cur_text.strip()[-1]
            ):
                starts_new = True
        if cur_n and starts_new:
            flush()
        cur_text += piece
        cur_n += n_tok
    flush()
    if pending and words:  # trailing whitespace tokens join the last word
        word, n = words[-1]
        words[-1] = (word, n + pending)
    return words


def words_from_matrix(
    matrix: np.ndarray,  # [n_text + 1, content_frames] (text rows + EOT row)
    text_tokens: Sequence[int],
    decode: Callable[[list[int]], str],
    offset_s: float = 0.0,
) -> list[dict]:
    """DTW the similarity matrix -> [{word, start, end}] with absolute times.
    The EOT row supplies the final word's end boundary."""
    n = len(text_tokens)
    if n == 0 or matrix.shape[0] != n + 1 or matrix.shape[1] == 0:
        return []
    ti, tj = dtw_path(-matrix.astype(np.float32))
    # first frame at which the path reaches each token row = that token's start
    jump_times = np.zeros(n + 1, np.float64)
    seen = np.zeros(n + 1, bool)
    for a, b in zip(ti.tolist(), tj.tolist()):
        if not seen[a]:
            seen[a] = True
            jump_times[a] = b * TIME_PER_POSITION
    words = []
    pos = 0
    for word, n_tok in split_words(text_tokens, decode):
        words.append(
            {
                "word": word,
                "start": round(offset_s + jump_times[pos], 2),
                "end": round(offset_s + jump_times[min(pos + n_tok, n)], 2),
                "_n_tokens": n_tok,  # consumed by attach_words
            }
        )
        pos += n_tok
    return words


def attach_words(segments: list[dict], words: list[dict]) -> None:
    """Distribute chunk-level words into their segments (in place) by token
    count: segments carry their text token ids (tokens_to_segments), and the
    words were aligned over the concatenation of exactly those ids."""
    it = iter(words)
    budgets = []
    for seg in segments:
        n = len(seg.get("tokens", ()))
        budgets.append(n)
        seg["words"] = []
    # words consume tokens in order; a word belongs to the segment in which
    # it STARTS (a word can never straddle segments: segment boundaries are
    # timestamp tokens, which never appear mid-word)
    consumed = 0
    boundaries = np.cumsum(budgets)
    for w in it:
        n_tok = w.pop("_n_tokens", 1)
        seg_idx = int(np.searchsorted(boundaries, consumed, side="right"))
        if seg_idx < len(segments):
            segments[seg_idx]["words"].append(w)
        consumed += n_tok


class WhisperAligner:
    """Batched chunk aligner: ``align_block`` lays each row's alignment
    sequence (prompt + <|notimestamps|> + text + EOT) into one
    ``[B, L]`` batch, L the longest row's length (the JAX aligner pads L to a
    64-token bucket for XLA; padding rows are masked out of every valid
    row's result either way)."""

    def __init__(self, decoder: WhisperDecoder, prompt: Sequence[int],
                 alignment_heads: Sequence[tuple[int, int]] | None = None):
        cfg = decoder.cfg
        self.cfg = cfg
        self.decoder = decoder
        self.prompt = (*prompt, cfg.no_timestamps)
        head_w = np.zeros((cfg.dec_layers, cfg.heads), np.float32)
        for layer, head in list(alignment_heads or default_alignment_heads(cfg)):
            head_w[layer, head] = 1.0
        head_w /= max(head_w.sum(), 1.0)
        self.head_w = torch.from_numpy(head_w).to(decoder.tok_embed.device)

    @property
    def text_budget(self) -> int:
        """Max text tokens per aligned row (prompt + text + EOT must fit in
        max_target_positions); callers clamp before ``align_block`` so the
        token list matches the matrix rows."""
        return self.cfg.max_target_positions - len(self.prompt) - 1

    @torch.inference_mode()
    def align_block(
        self,
        rows_text_tokens: Sequence[Sequence[int]],
        enc: torch.Tensor,  # [B, S, d] encoder states for the same rows
        content_samples: Sequence[int],
        prompt: Sequence[int] | None = None,
    ) -> list[np.ndarray]:
        """-> per row, the [n_text + 1, content_positions] similarity matrix
        (text rows + EOT row), ready for ``words_from_matrix``. ``prompt``
        overrides the constructor's (e.g. a per-video detected language)."""
        prompt_seq = tuple(prompt) if prompt is not None else self.prompt
        p = len(prompt_seq)
        b, s = len(rows_text_tokens), enc.shape[1]
        longest = max((len(r) for r in rows_text_tokens), default=0)
        l = min(p + longest + 1, self.cfg.max_target_positions)
        tokens = np.full((b, l), self.cfg.eot, np.int64)
        token_valid = np.zeros((b, l), bool)
        frame_valid = np.zeros((b, s), bool)
        n_text = []
        for i, row in enumerate(rows_text_tokens):
            row = list(row)[: l - p - 1]
            n_text.append(len(row))
            tokens[i, :p] = prompt_seq
            tokens[i, p : p + len(row)] = row
            token_valid[i, : p + len(row) + 1] = True  # prompt + text + eot
            pos = max(1, -(-min(int(content_samples[i]), N_SAMPLES) // SAMPLES_PER_POSITION))
            frame_valid[i, : min(pos, s)] = True
        dev = enc.device
        matrix = self.decoder.alignment_matrix(
            torch.from_numpy(tokens).to(dev), enc, torch.from_numpy(token_valid).to(dev),
            torch.from_numpy(frame_valid).to(dev), self.head_w,
        ).float().cpu().numpy()
        out = []
        for i, n in enumerate(n_text):
            frames = int(frame_valid[i].sum())
            out.append(matrix[i, p : p + n + 1, :frames])
        return out
