"""Decode, Soft-NMS and the judgement of served clips, in numpy float32,
written for the benchmark from the published inference code
(models/MMCTransformer.py:181-275 and models/softnms.py:3-38 of
github.com/YosubShin/Repurpose), with that Soft-NMS's behaviour kept as
published: the selection counter tests the score before the swap, interval
lengths are taken once and indexed by position, the loop stops at the
budget before decaying with that pivot, and the kept set is "score still
above the threshold" in position order, cut to the budget. One deviation,
as the program documents it: a 0/0 overlap ratio decays to 0, not NaN.

A served clip says what its video's per-second outputs were at one
second, its label, and the clips of a video are what Soft-NMS kept. Each
is judged against the reference's per-second outputs of that video; the
widest gap over every reply of the window is reported, and a median
video's beside it:

- ``logit_gap``: the served score's logit against the reference's
  classification logit at the label (both held within +-10);
- ``score_gap``: the same in probability, which the slope of the sigmoid
  at each clip's score scales from seed to seed;
- ``bound_gap_s``: the clip's bounds against the label minus and plus the
  reference's regression offsets there, in seconds;
- ``forced_gap``: Soft-NMS replayed on the reference's candidates with the
  served clips as its pivots, in their order: by how much a served pick's
  decayed score lies below the best one left at its turn;
- ``count_gap``: a video gets as many clips as the reference's own decode
  and Soft-NMS give it.

Which of them decide ``correct`` is the cell's choice (its workload's
``limits``), made from the readings (PERF.md).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from gpubench.reference import model as ref

# logits compared within +-10: a float32 score past it no longer resolves
# its logit to a hundredth
LOGIT_CLIP = 10.0


def outputs(weights: dict, m: dict, features: dict, device, precision: str = "float32"):
    """(logits [T], offsets [T, 2]) of one video, float32 numpy."""
    t = min(len(a) for a in features.values())
    x = {k: torch.from_numpy(np.ascontiguousarray(a[:t])).to(device)[None]
         for k, a in features.items()}
    valid = torch.ones((1, t), dtype=torch.bool, device=device)
    seg = torch.zeros((1, t), dtype=torch.long, device=device)
    pos = torch.arange(t, device=device)[None]
    with torch.no_grad():
        cls, off = ref.forward(weights, m, x["visual"], x["audio"], x["text"], valid, seg, pos,
                               None, precision)
    return cls[0].cpu().numpy(), off[0].cpu().numpy()


def _sigmoid(x):
    x = np.asarray(x, np.float64)
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e)).astype(np.float32)


def budget(duration: int, rate: float) -> int:
    """ceil((duration // 60) * rate), exactly."""
    f = Fraction(float(rate)).limit_denominator(10_000)
    return int(((duration // 60) * f.numerator + f.denominator - 1) // f.denominator)


def candidates(logits, offsets, tcfg: dict):
    """(scores, segments [K, 2], labels) of the gated candidates in
    descending score, the lower second first on ties."""
    prob = _sigmoid(logits)
    k = min(int(tcfg["pre_nms_topk"]), len(prob))
    order = np.argsort(-prob, kind="stable")[:k]
    order = order[prob[order] > tcfg["pre_nms_thresh"]]
    off = np.asarray(offsets, np.float32)[order]
    left = order.astype(np.float32) - off[:, 0]
    right = order.astype(np.float32) + off[:, 1]
    dur = right - left
    ok = (dur > tcfg["duration_thresh"]) & (dur < tcfg["duration_thresh_max"])
    return prob[order][ok], np.stack([left, right], 1)[ok], order[ok]


def _decay(scores, begin, end, lengths, i, sigma):
    pos = i + 1
    overlap = np.clip(np.minimum(end[i], end[pos:]) - np.maximum(begin[i], begin[pos:]), 0.0, None)
    total = lengths[i] + lengths[pos:] - overlap
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = overlap / total
        weight = np.exp(-(ratio * ratio) / sigma)
    scores[pos:] *= np.where(np.isnan(weight), 0.0, weight).astype(np.float32)


def soft_nms(scores, segments, sigma: float, thresh: float, max_seg: int):
    """Indices (into the candidates) kept, in output order."""
    s = np.asarray(scores, np.float32).copy()
    seg = np.asarray(segments, np.float32).copy()
    n = len(s)
    idx = np.arange(n)
    begin, end = seg[:, 0], seg[:, 1]
    lengths = (end - begin).copy()
    max_segments = min(max_seg, n)
    selected = 0
    for i in range(n):
        tscore = s[i]
        if i != n - 1:
            j = i + 1 + int(np.argmax(s[i + 1 :]))
            if tscore < s[j]:
                seg[[i, j]] = seg[[j, i]]
                s[[i, j]] = s[[j, i]]
                idx[[i, j]] = idx[[j, i]]
        if tscore > thresh:
            selected += 1
            if selected >= max_segments:
                break
        _decay(s, begin, end, lengths, i, sigma)
    return idx[np.nonzero(s > thresh)[0][:max_segments]]


def forced_gap(labels, sc, seg, lab, sigma: float) -> float:
    """Soft-NMS replayed on the reference's candidates with the served
    labels as its pivots, in order: the widest gap by which a served pick's
    decayed score lies below the best one left at its turn."""
    s = np.asarray(sc, np.float32).copy()
    seg = np.asarray(seg, np.float32).copy()
    idx = np.asarray(lab).copy()
    begin, end = seg[:, 0], seg[:, 1]
    lengths = (end - begin).copy()
    worst = 0.0
    for i, want in enumerate(labels):
        if i >= len(s):
            return float("inf")
        at = np.nonzero(idx[i:] == want)[0]
        if not len(at):
            return float("inf")
        j = i + int(at[0])
        worst = max(worst, float(s[i:].max() - s[j]))
        seg[[i, j]] = seg[[j, i]]
        s[[i, j]] = s[[j, i]]
        idx[[i, j]] = idx[[j, i]]
        _decay(s, begin, end, lengths, i, sigma)
    return worst


def clips(logits, offsets, duration: int, tcfg: dict) -> dict:
    """The reference's own answer for one video."""
    sc, seg, lab = candidates(logits, offsets, tcfg)
    keep = soft_nms(sc, seg, tcfg["nms_sigma"], tcfg["min_score"],
                    budget(duration, tcfg["max_seg_per_min"]))
    return {"segments": seg[keep], "scores": sc[keep], "labels": lab[keep], "duration": duration}


def judge_video(served: dict, logits, offsets, tcfg: dict) -> dict:
    """The gaps of one video's served clips against the reference's
    per-second outputs (module docstring)."""
    labels = np.asarray(served["labels"], np.int64)
    prob = _sigmoid(logits)
    out = {"score_gap": 0.0, "logit_gap": 0.0, "bound_gap_s": 0.0}
    if len(labels):
        if labels.min() < 0 or labels.max() >= len(prob):
            return {**out, "score_gap": float("inf"), "count_gap": float("inf")}
        segs = np.asarray(served["segments"], np.float64).reshape(-1, 2)
        at = labels.astype(np.float32)
        want = np.stack([at - offsets[labels, 0], at + offsets[labels, 1]], 1)
        scores = np.asarray(served["scores"], np.float64)
        out["score_gap"] = float(np.abs(scores - prob[labels]).max())
        with np.errstate(divide="ignore"):
            z = np.log(scores) - np.log1p(-scores)
        want_z = np.asarray(logits, np.float64)[labels]
        out["logit_gap"] = float(np.abs(np.clip(z, -LOGIT_CLIP, LOGIT_CLIP)
                                        - np.clip(want_z, -LOGIT_CLIP, LOGIT_CLIP)).max())
        out["bound_gap_s"] = float(np.abs(segs - want).max())
    sc, seg, lab = candidates(logits, offsets, tcfg)
    # a served clip that the reference's gates drop by a rounding's width
    # joins the replay with the reference's values
    extra = np.setdiff1d(labels, lab)
    if len(extra):
        at = extra.astype(np.float32)
        sc = np.concatenate([sc, prob[extra]])
        seg = np.concatenate([seg, np.stack([at - offsets[extra, 0], at + offsets[extra, 1]], 1)])
        lab = np.concatenate([lab, extra])
    out["forced_gap"] = forced_gap(labels, sc, seg, lab, tcfg["nms_sigma"])
    n_ref = len(clips(logits, offsets, int(served["duration"]), tcfg)["labels"])
    out["count_gap"] = float(abs(len(labels) - n_ref))
    return out


def judge(results: list[dict], reference: dict, tcfg: dict) -> tuple[dict, int]:
    """The widest of each gap over ``results`` (each {video_id, segments,
    scores, labels, duration}) against ``reference``: video id ->
    (logits, offsets), with ``<gap>.median``, the median video's; and the
    results whose duration disagrees."""
    per: dict[str, list[float]] = {}
    wrong = 0
    for r in results:
        logits, offsets = reference[r["video_id"]]
        if int(r["duration"]) != len(logits):
            wrong += 1
            continue
        for k, v in judge_video(r, logits, offsets, tcfg).items():
            per.setdefault(k, []).append(v)
    out = {}
    for k, v in per.items():
        out[k] = max(v)
        out[f"{k}.median"] = float(np.median(v))
    return out, wrong
