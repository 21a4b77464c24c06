"""Three training steps in plain PyTorch float32, worked out from the
corpus files and the seed alone: which videos each step trains on, how
they are laid into rows, their per-second labels, the loss and its
normalisation, the dropout masks, the gradient and Adam.

The rules are the published trainer's and the configuration's, written
anew here; each names where it comes from:

- the epoch plan: a permutation of the corpus from
  ``numpy.random.default_rng((seed, epoch))``, windows of
  ``max(64, batch)`` videos; packed, each window's videos first-fit
  decreasing (by length, ties in window order) into rows of the largest
  bucket, ``batch`` rows a step; unpacked, each window's videos grouped by
  the smallest bucket that holds them (in order of first appearance) and
  cut into batches of ``batch``. A video of duration d has d + 1 rows,
  its length;
- labels: 1 on every integer second in [int(start), int(end)] of an
  annotated clip (published dataset code, RepurposeClip.py:322-345);
- the loss: the sigmoid focal loss (alpha 0.7, gamma 2) summed over valid
  seconds, divided by the videos in the batch (``loss_norm:
  batch_size``) or by the configured batch (``config_batch_size``);
- dropout: before step s a generator on the run's device is seeded from
  ``numpy.random.SeedSequence([seed % 2**32, s])``'s first 64-bit word,
  and every mask drawn from it in the order the layers use them;
- Adam with L2 weight decay (the gradient plus wd * p), betas 0.9 / 0.999,
  eps 1e-8, bias-corrected, on the leaves that a loss reaches; the learning
  rate lr * (1 + cos(pi * s / total)) / 2, total = epochs x steps an epoch.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from gpubench.reference import model as ref
from gpubench.traffic import load_features

BETAS = (0.9, 0.999)
EPS = 1e-8


def video_length(entry: dict) -> int:
    t0, t1 = entry["timeRangeOffset"]
    return int(t1 - t0) + 1


def labels_of(entry: dict) -> np.ndarray:
    n = video_length(entry)
    out = np.zeros(n, np.float32)
    for s, e in entry["segmentsOffset"]:
        a, b = max(int(s), 0), min(int(e), n - 1)
        if b >= a:
            out[a : b + 1] = 1.0
    return out


def bucket_of(length: int, buckets) -> int:
    return next((b for b in buckets if length <= b), buckets[-1])


def _first_fit_decreasing(lengths, cap):
    order = sorted(range(len(lengths)), key=lambda i: -min(lengths[i], cap))
    rows: list[list] = []  # [room, members]
    for i in order:
        d = min(lengths[i], cap)
        for row in rows:
            if d <= row[0]:
                row[0] -= d
                row[1].append(i)
                break
        else:
            rows.append([cap - d, [i]])
    return [members for _, members in rows]


def epoch_plan(lengths, seed: int, epoch: int, tc: dict) -> list[tuple[int, list[list[int]]]]:
    """The epoch's steps: (row length T, rows of corpus indices)."""
    n, bs, buckets = len(lengths), tc["batch_size"], tc["buckets"]
    order = [int(i) for i in np.random.default_rng((seed, epoch)).permutation(n)]
    window = max(64, bs)
    steps = []
    for w0 in range(0, n, window):
        win = order[w0 : w0 + window]
        if tc["pack_sequences"]:
            rows = _first_fit_decreasing([lengths[i] for i in win], buckets[-1])
            rows = [[win[j] for j in r] for r in rows]
            steps += [(buckets[-1], rows[k : k + bs]) for k in range(0, len(rows), bs)]
        else:
            groups: dict[int, list[int]] = {}
            for i in win:
                groups.setdefault(bucket_of(lengths[i], buckets), []).append(i)
            for b, idx in groups.items():
                steps += [(max(bucket_of(lengths[i], buckets) for i in idx[k : k + bs]),
                           [[i] for i in idx[k : k + bs]]) for k in range(0, len(idx), bs)]
    return steps


def build_rows(corpus: dict, t: int, rows: list[list[int]], batch: int, device) -> dict:
    """The step's inputs: videos head to tail in their rows, padded to
    ``batch`` rows of ``t`` positions."""
    dims = {m: None for m in ("visual", "audio", "text")}
    feats = {}
    valid = np.zeros((batch, t), bool)
    seg = np.full((batch, t), -1, np.int64)
    pos = np.zeros((batch, t), np.int64)
    labels = np.zeros((batch, t), np.float32)
    for r, members in enumerate(rows):
        at = 0
        for j, i in enumerate(members):
            e = corpus["entries"][i]
            f = load_features(corpus, e["youtube_id"])
            n = min(video_length(e), t - at, *(len(a) for a in f.values()))
            for m, a in f.items():
                if dims[m] is None:
                    dims[m] = a.shape[1]
                    feats[m] = np.zeros((batch, t, a.shape[1]), np.float32)
                feats[m][r, at : at + n] = a[:n]
            valid[r, at : at + n] = True
            seg[r, at : at + n] = j
            pos[r, at : at + n] = np.arange(n)
            labels[r, at : at + n] = labels_of(e)[:n]
            at += n
    out = {m: torch.from_numpy(a).to(device) for m, a in feats.items()}
    out.update(valid=torch.from_numpy(valid).to(device), seg=torch.from_numpy(seg).to(device),
               positions=torch.from_numpy(pos).to(device),
               labels=torch.from_numpy(labels).to(device),
               videos=sum(len(r) for r in rows))
    return out


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    word = int(np.random.SeedSequence([seed % 2**32, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(word)


def follow(corpus: dict, cfg: dict, seed: int, weights: dict, steps: int, device,
           precision: str = "float32", leave_out_half: bool = False) -> dict:
    """The first ``steps`` training steps from ``weights``. Returns each
    step's loss, the first step's classification logits at its valid
    positions (row by row), each leaf's first gradient as Adam gets it, and
    the parameters after the steps. ``leave_out_half`` is the fault of a step
    that drops the second half of each batch's rows and takes the mean
    over the rest."""
    m, tc = cfg["model"], cfg["train"]
    lengths = [video_length(e) for e in corpus["entries"]]
    plan = epoch_plan(lengths, seed, 0, tc)
    total = tc["epochs"] * len(plan)
    w = {k: v.detach().clone().requires_grad_(v.ndim > 0 and k != "positional_encoding.pe")
         for k, v in weights.items()}
    trained = [k for k, v in w.items() if v.requires_grad]
    moments = {k: (torch.zeros_like(w[k]), torch.zeros_like(w[k])) for k in trained}
    losses, first_grad, first_logits = [], None, None
    for s in range(steps):
        t, rows = plan[s]
        if leave_out_half and len(rows) > 1:
            rows = rows[: len(rows) // 2]
        x = build_rows(corpus, t, rows, tc["batch_size"], device)
        drops = ref.DropStream(m["dropout"], dropout_generator(seed, s, device))
        cls, _ = ref.forward(w, m, x["visual"], x["audio"], x["text"], x["valid"], x["seg"],
                             x["positions"], drops, precision)
        norm = float(x["videos"]) if tc["loss_norm"] == "batch_size" else float(tc["batch_size"])
        loss = ref.focal_loss_sum(cls, x["labels"], x["valid"]) / norm
        grads = torch.autograd.grad(loss, [w[k] for k in trained], allow_unused=True)
        losses.append(float(loss.detach()))
        if first_logits is None:
            first_logits = cls.detach()[x["valid"]]
        lr = tc["lr"] * 0.5 * (1.0 + math.cos(math.pi * min(s, total) / total))
        with torch.no_grad():
            seen = {}
            for k, g in zip(trained, grads):
                if g is None:  # no loss reaches this leaf: Adam leaves it be
                    continue
                p = w[k]
                g = g + tc["weight_decay"] * p
                seen[k] = g.clone()
                m1, m2 = moments[k]
                m1.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                m2.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                c1, c2 = 1 - BETAS[0] ** (s + 1), 1 - BETAS[1] ** (s + 1)
                p.sub_(lr / c1 * m1 / (m2.sqrt() / math.sqrt(c2) + EPS))
        if first_grad is None:
            first_grad = seen
        del x, cls, grads
    return {"losses": losses, "first_logits": first_logits, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in w.items()}}


def leaves(named) -> dict[str, torch.Tensor]:
    """The leaves compared: each parameter, the packed q/k/v projection
    taken as its three parts (the key's bias gets no gradient under the
    softmax, the query's and value's do)."""
    out = {}
    for k, v in named:
        if "in_proj" in k:
            for part, x in zip("qkv", v.chunk(3, dim=0)):
                out[f"{k}.{part}"] = x
        else:
            out[k] = v
    return out


def norms(d: dict[str, torch.Tensor]) -> dict[str, float]:
    if not d:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(v.float()) for v in d.values()]).cpu()
    return dict(zip(d, vals.tolist()))


def summary(followed: dict, w0: dict) -> dict:
    """``follow``'s result as the numbers compared: losses, the first
    step's logits, the first gradient's leaves and their norms, and the
    norms of the change over the steps."""
    grads = leaves(followed["first_grad"].items())
    return {"losses": followed["losses"], "logits": followed["first_logits"],
            "grads": grads, "grad_norms": norms(grads),
            "update_norms": norms(leaves((k, followed["params"][k] - w0[k])
                                         for k in followed["first_grad"]))}


def judge(prog: dict, ref: dict) -> dict:
    """The gaps between the program's three steps and the reference's:

    - ``loss_gap``: the widest relative gap of a step's loss, and
      ``loss_gap.first`` the first step's alone;
    - ``logit_gap``: the widest gap between the program's classification
      logit and the reference's at a valid position of the first step's
      rows, in logit units; ``.rms``: their root mean square. A program
      whose logits are missing or laid out otherwise reads infinity;
    - ``grad_gap`` and ``update_gap``: by the worst leaf, the gap between
      the program's norm and the reference's (of the first gradient; of
      the change over the steps), over the reference's norm of that leaf or
      of the median leaf, whichever is larger; ``.median``: the median
      leaf's gap;
    - ``grad_err``: by the worst leaf, the norm of the difference between
      the program's first gradient and the reference's, over the same
      denominator; ``.median``: the median leaf's. Both sides take their
      first gradient from the same weights, inputs and dropout masks, so
      the difference is the rounding alone; a gap of norms sees only the
      part of it along the gradient.

    Leaves whose first reference gradient is under a thousandth of the
    median leaf's move under Adam by round-off alone and are left out; a
    leaf the reference moves and the program does not reads 1. ``worst``
    names the three widest leaves of each, for the record."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    rg = ref["grad_norms"]
    med = statistics.median(rg.values())
    keep = [k for k, v in rg.items() if v >= 1e-3 * med]
    ru = ref["update_norms"]
    medu = statistics.median(ru[k] for k in keep)
    g = {k: abs(prog["grad_norms"].get(k, 0.0) - rg[k]) / max(rg[k], med) for k in keep}
    u = {k: abs(prog["update_norms"].get(k, 0.0) - ru[k]) / max(ru[k], medu) for k in keep}
    rgrad, pgrad = ref["grads"], prog.get("grads", {})
    diff = {k: (pgrad[k].to(rgrad[k].device).float() - rgrad[k].float()) if k in pgrad
            else rgrad[k].float() for k in keep}
    e = {k: v / max(rg[k], med) for k, v in norms(diff).items()}
    rl, pl = ref["logits"], prog.get("logits")
    if pl is None or pl.shape != rl.shape:
        lg = {"logit_gap": math.inf, "logit_gap.rms": math.inf}
    else:
        d = (pl.to(rl.device).float() - rl.float()).abs()
        lg = {"logit_gap": float(d.max()), "logit_gap.rms": float(d.square().mean().sqrt())}

    def worst(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:3]]

    return {
        "loss_gap": max(steps), "loss_gap.first": steps[0], **lg,
        "grad_gap": max(g.values()), "grad_gap.median": statistics.median(g.values()),
        "grad_err": max(e.values()), "grad_err.median": statistics.median(e.values()),
        "update_gap": max(u.values()), "update_gap.median": statistics.median(u.values()),
        "steps": steps, "worst": {"grad": worst(g), "grad_err": worst(e), "update": worst(u)},
    }
