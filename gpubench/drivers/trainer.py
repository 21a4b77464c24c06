"""Driver of the training cells: the port's ``Trainer`` over its own
``BatchLoader`` and a ``RepurposeDataset`` of a corpus written from the
seed, as users train.

Every step, warm-up and window alike, is the body of
``Trainer._fit_loop``: ``train_loader.epoch``, ``_device_batch`` and
``train_step`` under the ``train_step`` span, with the Trainer's cadences
of per-layer gradient norms, histograms, the finite probe and the
validation probe, and the epoch's loss logged at each epoch's end. No
checkpoint and no evaluation run. Set-up builds the Trainer, loads the
benchmark's weights into it and runs the workload's warm-up steps through
that loop; its first three steps are the ones the plain reference follows
(``gpubench/reference/train.py``): their losses, the first step's
classification logits (read by a forward hook on the model's head), each
leaf's first gradient as Adam got it (its first moment after one step over
1 - beta1), and each leaf's change over the three.

Workload keys: ``traffic``: ``videos`` (the corpus), ``lengths`` (a
``gpubench.traffic`` spec); ``warmup_steps``; ``trace``: ``min_steps``,
``min_seconds``; ``limits``.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import time

import numpy as np
import torch

from gpubench import common, traffic
from gpubench.reference import train as ref_train
from gpubench.trace import Stretch
from gpubench.weights import make_weights

FOLLOWED = 3  # steps the reference follows


def row_lengths(batch) -> list[list[int]]:
    """The video lengths laid in each row of a host batch."""
    if batch.seg_ids is not None:
        return [np.bincount(r[r >= 0]).tolist() for r in np.asarray(batch.seg_ids)]
    return [[int(d)] for d in np.asarray(batch.durations) if d > 0]


def fit_steps(trainer):
    """The step section of ``Trainer._fit_loop``, one step a ``next``:
    yields each step's host batch and metrics; ``close()`` ends it."""
    from repurpose_tpu_torch.train.step import param_histograms
    from repurpose_tpu_torch.utils.profiling import annotate

    tc = trainer.cfg.train
    epoch = 0
    while True:
        batches = trainer.train_loader.epoch(epoch)
        losses = []
        try:
            for i, batch in enumerate(batches):
                norms_now = i % trainer.grad_norm_freq == 0
                hist_now = ((trainer.state.step + 1) % trainer.hist_freq == 0
                            or trainer.state.step == 0)
                with annotate("train_step"):
                    m = trainer.train_step(trainer.state, trainer._device_batch(batch),
                                           per_layer_grad_norms=norms_now,
                                           grad_histograms=hist_now)
                step = trainer.state.step
                losses.append(m["loss"])
                if step % trainer.finite_check_freq == 1:
                    trainer._assert_finite()
                if norms_now:
                    record = {"batch/loss": m["loss"], "batch/cls_loss": m["cls_loss"],
                              "batch/grad_norm": m["grad_norm"],
                              "batch/learning_rate": m.get("learning_rate", 0.0)}
                    norms = m["grad_norms/stacked"].cpu().numpy()
                    record.update({f"grad_norm/{n}": norms[j]
                                   for j, n in enumerate(trainer._layer_names)})
                    trainer.metrics.log(record, step)
                if hist_now:
                    trainer.metrics.log_histograms(trainer._layer_names, m["hist/grads/counts"],
                                                   m["hist/grads/edges"], step, prefix="grads")
                    ph = param_histograms(trainer.state.model, trainer.mesh)
                    trainer.metrics.log_histograms(trainer._layer_names, ph["counts"],
                                                   ph["edges"], step, prefix="params")
                if tc.intra_epoch_eval_freq and (i + 1) % tc.intra_epoch_eval_freq == 0:
                    val_loss = trainer._val_probe()
                    if val_loss is not None:
                        trainer.metrics.log({"val/loss": val_loss}, step)
                yield batch, m
        finally:
            batches.close()
        epoch_loss = float(torch.stack(losses).float().mean()) if losses else 0.0
        trainer.metrics.log({"epoch": epoch + 1, "epoch/loss": epoch_loss},
                            trainer.state.step)
        epoch += 1


def setup(ctx):
    """Set-up of a run: the corpus written from the seed, the Trainer with
    the benchmark's weights, and the workload's warm-up steps through the
    Trainer's loop. Returns the Trainer, the loop (``fit_steps``), the
    corpus and what the first ``FOLLOWED`` steps produced: their losses,
    the first step's classification logits at its valid positions and each
    leaf's first gradient as Adam got it (both on the host), that gradient's
    norms, and the norms of each leaf's change over them."""
    from repurpose_tpu_torch.config import DatasetConfig
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.train.loop import Trainer

    wl, raw, dev = ctx.workload, ctx.config, ctx.device
    tw, m = wl["traffic"], raw["model"]
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    lengths = traffic.durations(tw["lengths"], tw["videos"], ctx.seed)
    dims = {"visual": m["vis_dim"], "audio": m["aud_dim"], "text": m["text_dim"]}
    corpus = traffic.write_corpus(str(ctx.scratch / "corpus"), lengths, dims, ctx.seed, dev)
    ctx.say(f"corpus: {len(lengths)} videos, {corpus['bytes']} bytes of features, "
            f"written by {time.time() - ctx.t_start:.3f} s")
    d = corpus["dirs"]
    split = DatasetConfig(label_path=corpus["label_path"], video_path=d["visual"],
                          audio_path=d["audio"], text_path=d["text"])
    cfg = common.program_config(raw, ctx.seed)
    cfg = dataclasses.replace(cfg, train_dataset=split)
    trainer = Trainer(cfg, str(ctx.scratch / "work"), RepurposeDataset(split, validate=True),
                      device=dev)
    model, opt = trainer.state.model, trainer.state.optimizer
    w0 = make_weights(m, ctx.seed, dev)
    model.load_state_dict(w0, strict=True)
    beta1 = opt.param_groups[0]["betas"][0]
    ctx.say(f"Trainer built, weights loaded by {time.time() - ctx.t_start:.3f} s")

    steps = fit_steps(trainer)
    followed = {"losses": []}
    logits = []  # the first step's classification logits, as its forward gave them
    hook = model.cls_head.register_forward_hook(
        lambda mod, inp, out: logits.append(out.detach()[..., 0].float()))
    for s in range(wl["warmup_steps"]):
        batch, out = next(steps)
        if s < FOLLOWED:
            followed["losses"].append(out["loss"])
        if s == 0:
            hook.remove()
            valid = torch.as_tensor(np.asarray(batch.mask), device=logits[0].device)
            followed["logits"] = logits[0][valid].cpu()
            del logits
            # the first gradient as Adam got it
            grads = ref_train.leaves((n, opt.state[p]["exp_avg"] / (1 - beta1))
                                     for n, p in model.named_parameters() if p in opt.state)
            followed["grad_norms"] = ref_train.norms(grads)
            followed["grads"] = {k: v.detach().float().cpu() for k, v in grads.items()}
            del grads
        if s == FOLLOWED - 1:
            named = [(n, p.detach() - w0[n]) for n, p in model.named_parameters()]
            followed["update_norms"] = ref_train.norms(ref_train.leaves(named))
            del named, w0
    followed["losses"] = [float(x) for x in followed["losses"]]
    return trainer, steps, corpus, followed


def judge(ctx, corpus: dict, followed: dict) -> dict:
    """The reference's first ``FOLLOWED`` steps against the program's."""
    m = ctx.config["model"]
    w0 = make_weights(m, ctx.seed, ctx.device)
    ref = ref_train.summary(ref_train.follow(
        corpus, {"model": m, "train": common.train_settings(ctx.config)}, ctx.seed, w0,
        FOLLOWED, ctx.device), w0)
    ctx.say("losses: program " + " ".join(repr(x) for x in followed["losses"])
            + "; reference " + " ".join(repr(x) for x in ref["losses"]))
    return ref_train.judge(followed, ref)


def run(ctx) -> dict:
    wl, dev = ctx.workload, ctx.device
    trainer, steps, corpus, followed = setup(ctx)

    stretch = Stretch("train") if ctx.trace else None
    if stretch is not None:  # the profiler's start-up before the window
        stretch.start()
    common.sync(dev)
    common.reset_peak(dev)
    t0 = time.perf_counter()
    setup_s = time.time() - ctx.t_start
    trace, span_rows, window_rows = None, [], []
    t1 = t0 + ctx.seconds
    while time.perf_counter() < t1:
        batch, _ = next(steps)
        rows = row_lengths(batch)
        window_rows.append(rows)
        if stretch is not None:
            span_rows.append(rows)
            if (len(span_rows) >= wl["trace"]["min_steps"]
                    and time.perf_counter() - t0 >= wl["trace"]["min_seconds"]):
                trace = stretch.stop()
                stretch = None
    if stretch is not None:
        trace = stretch.stop()
    common.sync(dev)
    t_end = time.perf_counter()
    memory_peak = common.peak_bytes(dev)
    steps.close()
    trainer.close()
    del trainer, steps
    common.free_device()

    videos = sum(len(r) for rows in window_rows for r in rows)
    ctx.say(f"steps in the window: {len(window_rows)}, {videos} videos, "
            f"{t_end - t0:.6f} s to the closing synchronize")
    reader = {"kind": "train"}
    if ctx.trace:
        reader.update(videos=sum(len(r) for rows in span_rows for r in rows), rows=span_rows)
        ctx.say(f"traced: {len(span_rows)} steps, {reader['videos']} videos")

    # the comparison: the reference follows the first three steps
    gaps = judge(ctx, corpus, followed)
    shutil.rmtree(ctx.scratch, ignore_errors=True)
    ctx.say(f"gaps {json.dumps(gaps)}")
    limits = wl["limits"]
    return {
        "e2e": {"train_videos_per_s": videos / (t_end - t0),
                "train_peak_gib": memory_peak / 2**30, "setup_s": setup_s},
        "attempted": len(window_rows), "failed": 0,
        "compared": {k: gaps[k] for k in limits}, "limits": limits, "sound": True,
        "memory_peak_bytes": memory_peak, "trace": trace, "reader": reader,
    }
