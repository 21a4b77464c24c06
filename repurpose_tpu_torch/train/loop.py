"""Trainer: the training and evaluation driver on one card
(``repurpose_tpu/train/loop.py``).

- epoch loop over ``BatchLoader`` with a per-epoch reshuffle (packed or
  bucketed batches), one eager train step per batch;
- per-layer gradient norms logged every ``grad_norm_freq`` steps, the
  non-finite probe every ``finite_check_freq`` steps and before every save
  (a poisoned state is never written);
- the validation-loss probe every ``intra_epoch_eval_freq`` steps on at most
  10 val batches;
- periodic checkpoints every ``save_epochs`` epochs, best-tIoU checkpoints in
  their own directory, ``resume`` (a mid-epoch save re-runs its epoch);
- SIGTERM: checkpoint with ``epoch_complete=False`` and return;
- ``evaluate``: precision@tIoU through the port's ``InferencePipeline``,
  handed the live weights;
- ``fit_with_auto_resume``: rebuild and resume after a crash.

Not ported yet (ROADMAP): the mesh, ZeRO-1 and pipeline branches of the JAX
Trainer, multi-host evaluation, gradient/parameter histograms, debug
figures and wandb.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import signal
import time

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.config import Config
from repurpose_tpu_torch.data.batching import Batch, collate, iter_packed_batches, pick_bucket
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.train.checkpoint import Checkpointer
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import (
    batch_to_device,
    kernel_layer_names,
    make_eval_step,
    make_train_step,
)
from repurpose_tpu_torch.utils.logging_utils import MetricLogger
from repurpose_tpu_torch.utils.metrics import calculate_tiou

logger = logging.getLogger(__name__)

TIOU_THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)


class Trainer:
    """``device`` defaults to CUDA and raises when no card is visible; pass
    ``device="cpu"`` to train on the CPU. ``init_params`` is a state dict in
    the reference's names (a warm start; loaded strictly)."""

    def __init__(
        self,
        cfg: Config,
        workdir: str,
        train_ds,
        val_ds=None,
        test_ds=None,
        init_params=None,
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.workdir = workdir
        self.device = resolve_device(device)
        tc = cfg.train
        mesh = cfg.mesh
        if mesh.model > 1 or mesh.seq > 1 or mesh.pipe > 1 or mesh.data > 1:
            raise NotImplementedError(
                f"mesh {mesh}: the port trains on one card; tensor, sequence, "
                "pipeline and data parallelism are not ported yet (ROADMAP.md, "
                "Queue 1 item 9)"
            )
        if tc.pack_sequences and tc.loss_norm == "config_batch_size":
            logger.warning(
                "pack_sequences with loss_norm='config_batch_size' divides the loss "
                "by rows, not videos; use loss_norm='batch_size' for per-video "
                "normalisation"
            )
        self.train_loader = BatchLoader(
            train_ds, batch_size=tc.batch_size, buckets=tc.buckets, shuffle=True,
            seed=tc.seed, pack=tc.pack_sequences,
        )
        self.val_ds = val_ds
        self.test_ds = test_ds
        self.steps_per_epoch = max(self.train_loader.batches_per_epoch(0), 1)

        model = build_model(cfg.model, self.device, seed=tc.seed)
        if init_params is not None:
            model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                 for k, v in init_params.items()},
                strict=True,
            )
        model.set_dropout_generator(
            torch.Generator(device=self.device).manual_seed(tc.seed)
        )
        optimizer, schedule = make_optimizer(model, tc, self.steps_per_epoch)
        self.state = TrainState(model=model, optimizer=optimizer)
        self.train_step = make_train_step(cfg.model, tc, schedule)
        self.eval_step = make_eval_step(tc)
        # cadences: per-layer grad norms every 10 steps (reference
        # main.py:345-367); the finite probe is the only periodic host sync
        self.grad_norm_freq = 10
        self.finite_check_freq = 50
        self._layer_names = kernel_layer_names(model)

        self.checkpointer = Checkpointer(workdir + "/ckpt")
        self._best_ckpt: Checkpointer | None = None  # lazy (workdir/ckpt_best)
        self.metrics = MetricLogger(workdir)
        eval_model_cfg = dataclasses.replace(
            cfg.model, dropout=0.0,
            attention_impl="auto" if cfg.model.attention_impl == "ring"
            else cfg.model.attention_impl,
        )
        # evaluate() hands the pipeline the live weights on every call
        self.pipeline = InferencePipeline(
            eval_model_cfg, model.state_dict(), cfg.test_cfg, device=self.device
        )
        self.best_tiou = 0.0
        self.best_epoch = -1
        self.start_epoch = 0

    def _device_batch(self, batch: Batch) -> Batch:
        return batch_to_device(batch, self.device)

    # -- checkpointing ---------------------------------------------------------

    def resume(self) -> bool:
        step = self.checkpointer.latest_step()
        if step is None:
            return False
        self.state, meta = self.checkpointer.restore(self.state, step)
        self.start_epoch = int(meta.get("epoch", 0))
        self.best_tiou = float(meta.get("best_tiou", 0.0))
        self.best_epoch = int(meta.get("best_epoch", -1))
        logger.info("resumed from step %d (epoch %d)", step, self.start_epoch)
        return True

    def _assert_finite(self) -> None:
        """Raise if any train step so far produced a non-finite loss or
        gradient norm; every step was checked on the device, this one read
        covers them all."""
        bad = int(self.state.nonfinite_count)
        if bad:
            raise FloatingPointError(
                f"{bad} train step(s) produced non-finite loss/gradients "
                f"(by step {self.state.step}); refusing to continue"
            )

    def _save(self, epoch: int, extra: dict | None = None,
              epoch_complete: bool = True) -> None:
        self._assert_finite()  # never persist a poisoned state
        meta = {
            # a mid-epoch (preemption) save re-runs its epoch on resume
            "epoch": epoch + 1 if epoch_complete else epoch,
            "best_tiou": self.best_tiou,
            "best_epoch": self.best_epoch,
        }
        meta.update(extra or {})
        self.checkpointer.save(self.state.step, self.state, meta)

    def _save_best(self, epoch: int) -> None:
        """Best-tIoU weights in their own single-slot directory
        (workdir/ckpt_best), out of reach of the periodic saves' pruning."""
        if self._best_ckpt is None:
            self._best_ckpt = Checkpointer(self.workdir + "/ckpt_best", max_to_keep=1)
        self._best_ckpt.save(
            self.state.step, self.state,
            {"epoch": epoch + 1, "best_tiou": self.best_tiou,
             "best_epoch": self.best_epoch, "best": True},
        )

    # -- validation probe --------------------------------------------------------

    def _val_probe(self, max_batches: int = 10) -> float | None:
        if self.val_ds is None:
            return None
        if not hasattr(self, "_val_loader"):  # deterministic: build once
            self._val_loader = BatchLoader(
                self.val_ds, batch_size=self.cfg.train.batch_size,
                buckets=self.cfg.train.buckets, shuffle=False,
            )
        losses = []
        for batch in itertools.islice(self._val_loader.epoch(0), max_batches):
            out = self.eval_step(self.state.model, self._device_batch(batch))
            # normalised by the actual batch size (reference main.py:460-463)
            losses.append(float(out["cls_loss"]) / max(int(out["n_real"]), 1))
        return float(np.mean(losses)) if losses else None

    # -- evaluation ---------------------------------------------------------------

    def evaluate(self, dataset=None, max_videos: int | None = None,
                 pack: bool | None = None) -> dict:
        """Precision@tIoU over ``dataset`` (default: the test split).
        ``pack`` sequence-packs each bucket's videos (same results); it
        defaults to the training config's ``pack_sequences`` and needs a
        dataset with ``lengths()``."""
        ds = dataset if dataset is not None else self.test_ds
        if ds is None:
            return {}
        params = self.state.model.state_dict()
        bs = self.cfg.train.batch_size
        buckets = self.cfg.train.buckets
        n = len(ds) if max_videos is None else min(len(ds), max_videos)
        idx = list(range(n))
        sums = {t: 0.0 for t in TIOU_THRESHOLDS}
        count = 0
        entries = getattr(ds, "entries", None)
        use_pack = self.cfg.train.pack_sequences if pack is None else pack
        use_pack = use_pack and hasattr(ds, "lengths")
        gt_fifo: collections.deque = collections.deque()

        def gt_for(i, sample):
            if entries is not None:  # the split's own annotations
                return [list(s) for s in entries[i]["segmentsOffset"]]
            return sample.get("gt_segments") or []

        def staged():
            if hasattr(ds, "lengths"):  # group per bucket, chunk within
                lens = ds.lengths()
                groups: dict[int, list[int]] = {}
                for i in idx:
                    groups.setdefault(pick_bucket(int(lens[i]), buckets), []).append(i)
                chunks = [groups[b][j : j + bs] for b in sorted(groups)
                          for j in range(0, len(groups[b]), bs)]
            else:
                chunks = [idx[j : j + bs] for j in range(0, len(idx), bs)]
            for chunk in chunks:
                samples = [ds[i] for i in chunk]
                batch = collate(samples, buckets, bs)
                gt_fifo.append([gt_for(i, s) for i, s in zip(chunk, samples)])
                yield (batch.visual, batch.audio, batch.text, batch.mask,
                       batch.durations, [str(s.get("video_id", i))
                                         for i, s in zip(chunk, samples)])

        def staged_packed():
            lens = [int(t) for t in ds.lengths()]
            for batch, layout, gidx, samples in iter_packed_batches(
                lambda i: ds[i], lens, buckets, bs, indices=idx
            ):
                gt_fifo.append([gt_for(i, s) for i, s in zip(gidx, samples)])
                yield batch, layout, [str(s.get("video_id", i))
                                      for i, s in zip(gidx, samples)]

        stream = (self.pipeline.score_packed_stream(staged_packed(), params=params)
                  if use_pack else self.pipeline.score_stream(staged(), params=params))
        for results in stream:
            for gt, r in zip(gt_fifo.popleft(), results):
                tiou = calculate_tiou(gt, r["segments"].tolist(), TIOU_THRESHOLDS)
                for t in TIOU_THRESHOLDS:
                    sums[t] += tiou[t]
                count += 1
        out = {f"tiou/{t}": (sums[t] / count if count else 0.0) for t in TIOU_THRESHOLDS}
        out["tiou/mean"] = float(np.mean([out[f"tiou/{t}"] for t in TIOU_THRESHOLDS]))
        return out

    # -- main loop ------------------------------------------------------------------

    def fit(self, epochs: int | None = None) -> dict:
        """Train to ``epochs`` (default: the config's). On SIGTERM the state
        is checkpointed mid-epoch and ``{"preempted": True, ...}`` returned."""
        epochs = epochs if epochs is not None else self.cfg.train.epochs
        preempted = {"flag": False}

        def on_sigterm(signum, frame):
            preempted["flag"] = True

        try:
            prev = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev = None
        try:
            return self._fit_loop(epochs, preempted)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _fit_loop(self, epochs: int, preempted: dict) -> dict:
        tc = self.cfg.train
        final_eval: dict = {}
        epoch_loss = 0.0
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            epoch_losses = []
            for i, batch in enumerate(self.train_loader.epoch(epoch)):
                norms_now = i % self.grad_norm_freq == 0
                m = self.train_step(self.state, self._device_batch(batch),
                                    per_layer_grad_norms=norms_now)
                step = self.state.step
                epoch_losses.append(m["loss"])
                if step % self.finite_check_freq == 1:
                    self._assert_finite()
                if norms_now:
                    record = {
                        "batch/loss": m["loss"],
                        "batch/cls_loss": m["cls_loss"],
                        "batch/grad_norm": m["grad_norm"],
                        "batch/learning_rate": m.get("learning_rate", 0.0),
                    }
                    norms = m["grad_norms/stacked"].cpu().numpy()
                    record.update({f"grad_norm/{n}": norms[j]
                                   for j, n in enumerate(self._layer_names)})
                    self.metrics.log(record, step)
                if tc.intra_epoch_eval_freq and (i + 1) % tc.intra_epoch_eval_freq == 0:
                    val_loss = self._val_probe()
                    if val_loss is not None:
                        self.metrics.log({"val/loss": val_loss}, step)
                if preempted["flag"]:
                    logger.warning("SIGTERM received: checkpointing and exiting")
                    self._save(epoch, {"preempted": True}, epoch_complete=False)
                    return {"preempted": True, "epoch": epoch}
            epoch_loss = (float(torch.stack(epoch_losses).float().mean())
                          if epoch_losses else 0.0)
            self.metrics.log({"epoch": epoch + 1, "epoch/loss": epoch_loss,
                              "epoch/time_s": time.time() - t0}, self.state.step)
            if (epoch + 1) % tc.save_epochs == 0:
                self._save(epoch)
            if self.test_ds is not None and tc.eval_freq and (epoch + 1) % tc.eval_freq == 0:
                final_eval = self.evaluate()
                self.metrics.log(final_eval, self.state.step)
                if final_eval.get("tiou/mean", 0.0) > self.best_tiou:
                    self.best_tiou = final_eval["tiou/mean"]
                    self.best_epoch = epoch
                    self._save_best(epoch)
        self.start_epoch = epochs  # a later fit() continues from here
        return {"best_tiou": self.best_tiou, "best_epoch": self.best_epoch,
                "final_loss": epoch_loss, "step": self.state.step, **final_eval}

    def close(self) -> None:
        self.metrics.close()


def fit_with_auto_resume(make_trainer, epochs: int | None = None, max_restarts: int = 3,
                         resume_first: bool = False, on_complete=None) -> dict:
    """Run ``fit()``; on an unexpected crash rebuild the Trainer with
    ``make_trainer()``, restore the latest checkpoint and continue, up to
    ``max_restarts`` times. Not retried: ``FloatingPointError`` (resuming
    replays the divergence), ``KeyboardInterrupt``, and a SIGTERM
    preemption (fit() returns normally after checkpointing)."""
    restarts = 0
    trainer = make_trainer()
    if resume_first:
        trainer.resume()
    while True:
        try:
            summary = trainer.fit(epochs=epochs)
        except (FloatingPointError, KeyboardInterrupt):
            trainer.close()
            raise
        except Exception as e:
            restarts += 1
            logger.warning("training crashed (%s: %s); auto-resume %d/%d",
                           type(e).__name__, e, restarts, max_restarts)
            trainer.close()
            if restarts > max_restarts:
                raise
            trainer = make_trainer()
            trainer.resume()
            continue
        summary["restarts"] = restarts
        try:
            if on_complete is not None:
                on_complete(trainer, summary)
        finally:
            trainer.close()
        return summary
