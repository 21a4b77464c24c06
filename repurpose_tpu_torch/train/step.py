"""Train and eval steps (``repurpose_tpu/train/step.py``).

A step is forward, masked focal loss, backward (through the attention
kernels' autograd Function), telemetry and the Adam update, run eagerly.
Nothing in it waits for the device: the loss, the gradient norm, the
per-layer norms and the non-finite guard stay device tensors until a caller
reads them.

Loss normalisation follows ``TrainConfig.loss_norm``: the reference divides
the summed focal loss by the configured batch size; ``batch_size`` divides by
the real videos in the batch (under packing, the segments, not the rows).

The gradient histograms (``grad_histograms``) and ``param_histograms`` are
the wandb.watch(model) equivalent: ``HIST_BINS`` bins per matrix parameter,
with ``jnp.histogram``'s edges and counting rule (``histogram``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.ops.losses import masked_cls_loss, masked_reg_loss
from repurpose_tpu_torch.train.state import TrainState

_BATCH_DTYPES = {"mask": torch.bool, "durations": torch.int64, "seg_ids": torch.int32,
                 "positions": torch.int64}


def batch_to_device(batch: Batch, device) -> Batch:
    """A numpy ``Batch`` as tensors on ``device`` (features, labels and
    segments float32; mask bool; seg_ids int32; durations, positions int64)."""
    return Batch(*[
        None if x is None else torch.as_tensor(
            np.asarray(x), dtype=_BATCH_DTYPES.get(name, torch.float32)
        ).to(device)
        for name, x in zip(Batch._fields, batch)
    ])


def loss_denominator(train_cfg: TrainConfig, batch: Batch):
    """(n_real, norm): the real (non-padding) videos of the batch and the
    loss denominator under ``train_cfg.loss_norm``. Packed rows hold several
    videos, so count segments there. Gradient accumulation divides every
    chunk by the whole batch's denominator, so chunk losses sum to it."""
    if batch.seg_ids is not None:
        n_real = (batch.seg_ids.amax(dim=1) + 1).clamp(min=0).sum()
    else:
        n_real = (batch.durations > 0).sum()
    if train_cfg.loss_norm == "config_batch_size":
        norm = torch.tensor(float(train_cfg.batch_size), device=n_real.device)
    else:
        norm = n_real.clamp(min=1).float()
    return n_real, norm


def loss_fn(model, train_cfg: TrainConfig, batch: Batch, norm_override=None):
    """(total loss, aux metrics) of one forward; the model's mode (train or
    eval) decides whether dropout is on."""
    packed_kw = (
        {"seg_ids": batch.seg_ids, "positions": batch.positions}
        if batch.seg_ids is not None else {}
    )
    out = model(batch.visual, batch.audio, batch.text, batch.mask, **packed_kw)
    cls_loss = masked_cls_loss(out.cls_logits, batch.labels, batch.mask)
    n_real, norm = loss_denominator(train_cfg, batch)
    if norm_override is not None:
        norm = norm_override
    total = cls_loss / norm
    aux = {"cls_loss": cls_loss, "loss": total, "n_real": n_real}
    if train_cfg.reg_loss_weight > 0.0:
        reg_loss = masked_reg_loss(out.offsets, batch.segments, batch.labels, batch.mask)
        total = total + train_cfg.reg_loss_weight * reg_loss / norm
        aux["reg_loss"] = reg_loss
        aux["loss"] = total
    return total, aux


def dropout_seed(seed: int, step: int) -> int:
    """Seed of step ``step``'s dropout masks: a hash of (seed, step), as the
    JAX step folds the step into its key (``fold_in(rng, state.step)``), so
    a resumed run draws the masks an uninterrupted one would."""
    return int(np.random.SeedSequence([seed % 2**32, step]).generate_state(1, np.uint64)[0])


def kernel_layer_names(model) -> list[str]:
    """Names of the matrix parameters (the JAX package's ``kernel`` leaves:
    every Linear weight and the packed QKV projection), in the order of the
    per-layer gradient norms."""
    return [n for n, p in model.named_parameters() if p.ndim == 2]


HIST_BINS = 64


@torch.no_grad()
def histogram(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts [HIST_BINS] float32, edges [HIST_BINS + 1] float32) of ``x``'s
    values, as ``jnp.histogram(x.ravel(), HIST_BINS)`` computes them: edges
    from min to max (widened by 0.5 each way when they meet) by
    ``jnp.linspace``'s arithmetic, each value in the bin of the last edge at
    or below it, the maximum in the last bin."""
    x = x.detach().float().reshape(-1)
    lo, hi = x.min(), x.max()
    same = lo == hi
    lo, hi = torch.where(same, lo - 0.5, lo), torch.where(same, hi + 0.5, hi)
    step = torch.arange(HIST_BINS, dtype=torch.float32, device=x.device) / HIST_BINS
    edges = torch.cat([lo * (1 - step) + hi * step, hi[None]])
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], HIST_BINS, idx)
    counts = torch.bincount(idx, minlength=HIST_BINS + 1)[1:].float()
    return counts, edges


def _kernel_params(model) -> list[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.ndim == 2]


@torch.no_grad()
def param_histograms(model) -> dict:
    """Per-matrix parameter histograms {counts [L, B], edges [L, B + 1]},
    rows labelled by ``kernel_layer_names``: the parameter half of the
    wandb.watch equivalent."""
    hists = [histogram(p) for p in _kernel_params(model)]
    return {"counts": torch.stack([c for c, _ in hists]),
            "edges": torch.stack([e for _, e in hists])}


def _chunk(batch: Batch, c: int, accum: int) -> Batch:
    """Rows c, c + accum, c + 2 * accum, ... (the JAX step's strided chunks)."""
    return Batch(*[None if x is None else x[c::accum] for x in batch])


def make_train_step(
    model_cfg: ModelConfig, train_cfg: TrainConfig, schedule: Callable | None = None
) -> Callable:
    """``train_step(state, batch, per_layer_grad_norms=False,
    grad_histograms=False) -> metrics``: one Adam update of ``state`` on a
    device batch. ``metrics`` holds device tensors (loss, cls_loss, n_real,
    grad_norm, and reg_loss with the regression loss on), ``learning_rate``
    as a float, with ``per_layer_grad_norms`` a stacked vector
    ``grad_norms/stacked`` and with ``grad_histograms``
    ``hist/grads/counts`` [L, HIST_BINS] and ``hist/grads/edges``
    [L, HIST_BINS + 1], both labelled by ``kernel_layer_names`` (a matrix
    without a gradient counts as zeros, as the JAX step's zero gradient)."""
    accum = max(int(train_cfg.grad_accum_steps), 1)
    accum_dtype = (torch.bfloat16 if train_cfg.grad_accum_dtype == "bfloat16"
                   else torch.float32)

    def accumulate(model, batch: Batch) -> dict:
        """Gradient accumulation over ``accum`` strided chunks, summed in
        ``grad_accum_dtype`` buffers; a parameter no chunk reaches keeps
        ``.grad is None``."""
        b = batch.visual.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps {accum}")
        n_real, norm = loss_denominator(train_cfg, batch)
        sums: dict[torch.nn.Parameter, torch.Tensor] = {}
        aux_sum: dict[str, torch.Tensor] = {}
        for c in range(accum):
            model.zero_grad(set_to_none=True)
            total, aux = loss_fn(model, train_cfg, _chunk(batch, c, accum),
                                 norm_override=norm)
            total.backward()
            for p in model.parameters():
                if p.grad is not None:
                    g = p.grad.to(accum_dtype)
                    sums[p] = g if p not in sums else sums[p] + g
            for k, v in aux.items():
                if k != "n_real":
                    aux_sum[k] = v.detach() if k not in aux_sum else aux_sum[k] + v.detach()
        for p in model.parameters():
            p.grad = sums[p].to(p.dtype) if p in sums else None
        aux_sum["n_real"] = n_real
        return aux_sum

    def train_step(state: TrainState, batch: Batch, per_layer_grad_norms: bool = False,
                   grad_histograms: bool = False):
        model, opt = state.model, state.optimizer
        model.train()
        gen = getattr(model, "dropout_generator", None)
        if gen is not None:
            gen.manual_seed(dropout_seed(train_cfg.seed, state.step))
        lr = schedule(state.step) if schedule is not None else None
        if lr is not None:
            for group in opt.param_groups:
                group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        if accum > 1:
            aux = accumulate(model, batch)
        else:
            total, aux = loss_fn(model, train_cfg, batch)
            total.backward()
            aux = {k: v.detach() for k, v in aux.items()}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics = dict(aux)
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
        )
        if per_layer_grad_norms:
            metrics["grad_norms/stacked"] = torch.stack([
                torch.linalg.vector_norm(p.grad.float()) if p.grad is not None
                else torch.zeros((), device=p.device)
                for p in model.parameters() if p.ndim == 2
            ])
        if grad_histograms:
            hists = [histogram(p.grad if p.grad is not None else torch.zeros_like(p))
                     for p in _kernel_params(model)]
            metrics["hist/grads/counts"] = torch.stack([c for c, _ in hists])
            metrics["hist/grads/edges"] = torch.stack([e for _, e in hists])
        if lr is not None:
            metrics["learning_rate"] = lr
        bad = ~(torch.isfinite(aux["loss"]) & torch.isfinite(metrics["grad_norm"]))
        opt.step()
        state.step += 1
        state.nonfinite_count += bad.to(torch.int32)
        return metrics

    return train_step


def make_eval_step(train_cfg: TrainConfig) -> Callable:
    """Loss-only evaluation (the val probe): ``eval_step(model, batch) ->
    aux``, in eval mode and without gradients."""

    @torch.no_grad()
    def eval_step(model, batch: Batch) -> dict:
        model.eval()
        _, aux = loss_fn(model, train_cfg, batch)
        return aux

    return eval_step

