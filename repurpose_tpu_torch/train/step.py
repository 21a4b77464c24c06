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

On a mesh (``parallel/mesh.py``) the step equals the one-process step on
the global batch, as the JAX step on a data-sharded batch does by
construction:

- ``data`` > 1: each rank holds its rows. The real videos are summed over
  the axis first and the global denominator is every rank's
  ``norm_override`` (per-rank ``n_real`` differ under packing and on a
  padded last batch, so a mean of per-rank losses would not be the global
  loss); then the gradients are SUMMED over the axis, once per step after
  any accumulation (``all_reduce_grads``). The loss metrics are summed
  likewise. Each data rank draws its own dropout masks: its coordinate is
  folded into ``dropout_seed``.
- ``model`` > 1: the tensor-parallel model (models/encoder.py). The
  gradient norm sums the squared norms of sharded parameters over the
  axis and counts replicated ones once; histograms are of the gathered
  values. A fusion variant is replicated over ``model`` (``build_model``):
  every model rank computes the same forward and the same gradients, so
  no gradient is summed over ``model``, and its norm counts each
  parameter once. Under dropout the model ranks draw the same masks (the
  model's dropout generator, seeded alike on every model rank).
- ``pipe`` > 1: the encoder runs as a pipeline: GPipe's forward
  (``parallel/pipeline.py``'s ``PipelinedMMCT``, the reverse in autograd)
  here, or the 1F1B schedule (``parallel/pipeline_1f1b.py``, which hands
  its ``loss_and_grads`` to this step). Either way the gradients are then
  summed over ``pipe`` as their owning stage computed them
  (``reduce_pipeline_grads``), so the step is the one-process one.
  ``grad_accum_steps`` > 1 raises: the microbatches do that work. In the
  split layout (``create_pipeline_train_state``) a stage holds its own
  layers only: the gradient norm sums their squares over ``pipe``, and the
  per-layer norms and histograms are of the whole model's gradients,
  gathered.
- ``seq`` > 1 with ring attention: each rank holds ``T / seq`` columns of
  its rows (``local_rows``); the loss sums and the gradients are summed
  over ``seq`` as over ``data``, and the denominator (from the rows'
  durations or segments, which every ``seq`` rank holds whole) is not.
  The ``seq`` coordinate is folded into the dropout seed too. A fusion
  variant has no ring (``seq_split``): every ``seq`` rank holds the whole
  rows and computes the same step, with the same dropout masks, and
  nothing is summed over ``seq``.

The non-finite guard reads the global loss and norm, so it is global.

Under a ``torch.profiler`` session the step records its phases as spans
(``utils/profiling.py``): ``train.forward_loss``, ``train.backward``,
``train.grad_norms``, ``train.optimizer``, and the histograms as
``train.telemetry``; ``batch_to_device`` its copy to the card as
``train.stage``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.staging import field_dtype
from repurpose_tpu_torch.models import require_unpacked
from repurpose_tpu_torch.ops.losses import masked_cls_loss, masked_reg_loss
from repurpose_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    gather_tensor,
    param_sharding_rule,
    seq_split,
)
from repurpose_tpu_torch.train.state import TrainState
from repurpose_tpu_torch.utils.profiling import recording, span


def batch_to_device(batch: Batch, device) -> Batch:
    """A host batch as tensors on ``device`` (features, labels and segments
    float32; mask bool; seg_ids int32; durations, positions int64).

    A numpy field is converted by ``torch.as_tensor`` and copied with the
    host waiting. A field that is a pinned CPU tensor (the Trainer's batches
    on a card, built by ``data/staging.py``) is copied with
    ``non_blocking=True`` on the current stream: the copy reads the pinned
    tensor itself, whose block the caching host allocator then keeps until
    the copy has run, and the host goes on queueing the step. Under a profiler the copies are one ``train.stage``
    span with the ``bytes`` sent and the ``pinned_bytes`` of them that came
    from pinned memory."""
    host = [None if x is None else torch.as_tensor(
        x if torch.is_tensor(x) else np.asarray(x), dtype=field_dtype(name))
        for name, x in zip(Batch._fields, batch)]
    ids = {}
    if recording():
        sent = [x for x in host if x is not None]
        ids = {"bytes": sum(x.nbytes for x in sent),
               "pinned_bytes": sum(x.nbytes for x in sent if x.is_pinned())}
    with span("train.stage", **ids):
        return Batch(*[None if x is None else x.to(device, non_blocking=x.is_pinned())
                       for x in host])


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
        # filled on the device: a host tensor's copy would wait for the stream
        norm = torch.full((), float(train_cfg.batch_size), device=n_real.device)
    else:
        norm = n_real.clamp(min=1).float()
    return n_real, norm


def global_denominator(train_cfg: TrainConfig, batch: Batch, mesh=None):
    """(n_real, norm) of the global batch of which ``batch`` is this rank's
    rows: ``loss_denominator``'s, with the real videos summed over the
    mesh's ``data`` axis and the configured batch size (per rank) times its
    size."""
    n_real, norm = loss_denominator(train_cfg, batch)
    if mesh is None or mesh.size("data") == 1:
        return n_real, norm
    n_real = mesh.all_reduce(n_real.clone(), "data")
    if train_cfg.loss_norm == "config_batch_size":
        return n_real, norm * mesh.size("data")
    return n_real, n_real.clamp(min=1).float()


def loss_fn(model, train_cfg: TrainConfig, batch: Batch, norm_override=None):
    """(total loss, aux metrics) of one forward; the model's mode (train or
    eval) decides whether dropout is on."""
    packed_kw = {}
    if batch.seg_ids is not None:
        require_unpacked(model)
        packed_kw = {"seg_ids": batch.seg_ids, "positions": batch.positions}
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


def dropout_seed(seed: int, step: int, data_rank: int = 0, seq_rank: int = 0) -> int:
    """Seed of step ``step``'s dropout masks: a hash of (seed, step), as the
    JAX step folds the step into its key (``fold_in(rng, state.step)``), so
    a resumed run draws the masks an uninterrupted one would. Data rank
    r > 0 folds r in too: its rows get draws of their own; so does a
    ``seq`` rank > 0, for its positions."""
    words = [seed % 2**32, step] + ([data_rank] if data_rank or seq_rank else [])
    words += [seq_rank] if seq_rank else []
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


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


def _kernel_params(model) -> list[tuple[str, torch.nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters() if p.ndim == 2]


def _tp(mesh) -> bool:
    return mesh is not None and mesh.size("model") > 1


@torch.no_grad()
def param_histograms(model, mesh=None) -> dict:
    """Per-matrix parameter histograms {counts [L, B], edges [L, B + 1]},
    rows labelled by ``kernel_layer_names``: the parameter half of the
    wandb.watch equivalent (of the gathered values under tensor
    parallelism: a collective over ``model``)."""
    with span("train.telemetry"):
        hists = [histogram(gather_tensor(n, p, mesh) if _tp(mesh) else p)
                 for n, p in _kernel_params(model)]
        return {"counts": torch.stack([c for c, _ in hists]),
                "edges": torch.stack([e for _, e in hists])}


def _split_grad_norms(model, mesh, per_layer: bool):
    """``_grad_norms`` of a split-layout stage model: the squares of the
    stage's own layers summed over ``pipe``, the rest counted once; the
    per-matrix norms of the whole model's gathered gradients."""
    from repurpose_tpu_torch.parallel.pipeline import pipeline_grads_by_name

    sq = [torch.zeros((), device=mesh.device), torch.zeros((), device=mesh.device)]
    for n, p in model.named_parameters():
        if p.grad is not None:
            sq[n.startswith("multimodal_encoder.layers.")] += p.grad.float().pow(2).sum()
    total = (sq[0] + mesh.all_reduce(sq[1], "pipe")).sqrt()
    if not per_layer:
        return total, None
    grads = pipeline_grads_by_name(model, mesh)
    return total, torch.stack([torch.linalg.vector_norm(g.float()) for g in grads.values()
                               if g.ndim == 2])


def _grad_norms(model, mesh, per_layer: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(global gradient norm, per-matrix norms or None). Under tensor
    parallelism the squared norms of sharded parameters are summed over
    ``model`` (one all_reduce) and replicated ones counted once."""
    if hasattr(model, "layer_offset"):
        return _split_grad_norms(model, mesh, per_layer)
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    if not _tp(mesh):
        total = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad.float()) for _, p in named]))
        layers = None
        if per_layer:
            layers = torch.stack([
                torch.linalg.vector_norm(p.grad.float()) if p.grad is not None
                else torch.zeros((), device=p.device) for _, p in _kernel_params(model)])
        return total, layers
    rows = named + ([(n, p) for n, p in _kernel_params(model)] if per_layer else [])
    sq = torch.stack([torch.linalg.vector_norm(p.grad.float()) ** 2 if p.grad is not None
                      else torch.zeros((), device=p.device) for _, p in rows])
    sharded = torch.tensor([param_sharding_rule(n) is not None for n, _ in rows],
                           device=sq.device)
    sq = torch.where(sharded, mesh.all_reduce(torch.where(sharded, sq, 0.0), "model"), sq)
    total = sq[: len(named)].sum().sqrt()
    return total, (sq[len(named):].sqrt() if per_layer else None)


def _chunk(batch: Batch, c: int, accum: int) -> Batch:
    """Rows c, c + accum, c + 2 * accum, ... (the JAX step's strided chunks)."""
    return Batch(*[None if x is None else x[c::accum] for x in batch])


def make_train_step(
    model_cfg: ModelConfig, train_cfg: TrainConfig, schedule: Callable | None = None,
    mesh=None, loss_and_grads: Callable | None = None,
) -> Callable:
    """``train_step(state, batch, per_layer_grad_norms=False,
    grad_histograms=False) -> metrics``: one Adam update of ``state`` on a
    device batch. ``metrics`` holds device tensors (loss, cls_loss, n_real,
    grad_norm, and reg_loss with the regression loss on), ``learning_rate``
    as a float, with ``per_layer_grad_norms`` a stacked vector
    ``grad_norms/stacked`` and with ``grad_histograms``
    ``hist/grads/counts`` [L, HIST_BINS] and ``hist/grads/edges``
    [L, HIST_BINS + 1], both labelled by ``kernel_layer_names`` (a matrix
    without a gradient counts as zeros, as the JAX step's zero gradient).
    ``mesh``: ``batch`` is this rank's rows (and columns, under ring
    attention) and the step is the global one (module docstring); every
    rank of the mesh must call it. On a ``pipe`` axis the forward is
    GPipe's unless ``loss_and_grads(model, batch) -> aux`` (the 1F1B
    schedule's, ``make_1f1b_train_step``) replaces the forward and backward;
    the state may be ``create_pipeline_train_state``'s (the split layout)."""
    from repurpose_tpu_torch.parallel.pipeline import (
        PipelinedMMCT,
        pipeline_grads_by_name,
        reduce_pipeline_grads,
    )

    accum = max(int(train_cfg.grad_accum_steps), 1)
    pipe = mesh is not None and mesh.size("pipe") > 1
    if pipe and accum > 1:
        raise ValueError("grad_accum_steps > 1 does not compose with pipeline parallelism — "
                         "pipeline microbatches already serve that role; raise "
                         "pipeline_microbatches instead")
    seq = mesh is not None and seq_split(model_cfg, mesh)
    # the replicated dropout masks need one generator state on every model rank
    needs_generator = _tp(mesh) and model_cfg.dropout > 0
    data_rank = 0 if mesh is None else mesh.coord("data")
    seq_rank = mesh.coord("seq") if seq else 0
    data_parallel = mesh is not None and mesh.size("data") > 1
    accum_dtype = (torch.bfloat16 if train_cfg.grad_accum_dtype == "bfloat16"
                   else torch.float32)

    def accumulate(model, batch: Batch) -> dict:
        """Gradient accumulation over ``accum`` strided chunks, summed in
        ``grad_accum_dtype`` buffers; a parameter no chunk reaches keeps
        ``.grad is None``."""
        b = batch.visual.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} not divisible by grad_accum_steps {accum}")
        n_real, norm = global_denominator(train_cfg, batch, mesh)
        sums: dict[torch.nn.Parameter, torch.Tensor] = {}
        aux_sum: dict[str, torch.Tensor] = {}
        for c in range(accum):
            model.zero_grad(set_to_none=True)
            with span("train.forward_loss"):
                total, aux = loss_fn(model, train_cfg, _chunk(batch, c, accum),
                                     norm_override=norm)
            with span("train.backward"):
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

    def forward_backward(model, batch: Batch) -> dict:
        if accum > 1:
            return accumulate(model, batch)
        n_real, norm = global_denominator(train_cfg, batch, mesh)
        fwd = PipelinedMMCT(model, mesh, train_cfg.pipeline_microbatches) if pipe else model
        with span("train.forward_loss"):
            total, aux = loss_fn(fwd, train_cfg, batch, norm_override=norm)
        with span("train.backward"):
            total.backward()
        aux = {k: v.detach() for k, v in aux.items()}
        aux["n_real"] = n_real
        return aux

    grads_of = loss_and_grads or forward_backward

    def train_step(state: TrainState, batch: Batch, per_layer_grad_norms: bool = False,
                   grad_histograms: bool = False):
        model, opt = state.model, state.optimizer
        model.train()
        gen = getattr(model, "dropout_generator", None)
        if gen is None and needs_generator:
            raise ValueError("tensor parallelism with dropout needs the model's dropout "
                             "generator (MMCT.set_dropout_generator): the model ranks must "
                             "draw the same masks")
        if gen is not None:
            gen.manual_seed(dropout_seed(train_cfg.seed, state.step, data_rank, seq_rank))
        lr = schedule(state.step) if schedule is not None else None
        if lr is not None:
            for group in opt.param_groups:
                group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        aux = grads_of(model, batch)
        if pipe:
            reduce_pipeline_grads(model, mesh)
        # once per step, after any accumulation
        for axis in ("data",) * data_parallel + ("seq",) * seq:
            all_reduce_grads(model.parameters(), mesh, axis=axis)
            keys = [k for k in ("loss", "cls_loss", "reg_loss") if k in aux]
            sums = mesh.all_reduce(torch.stack([aux[k].float() for k in keys]), axis)
            aux.update(zip(keys, sums.unbind()))
        metrics = dict(aux)
        with span("train.grad_norms"):
            metrics["grad_norm"], layer_norms = _grad_norms(model, mesh, per_layer_grad_norms)
        if per_layer_grad_norms:
            metrics["grad_norms/stacked"] = layer_norms
        if grad_histograms:
            with span("train.telemetry"):
                if hasattr(model, "layer_offset"):  # the split layout: gathered over pipe
                    kernels = [g for g in pipeline_grads_by_name(model, mesh).values()
                               if g.ndim == 2]
                else:
                    kernels = [gather_tensor(n, g, mesh) if _tp(mesh) else g
                               for n, g in ((n, p.grad if p.grad is not None
                                             else torch.zeros_like(p))
                                            for n, p in _kernel_params(model))]
                hists = [histogram(g) for g in kernels]
                metrics["hist/grads/counts"] = torch.stack([c for c, _ in hists])
                metrics["hist/grads/edges"] = torch.stack([e for _, e in hists])
        if lr is not None:
            metrics["learning_rate"] = lr
        with span("train.optimizer"):
            bad = ~(torch.isfinite(aux["loss"]) & torch.isfinite(metrics["grad_norm"]))
            opt.step()
            state.step += 1
            state.nonfinite_count += bad.to(torch.int32)
        return metrics

    return train_step


def make_eval_step(train_cfg: TrainConfig, mesh=None) -> Callable:
    """Loss-only evaluation (the val probe): ``eval_step(model, batch) ->
    aux``, in eval mode and without gradients. On a ``pipe`` axis the
    forward is GPipe's; under ring attention ``batch`` is this rank's
    columns and the loss sums are summed over ``seq``."""
    from repurpose_tpu_torch.parallel.pipeline import PipelinedMMCT

    pipe = mesh is not None and mesh.size("pipe") > 1

    @torch.no_grad()
    def eval_step(model, batch: Batch) -> dict:
        model.eval()
        fwd = PipelinedMMCT(model, mesh, train_cfg.pipeline_microbatches) if pipe else model
        _, aux = loss_fn(fwd, train_cfg, batch)
        if mesh is not None and seq_split(model.cfg, mesh):
            keys = [k for k in ("loss", "cls_loss", "reg_loss") if k in aux]
            sums = mesh.all_reduce(torch.stack([aux[k].float() for k in keys]), "seq")
            aux.update(zip(keys, sums.unbind()))
        return aux

    return eval_step
