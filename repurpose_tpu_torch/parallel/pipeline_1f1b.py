"""The 1F1B pipeline schedule over the mesh's ``pipe`` axis
(``repurpose_tpu/parallel/pipeline_1f1b.py``).

GPipe (``pipeline.py``) banks every microbatch's residuals before the
first backward, so a stage's activation memory grows with the microbatch
count M. 1F1B interleaves: on each tick every stage runs one forward and
one backward, on different microbatches, and holds only a ring buffer of
``W = 2 S - 1`` stage inputs, O(S) whatever M.

The schedule, as in the JAX package: ``M + 2 S - 2`` ticks; the forward of
microbatch m on stage s on tick ``m + s`` (no graph kept: only its input
goes into slot ``m mod W``), its backward on tick ``m + 2 (S - 1) - s``.
The backward recomputes the stage's block from the saved input under
autograd, with the microbatch's attention sweep kept beside the input and
the dropout generator re-seeded per (layer, microbatch) as the forward
seeded it (the replay that remat makes: the same masks), then runs
``torch.autograd.backward`` from the gradient the next stage sent. The
last stage seeds each chain: the head and the loss on the microbatch it
has just finished (its backward tick is its forward tick), stage 0 closes
it through the embed. Each tick's two hops (activations up, gradients
down) follow the schedule on every rank, so they pair up.

The loss of a microbatch is its masked sums over the global denominator
(``train/step.py``'s ``global_denominator``), so the microbatches' losses
add up to the batch's. The parameter gradients accumulate on their stage
and then go through the same reduction as GPipe's
(``reduce_pipeline_grads``: the embed's counted from stage 0, the head's
from the last stage, each once) and over ``data``.

The fill and drain ticks of the JAX schedule run on clamped indices and
are masked away; here a stage skips them (no compute, no message).
Restrictions: those of the GPipe schedule (``validate_1f1b`` is
``validate_pipeline``).
"""

from __future__ import annotations

from typing import Callable

import torch

from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.ops.losses import masked_cls_loss, masked_reg_loss
from repurpose_tpu_torch.parallel.pipeline import StageBlock, total_layers, validate_pipeline


validate_1f1b = validate_pipeline  # the GPipe schedule's restrictions


def _loss_and_grads(model, train_cfg: TrainConfig, mesh, m_micro: int, batch: Batch, norm):
    """Runs the 1F1B schedule on this rank's rows ``batch`` (module
    docstring), accumulating this stage's parameter gradients into
    ``.grad``; returns the (total, cls, reg) loss sums of the rows, summed
    over ``pipe`` (every rank of the axis holds them)."""
    cfg = model.cfg
    block = StageBlock(model, mesh, m_micro, batch.mask, batch.seg_ids)
    s, n = block.stage, block.stages
    w = 2 * n - 1
    rows = block.rows
    micro = lambda x, m: None if x is None else x[m * rows : (m + 1) * rows]
    spec = [((rows, batch.mask.shape[1], cfg.d_model), model.compute_dtype)]
    reg_w = float(train_cfg.reg_loss_weight)
    n_layers = total_layers(model)

    def embed(m):
        return model.embed(micro(batch.visual, m), micro(batch.audio, m), micro(batch.text, m),
                           micro(batch.positions, m))

    xbuf: list = [None] * w
    losses = torch.zeros(3, dtype=torch.float32, device=mesh.device)
    act = grad = None
    for t in range(m_micro + 2 * n - 2):
        # forward slot: microbatch t - s
        mf = t - s
        y = g_y = None
        if 0 <= mf < m_micro:
            sweep = block.sweep(mf)
            with torch.no_grad():
                x_in = embed(mf) if s == 0 else act[0]
                y = block(x_in, mf, sweep)
            xbuf[mf % w] = (x_in, sweep)
            if s == n - 1:  # the head and the loss seed this microbatch's backward
                y_req = y.detach().requires_grad_()
                block.seed_head(1 << 20, mf, n_layers)
                out = model.head(y_req)
                labels, mask = micro(batch.labels, mf), micro(batch.mask, mf)
                cls = masked_cls_loss(out.cls_logits, labels, mask)
                total = cls / norm
                reg = torch.zeros((), device=mesh.device)
                if reg_w > 0.0:
                    reg = masked_reg_loss(out.offsets, micro(batch.segments, mf), labels, mask)
                    total = total + reg_w * reg / norm
                total.backward()
                g_y = y_req.grad
                losses += torch.stack([total.detach(), cls.detach(), reg.detach()]).float()
        # backward slot: microbatch t - 2 (S - 1) + s
        mb = t - 2 * (n - 1) + s
        g_x = None
        if 0 <= mb < m_micro:
            x_b, sweep = xbuf[mb % w]
            xbuf[mb % w] = None
            x_r = x_b.detach().requires_grad_()
            torch.autograd.backward(block(x_r, mb, sweep), g_y if s == n - 1 else grad[0])
            g_x = x_r.grad
            if s == 0:  # the embed closes the chain
                torch.autograd.backward(embed(mb), g_x)
        if n > 1:
            up = spec if s > 0 and 0 <= t + 1 - s < m_micro else None
            act = mesh.hop("pipe", send=[y] if y is not None and s < n - 1 else None, recv=up)
            down = spec if s < n - 1 and 0 <= t + 1 - 2 * (n - 1) + s < m_micro else None
            grad = mesh.hop("pipe", send=[g_x] if g_x is not None and s > 0 else None, recv=down,
                            step=-1)
    return mesh.all_reduce(losses, "pipe")


def make_1f1b_train_step(model_cfg: ModelConfig, train_cfg: TrainConfig,
                         schedule: Callable | None = None, mesh=None, n_microbatches: int = 2,
                         split_layout: bool = False, zero1: bool = False) -> Callable:
    """The 1F1B train step: ``make_train_step``'s contract (``train_step(state,
    batch, per_layer_grad_norms=False, grad_histograms=False) ->
    metrics``) on a mesh whose ``pipe`` axis carries the schedule.
    ``split_layout``: the state is ``create_pipeline_train_state``'s (each
    stage its own layers); ``zero1``: the state's optimizer is ZeRO-1's
    (``TrainConfig.shard_opt_state``), which the standard layout only
    takes, as in the JAX package (the step itself follows the state)."""
    from repurpose_tpu_torch.train.step import global_denominator, make_train_step

    if mesh is None:
        raise ValueError("the 1F1B step needs the mesh with the pipe axis")
    if zero1 and split_layout:
        raise ValueError("zero1 supports the standard param layout only (the split layout's "
                         "moments are already the stage's own)")

    def loss_and_grads(model, batch: Batch) -> dict:
        validate_1f1b(model_cfg, mesh, n_microbatches, batch.mask.shape[0] * mesh.size("data"))
        n_real, norm = global_denominator(train_cfg, batch, mesh)
        total, cls, reg = _loss_and_grads(model, train_cfg, mesh, n_microbatches, batch,
                                          norm).unbind()
        aux = {"loss": total, "cls_loss": cls, "n_real": n_real}
        if train_cfg.reg_loss_weight > 0.0:
            aux["reg_loss"] = reg
        return aux

    return make_train_step(model_cfg, train_cfg, schedule, mesh, loss_and_grads=loss_and_grads)
