"""Train state and optimizer (``repurpose_tpu/train/state.py``).

``torch.optim.Adam(lr, weight_decay)`` applies L2 regularisation inside the
gradient (g + wd * p) before the moment updates: the reference's optimizer,
which the JAX package rebuilds with ``add_decayed_weights`` before
``scale_by_adam``. The learning rate is set before every update from the
schedule at the step count before the increment, as optax's ``count`` is.

With the regression loss off no loss reaches the reg head, so its gradients
stay ``None`` and Adam skips those parameters, weight decay included: the
freeze the JAX package builds with ``optax.masked``. Gradients are cleared
with ``zero_grad(set_to_none=True)`` and never zero-filled, so that holds.

ZeRO-1 (``TrainConfig.shard_opt_state`` on a mesh with ``data`` > 1, as
at repurpose_tpu/train/loop.py:159): ``Zero1Adam`` keeps the Adam moments
of this data rank's slice of each parameter only (``zero1_dim``: the
first dim that ``data`` divides; a parameter without one is updated whole
on every rank), runs the same Adam on those slices and re-syncs the
parameters with one broadcast per data rank. The update is elementwise,
so the parameters equal the replicated optimizer's.

``TrainState.gathered`` / ``load_gathered`` carry the state in one form
whatever the mesh: the full, reference-named model state dict and the
one-process ``torch.optim.Adam`` state dict of the full model. A
checkpoint saved on one mesh therefore restores on another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from repurpose_tpu_torch.config import TrainConfig
from repurpose_tpu_torch.models.mmct import MMCT
from repurpose_tpu_torch.parallel.sharding import (
    gather_state_dict,
    gather_tensor,
    shard_state_dict,
    shard_tensor,
    zero1_dim,
)
from repurpose_tpu_torch.train.schedule import warmup_cosine_schedule

ADAM_MOMENTS = ("exp_avg", "exp_avg_sq")


class Zero1Adam:
    """ZeRO-1 Adam over ``mesh``'s ``data`` axis (module docstring); the
    parts of ``torch.optim.Adam``'s interface the port calls."""

    def __init__(self, params, mesh, **adam_kw):
        self.params = list(params)
        self.mesh = mesh
        dp, rank = mesh.size("data"), mesh.coord("data")
        self.parts: list[tuple[int | None, int]] = []  # (dim, slice length) per parameter
        views = []
        for p in self.params:
            dim = zero1_dim(p.shape, dp)
            n = 0 if dim is None else p.shape[dim] // dp
            self.parts.append((dim, n))
            views.append(p.detach() if dim is None else p.detach().narrow(dim, rank * n, n))
        self.views = views
        self.inner = torch.optim.Adam(views, **adam_kw)

    @property
    def param_groups(self):
        return self.inner.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            p.grad = None

    def _slice(self, x: torch.Tensor, i: int, owner: int) -> torch.Tensor:
        dim, n = self.parts[i]
        return x if dim is None else x.narrow(dim, owner * n, n)

    @torch.no_grad()
    def step(self) -> None:
        rank = self.mesh.coord("data")
        for i, (p, view) in enumerate(zip(self.params, self.views)):
            view.grad = None if p.grad is None else self._slice(p.grad, i, rank)
        self.inner.step()
        # every rank's slices back to every rank: one broadcast per owner
        group, members = self.mesh.group("data"), self.mesh.group_ranks["data"]
        sliced = [i for i, p in enumerate(self.params)
                  if p.grad is not None and self.parts[i][0] is not None]
        for owner, src in enumerate(members):
            parts = [self._slice(self.params[i].detach(), i, owner) for i in sliced]
            flat = torch.cat([x.reshape(-1) for x in parts])
            dist.broadcast(flat, src=src, group=group)
            if owner != rank:
                at = 0
                for x in parts:
                    x.copy_(flat[at : at + x.numel()].view_as(x))
                    at += x.numel()

    def full_moments(self, i: int, moment: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s whole (local-shape) moment from the data ranks'
        slices: placed into zeros and summed over ``data``."""
        dim, n = self.parts[i]
        if dim is None:
            return moment
        full = torch.zeros_like(self.params[i], dtype=moment.dtype)
        self._slice(full, i, self.mesh.coord("data")).copy_(moment)
        return self.mesh.all_reduce(full, "data")


def optimizer_state_bytes(optimizer) -> int:
    """Bytes of the optimizer's tensors held by this rank."""
    inner = optimizer.inner if isinstance(optimizer, Zero1Adam) else optimizer
    return sum(v.numel() * v.element_size() for s in inner.state.values()
               for v in s.values() if torch.is_tensor(v))


@dataclass
class TrainState:
    model: MMCT
    optimizer: torch.optim.Adam | Zero1Adam
    step: int = 0  # updates taken; the schedule reads it before each update
    nonfinite_count: torch.Tensor | None = None
    """int32 scalar on the model's device: steps whose loss or grad norm was
    non-finite. The step adds to it on the device, with no host sync; the
    Trainer reads it on its probe cadence and before every save."""
    mesh: object = None
    """The ``parallel.mesh.Mesh`` the model and optimizer are sharded over
    (None: one process)."""

    def __post_init__(self) -> None:
        if self.nonfinite_count is None:
            device = next(self.model.parameters()).device
            self.nonfinite_count = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def is_main(self) -> bool:
        return self.mesh is None or self.mesh.is_main

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.world > 1

    def gathered(self) -> tuple[dict, dict]:
        """(the full model state dict, the one-process Adam state dict of the
        full model); on a mesh a collective that every rank must call."""
        if not self._sharded():
            return self.model.state_dict(), self.optimizer.state_dict()
        mesh, opt = self.mesh, self.optimizer
        names = [n for n, _ in self.model.named_parameters()]
        zero1 = isinstance(opt, Zero1Adam)
        inner = opt.inner if zero1 else opt
        local = inner.state_dict()
        state = {}
        for i, name in enumerate(names):
            if i not in local["state"]:
                continue
            entry = dict(local["state"][i])
            for m in ADAM_MOMENTS:
                full = opt.full_moments(i, entry[m]) if zero1 else entry[m]
                entry[m] = gather_tensor(name, full, mesh)
            state[i] = entry
        group = {k: v for k, v in local["param_groups"][0].items() if k != "params"}
        return (gather_state_dict(self.model.state_dict(), mesh),
                {"state": state, "param_groups": [{**group, "params": list(range(len(names)))}]})

    def load_gathered(self, model_sd: dict, opt_sd: dict) -> None:
        """Loads the state ``gathered`` returns, whichever mesh it came from,
        into this rank's shards."""
        if not self._sharded():
            self.model.load_state_dict(model_sd, strict=True)
            self.optimizer.load_state_dict(opt_sd)
            return
        mesh, opt = self.mesh, self.optimizer
        self.model.load_state_dict(shard_state_dict(model_sd, mesh), strict=True)
        names = [n for n, _ in self.model.named_parameters()]
        rank, size = mesh.coord("model"), mesh.size("model")
        zero1 = isinstance(opt, Zero1Adam)
        inner = opt.inner if zero1 else opt
        state = {}
        for i, entry in opt_sd["state"].items():
            entry = dict(entry)
            for m in ADAM_MOMENTS:
                x = shard_tensor(names[i], entry[m], rank, size)
                entry[m] = opt._slice(x, i, mesh.coord("data")).clone() if zero1 else x
            state[i] = entry
        group = {k: v for k, v in opt_sd["param_groups"][0].items() if k != "params"}
        inner.load_state_dict({"state": state, "param_groups": [
            {**group, "params": inner.state_dict()["param_groups"][0]["params"]}]})


def make_optimizer(
    model: MMCT, train_cfg: TrainConfig, steps_per_epoch: int, mesh=None
) -> tuple[torch.optim.Adam | Zero1Adam, Callable[[int], float]]:
    """Adam (betas 0.9/0.999, eps 1e-8, L2 weight decay) over every
    parameter, and the warmup -> cosine schedule over the whole run;
    ``Zero1Adam`` where ``train_cfg.shard_opt_state`` and ``mesh``'s
    ``data`` axis is > 1."""
    total_steps = train_cfg.epochs * steps_per_epoch
    warmup_steps = train_cfg.warmup_epochs * steps_per_epoch
    schedule = warmup_cosine_schedule(train_cfg.lr, warmup_steps, total_steps)
    kw = dict(lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
              weight_decay=train_cfg.weight_decay)
    if train_cfg.shard_opt_state and mesh is not None and mesh.size("data") > 1:
        return Zero1Adam(model.parameters(), mesh, **kw), schedule
    return torch.optim.Adam(model.parameters(), **kw), schedule
