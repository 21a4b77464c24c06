"""Checkpoints with ``torch.save`` (``repurpose_tpu/train/checkpoint.py``,
which uses Orbax).

One file per step, ``<directory>/<step>.pt``, holding the model and optimizer
state dicts, the step, ``nonfinite_count`` and a JSON-like metadata dict
(epoch, best metric). The schedule needs no state: it is a function of the
step. Writes go to a temporary file first and are renamed into place, so a
crash mid-write never leaves a truncated checkpoint; only the newest
``max_to_keep`` are kept.

``async_save=True`` overlaps the writes with training (the JAX package's
Orbax async checkpointing): ``save`` takes a CPU copy of the state and
returns, and one background thread writes it. At most one write is in
flight; ``save``, ``all_steps``, ``latest_step``, the restores and
``close`` wait for it first, and a failed write raises there.

On a mesh the checkpoint is the same file: every rank gathers the full,
reference-named model and the one-process optimizer state
(``TrainState.gathered``, a collective), rank 0 writes it, and a restore
shards it onto whatever mesh restores it. The ranks must share the
directory's filesystem.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

import torch

from repurpose_tpu_torch.train.state import TrainState


def _cpu_copy(x):
    """``x`` with every tensor copied to the CPU (a snapshot that training
    can no longer change)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu_copy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_copy(v) for v in x)
    return x


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int | None = 5,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self._writer: threading.Thread | None = None
        self._error: BaseException | None = None
        os.makedirs(self.directory, exist_ok=True)

    def wait(self) -> None:
        """Waits for the write in flight; raises if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint write failed") from err

    def close(self) -> None:
        self.wait()

    def _path(self, step: int) -> Path:
        return Path(self.directory) / f"{step}.pt"

    def all_steps(self) -> list[int]:
        self.wait()
        return sorted(int(p.stem) for p in Path(self.directory).glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, metadata: dict | None = None) -> None:
        """Writes step ``step``, replacing a checkpoint of the same step (a
        best-tIoU save can land on the step the epoch save just wrote). On a
        mesh every rank calls it and rank 0 writes."""
        self.wait()
        model_sd, opt_sd = state.gathered()
        if not state.is_main:
            return
        blob = {
            "model": model_sd,
            "optimizer": opt_sd,
            "step": int(state.step),
            "nonfinite_count": int(state.nonfinite_count),
            "meta": dict(metadata or {}),
        }
        if not self.async_save:
            self._write(step, blob)
            return
        blob = _cpu_copy(blob)

        def write():
            try:
                self._write(step, blob)
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._writer = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._writer.start()

    def _write(self, step: int, blob: dict) -> None:
        path = self._path(step)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        torch.save(blob, tmp)
        os.replace(tmp, path)
        if self.max_to_keep is not None:
            steps = sorted(int(p.stem) for p in Path(self.directory).glob("*.pt")
                           if p.stem.isdigit())
            for old in steps[: -self.max_to_keep]:
                self._path(old).unlink(missing_ok=True)

    def restore_model(self, step: int | None = None) -> dict:
        """The model state dict of step ``step`` (default: the latest), on the
        CPU: what evaluation needs, without an optimizer."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)["model"]

    def restore(self, state: TrainState, step: int | None = None) -> tuple[TrainState, dict]:
        """Loads step ``step`` (default: the latest) into ``state``'s model and
        optimizer, on their device, sharded onto its mesh; returns the state
        and the metadata."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        device = state.nonfinite_count.device
        # loaded on the CPU: load_state_dict copies into the device's tensors,
        # and the optimizer moves its moments to the parameters' device but
        # keeps Adam's step counters on the host, where torch wants them
        blob = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.load_gathered(blob["model"], blob["optimizer"])
        state.step = int(blob["step"])
        state.nonfinite_count = torch.tensor(
            blob["nonfinite_count"], dtype=torch.int32, device=device
        )
        return state, dict(blob["meta"])
