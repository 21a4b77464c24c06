"""Host batches in page-locked memory, for the Trainer's host-to-device copy.

A ``Staging`` builds a batch's fields as CPU tensors in the dtypes the train
step takes (``field_dtype``: float32 features, labels and segments; bool
mask; int32 ``seg_ids``; int64 ``durations`` and ``positions``), in
page-locked (pinned) memory wherever a CUDA card is visible. From there
``train/step.py:batch_to_device`` copies them with ``non_blocking=True`` on
the current stream: at the card's pinned rate, and without holding the host
until the copy, and the kernels queued ahead of it, have run.

The blocks come from torch's caching host allocator, so a training process
reuses the same few blocks batch after batch (one a batch in flight: those
the loader holds ready, the one it builds and the one being copied). A
non-blocking copy records its stream on the block of the tensor it reads,
and the allocator hands that block out again only after the copy has run:
so the copy has to read the staged tensor itself, never a numpy view of it.

The loader's worker builds its batches through a ``Staging`` where the
Trainer's device is a card (``BatchLoader(staging=...)``): the native
``.npy`` route reads the features straight into the staged tensors
(``RepurposeDataset.load_batch``), and the numpy routes (``collate``,
``pack_batch``) copy their result into them (``stage``).
"""

from __future__ import annotations

import torch

from repurpose_tpu_torch.data.batching import Batch

# the train step's dtype of each Batch field; float32 for the rest
_DTYPES = {"mask": torch.bool, "durations": torch.int64, "seg_ids": torch.int32,
           "positions": torch.int64}


def field_dtype(name: str) -> torch.dtype:
    """The dtype the train step takes for the Batch field ``name``."""
    return _DTYPES.get(name, torch.float32)


class Staging:
    """Makes host batch fields as CPU tensors in the step's dtypes, pinned
    where a CUDA card is visible (``pin``)."""

    def __init__(self):
        self.pin = torch.cuda.is_available()

    def empty(self, name: str, shape) -> torch.Tensor:
        """An uninitialised staging tensor for the Batch field ``name``."""
        return torch.empty(shape, dtype=field_dtype(name), pin_memory=self.pin)

    def _staged(self, name: str, x) -> bool:
        return (torch.is_tensor(x) and x.dtype == field_dtype(name) and x.is_contiguous()
                and (x.is_pinned() or not self.pin))

    def stage(self, batch: Batch) -> Batch:
        """``batch`` with every field a staging tensor: a numpy field, or a
        tensor that is not one already (another dtype, not contiguous, as a
        column slice is, or not pinned), is copied into a new one."""
        return Batch(*[
            None if x is None else x if self._staged(name, x)
            else self.empty(name, x.shape).copy_(torch.as_tensor(x))
            for name, x in zip(Batch._fields, batch)
        ])
