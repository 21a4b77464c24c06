"""Host-side batch loader: bucket-aware grouping, per-rank slicing and
background prefetch (``repurpose_tpu/data/loader.py``).

- the epoch plan (permutation, bucket grouping, batch composition) is a pure
  function of (seed, epoch), the same as the JAX loader's, so one seed gives
  the same batches in both packages, packed and unpacked;
- the plan is of GLOBAL batches of ``batch_size * process_count`` samples
  (rows, packed), the same on every rank; rank ``process_index`` takes the
  strided slice ``[process_index::process_count]`` of each (its data
  coordinate on the mesh), so every rank agrees on the batch count and the
  bucket of batch k, as the collectives of a step need. A global tail
  smaller than ``process_count`` is dropped; ``pad_last=False`` with more
  than one rank raises (ragged tails would give ranks different shapes);
- within a shuffled window, samples group by length bucket so batches pad to
  the smallest bucket; ``pack=True`` first-fit-decreasing packs each window
  into rows of the largest bucket instead;
- a background thread keeps ``PREFETCH`` collated numpy batches ready while
  the device computes; abandoning the iterator early shuts it down;
- unpacked batches come from the dataset's whole-batch ``load_batch`` where
  it has one and it applies (``RepurposeDataset``: the native loader), else
  from ``collate`` over the samples;
- batches are numpy ``Batch``es, or with a ``staging`` (``data/staging.py``,
  which the Trainer passes on a card) CPU tensors in the step's dtypes in
  pinned memory: ``load_batch`` reads the features straight into them, and a
  ``collate`` or ``pack_batch`` result is copied into them;
- under a ``torch.profiler`` session (``utils/profiling.py``) the worker
  records each batch's build as a ``loader.load`` span with its ``videos``,
  and the consumer each wait for a batch as ``loader.wait``.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Sequence

import numpy as np

from repurpose_tpu_torch.data.batching import (
    Batch, collate, pack_batch, pick_bucket, plan_packing,
)
from repurpose_tpu_torch.data.staging import Staging
from repurpose_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

PREFETCH = 2  # collated batches kept ready ahead of the device


class BatchLoader:
    def __init__(
        self,
        dataset,  # indexable, with .lengths() for bucketing and packing
        batch_size: int,
        buckets: Sequence[int],
        shuffle: bool = True,
        seed: int = 0,
        bucket_window: int = 64,
        pack: bool = False,
        drop_last: bool = False,
        pad_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        staging: Staging | None = None,
    ):
        """Batches of ``batch_size`` rows per rank, a ragged tail padded with
        all-padding rows (``pad_last``) or dropped (``drop_last``).
        ``pack=True`` switches to sequence-packed batches: every window's
        videos first-fit-decreasing into rows of the largest bucket, several
        head-to-tail videos per row with block-diagonal attention;
        ``batch_size`` then counts rows. ``staging`` builds the batches'
        fields in its tensors (module docstring); None yields numpy."""
        if not pad_last and not drop_last and process_count > 1:
            raise ValueError(
                "pad_last=False with process_count > 1 gives the ranks different batch "
                "shapes on ragged tails; use pad_last=True (default) or drop_last=True"
            )
        self.dataset = dataset
        self.batch_size = batch_size  # per rank
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.process_index = process_index
        self.process_count = process_count
        self.bucket_window = max(bucket_window, batch_size * process_count)
        self.pack = pack
        self.staging = staging
        self._lengths = dataset.lengths() if hasattr(dataset, "lengths") else None
        if pack and self._lengths is None:
            raise ValueError("pack=True needs a dataset exposing .lengths()")
        self._plan_cache: tuple[int, list] | None = None

    def _epoch_batches(self, epoch: int) -> list[tuple[int, list]]:
        """Global batch plan [(bucket, sample indices)], or [(bucket, rows of
        sample indices)] when packed, the same on every rank; memoized per
        epoch (the val probe asks for epoch 0 again and again)."""
        if self._plan_cache is None or self._plan_cache[0] != epoch:
            self._plan_cache = (epoch, self._build_epoch_batches(epoch))
        return self._plan_cache[1]

    def _build_epoch_batches(self, epoch: int) -> list[tuple[int, list]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        bs = self.batch_size * self.process_count
        if self.pack:
            bucket = self.buckets[-1]
            packed: list[tuple[int, list[list[int]]]] = []
            for w0 in range(0, len(order), self.bucket_window):
                window = [int(i) for i in order[w0 : w0 + self.bucket_window]]
                for rows in plan_packing([self._lengths[i] for i in window], bucket, bs):
                    packed.append((bucket, [[window[j] for j in row] for row in rows]))
            packed = self._whole(packed)
            if epoch == 0 and packed:  # packing efficiency, once per run
                rows = [r for _, batch_rows in packed for r in batch_rows]
                fill = sum(min(self._lengths[i], bucket) for r in rows for i in r) / (
                    len(rows) * bucket)
                logger.info(
                    "sequence packing: %d videos in %d rows of %d (%.2f videos/row, "
                    "fill %.1f%%)", sum(len(r) for r in rows), len(rows), bucket,
                    sum(len(r) for r in rows) / len(rows), 100 * fill,
                )
            return packed
        batches: list[tuple[int, list[int]]] = []
        if self._lengths is None:
            for i in range(0, len(order), bs):
                batches.append((self.buckets[-1], [int(j) for j in order[i : i + bs]]))
        else:
            for w0 in range(0, len(order), self.bucket_window):
                by_bucket: dict[int, list[int]] = {}
                for i in order[w0 : w0 + self.bucket_window]:
                    b = pick_bucket(self._lengths[int(i)], self.buckets)
                    by_bucket.setdefault(b, []).append(int(i))
                for bucket, idxs in by_bucket.items():
                    for j in range(0, len(idxs), bs):
                        batches.append((bucket, idxs[j : j + bs]))
        return self._whole(batches)

    def _whole(self, batches: list[tuple[int, list]]) -> list[tuple[int, list]]:
        """The batches every rank can take: full ones only with ``drop_last``;
        with several ranks, those that give each rank one entry or more (a
        rank needs a sample to derive its shapes from)."""
        gbs = self.batch_size * self.process_count
        if self.drop_last:
            return [b for b in batches if len(b[1]) == gbs]
        if self.process_count == 1:
            return batches
        kept = [b for b in batches if len(b[1]) >= self.process_count]
        dropped = sum(len(b[1]) for b in batches) - sum(len(b[1]) for b in kept)
        if dropped:
            logger.info("loader: dropped %d entries in global tails smaller than "
                        "process_count=%d this epoch", dropped, self.process_count)
        return kept

    def batches_per_epoch(self, epoch: int = 0) -> int:
        return len(self._epoch_batches(epoch))

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Iterate this rank's slice of the epoch's batches, prefetched by a
        worker thread."""
        batches = self._epoch_batches(epoch)
        load_batch = getattr(self.dataset, "load_batch", None)
        pad_b = self.batch_size if self.pad_last else None
        rank, ranks = self.process_index, self.process_count
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue-put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for bucket, idxs in batches:
                    if stop.is_set():
                        return
                    local = idxs[rank::ranks]
                    videos = sum(map(len, local)) if self.pack else len(local)
                    with span("loader.load", videos=videos):
                        if self.pack:  # rows (index lists)
                            flat = [i for row in local for i in row]
                            remap = {i: j for j, i in enumerate(flat)}
                            batch = pack_batch(
                                [self.dataset[i] for i in flat],
                                [[remap[i] for i in row] for row in local], bucket, pad_b,
                            )
                        else:
                            batch = (load_batch(local, (bucket,), pad_b, self.staging)
                                     if load_batch else None)
                            if batch is None:  # per-sample path
                                batch = collate([self.dataset[i] for i in local], (bucket,),
                                                pad_b)
                        if self.staging is not None:
                            batch = self.staging.stage(batch)
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # surface loader errors to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                with span("loader.wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a worker mid-put
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
