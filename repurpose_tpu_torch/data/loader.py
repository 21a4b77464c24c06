"""Host-side batch loader: bucket-aware grouping and background prefetch
(``repurpose_tpu/data/loader.py``, single process).

- the epoch plan (permutation, bucket grouping, batch composition) is a pure
  function of (seed, epoch), the same as the JAX loader's, so one seed gives
  the same batches in both packages, packed and unpacked;
- within a shuffled window, samples group by length bucket so batches pad to
  the smallest bucket; ``pack=True`` first-fit-decreasing packs each window
  into rows of the largest bucket instead;
- a background thread keeps ``PREFETCH`` collated numpy batches ready while
  the device computes; abandoning the iterator early shuts it down;
- unpacked batches come from the dataset's whole-batch ``load_batch`` where
  it has one and it applies (``RepurposeDataset``: the native loader), else
  from ``collate`` over the samples.

The JAX loader's multi-host slicing (``process_index``/``process_count``) is
not ported: the port trains on one card (ROADMAP).
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
    ):
        """Batches pad to ``batch_size`` rows (a ragged tail with all-padding
        rows). ``pack=True`` switches to sequence-packed batches: every
        window's videos first-fit-decreasing into rows of the largest bucket,
        several head-to-tail videos per row with block-diagonal attention;
        ``batch_size`` then counts rows."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.shuffle = shuffle
        self.seed = seed
        self.bucket_window = max(bucket_window, batch_size)
        self.pack = pack
        self._lengths = dataset.lengths() if hasattr(dataset, "lengths") else None
        if pack and self._lengths is None:
            raise ValueError("pack=True needs a dataset exposing .lengths()")
        self._plan_cache: tuple[int, list] | None = None

    def _epoch_batches(self, epoch: int) -> list[tuple[int, list]]:
        """Batch plan [(bucket, sample indices)], or [(bucket, rows of sample
        indices)] when packed; memoized per epoch (the val probe asks for
        epoch 0 again and again)."""
        if self._plan_cache is None or self._plan_cache[0] != epoch:
            self._plan_cache = (epoch, self._build_epoch_batches(epoch))
        return self._plan_cache[1]

    def _build_epoch_batches(self, epoch: int) -> list[tuple[int, list]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        bs = self.batch_size
        if self.pack:
            bucket = self.buckets[-1]
            packed: list[tuple[int, list[list[int]]]] = []
            for w0 in range(0, len(order), self.bucket_window):
                window = [int(i) for i in order[w0 : w0 + self.bucket_window]]
                for rows in plan_packing([self._lengths[i] for i in window], bucket, bs):
                    packed.append((bucket, [[window[j] for j in row] for row in rows]))
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
        return batches

    def batches_per_epoch(self, epoch: int = 0) -> int:
        return len(self._epoch_batches(epoch))

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """Iterate the epoch's batches, prefetched by a worker thread."""
        batches = self._epoch_batches(epoch)
        load_batch = getattr(self.dataset, "load_batch", None)
        pad_b = self.batch_size
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
                    if self.pack:  # idxs is a list of rows (index lists)
                        flat = [i for row in idxs for i in row]
                        remap = {i: j for j, i in enumerate(flat)}
                        batch = pack_batch(
                            [self.dataset[i] for i in flat],
                            [[remap[i] for i in row] for row in idxs], bucket, pad_b,
                        )
                    else:
                        batch = load_batch(idxs, (bucket,), pad_b) if load_batch else None
                        if batch is None:  # per-sample path
                            batch = collate([self.dataset[i] for i in idxs], (bucket,),
                                            pad_b)
                    if not put(batch):
                        return
                put(None)
            except BaseException as e:  # surface loader errors to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
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
