"""The Trainer's host staging (``data/staging.py``) on the CPU, where
nothing is pinned: a loader with the Trainer's ``Staging`` yields, field by
field and dtype by dtype, what ``batch_to_device`` makes of the numpy batch
the loader gives without one (the native route, the numpy route and packed
batches); ``native.batch_load_npy`` into a reused buffer equals a new batch
bit for bit; ``batch_to_device`` on numpy input is what it always was; and
its ``train.stage`` span carries ``bytes`` and ``pinned_bytes``. The pinned,
non-blocking copy itself is tested on the card
(``tests/test_torch_staging_gpu.py``)."""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch import native
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.data.batching import Batch, collate, pack_batch
from repurpose_tpu_torch.data.dataset import RepurposeDataset
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.staging import Staging, field_dtype
from repurpose_tpu_torch.data.synthetic import SyntheticDataset, write_synthetic_dataset
from repurpose_tpu_torch.train.step import batch_to_device
from repurpose_tpu_torch.utils import profiling

CFG = ModelConfig(vis_dim=8, aud_dim=12, text_dim=6, d_model=16, self_num_layers=1,
                  num_heads=2, d_ff=32, hidden_dim=8)
DURATIONS = [61, 130, 97, 240, 80, 33, 200]


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("split")), DURATIONS, CFG,
                                   seed=11)


def _loader(split, staging, pack):
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    return BatchLoader(ds, batch_size=2, buckets=(128, 256), seed=3, pack=pack,
                       staging=staging)


@pytest.mark.parametrize("route", ["native", "numpy", "packed"])
def test_staged_batches_equal_the_numpy_batches_on_the_device(split, monkeypatch, route):
    if route == "numpy":  # load_batch declines; the worker collates samples
        monkeypatch.setattr(native, "available", lambda: False)
    else:
        assert native.available()
    pack = route == "packed"
    want = list(_loader(split, None, pack).epoch(1))
    got = list(_loader(split, Staging(), pack).epoch(1))
    assert len(got) == len(want) > 1
    for staged, plain in zip(got, want):
        assert isinstance(plain.visual, np.ndarray)
        assert (staged.seg_ids is not None) == pack
        for name, x, y in zip(Batch._fields, staged, batch_to_device(plain, "cpu")):
            assert (x is None) == (y is None), name
            if x is None:
                continue
            assert torch.is_tensor(x) and x.is_contiguous() and not x.is_pinned(), name
            assert x.dtype == y.dtype == field_dtype(name), name
            assert torch.equal(x, y), name
        # what the benchmark's training harness reads of a host batch
        assert np.array_equal(np.asarray(staged.mask), plain.mask)
        assert np.array_equal(np.asarray(staged.durations), plain.durations)


def _write_npy(tmp_path, rows, d, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i, r in enumerate(rows):
        p = tmp_path / f"{seed}_{i}.npy"
        np.save(p, rng.normal(size=(r, d)).astype(np.float32))
        paths.append(str(p))
    return paths


def test_batch_load_npy_into_a_reused_buffer_equals_a_new_batch(tmp_path):
    assert native.available()
    t, d = 64, 5
    long_paths = _write_npy(tmp_path, [64, 80, 50], d, seed=1)  # one past t: truncated
    short_paths = _write_npy(tmp_path, [10, 63, 1], d, seed=2)
    buf = np.full((3, t, d), np.nan, np.float32)
    for paths in (long_paths, short_paths, long_paths):  # the buffer reused each time
        fresh, fresh_rows = native.batch_load_npy(paths, t=t, d=d)
        got, rows = native.batch_load_npy(paths, t=t, d=d, out=buf)
        assert got is buf
        assert rows.tolist() == fresh_rows.tolist() == [min(r, t) for r in
                                                        ([64, 80, 50] if paths is long_paths
                                                         else [10, 63, 1])]
        assert got.tobytes() == fresh.tobytes()
    with pytest.raises(ValueError, match="out"):
        native.batch_load_npy(long_paths, t=t, d=d, out=np.zeros((3, t, d), np.float64))
    with pytest.raises(ValueError, match="out"):
        native.batch_load_npy(long_paths, t=t, d=d, out=np.zeros((2, t, d), np.float32))


class _Reused(Staging):
    """A staging whose blocks hold an earlier batch's bytes, as reused
    pinned blocks do: every new tensor starts as garbage."""

    def empty(self, name, shape):
        return super().empty(name, shape).fill_(float("nan") if name in (
            "visual", "audio", "text", "labels", "segments") else 7)


def test_load_batch_into_staging_equals_load_batch(split):
    """The native route's staged batch against its numpy one, a padded row
    included, in blocks that held other bytes."""
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    staging = _Reused()
    for idx in ([3, 6], [0, 5], [2]):
        plain = ds.load_batch(idx, (128, 256), 2)
        staged = ds.load_batch(idx, (128, 256), 2, staging)
        for name, x, y in zip(Batch._fields, staged, batch_to_device(plain, "cpu")):
            assert (x is None) == (y is None), name
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y), name


def _numpy_batch(pack):
    ds = SyntheticDataset([40, 25, 17], CFG, seed=5)
    samples = [ds[i] for i in range(3)]
    if pack:
        return pack_batch(samples, [[0, 2], [1]], 64, 3)
    return collate(samples, (64,), 4)


@pytest.mark.parametrize("pack", [False, True])
def test_batch_to_device_on_numpy_is_unchanged(pack):
    batch = _numpy_batch(pack)
    got = batch_to_device(batch, "cpu")
    for name, x, y in zip(Batch._fields, got, batch):
        assert (x is None) == (y is None), name
        if x is None:
            continue
        want = torch.as_tensor(np.asarray(y), dtype=field_dtype(name)).to("cpu")
        assert x.dtype == want.dtype and torch.equal(x, want), name
        if y.dtype == np.float32 or y.dtype == bool:  # as before: the numpy memory itself
            assert x.data_ptr() == y.ctypes.data, name


def test_stage_copies_what_is_not_staged_and_passes_the_rest():
    staging = Staging()
    staged = staging.stage(_numpy_batch(pack=True))
    assert staging.stage(staged).visual is staged.visual  # already staged: no copy
    cols = Batch(*[None if x is None or x.ndim < 2 else x[:, 8:40] for x in staged])
    assert not cols.visual.is_contiguous()  # a column slice, as local_columns makes
    again = staging.stage(cols)
    for name, x, y in zip(Batch._fields, again, cols):
        if x is not None:
            assert x.is_contiguous() and x.dtype == field_dtype(name), name
            assert torch.equal(x, y), name


def test_train_stage_records_bytes_and_pinned_bytes():
    batch = _numpy_batch(pack=True)
    staged = Staging().stage(batch)
    want = sum(x.nbytes for x in staged if x is not None)
    profiling.clear()
    batch_to_device(staged, "cpu")  # no profiler: nothing recorded
    assert not profiling.records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        batch_to_device(staged, "cpu")
        batch_to_device(batch, "cpu")
    stages = [r for r in profiling.records() if r.name == "train.stage"]
    profiling.clear()
    assert len(stages) == 2
    for r in stages:  # numpy input counts in the step's dtypes (int64 durations)
        assert r.ids == {"bytes": want, "pinned_bytes": 0}
        assert r.end_ns >= r.start_ns
