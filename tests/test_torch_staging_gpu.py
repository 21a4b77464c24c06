"""The Trainer's pinned, non-blocking staging (``data/staging.py``,
``train/step.py:batch_to_device``) on the card. Marked ``gpu``; each test
skips (in its fixture) where no card is visible. Run on a machine with an
H100:

    python -m pytest --noconftest -m gpu tests/test_torch_staging_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

- A [1, 32768] batch at the long configuration's widths: the pinned,
  non-blocking copy equals the pageable one bit for bit, field by field.
- Reuse under a delayed stream: with the copy of a loader's batch queued
  behind ``torch.cuda._sleep``, and the host batch dropped, the loader's
  worker builds ``PREFETCH`` + 2 more batches while the copy has not run;
  none of them takes the dropped batch's block, and the device tensor
  equals its own batch.
- One long-video training step (the long configuration, remat, dropout 0.1
  seeded as the Trainer seeds it) gives the same loss and gradients bit for
  bit from the pinned and from the pageable staging. At its smallest bucket,
  T = 2048: past it the fused attention backward adds dq over key blocks in
  a run-dependent float32 order, so two steps on the same input differ in
  their last bits whatever the staging.
- A profiled Trainer epoch: every ``train.stage`` span has
  ``pinned_bytes == bytes``, and no host-to-device copy in it reads pageable
  memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.data.staging import Staging

pytestmark = pytest.mark.gpu

LONG = dict(vis_dim=512, aud_dim=2048, text_dim=384)  # configs/longvideo.yaml's widths


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repurpose_tpu_torch  # noqa: F401  (switches TF32 off)


def _host_batch(t: int, fill: float, seed: int) -> Batch:
    """A numpy batch of one video of ``fill * t`` seconds at the long widths."""
    rng = np.random.default_rng(seed)
    n = int(fill * t)
    feats = [np.zeros((1, t, LONG[k]), np.float32) for k in ("vis_dim", "aud_dim", "text_dim")]
    for f in feats:
        f[0, :n] = rng.normal(size=(n, f.shape[-1])).astype(np.float32)
    mask = np.zeros((1, t), bool)
    mask[0, :n] = True
    labels = np.zeros((1, t), np.float32)
    labels[0, :n] = rng.random(n) < 0.2
    segments = np.zeros((1, t, 2), np.float32)
    segments[0, :n] = rng.random((n, 2)) * 30
    return Batch(*feats, mask, labels, segments, np.array([n], np.int32))


def test_pinned_copy_equals_the_pageable_copy(cuda):
    from repurpose_tpu_torch.train.step import batch_to_device

    plain = _host_batch(32768, 0.9, seed=1)
    staged = Staging().stage(plain)
    assert all(x.is_pinned() for x in staged if x is not None)
    got = batch_to_device(staged, "cuda")
    want = batch_to_device(plain, "cuda")
    torch.cuda.synchronize()
    for name, x, y in zip(Batch._fields, got, want):
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.is_cuda and x.dtype == y.dtype and torch.equal(x, y), name


def test_reuse_is_safe_under_a_delayed_stream(cuda, tmp_path):
    from repurpose_tpu_torch.config import ModelConfig
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.data.loader import PREFETCH, BatchLoader
    from repurpose_tpu_torch.data.synthetic import write_synthetic_dataset
    from repurpose_tpu_torch.train.step import batch_to_device

    n = PREFETCH + 6
    split = write_synthetic_dataset(str(tmp_path), [1000] * n, ModelConfig(**LONG), seed=3)
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    loader = BatchLoader(ds, batch_size=1, buckets=(1024,), shuffle=False, staging=Staging())
    batches = loader.epoch(0)
    first = next(batches)
    assert first.visual.is_pinned()
    want = [None if x is None else x.clone() for x in first]  # pageable
    block = first.visual.data_ptr()
    torch.cuda.synchronize()
    torch.cuda._sleep(4_000_000_000)  # about 2 s at the H100's clock
    dev = batch_to_device(first, "cuda")
    del first
    later = [next(batches) for _ in range(PREFETCH + 2)]
    pending = not torch.cuda.current_stream().query()
    batches.close()
    torch.cuda.synchronize()
    assert pending, "the delayed copy ran before the later batches were built"
    assert block not in {b.visual.data_ptr() for b in later}
    for b in later:  # other videos: a rewritten block would show
        assert not torch.equal(b.visual, want[0])
    for name, x, y in zip(Batch._fields, dev, want):
        if x is not None:
            assert torch.equal(x.cpu(), y), name


def _long_config(**train):
    """``configs/longvideo.yaml``'s model and batching, built in Python (the
    card's machine has no PyYAML): the published widths in bf16, dropout 0.1,
    remat, batch 1, ``loss_norm`` ``config_batch_size``."""
    from repurpose_tpu_torch.config import Config, ModelConfig, TrainConfig

    return Config(model=ModelConfig(compute_dtype="bfloat16", attention_impl="auto",
                                    remat=True),
                  train=TrainConfig(seed=7, batch_size=1, **train))


def _long_step(batch, staged: bool):
    """Loss and gradients of one train step of the long configuration on
    ``batch`` (numpy), staged through pinned memory or copied from numpy."""
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = _long_config(buckets=(2048,))
    assert cfg.model.dropout == 0.1
    tc = cfg.train
    model = build_model(cfg.model, "cuda", seed=tc.seed)
    model.set_dropout_generator(torch.Generator(device="cuda").manual_seed(tc.seed))
    opt, sched = make_optimizer(model, tc, steps_per_epoch=1)
    step = make_train_step(cfg.model, tc, sched)
    dev = batch_to_device(Staging().stage(batch) if staged else batch, "cuda")
    m = step(TrainState(model=model, optimizer=opt), dev)
    torch.cuda.synchronize()
    return m["loss"].cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()
                             if p.grad is not None}


def test_pinned_and_pageable_staging_train_alike(cuda):
    batch = _host_batch(2048, 0.85, seed=5)
    loss_p, grads_p = _long_step(batch, staged=True)
    loss_n, grads_n = _long_step(batch, staged=False)
    assert torch.isfinite(loss_p) and torch.equal(loss_p, loss_n)
    assert grads_p.keys() == grads_n.keys() and len(grads_p) > 10
    for name in grads_p:
        assert torch.equal(grads_p[name], grads_n[name]), name


def test_a_profiled_trainer_epoch_stages_only_pinned_bytes(cuda, tmp_path):
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.data.synthetic import write_synthetic_dataset
    from repurpose_tpu_torch.train.loop import Trainer
    from repurpose_tpu_torch.utils import profiling

    cfg = _long_config(buckets=(2048, 4096), save_epochs=1000, eval_freq=0,
                       intra_epoch_eval_freq=0)
    split = write_synthetic_dataset(str(tmp_path / "data"), [1500, 3000, 1900, 2500],
                                    cfg.model, seed=4)
    cfg = dataclasses.replace(cfg, train_dataset=split)
    trainer = Trainer(cfg, str(tmp_path / "work"),
                      RepurposeDataset(split, validate=False, use_cache=False))
    assert trainer.staging is not None and trainer.staging.pin
    trainer.fit(epochs=1)  # warm: the kernels built, the pinned blocks allocated
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        trainer.fit(epochs=2)
        torch.cuda.synchronize()
    stages = [r for r in profiling.records() if r.name == "train.stage"]
    profiling.clear()
    trainer.close()
    assert len(stages) == 4
    for r in stages:
        assert r.ids["bytes"] > 0 and r.ids["pinned_bytes"] == r.ids["bytes"], r.ids
    copies = [e.name for e in prof.events() if "HtoD" in e.name]
    assert any("Pinned" in c for c in copies), copies
    assert not [c for c in copies if "Pageable" in c], copies
