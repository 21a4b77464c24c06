"""Rematerialisation (``ModelConfig.remat``) and the long-video training
slice of the port on the CPU, against itself and against the JAX package.

- Remat on against off, dropout on: every dropout mask (the recompute's
  too), the loss and every parameter gradient are equal bit for bit, and
  the dropout generator ends the step in the same state.
- The whole slice: the port's ``Trainer`` with remat on against the JAX
  ``Trainer`` with remat on, from the same weights on the same batches, with
  a ``configs/longvideo.yaml``-like ladder at a quarter of 2048 (buckets
  128 / 256 / 512 at batch 1) and the thresholds of both packages patched
  so that 128 takes the dense attention, 256 the streaming kernels and, on
  the JAX side, 512 the HBM dq kernel (the JAX Pallas kernels in interpret
  mode, the port's plain versions). Unpacked and packed, float32, dropout 0
  (the two packages draw different masks); per-step losses within rtol
  1e-3, the tolerance of tests/test_torch_trainer.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repurpose_tpu.ops.flash_attention as fa
from repurpose_tpu.config import Config as JConfig
from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TestConfig as JTestConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.train.loop import Trainer as JTrainer
from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import collate
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.models.encoder import Dropout
from repurpose_tpu_torch.ops import flash_attention as port_fa
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.step import batch_to_device, loss_fn


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster than
    several workers each spreading small ops over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=2,
                    num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                    attention_impl="pallas_full", attn_softmax_dtype="float32",
                    dropout=0.0, remat=True)
LONG_BUCKETS = (128, 256, 512)  # configs/longvideo.yaml's ladder at a quarter of 2048
DURS = [100, 200, 450, 60, 300, 129]


def _step_with_dropout(remat: bool, packed: bool):
    """One forward and backward of the tiny model with dropout 0.3 on a
    [2, 256] batch past the patched STREAM_MAX_T: (the keep mask of every
    dropout call per module, loss, gradients, the generator's state after).
    A mask is drawn again, in a pre-hook, from a copy of the generator's
    state as the call finds it (a recompute stops after the last tensor it
    has to save, so a forward hook would miss the layer's last dropout)."""
    cfg = dataclasses.replace(MODEL, dropout=0.3, remat=remat)
    model = build_model(cfg, "cpu", seed=3).train()
    gen = torch.Generator().manual_seed(11)
    model.set_dropout_generator(gen)
    calls = {}

    def record(name, mod, args):
        copy = torch.Generator().set_state(mod.generator.get_state())
        calls.setdefault(name, []).append(
            torch.rand(args[0].shape, generator=copy) < 1.0 - mod.p)

    for name, m in model.named_modules():
        if isinstance(m, Dropout):
            m.register_forward_pre_hook(lambda mod, args, name=name: record(name, mod, args))
    ds = SyntheticDataset([250, 90, 140], cfg, seed=4)
    train_cfg = TrainConfig(batch_size=2, buckets=(256,), pack_sequences=packed,
                            loss_norm="batch_size")
    if packed:
        from repurpose_tpu_torch.data.loader import BatchLoader

        batch = next(iter(BatchLoader(ds, 2, (256,), shuffle=False, pack=True).epoch(0)))
    else:
        batch = collate([ds[i] for i in range(2)], (256,), 2)
    total, _ = loss_fn(model, train_cfg, batch_to_device(batch, "cpu"))
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return calls, total.detach(), grads, gen.get_state()


@pytest.mark.parametrize("packed", [False, True])
def test_remat_replays_dropout_masks_and_gives_the_same_gradients(monkeypatch, packed):
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)
    off = _step_with_dropout(False, packed)
    on = _step_with_dropout(True, packed)
    calls_off, calls_on = off[0], on[0]
    assert calls_off.keys() == calls_on.keys()
    recomputed = 0
    for name, masks in calls_off.items():
        assert len(masks) == 1 and not masks[0].all()
        if name.startswith("multimodal_encoder.layers."):
            # the forward's mask and the recompute's, both the remat-off mask
            assert len(calls_on[name]) == 2
            recomputed += 1
        assert all(torch.equal(m, masks[0]) for m in calls_on[name]), name
    assert recomputed == 3 * MODEL.self_num_layers
    assert torch.equal(off[1], on[1])
    assert off[2].keys() == on[2].keys() and len(off[2]) > 0
    for name, g in off[2].items():
        assert torch.equal(g, on[2][name]), name
    assert torch.equal(off[3], on[3])  # the generator ends where it would without remat


def test_remat_is_off_without_gradients():
    """Evaluation and serving (no_grad / inference_mode) run the layers
    directly: the same outputs as the remat-off model."""
    cfg = dataclasses.replace(MODEL, dropout=0.0)
    ds = SyntheticDataset([100, 60], cfg, seed=5)
    batch = collate([ds[0], ds[1]], (128,), 2)
    args = [torch.from_numpy(x) for x in (batch.visual, batch.audio, batch.text, batch.mask)]
    with torch.no_grad():
        got = build_model(cfg, "cpu", seed=1).eval()(*args).cls_logits
        want = build_model(dataclasses.replace(cfg, remat=False), "cpu",
                           seed=1).eval()(*args).cls_logits
    assert torch.equal(got, want)


def _patch_long_t(monkeypatch):
    """Past T = 128 the streaming attention in both packages; on the JAX side
    past 256 the HBM dq kernel, every block 64."""
    for name in ("STREAM_K_BLOCK", "HBM_FWD_K_BLOCK", "PACKED_K_BLOCK", "HBM_DKV_K_BLOCK",
                 "DEFAULT_Q_BLOCK", "DEFAULT_K_BLOCK", "PACKED_Q_BLOCK"):
        monkeypatch.setattr(fa, name, 64)
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    monkeypatch.setattr(fa, "HBM_STREAM_T", 256)
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)


def _recording(step, losses, lengths=None):
    """``step`` that appends each step's loss (and, given ``lengths``, its
    batch's T) to ``losses``."""
    def recorded(state, batch, *args, **kwargs):
        out = step(state, batch, *args, **kwargs)
        m = out[1] if isinstance(out, tuple) else out
        losses.append(float(m["loss"]))
        if lengths is not None:
            lengths.append(int(batch.visual.shape[1]))
        return out

    return recorded


@pytest.mark.parametrize("packed,buckets,rows", [
    (False, LONG_BUCKETS, [128, 128, 256, 256, 512, 512]),
    (True, LONG_BUCKETS, [512] * 3),  # packed rows take the longest bucket
    (True, LONG_BUCKETS[:2], [256] * 5),
])
def test_remat_trainer_matches_the_jax_trainer_on_the_long_video_ladder(monkeypatch, tmp_path,
                                                                       packed, buckets, rows):
    """Unpacked, every window; packed, rows of 512 (the JAX packed HBM dq
    kernel) and of 256 (its packed-stream dq kernel)."""
    _patch_long_t(monkeypatch)
    model = dataclasses.replace(MODEL, self_num_layers=1)
    train = TrainConfig(batch_size=1, buckets=buckets, epochs=1, save_epochs=100,
                        eval_freq=0, intra_epoch_eval_freq=0, lr=1e-3,
                        pack_sequences=packed, loss_norm="batch_size")
    test_cfg = TestConfig(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                          duration_thresh_max=90.0, max_seg_per_min=1.0)
    jcfg = JConfig(
        model=JModelConfig(**dataclasses.asdict(model) | {"matmul_precision": "highest"}),
        train=JTrainConfig(**dataclasses.asdict(train) | {"buckets": buckets}),
        mesh=JMeshConfig(data=1),
        test_cfg=JTestConfig(**dataclasses.asdict(test_cfg)),
    )
    jtrainer = JTrainer(jcfg, str(tmp_path / "jax"), JSyntheticDataset(DURS, jcfg.model, seed=1))
    want = []
    for name in ("train_step", "train_step_norms", "train_step_hist"):
        setattr(jtrainer, name, _recording(getattr(jtrainer, name), want))
    init = state_dict_from_jax_params(jax.device_get(jtrainer.state.params))
    jtrainer.fit()
    jtrainer.close()

    cfg = Config(model=model, train=train, mesh=MeshConfig(data=1), test_cfg=test_cfg)
    trainer = Trainer(cfg, str(tmp_path / "port"), SyntheticDataset(DURS, model, seed=1),
                      init_params=init, device="cpu")
    got, lengths = [], []
    trainer.train_step = _recording(trainer.train_step, got, lengths)
    summary = trainer.fit()
    trainer.close()
    assert summary["step"] == len(got) == len(want) == trainer.steps_per_epoch
    assert sorted(lengths) == rows
    np.testing.assert_allclose(got, want, rtol=1e-3)
