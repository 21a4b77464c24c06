"""The port's Trainer, loader, checkpoints and CLI on the CPU, against the
JAX package where both have the piece.

Tolerance of the whole-run comparison: the final epoch loss of the port's
``Trainer.fit`` against the JAX ``Trainer.fit`` from the same weights on the
same batches, float32 and dropout 0, rtol 1e-3 (six Adam steps of float32
op-order drift).
"""

import dataclasses
import json
import os
import signal
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import Config as JConfig
from repurpose_tpu.config import MeshConfig as JMeshConfig
from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TestConfig as JTestConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.config import load_config as jax_load_config
from repurpose_tpu.data.buckets import suggest_buckets as jax_suggest_buckets
from repurpose_tpu.data.dataset import RepurposeDataset as JRepurposeDataset
from repurpose_tpu.data.loader import BatchLoader as JBatchLoader
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.data.synthetic import write_synthetic_dataset
from repurpose_tpu.train.loop import Trainer as JTrainer
from repurpose_tpu.utils.metrics import calculate_tiou as jax_tiou
from repurpose_tpu_torch.config import (
    Config, DatasetConfig, MeshConfig, ModelConfig, TestConfig, TrainConfig,
)
from repurpose_tpu_torch.data.buckets import padding_waste, suggest_buckets
from repurpose_tpu_torch.data.dataset import RepurposeDataset
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.train import __main__ as cli
from repurpose_tpu_torch.train.loop import Trainer, fit_with_auto_resume
from repurpose_tpu_torch.utils.metrics import calculate_tiou

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster than
    several workers each spreading small ops over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                    num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                    attention_impl="auto", attn_softmax_dtype="float32", dropout=0.0)
CFG = Config(
    model=MODEL,
    train=TrainConfig(batch_size=2, buckets=(64, 128), epochs=2, save_epochs=1,
                      eval_freq=1, intra_epoch_eval_freq=2, lr=1e-3,
                      pack_sequences=True, loss_norm="batch_size"),
    mesh=MeshConfig(data=1),
    test_cfg=TestConfig(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                        duration_thresh_max=90.0, max_seg_per_min=1.0),
)
DURS = [100, 90, 50, 95, 40, 30, 60, 45]


def _datasets(model=MODEL):
    return (SyntheticDataset(DURS, model, seed=1), SyntheticDataset([80, 40], model, seed=2),
            SyntheticDataset([120, 60, 35], model, seed=3))


# -- loader, dataset, metrics: the JAX package's copies ------------------------------


@pytest.mark.parametrize("pack", [False, True])
def test_batch_loader_plans_and_batches_equal_the_jax_loaders(pack):
    jds = JSyntheticDataset(DURS * 3, JModelConfig(**dataclasses.asdict(MODEL)), seed=5)
    pds = SyntheticDataset(DURS * 3, MODEL, seed=5)
    kw = dict(batch_size=3, buckets=(64, 128), shuffle=True, seed=9, pack=pack,
              bucket_window=8)
    ours, theirs = BatchLoader(pds, **kw), JBatchLoader(jds, **kw)
    for epoch in range(3):
        assert ours._epoch_batches(epoch) == theirs._epoch_batches(epoch)
    for a, b in zip(ours.epoch(1), theirs.epoch(1)):
        for x, y in zip(a, b):
            assert (x is None and y is None) or np.array_equal(x, y)


def test_repurpose_dataset_matches_the_jax_dataset(tmp_path):
    """The same feature files read by both packages give the same samples."""
    jcfg = write_synthetic_dataset(str(tmp_path / "ds"), [30, 45, 20],
                                   JModelConfig(**dataclasses.asdict(MODEL)), seed=4)
    dcfg = DatasetConfig(**dataclasses.asdict(jcfg))
    ours = RepurposeDataset(dcfg, validate=True, keep_gt_segments=True)
    theirs = JRepurposeDataset(jcfg, validate=True, keep_gt_segments=True)
    assert len(ours) == len(theirs) == 3 and ours.lengths() == theirs.lengths()
    for i in range(3):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]) if isinstance(a[k], np.ndarray) else a[k] == b[k]


def test_tiou_and_buckets_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        ref = np.sort(rng.uniform(0, 100, (3, 2)), axis=1).tolist()
        pred = np.sort(rng.uniform(0, 100, (5, 2)), axis=1).tolist()
        th = (0.1, 0.3, 0.5)
        assert calculate_tiou(ref, pred, th) == jax_tiou(ref, pred, th)
    lengths = rng.integers(30, 2000, 200).tolist()
    assert suggest_buckets(lengths, 4) == jax_suggest_buckets(lengths, 4)
    assert padding_waste(lengths, (512, 2048)) > padding_waste(lengths, (256, 512, 1024, 2048))


# -- the whole run against the JAX Trainer -------------------------------------------


def test_fit_final_loss_matches_the_jax_trainer(tmp_path):
    """Two epochs of the same packed batches from the same weights; no
    probe, no eval (xla attention, float32, dropout 0)."""
    jcfg = JConfig(
        model=JModelConfig(**dataclasses.asdict(MODEL) | {"attention_impl": "xla",
                                                           "matmul_precision": "highest"}),
        train=JTrainConfig(**dataclasses.asdict(CFG.train) | {
            "buckets": CFG.train.buckets, "save_epochs": 100, "eval_freq": 0,
            "intra_epoch_eval_freq": 0}),
        mesh=JMeshConfig(data=1),
        test_cfg=JTestConfig(**dataclasses.asdict(CFG.test_cfg)),
    )
    jtrainer = JTrainer(jcfg, str(tmp_path / "jax"),
                        JSyntheticDataset(DURS, jcfg.model, seed=1))
    init = state_dict_from_jax_params(jax.device_get(jtrainer.state.params))
    want = jtrainer.fit()
    jtrainer.close()
    cfg = dataclasses.replace(
        CFG, model=dataclasses.replace(MODEL, attention_impl="xla"),
        train=dataclasses.replace(CFG.train, save_epochs=100, eval_freq=0,
                                  intra_epoch_eval_freq=0))
    trainer = Trainer(cfg, str(tmp_path / "port"), SyntheticDataset(DURS, MODEL, seed=1),
                      init_params=init, device="cpu")
    got = trainer.fit()
    trainer.close()
    assert got["step"] == int(jtrainer.state.step) == 2 * trainer.steps_per_epoch
    np.testing.assert_allclose(got["final_loss"], want["final_loss"], rtol=1e-3)


# -- the port's own driver --------------------------------------------------------------


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("run"))
    trainer = Trainer(CFG, workdir, *_datasets(), device="cpu")
    tious = iter([0.2, 0.1])  # epoch 1 is the best
    evaluate = trainer.evaluate
    trainer.evaluate = lambda: {**evaluate(), "tiou/mean": next(tious)}
    summary = trainer.fit()
    trainer.evaluate = evaluate
    trainer.close()
    return workdir, trainer, summary


def test_fit_logs_probes_and_checkpoints(run):
    workdir, trainer, summary = run
    assert summary["step"] == trainer.state.step == 2 * trainer.steps_per_epoch
    assert int(trainer.state.nonfinite_count) == 0 and np.isfinite(summary["final_loss"])
    lines = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    keys = set().union(*lines)
    assert {"batch/loss", "batch/grad_norm", "val/loss", "epoch/loss", "tiou/mean"} <= keys
    assert any(k.startswith("grad_norm/multimodal_encoder.layers.0.self_attn.in_proj")
               for k in keys)
    assert trainer.checkpointer.all_steps() == [trainer.steps_per_epoch, trainer.state.step]
    assert summary["best_epoch"] == 0 and summary["best_tiou"] == 0.2
    best = Trainer(CFG, workdir + "/best_probe", _datasets()[0], device="cpu")
    best.checkpointer = trainer._best_ckpt
    assert best.resume() and best.state.step == trainer.steps_per_epoch
    assert best.best_tiou == 0.2 and best.start_epoch == 1


def test_resume_restores_the_state(run):
    workdir, trainer, _ = run
    again = Trainer(CFG, workdir, _datasets()[0], device="cpu")
    assert again.resume()
    assert again.state.step == trainer.state.step and again.start_epoch == 2
    assert again.best_tiou == 0.2 and again.best_epoch == 0
    for (n, a), b in zip(trainer.state.model.state_dict().items(),
                         again.state.model.state_dict().values()):
        assert torch.equal(a, b), n
    exp_a = trainer.state.optimizer.state_dict()["state"]
    exp_b = again.state.optimizer.state_dict()["state"]
    assert all(torch.equal(exp_a[i]["exp_avg_sq"], exp_b[i]["exp_avg_sq"]) for i in exp_a)
    assert again.fit()["step"] == trainer.state.step  # nothing left to train


def test_evaluate_returns_tiou_keys_packed_and_unpacked(run):
    _, trainer, _ = run
    packed, unpacked = trainer.evaluate(pack=True), trainer.evaluate(pack=False)
    assert set(packed) == {f"tiou/{t}" for t in (0.5, 0.6, 0.7, 0.8, 0.9)} | {"tiou/mean"}
    for k in packed:
        assert 0.0 <= packed[k] <= 1.0
        assert packed[k] == pytest.approx(unpacked[k], abs=1e-9)


def test_sigterm_checkpoints_mid_epoch(tmp_path):
    trainer = Trainer(CFG, str(tmp_path), _datasets()[0], device="cpu")
    step = trainer.train_step
    calls = {"n": 0}

    def preempting(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*args, **kwargs)

    trainer.train_step = preempting
    summary = trainer.fit()
    assert summary == {"preempted": True, "epoch": 0}
    resumed = Trainer(CFG, str(tmp_path), _datasets()[0], device="cpu")
    assert resumed.resume() and resumed.state.step == 2
    assert resumed.start_epoch == 0  # epoch_complete=False: epoch 0 runs again
    blob = torch.load(Path(tmp_path) / "ckpt" / "2.pt", weights_only=True)
    assert blob["meta"]["preempted"] is True and blob["meta"]["epoch"] == 0


def test_nonfinite_state_is_never_saved(tmp_path):
    trainer = Trainer(CFG, str(tmp_path), _datasets()[0], device="cpu")
    trainer.state.nonfinite_count += 1
    with pytest.raises(FloatingPointError):
        trainer._save(0)
    assert trainer.checkpointer.latest_step() is None


def test_auto_resume_recovers_from_a_crash(tmp_path):
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, epochs=3, eval_freq=0, intra_epoch_eval_freq=0))
    made = []

    def make_trainer():
        t = Trainer(cfg, str(tmp_path), _datasets()[0], device="cpu")
        if not made:  # the first one crashes on the first step of epoch 2
            step, calls = t.train_step, {"n": 0}

            def crashing(*args, **kwargs):
                calls["n"] += 1
                if calls["n"] == t.steps_per_epoch + 1:
                    raise RuntimeError("injected crash")
                return step(*args, **kwargs)

            t.train_step = crashing
        made.append(t)
        return t

    summary = fit_with_auto_resume(make_trainer, max_restarts=2)
    assert summary["restarts"] == 1 and len(made) == 2
    assert made[1].state.step == 3 * made[1].steps_per_epoch


TINY_YAML = """
model: {vis_dim: 8, aud_dim: 12, text_dim: 6, d_model: 16, self_num_layers: 1,
        num_heads: 2, d_ff: 32}
train: {seed: 7, lr: 0.001, epochs: 1, save_epochs: 1, batch_size: 2, eval_freq: 1,
        intra_epoch_eval_freq: 0}
test_cfg: {pre_nms_topk: 16, pre_nms_thresh: 0.3, duration_thresh: 1,
           duration_thresh_max: 90, max_seg_per_min: 2.0, nms_sigma: 0.5, min_score: 0.01}
tpu:
  mesh: {data: 1, model: 1, seq: 1}
  buckets: [128, 256]
  compute_dtype: float32
  pack_sequences: true
  loss_norm: batch_size
"""


def test_cli_trains_on_the_cpu(tmp_path):
    """python -m repurpose_tpu_torch.train --device cpu --synthetic 8
    --epochs 1, with --auto-resume and --export_torch; the export loads
    strictly into the port's model. Then --resume and --torch_ckpt."""
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    workdir, exported = str(tmp_path / "run"), str(tmp_path / "out.pth")
    base = ["--config_path", str(cfg_path), "--synthetic", "8", "--epochs", "1",
            "--workdir", workdir, "--device", "cpu"]
    assert cli.main(base + ["--auto-resume", "1", "--export_torch", exported]) == 0
    lines = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    assert any("batch/loss" in m for m in lines) and any("tiou/mean" in m for m in lines)
    ckpt = torch.load(exported, weights_only=True)
    model = build_model(cli.load_config(str(cfg_path)).model, "cpu")
    model.load_state_dict(ckpt["model"], strict=True)
    assert ckpt["loss"] > 0 and np.isfinite(ckpt["loss"])
    assert cli.main(base + ["--resume"]) == 0
    warm = str(tmp_path / "warm")
    assert cli.main(base[:-4] + ["--workdir", warm, "--device", "cpu",
                                 "--torch_ckpt", exported]) == 0


def test_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(CFG, str(tmp_path), _datasets()[0])
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(TINY_YAML)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--config_path", str(cfg_path), "--synthetic", "8", "--epochs", "1",
                  "--workdir", str(tmp_path / "run")])


def test_training_options_not_ported_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        Trainer(dataclasses.replace(CFG, model=dataclasses.replace(MODEL, remat=True)),
                str(tmp_path), _datasets()[0], device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        Trainer(dataclasses.replace(CFG, mesh=MeshConfig(data=1, model=2)),
                str(tmp_path), _datasets()[0], device="cpu")


def test_chip_smoke_config_is_the_production_config():
    """chip_smoke.py builds the production Config in Python (the card's
    machine has no PyYAML); it must equal configs/repurpose.yaml, as both
    packages load it."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    path = str(ROOT / "configs" / "repurpose.yaml")
    want = cli.load_config(path)
    assert chip_smoke.production_config() == want
    assert want.to_dict() == jax_load_config(path).to_dict()
