"""Resume is step-exact under dropout: the port's train step seeds each
step's dropout masks from (seed, step), as the JAX step folds the step into
its key, so a run stopped after an epoch and resumed from its checkpoint
ends with the weights of a run that never stopped, bit for bit (CPU,
float32, dropout 0.1, one intra-op thread)."""

import dataclasses

import pytest
import torch

from repurpose_tpu_torch.config import Config, MeshConfig, ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.train.loop import Trainer
from repurpose_tpu_torch.train.step import dropout_seed

MODEL = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                    num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                    attention_impl="auto", attn_softmax_dtype="float32", dropout=0.1)
DURS = [100, 90, 50, 95, 40, 30, 60, 45]


def _cfg(pack: bool) -> Config:
    return Config(
        model=MODEL,
        train=TrainConfig(batch_size=2, buckets=(64, 128), epochs=2, save_epochs=1,
                          eval_freq=0, intra_epoch_eval_freq=0, lr=1e-3,
                          pack_sequences=pack, loss_norm="batch_size"),
        mesh=MeshConfig(data=1),
        test_cfg=TestConfig(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                            duration_thresh_max=90.0, max_seg_per_min=1.0),
    )


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(cfg, workdir):
    return Trainer(cfg, str(workdir), SyntheticDataset(DURS, MODEL, seed=1), device="cpu")


@pytest.mark.parametrize("pack", [False, True])
def test_resumed_run_equals_the_uninterrupted_run_under_dropout(tmp_path, pack):
    cfg = _cfg(pack)
    straight = _trainer(cfg, tmp_path / "straight")
    straight.fit()
    straight.close()

    first = _trainer(cfg, tmp_path / "stopped")
    first.fit(epochs=1)
    first.close()
    resumed = _trainer(cfg, tmp_path / "stopped")
    assert resumed.resume() and resumed.start_epoch == 1
    summary = resumed.fit()
    resumed.close()

    assert summary["step"] == straight.state.step == 2 * straight.steps_per_epoch
    for (name, a), b in zip(straight.state.model.state_dict().items(),
                            resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_dropout_seed_is_a_function_of_seed_and_step():
    seeds = {dropout_seed(s, t) for s in (0, 1, 1234) for t in range(50)}
    assert len(seeds) == 150
    assert dropout_seed(1234, 7) == dropout_seed(1234, 7)
    assert all(0 <= s < 2**64 for s in seeds)


def test_train_step_reseeds_the_model_generator(tmp_path):
    """Two steps from the same state draw the same masks whatever the
    generator's state before them; the next step number draws others."""
    trainer = _trainer(_cfg(False), tmp_path)
    model = trainer.state.model
    assert model.dropout_generator is not None
    batch = trainer._device_batch(next(iter(trainer.train_loader.epoch(0))))
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    opt0 = trainer.state.optimizer.state_dict()
    opt0 = {"state": {k: {n: x.clone() for n, x in s.items()} for k, s in opt0["state"].items()},
            "param_groups": opt0["param_groups"]}
    losses = []
    for burn in (0, 5):
        model.load_state_dict(state0)
        trainer.state.optimizer.load_state_dict(opt0)
        trainer.state.step = 3
        torch.rand(burn, generator=model.dropout_generator)
        losses.append(trainer.train_step(trainer.state, batch)["loss"])
    assert torch.equal(losses[0], losses[1])
    model.load_state_dict(state0)
    trainer.state.optimizer.load_state_dict(opt0)
    trainer.state.step = 4
    assert not torch.equal(trainer.train_step(trainer.state, batch)["loss"], losses[0])


def test_model_keeps_the_generator_it_was_given():
    model = build_model(dataclasses.replace(MODEL), "cpu", seed=0)
    assert model.dropout_generator is None
    gen = torch.Generator().manual_seed(3)
    model.set_dropout_generator(gen)
    assert model.dropout_generator is gen
