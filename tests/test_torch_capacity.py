"""The port's capacity model (``repurpose_tpu_torch/utils/capacity.py``) on
the CPU: ``param_count`` is exact (the JAX package's count and the port
model's own number of elements), the estimates rank configurations as
tests/test_capacity.py asks of the JAX model, and no memory figure is
assumed: the CPU needs one given. The estimate is held to the measured peak
on the card by the ``gpu`` test below and by ``chip_smoke.py``."""

import dataclasses

import pytest
import torch

from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.utils.capacity import (
    capacity_table,
    device_memory_bytes,
    estimate_train_bytes,
    max_safe_bucket,
    measured_memory,
    param_count,
)

TINY = dict(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=2,
            num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32")
FLAGSHIP = ModelConfig(attention_impl="auto", compute_dtype="bfloat16")


@pytest.mark.parametrize("kw", [{}, TINY, dict(TINY, self_num_layers=1, d_model=32,
                                                num_heads=4, d_ff=64)])
def test_param_count_is_exact(kw):
    from repurpose_tpu.config import ModelConfig as JaxModelConfig
    from repurpose_tpu.utils.capacity import param_count as jax_param_count

    cfg = ModelConfig(**kw)
    real = sum(p.numel() for p in build_model(cfg, "cpu").parameters())
    assert param_count(cfg) == real == jax_param_count(JaxModelConfig(**kw))


def test_estimates_rank_sensibly():
    xla = dataclasses.replace(FLAGSHIP, attention_impl="xla")
    remat = dataclasses.replace(FLAGSHIP, remat=True)
    e = {name: estimate_train_bytes(cfg, 6, 2048)["total_bytes"]
         for name, cfg in (("flash", FLAGSHIP), ("xla", xla), ("remat", remat))}
    assert e["remat"] < e["flash"] < e["xla"]
    assert (estimate_train_bytes(FLAGSHIP, 6, 4096)["total_bytes"] > e["flash"]
            > estimate_train_bytes(FLAGSHIP, 2, 2048)["total_bytes"])
    # float32 activations cost more than bf16 ones; dropout 0 saves the masks
    f32 = dataclasses.replace(FLAGSHIP, compute_dtype="float32")
    assert estimate_train_bytes(f32, 6, 2048)["activation_bytes"] > \
        estimate_train_bytes(FLAGSHIP, 6, 2048)["activation_bytes"]
    no_drop = dataclasses.replace(FLAGSHIP, dropout=0.0)
    assert estimate_train_bytes(no_drop, 6, 2048)["total_bytes"] < e["flash"]


def test_grad_accum_and_zero1_move_the_estimate():
    base = estimate_train_bytes(FLAGSHIP, 8, 2048)
    accum = estimate_train_bytes(FLAGSHIP, 8, 2048, grad_accum_steps=4)
    assert accum["activation_bytes"] < base["activation_bytes"] / 3
    assert accum["total_bytes"] < base["total_bytes"]
    bf16 = estimate_train_bytes(FLAGSHIP, 8, 2048, grad_accum_steps=4,
                                grad_accum_dtype="bfloat16")
    assert bf16["state_bytes"] < accum["state_bytes"]
    assert estimate_train_bytes(FLAGSHIP, 8, 2048, grad_accum_dtype="bfloat16")[
        "state_bytes"] == base["state_bytes"]
    z = estimate_train_bytes(FLAGSHIP, 8, 2048, zero1_dp=4)
    n = z["params"]
    assert base["state_bytes"] - z["state_bytes"] == 2 * 4 * n - 2 * 4 * n // 4
    assert accum["input_bytes"] == base["input_bytes"]


def test_capacity_table_and_max_bucket():
    h100 = 80e9
    rows = capacity_table(FLAGSHIP, 6, (256, 1024, 2048), h100)
    assert [r["bucket"] for r in rows] == [256, 1024, 2048] and all(r["fits"] for r in rows)
    best = max_safe_bucket(FLAGSHIP, 6, h100)
    assert best >= 2048
    assert max_safe_bucket(dataclasses.replace(FLAGSHIP, remat=True), 6, h100) >= best
    assert max_safe_bucket(FLAGSHIP, 6, 2e9) < best
    # the long-video remat step at batch 1 fits the card at 32768
    remat = dataclasses.replace(FLAGSHIP, remat=True)
    assert capacity_table(remat, 1, (32768,), h100)[0]["fits"]


def test_device_memory_needs_a_figure_off_the_card():
    with pytest.raises(ValueError, match="memory_bytes"):
        device_memory_bytes("cpu")
    with pytest.raises(ValueError, match="memory_bytes"):
        capacity_table(FLAGSHIP, 6, (256,), device="cpu")
    assert device_memory_bytes("cpu", 16e9) == 16e9
    with pytest.raises(ValueError, match="CUDA"):
        measured_memory(ModelConfig(**TINY), TrainConfig(batch_size=2), 64, "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_estimate_is_at_or_above_the_measured_peak(cuda, packed):
    tc = TrainConfig(batch_size=2, pack_sequences=packed)
    for cfg in (FLAGSHIP, dataclasses.replace(FLAGSHIP, remat=True, self_num_layers=4)):
        mem = measured_memory(cfg, tc, 1024, cuda)
        est = estimate_train_bytes(cfg, 2, 1024)["total_bytes"]
        assert 0 < mem["peak_bytes"] <= est, (mem, est)
