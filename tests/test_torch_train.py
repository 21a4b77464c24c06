"""The port's training step against the JAX package and the reference
trajectory, on the CPU.

- losses against ``repurpose_tpu.ops.losses`` and the reference's golden
  outputs (``tests/golden/losses.json``, tolerances of tests/test_losses.py);
- the schedule against the JAX one;
- the step on ``tests/golden/tiny_trained.npz``: the reference's 120-step
  trajectory, at the tolerances of tests/test_train_parity.py (early steps
  rtol 1e-4; the whole curve rtol 0.05 / atol 2e-3, since float32 op-order
  drift compounds through Adam; final params rtol 0.05 / atol 5e-3);
- the step against the JAX ``make_train_step`` (packed, gradient
  accumulation, with and without the regression loss);
- the reg-head freeze, the non-finite guard and dropout.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JModelConfig
from repurpose_tpu.config import TrainConfig as JTrainConfig
from repurpose_tpu.data.batching import pack_batch as jax_pack_batch
from repurpose_tpu.data.synthetic import SyntheticDataset as JSyntheticDataset
from repurpose_tpu.ops import losses as jlosses
from repurpose_tpu.train.schedule import warmup_cosine_schedule as jax_schedule
from repurpose_tpu.train.state import create_train_state
from repurpose_tpu.train.step import make_train_step as jax_make_train_step
from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch, pack_batch, plan_packing
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.models.encoder import Dropout
from repurpose_tpu_torch.ops import losses
from repurpose_tpu_torch.train.schedule import warmup_cosine_schedule
from repurpose_tpu_torch.train.state import TrainState, make_optimizer
from repurpose_tpu_torch.train.step import (
    batch_to_device,
    kernel_layer_names,
    make_eval_step,
    make_train_step,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster than
    several workers each spreading small ops over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- losses --------------------------------------------------------------------


def test_losses_match_reference_goldens():
    g = json.load(open(os.path.join(GOLDEN_DIR, "losses.json")))
    focal = losses.sigmoid_focal_loss(torch.tensor(g["logits"]), torch.tensor(g["targets"]))
    np.testing.assert_allclose(focal.numpy(), np.asarray(g["focal"]), rtol=2e-4, atol=1e-7)
    diou = losses.ctr_diou_loss_1d(torch.tensor(g["off_in"]), torch.tensor(g["off_tg"]))
    np.testing.assert_allclose(diou.numpy(), np.asarray(g["diou"]), rtol=1e-5, atol=1e-6)


def test_masked_losses_match_jax():
    """Same numpy inputs, float32, rtol 1e-6 (bf16 logits go in as bf16)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, (3, 20, 1)).astype(np.float32)
    labels = rng.integers(0, 2, (3, 20)).astype(np.float32)
    mask = rng.random((3, 20)) > 0.3
    offsets = np.abs(rng.normal(0, 5, (3, 20, 2))).astype(np.float32)
    gt = np.abs(rng.normal(0, 5, (3, 20, 2))).astype(np.float32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = losses.masked_cls_loss(torch.from_numpy(logits).to(dtype),
                                     torch.from_numpy(labels), torch.from_numpy(mask))
        want = jlosses.masked_cls_loss(jnp.asarray(logits, jdtype), jnp.asarray(labels),
                                       jnp.asarray(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = losses.masked_reg_loss(*(torch.from_numpy(x) for x in (offsets, gt, labels, mask)))
    want = jlosses.masked_reg_loss(*(jnp.asarray(x) for x in (offsets, gt, labels, mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("warmup", [0, 5])
def test_schedule_matches_jax(warmup):
    """Warmup, the cosine phase and the clamp past total_steps; the JAX
    schedule computes in float32, hence rtol 1e-5."""
    ours = warmup_cosine_schedule(1e-3, warmup, 20)
    theirs = jax_schedule(1e-3, warmup, 20)
    steps = [0, 1, 4, 5, 6, 12, 19, 20, 25, 40]
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(theirs(s)) for s in steps], rtol=1e-5, atol=1e-12)
    assert ours(40) == ours(20 + warmup)  # held at the floor past total_steps


# -- the reference trajectory ---------------------------------------------------------

TINY_REF = ModelConfig(
    vis_dim=32, aud_dim=64, text_dim=16, d_model=64, self_num_layers=2, num_heads=4,
    d_ff=128, dropout=0.0, compute_dtype="float32", attention_impl="xla",
    attn_softmax_dtype="float32",
)


def _golden_batch(data, prefix: str) -> Batch:
    return Batch(
        visual=data[f"{prefix}/visual"].astype(np.float32),
        audio=data[f"{prefix}/audio"].astype(np.float32),
        text=data[f"{prefix}/text"].astype(np.float32),
        mask=data[f"{prefix}/mask"][:, 0, :],
        labels=data[f"{prefix}/labels"].astype(np.float32),
        segments=data[f"{prefix}/segments"].astype(np.float32),
        durations=data[f"{prefix}/lens"].astype(np.int32),
    )


def _sd(data, prefix: str) -> dict:
    return {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
            for k in data.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def golden():
    data = np.load(os.path.join(GOLDEN_DIR, "tiny_trained.npz"))
    meta = json.load(open(os.path.join(GOLDEN_DIR, "tiny_trained_decode.json")))
    return data, meta


@pytest.mark.parametrize("impl", ["xla", "pallas_full"])
def test_step_rides_the_reference_trajectory(golden, impl):
    """The reference's own training run (Adam lr 1e-3 wd 1e-4, loss / config
    batch size, per-step cosine): the port's step, from the same initial
    weights on the same 4 batches, with the plain attention and with the
    kernel attention's Function (float32 interior, plain versions on CPU)."""
    data, meta = golden
    steps = int(meta["steps"])
    cfg = dataclasses.replace(TINY_REF, attention_impl=impl)
    model = build_model(cfg, "cpu")
    model.load_state_dict(_sd(data, "init_sd/"), strict=True)
    tc = TrainConfig(batch_size=int(meta["batch_size_cfg"]), lr=1e-3, weight_decay=1e-4,
                     warmup_epochs=0, epochs=steps, buckets=(128,),
                     loss_norm="config_batch_size")
    opt, schedule = make_optimizer(model, tc, steps_per_epoch=1)
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(cfg, tc, schedule)
    batches = [batch_to_device(_golden_batch(data, f"batch{i}"), "cpu") for i in range(4)]
    ours = np.asarray([float(step(state, batches[s % 4])["loss"]) for s in range(steps)])
    ref = data["losses"]
    np.testing.assert_allclose(ours[:6], ref[:6], rtol=1e-4)
    np.testing.assert_allclose(ours, ref, rtol=0.05, atol=2e-3)
    assert ours[-1] < ours[0] * 0.2
    trained = _sd(data, "trained_sd/")
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), trained[name].numpy(), rtol=0.05, atol=5e-3,
                                   err_msg=name)


# -- against the JAX train step ----------------------------------------------------

JCFG = JModelConfig(
    vis_dim=16, aud_dim=24, text_dim=8, d_model=32, self_num_layers=2, num_heads=4,
    d_ff=64, hidden_dim=16, compute_dtype="float32", attention_impl="xla", dropout=0.0,
    matmul_precision="highest",
)
PCFG = ModelConfig(**{f.name: getattr(JCFG, f.name) for f in dataclasses.fields(JCFG)})


def _packed_batches(n_batches: int):
    durs = [40, 20, 30, 25, 35, 15, 45, 10]
    out = []
    for s in range(n_batches):
        jds = JSyntheticDataset(durs, JCFG, seed=3 + s)
        rows = plan_packing(durs, 64, 4)[0]
        jb = jax_pack_batch([jds[i] for i in range(8)], rows, 64, 4)
        pds = SyntheticDataset(durs, PCFG, seed=3 + s)
        pb = pack_batch([pds[i] for i in range(8)], rows, 64, 4)
        for a, b in zip(jb, pb):
            np.testing.assert_array_equal(a, b)
        out.append((jb, pb))
    return out


def _jax_to_port_kernel_order(params) -> list[int]:
    """For each port matrix parameter (kernel_layer_names order), its index
    in the JAX per-layer norm vector."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, (_, x) in enumerate(flat)])
    sd = state_dict_from_jax_params(tagged)
    kernels = [i for i, (path, _) in enumerate(flat)
               if "/".join(getattr(p, "key", str(p)) for p in path).endswith("kernel")]
    model = build_model(PCFG, "cpu")
    return [kernels.index(int(sd[n].flatten()[0])) for n in kernel_layer_names(model)]


@pytest.mark.parametrize("reg_loss_weight", [0.0, 0.5])
def test_step_matches_jax_step_packed_with_accumulation(reg_loss_weight):
    """Three steps on packed batches with grad_accum_steps=2, from the same
    weights: loss, grad_norm, per-layer norms (rtol 1e-4) and the params
    after three steps (rtol 1e-4, atol 1e-6), float32. One exception: the
    key third of each QKV bias has an analytically zero gradient (softmax is
    shift-invariant), so Adam normalises float32 noise there and moves it by
    up to lr per step in either framework, in either direction: it is held to
    3 x lr."""
    tc = TrainConfig(batch_size=4, buckets=(64,), epochs=1, lr=1e-3, pack_sequences=True,
                     loss_norm="batch_size", grad_accum_steps=2,
                     reg_loss_weight=reg_loss_weight)
    jtc = JTrainConfig(**dataclasses.asdict(tc) | {"buckets": tc.buckets})
    jstate, tx, jsched = create_train_state(JCFG, jtc, steps_per_epoch=3,
                                            rng=jax.random.key(1))
    jstep = jax_make_train_step(JCFG, jtc, tx, jsched, donate=False,
                                per_layer_grad_norms=True)
    order = _jax_to_port_kernel_order(jstate.params)

    model = build_model(PCFG, "cpu")
    model.load_state_dict(state_dict_from_jax_params(jax.device_get(jstate.params)),
                          strict=True)
    opt, sched = make_optimizer(model, tc, steps_per_epoch=3)
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(PCFG, tc, sched)
    for jb, pb in _packed_batches(3):
        jstate, jm = jstep(jstate, jb, jax.random.key(7))
        m = step(state, batch_to_device(pb, "cpu"), per_layer_grad_norms=True)
        for key in ("loss", "cls_loss", "grad_norm") + (("reg_loss",) if reg_loss_weight else ()):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4, err_msg=key)
        assert int(m["n_real"]) == int(jm["n_real"]) == 8
        np.testing.assert_allclose(float(m["learning_rate"]), float(jm["learning_rate"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(m["grad_norms/stacked"].numpy(),
                                   np.asarray(jm["grad_norms/stacked"])[order],
                                   rtol=1e-4, atol=1e-7)
    want = state_dict_from_jax_params(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        got, w = p.numpy(), want[name].numpy()
        if name.endswith("in_proj_bias"):
            d = PCFG.d_model
            np.testing.assert_allclose(got[d:2 * d], w[d:2 * d], atol=3 * tc.lr, rtol=0)
            got, w = np.delete(got, np.s_[d:2 * d]), np.delete(w, np.s_[d:2 * d])
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-6, err_msg=name)


# -- guards and dropout --------------------------------------------------------------

TINY = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
                   num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                   attention_impl="auto", attn_softmax_dtype="float32", dropout=0.1)


def _tiny_batch(seed=0, b=2, t=32):
    ds = SyntheticDataset([t - 3 * i for i in range(b)], TINY, seed=seed)
    from repurpose_tpu_torch.data.batching import collate

    return batch_to_device(collate([ds[i] for i in range(b)], (t,), b), "cpu")


def _tiny_state(tc, cfg=TINY):
    model = build_model(cfg, "cpu", seed=1)
    opt, sched = make_optimizer(model, tc, steps_per_epoch=2)
    return TrainState(model=model, optimizer=opt), make_train_step(cfg, tc, sched)


@pytest.mark.parametrize("accum,accum_dtype", [(1, "float32"), (2, "bfloat16")])
def test_reg_head_frozen_without_regression_loss(accum, accum_dtype):
    """reg_loss_weight 0: no loss reaches the reg head, its grads stay None
    (bf16 accumulation included) and Adam leaves it untouched, weight decay
    and all; with the regression loss on it trains."""
    tc = TrainConfig(batch_size=2, buckets=(32,), epochs=1, weight_decay=1e-2,
                     grad_accum_steps=accum, grad_accum_dtype=accum_dtype)
    state, step = _tiny_state(tc)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    step(state, _tiny_batch())
    for n, p in state.model.named_parameters():
        if n.startswith("reg_head."):
            assert p.grad is None and torch.equal(p, before[n]), n
        else:
            assert p.grad is not None, n
    state, step = _tiny_state(dataclasses.replace(tc, reg_loss_weight=1.0))
    step(state, _tiny_batch())
    assert not torch.equal(state.model.reg_head._modules["7"].weight,
                           before["reg_head.7.weight"])


def test_nonfinite_count_counts_a_nan_step():
    tc = TrainConfig(batch_size=2, buckets=(32,), epochs=1)
    state, step = _tiny_state(tc)
    m = step(state, _tiny_batch())
    assert int(state.nonfinite_count) == 0 and bool(torch.isfinite(m["loss"]))
    bad = _tiny_batch()
    bad.visual[0, 0, 0] = float("nan")
    step(state, bad)
    assert state.nonfinite_count.dtype == torch.int32 and int(state.nonfinite_count) == 1
    assert state.step == 2


def test_eval_step_is_deterministic_and_leaves_no_grads():
    tc = TrainConfig(batch_size=2, buckets=(32,), epochs=1)
    state, _ = _tiny_state(tc)
    eval_step = make_eval_step(tc)
    a, b = eval_step(state.model, _tiny_batch()), eval_step(state.model, _tiny_batch())
    assert float(a["loss"]) == float(b["loss"]) and int(a["n_real"]) == 2
    assert all(p.grad is None for p in state.model.parameters())


def _forward(model, batch):
    return model(batch.visual, batch.audio, batch.text, batch.mask).cls_logits


def test_dropout_eval_deterministic_train_reproducible():
    batch = _tiny_batch()
    model = build_model(TINY, "cpu", seed=2)
    assert not model.training  # build_model returns eval mode
    e1, e2 = _forward(model, batch), _forward(model, batch)
    assert torch.equal(e1, e2)
    model.train()
    outs = []
    for _ in range(2):
        model.set_dropout_generator(torch.Generator().manual_seed(11))
        outs.append(_forward(model, batch))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], e1)
    model.set_dropout_generator(torch.Generator().manual_seed(12))
    assert not torch.equal(_forward(model, batch), outs[0])
    plain = build_model(dataclasses.replace(TINY, dropout=0.0), "cpu", seed=2).train()
    assert torch.equal(_forward(plain, batch), e1)


def test_dropout_law():
    """Keep probability 1 - p and survivors scaled by 1/(1-p); 4 sigma of
    the binomial count over 200k draws is ~0.004."""
    drop = Dropout(0.25).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(200_000))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.004
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(drop.eval()(torch.ones(10)), torch.ones(10))
