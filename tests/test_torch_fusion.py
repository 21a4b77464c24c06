"""The fusion variants of the port (``fusion: cross`` -> ``MMCTCross``,
``fusion: bottleneck`` -> ``MMCTBottleneck``) against the JAX modules on the
same weights, carried over by ``state_dict_from_jax_params``; built as
tests/test_cross_modal.py builds them (tiny widths, one layer of each kind),
and at two layers of each kind.

Tolerances: float32, 1e-5 x max |value| for the eval forward and 1e-4 x max
|value| for the loss and each parameter's gradient (sums in another order
through the backward; a gradient that is 0 in exact arithmetic is held to
1e-7 x the largest gradient); bf16 activations, 5e-2 x max |value| on the logits
and offsets (bf16 rounds at the same points in both, but a last-bit
difference in a float32 product before a bf16 rounding moves that value by
one bf16 ulp, 2**-8 relative, and a few layers compound it); the served
clips as tests/test_torch_infer.py holds the JAX pipeline's (scores atol
1e-4, segments atol 2e-3, labels exact).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JaxModelConfig
from repurpose_tpu.config import TestConfig as JaxTestConfig
from repurpose_tpu.infer import InferencePipeline as JaxPipeline
from repurpose_tpu.models.bottleneck import MMCTBottleneck as JaxBottleneck
from repurpose_tpu.models.cross_modal import MMCTCross as JaxCross
from repurpose_tpu.ops.losses import masked_cls_loss as jax_cls_loss
from repurpose_tpu_torch.config import ModelConfig, TestConfig, TrainConfig
from repurpose_tpu_torch.data.batching import Batch
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params
from repurpose_tpu_torch.models.bottleneck import MMCTBottleneck
from repurpose_tpu_torch.models.cross_modal import MMCTCross
from repurpose_tpu_torch.ops.losses import masked_cls_loss
from repurpose_tpu_torch.train.step import loss_fn

TINY = dict(
    vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
    text_num_layers=1, cross_num_layers=1, num_heads=2, d_ff=32, hidden_dim=8,
    compute_dtype="float32", attention_impl="xla", dropout=0.0,
)
JAX_MODELS = {"cross": JaxCross, "bottleneck": JaxBottleneck}
PORT_MODELS = {"cross": MMCTCross, "bottleneck": MMCTBottleneck}
SERVE_CFG = dict(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                 duration_thresh_max=90, max_seg_per_min=1.0)


def _batch(seed, b=2, t=32):
    rng = np.random.default_rng(seed)
    vis, aud, txt = (rng.normal(0, 1, (b, t, n)).astype(np.float32) for n in (8, 12, 4))
    mask = np.ones((b, t), bool)
    mask[0, t // 2:] = False
    labels = rng.integers(0, 2, (b, t)).astype(np.float32)
    return vis, aud, txt, mask, labels


@functools.lru_cache(maxsize=None)
def _init_params(fusion, layers):
    """The JAX model's float32 params (the tree does not depend on the
    compute dtype or the batch), each leaf moved by seeded noise so that no
    bias or norm scale sits at its init value; made once per tree."""
    cfg_kw = dict(TINY, text_num_layers=layers, cross_num_layers=layers)
    model = JAX_MODELS[fusion](JaxModelConfig(**cfg_kw, fusion=fusion))
    vis, aud, txt, mask, _ = _batch(0)
    params = jax.jit(lambda r: model.init(r, vis, aud, txt, mask, True)["params"])(
        jax.random.key(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), params)


def _jax_params(fusion, cfg_kw):
    """(the JAX model of ``cfg_kw``, its params from ``_init_params``)."""
    jcfg = JaxModelConfig(**cfg_kw, fusion=fusion, matmul_precision="highest")
    return JAX_MODELS[fusion](jcfg), _init_params(fusion, cfg_kw["text_num_layers"])


def _port(fusion, cfg_kw, params):
    model = build_model(ModelConfig(**cfg_kw, fusion=fusion), "cpu")
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_build_model_builds_the_variant(fusion):
    cfg = ModelConfig(**TINY, fusion=fusion)
    model = build_model(cfg, "cpu", seed=3)
    assert type(model) is PORT_MODELS[fusion] and not model.training
    if fusion == "bottleneck":  # a normal of std 0.02, not Xavier
        tokens = model.bottleneck_tokens.detach().numpy()
        assert tokens.shape == (8, 16) and 0.01 < tokens.std() < 0.03
    assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
@pytest.mark.parametrize("layers", [1, 2])
def test_eval_forward_matches_jax(fusion, layers):
    cfg_kw = dict(TINY, text_num_layers=layers, cross_num_layers=layers)
    batch = _batch(layers)
    jmodel, params = _jax_params(fusion, cfg_kw)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, *batch[:4], True))(params)
    got = _port(fusion, cfg_kw, params)(*(torch.from_numpy(x) for x in batch[:4]))
    for name in ("cls_logits", "offsets", "feats"):
        g, w = getattr(got, name).detach().numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_bf16_eval_forward_matches_jax(fusion):
    cfg_kw = dict(TINY, compute_dtype="bfloat16")
    batch = _batch(7)
    jmodel, params = _jax_params(fusion, cfg_kw)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, *batch[:4], True))(params)
    got = _port(fusion, cfg_kw, params)(*(torch.from_numpy(x) for x in batch[:4]))
    assert got.feats.dtype == torch.bfloat16
    for name in ("cls_logits", "offsets"):
        g, w = getattr(got, name).detach().float().numpy(), np.asarray(getattr(want, name))
        assert _rel(g, w) <= 5e-2, (name, _rel(g, w))


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_train_step_loss_and_gradients_match_jax(fusion):
    """One step's loss (the masked focal cls loss) and every parameter's
    gradient, dropout 0, against jax.grad."""
    batch = _batch(11)
    vis, aud, txt, mask, labels = batch
    jmodel, params = _jax_params(fusion, TINY)

    def jloss(p):
        out = jmodel.apply({"params": p}, vis, aud, txt, mask, False)
        return jax_cls_loss(out.cls_logits, jnp.asarray(labels), jnp.asarray(mask))

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    model = _port(fusion, TINY, params).train()
    out = model(*(torch.from_numpy(x) for x in (vis, aud, txt, mask)))
    loss = masked_cls_loss(out.cls_logits, torch.from_numpy(labels), torch.from_numpy(mask))
    loss.backward()
    assert _rel(loss.item(), float(want_loss)) <= 1e-4
    want_sd = state_dict_from_jax_params(jax.tree.map(np.asarray, want_grads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_sd)
    # the key projection's bias has a gradient of 0 in exact arithmetic (it
    # shifts every score of a query alike), so both sides hold rounding noise
    # there: each parameter is held to 1e-4 x the larger of its own largest
    # gradient and 1e-3 x the largest gradient of any parameter
    top = max(float(np.abs(w.numpy()).max()) for w in want_sd.values())
    for name, g in grads.items():
        want = want_sd[name].numpy()
        if g is None:  # no loss reaches the reg head: JAX's gradient is zero there
            assert name.startswith("reg_head.") and not want.any(), name
            continue
        got = g.numpy()
        err = float(np.abs(got - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-3 * top), (name, err)


def _videos(seed, lengths):
    rng = np.random.default_rng(seed)
    return [
        {"visual": rng.normal(0, 1, (t, 8)).astype(np.float32),
         "audio": rng.normal(0, 1, (t, 12)).astype(np.float32),
         "text": rng.normal(0, 1, (t, 4)).astype(np.float32),
         "video_id": f"vid{i}"}
        for i, t in enumerate(lengths)
    ]


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_score_videos_matches_the_jax_pipeline(fusion):
    """score_videos, unpacked, on the same weights and clips as the JAX
    InferencePipeline."""
    _, params = _jax_params(fusion, TINY)
    jcfg = JaxModelConfig(**TINY, fusion=fusion, matmul_precision="highest")
    videos = _videos(4, [30, 55, 62, 40, 64])  # one bucket, one compiled program
    want = JaxPipeline(jcfg, params, JaxTestConfig(**SERVE_CFG)).score_videos(
        videos, buckets=(64,), batch_size=2)
    got = InferencePipeline(ModelConfig(**TINY, fusion=fusion),
                            state_dict_from_jax_params(params), TestConfig(**SERVE_CFG),
                            device="cpu").score_videos(videos, buckets=(64,), batch_size=2)
    assert sum(len(r["labels"]) for r in want) > 0
    for a, b in zip(got, want):
        assert a["video_id"] == b["video_id"] and a["duration"] == b["duration"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
        np.testing.assert_allclose(a["segments"], b["segments"], atol=2e-3)


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_a_packed_batch_raises_a_clear_error(fusion):
    cfg = ModelConfig(**TINY, fusion=fusion)
    model = build_model(cfg, "cpu")
    vis, aud, txt, mask, labels = (torch.from_numpy(x) for x in _batch(2))
    seg = torch.where(mask, 0, -1).to(torch.int32)
    packed = Batch(vis, aud, txt, mask, labels, torch.zeros(*labels.shape, 2),
                   mask.sum(1).to(torch.int32), seg, torch.zeros_like(seg))
    with pytest.raises(ValueError, match="sequence-packed"):
        loss_fn(model, TrainConfig(batch_size=2), packed)
    loss_fn(model, TrainConfig(batch_size=2), packed._replace(seg_ids=None, positions=None))
    pipe = InferencePipeline(cfg, model.state_dict(), TestConfig(**SERVE_CFG), device="cpu")
    with pytest.raises(ValueError, match="sequence-packed"):
        pipe.score_videos(_videos(1, [30, 40]), buckets=(64,), pack=True)
    assert len(pipe.score_videos(_videos(1, [30, 40]), buckets=(64,))) == 2


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_the_trainer_trains_a_variant_unpacked(fusion, tmp_path):
    """The Trainer builds the variant through build_model, takes an epoch of
    steps with a finite loss, evaluates, and resumes its checkpoint."""
    from repurpose_tpu_torch.config import Config
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.train.loop import Trainer

    mc = ModelConfig(**{**TINY, "dropout": 0.1}, fusion=fusion)
    tc = TrainConfig(batch_size=2, buckets=(64, 128), epochs=1, eval_freq=1, save_epochs=1,
                     warmup_epochs=0)
    cfg = Config(model=mc, train=tc, test_cfg=TestConfig(**SERVE_CFG))
    ds = SyntheticDataset([40, 50, 60, 70], mc, seed=1)
    trainer = Trainer(cfg, str(tmp_path), ds, ds, device="cpu")
    summary = trainer.fit()
    trainer.close()
    assert type(trainer.state.model) is PORT_MODELS[fusion]
    assert summary["step"] == trainer.steps_per_epoch and np.isfinite(summary["final_loss"])
    again = Trainer(cfg, str(tmp_path), ds, device="cpu")
    assert again.resume() and again.state.step == trainer.steps_per_epoch
    for (n, a), b in zip(trainer.state.model.state_dict().items(),
                         again.state.model.state_dict().values()):
        assert torch.equal(a, b), n
    again.close()
