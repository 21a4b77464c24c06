"""Port MMCT (repurpose_tpu_torch.models) against the reference golden outputs
and against the JAX MMCT on the same weights, on the CPU.

Tolerances: float32 against the golden torch forward, atol 2e-4 / rtol 1e-3
(as tests/test_model.py holds the JAX model). float32 against the JAX model,
atol 5e-5 / rtol 1e-4: both run full float32 products, only the order of sums
differs. bf16 activations: coarse agreement, mean |d| < 0.05 on the cls
logits, as tests/test_model.py bounds the JAX bf16 forward.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JaxModelConfig
from repurpose_tpu.models import MMCT as JaxMMCT
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.data.batching import pack_batch, plan_packing
from repurpose_tpu_torch.models import build_model, state_dict_from_jax_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tiny_model.npz")

TINY = dict(
    vis_dim=32, aud_dim=64, text_dim=16, d_model=64,
    self_num_layers=2, num_heads=4, d_ff=128,
    compute_dtype="float32", matmul_precision="highest", attn_softmax_dtype="float32",
)


def _port(cfg: ModelConfig, sd) -> torch.nn.Module:
    model = build_model(cfg, "cpu")
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
                          strict=True)
    return model


def _run(model, *arrays, seg_ids=None, positions=None):
    with torch.inference_mode():
        t = [torch.from_numpy(np.asarray(a)) for a in arrays]
        kw = {}
        if seg_ids is not None:
            kw = dict(seg_ids=torch.from_numpy(seg_ids), positions=torch.from_numpy(positions))
        return model(*t, **kw)


@pytest.fixture(scope="module")
def golden():
    data = np.load(GOLDEN)
    return data, {k[3:]: data[k] for k in data.files if k.startswith("sd/")}


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_forward_matches_golden_fp32(golden, impl):
    data, sd = golden
    out = _run(_port(ModelConfig(**TINY, attention_impl=impl), sd),
               data["visual"], data["audio"], data["text"], data["mask"])
    mask = data["mask"].astype(bool)
    for got, want in ((out.cls_logits, data["cls_logits"]), (out.offsets, data["offsets"])):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[mask], want[mask], atol=2e-4, rtol=1e-3)
    assert torch.isfinite(out.cls_logits).all() and torch.isfinite(out.offsets).all()


def test_forward_bf16_close_to_golden(golden):
    data, sd = golden
    cfg = ModelConfig(**{**TINY, "compute_dtype": "bfloat16",
                         "attn_softmax_dtype": "bfloat16"})
    out = _run(_port(cfg, sd), data["visual"], data["audio"], data["text"], data["mask"])
    mask = data["mask"].astype(bool)
    assert out.cls_logits.dtype == torch.float32 and out.feats.dtype == torch.bfloat16
    assert np.abs(out.cls_logits.numpy()[mask] - data["cls_logits"][mask]).mean() < 0.05


@functools.lru_cache(maxsize=None)
def _jax_model_and_params(compute_dtype: str):
    """JAX MMCT with random weights; biases and norms perturbed so the weight
    mapping is exercised for every tensor, not only the matrices."""
    cfg = JaxModelConfig(**{**TINY, "compute_dtype": compute_dtype,
                            "attention_impl": "xla"})
    model = JaxMMCT(cfg)
    params = model.init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), params
    )
    return cfg, model, params


def _batch(packed: bool):
    rng = np.random.default_rng(1)
    lens = [90, 40, 120, 60, 30]
    samples = [{"visual": rng.normal(0, 1, (n, 32)).astype(np.float32),
                "audio": rng.normal(0, 1, (n, 64)).astype(np.float32),
                "text": rng.normal(0, 1, (n, 16)).astype(np.float32),
                "duration": n} for n in lens]
    if packed:
        return pack_batch(samples, plan_packing(lens, 128, 4)[0], 128)
    batch = pack_batch(samples, [[i] for i in range(len(lens))], 128)
    return batch._replace(seg_ids=None, positions=None)


@pytest.mark.parametrize("impl", ["xla", "auto"])
@pytest.mark.parametrize("packed", [False, True])
def test_forward_matches_jax_model(packed, impl):
    jcfg, jmodel, params = _jax_model_and_params("float32")
    b = _batch(packed)
    kw = {} if not packed else dict(seg_ids=jnp.asarray(b.seg_ids),
                                    positions=jnp.asarray(b.positions))
    want = jax.jit(lambda p: jmodel.apply(
        {"params": p}, b.visual, b.audio, b.text, b.mask, True, **kw))(params)
    port = _port(ModelConfig(**TINY, attention_impl=impl), state_dict_from_jax_params(params))
    got = _run(port, b.visual, b.audio, b.text, b.mask,
               seg_ids=b.seg_ids, positions=b.positions)
    for g, w in ((got.cls_logits, want.cls_logits), (got.offsets, want.offsets),
                 (got.feats, want.feats)):
        np.testing.assert_allclose(g.numpy()[b.mask], np.asarray(w)[b.mask],
                                   atol=5e-5, rtol=1e-4)


def test_forward_bf16_close_to_jax_model():
    jcfg, jmodel, params = _jax_model_and_params("bfloat16")
    b = _batch(packed=True)
    want = jax.jit(lambda p: jmodel.apply(
        {"params": p}, b.visual, b.audio, b.text, b.mask, True,
        seg_ids=jnp.asarray(b.seg_ids), positions=jnp.asarray(b.positions)))(params)
    cfg = ModelConfig(**{**TINY, "compute_dtype": "bfloat16",
                         "attn_softmax_dtype": "bfloat16"})
    got = _run(_port(cfg, state_dict_from_jax_params(params)), b.visual, b.audio,
               b.text, b.mask, seg_ids=b.seg_ids, positions=b.positions)
    d = np.abs(got.cls_logits.numpy()[b.mask] - np.asarray(want.cls_logits)[b.mask])
    assert d.mean() < 0.05


def test_state_dict_names_match_reference(golden):
    _, sd = golden
    _, _, params = _jax_model_and_params("float32")
    port = build_model(ModelConfig(**TINY), "cpu")
    assert set(port.state_dict()) == set(sd) == set(state_dict_from_jax_params(params))


def test_init_weights_follow_the_jax_init():
    model = build_model(ModelConfig(**TINY), "cpu", seed=3)
    for name, p in model.named_parameters():
        if p.ndim == 2:
            fan_out, fan_in = p.shape
            lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
            assert p.abs().max() <= lim and p.std() > lim / 3, name
        elif name.endswith("bias"):
            assert (p == 0).all(), name
        else:
            assert (p == 1).all(), name
    again = build_model(ModelConfig(**TINY), "cpu", seed=3).state_dict()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, again[k], atol=0, rtol=0)


@pytest.mark.parametrize("fusion", ["cross", "bottleneck"])
def test_other_fusions_are_not_ported(fusion):
    """The other fusions were not ported and raised NotImplementedError; they
    are now (the name stays): ``build_model`` builds the variant, not the
    concat MMCT, with the JAX variant's parameter tree and no packed
    forward (tests/test_torch_fusion.py holds them to the JAX modules)."""
    from repurpose_tpu.models import build_model as jax_build_model

    cfg = dataclasses.replace(ModelConfig(**TINY), fusion=fusion)
    model = build_model(cfg, "cpu")
    assert type(model).__name__ == {"cross": "MMCTCross", "bottleneck": "MMCTBottleneck"}[fusion]
    jmodel = jax_build_model(JaxModelConfig(**{**TINY, "fusion": fusion}))
    x = lambda d: jnp.zeros((1, 16, d), jnp.float32)  # noqa: E731
    shapes = jax.eval_shape(lambda r: jmodel.init(r, x(32), x(64), x(16),
                                                  jnp.ones((1, 16), bool), True)["params"],
                            jax.random.key(0))
    want = state_dict_from_jax_params(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes))
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape for k in want)
