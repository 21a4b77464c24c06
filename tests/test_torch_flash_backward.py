"""The port's attention backward against the JAX package on the CPU.

Same numpy inputs through both. The JAX backward runs its Pallas kernels in
interpret mode (``_flash_backward(..., q_block=64, k_block=64,
interpret=True)``); o and lse come from the JAX forward and go to both, and
the upstream gradient is 0 on query rows at or past the last valid key (the
model's contract; see ops/flash_attention.py).

Tolerances, as a fraction of max |gradient|: float32 inputs with the float32
interior, 1e-5 (measured 1e-6: float32 sums in another order). bf16 inputs
or the bf16 interior, 2**-6: XLA on the CPU and PyTorch round the interior's
bf16 products at slightly different points, which moves single p / ds
entries by one bf16 ulp (measured 5.7e-3 of max, one bf16 ulp at the top of
the range).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.ops.attention import mha_xla
from repurpose_tpu.ops.flash_attention import (
    _flash_backward,
    _flash_forward,
    _pick_block,
    mha_pallas,
)
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops.attention import select_attention_impl
from repurpose_tpu_torch.ops.flash_attention import (
    FlashAttention,
    _kv_len,
    flash_attention,
    flash_backward,
    flash_backward_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
)

F32_REL = 1e-5
BF16_REL = 2.0 ** -6


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread per test worker is faster than
    several workers each spreading small ops over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(t: int, packed: bool):
    """Unpacked: row 0 ragged (t - 28 valid), row 1 forty valid keys with a
    hole of four. Packed: row 0 three videos with a gap of padding between
    the second and the third, row 1 no valid key at all."""
    valid = np.zeros((2, t), bool)
    if not packed:
        valid[0, : t - 28] = True
        valid[1, :40] = True
        valid[1, 10:14] = False
        return valid, None
    seg = np.full((2, t), -1, np.int32)
    for s, (a, b) in enumerate([(0, 50), (50, t - 40), (t - 34, t - 20)]):
        valid[0, a:b] = True
        seg[0, a:b] = s
    return valid, seg


def _inputs(seed, t, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, t, 2, dh)).astype(np.float32) for _ in range(4)]


def _assert_rel(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * max(scale, 1e-6), f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("t,dh", [(128, 32), (96, 16)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype,softmax_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
def test_backward_reference_matches_pallas_kernels(t, dh, packed, dtype, softmax_dtype):
    """dq, dk, dv on every row against the JAX dq / dkv kernels."""
    q, k, v, g = _inputs(t + dh, t, dh)
    valid, seg = _layout(t, packed)
    g[np.arange(t)[None] >= _kv_len(torch.from_numpy(valid)).numpy()] = 0.0
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jsm = jnp.bfloat16 if softmax_dtype == "bfloat16" else jnp.float32
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    o, lse = _flash_forward(jq, jk, jv, jnp.asarray(valid), _pick_block(t, 64), True,
                            sm_dtype=jsm, seg_ids=jseg)
    want = _flash_backward(jq, jk, jv, jnp.asarray(valid), o, lse, jg, 64, 64, True,
                           sm_dtype=jsm, seg_ids=jseg)
    td = getattr(torch, dtype)
    as_t = lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(td)  # noqa: E731
    got = flash_backward(
        *(as_t(x) for x in (jq, jk, jv)), torch.from_numpy(valid), as_t(o),
        torch.from_numpy(np.array(lse)), as_t(jg),
        None if seg is None else torch.from_numpy(seg), softmax_dtype,
    )
    rel = F32_REL if (dtype, softmax_dtype) == ("float32", "float32") else BF16_REL
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and a.shape == (2, t, 2, dh)
        _assert_rel(a.float().numpy(), np.asarray(w.astype(jnp.float32)), rel, name)
    if packed:  # the row with no valid key
        assert all(bool((a[1] == 0).all()) for a in got)


def test_backward_wrappers_on_cpu_are_the_plain_versions():
    """On CPU tensors the wrappers compute the plain versions and count no
    kernel launch."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, 64, 16))
    valid = torch.ones(2, 64, dtype=torch.bool)
    from repurpose_tpu_torch.ops.flash_attention import flash_forward

    o, lse = flash_forward(q, k, v, valid)
    before = (flash_bwd_dq.launches, flash_bwd_dkv.launches)
    got = flash_backward(q, k, v, valid, o, lse, g)
    want = flash_backward_reference(q, k, v, valid, o, lse, g)
    assert (flash_bwd_dq.launches, flash_bwd_dkv.launches) == before
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def _jax_grads(fn, q, k, v, w):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_autograd_function_matches_jax_grad(packed, backward):
    """Gradients of sum(out * w) (w zero on padding rows, as the model's
    upstream gradient is) through the port's Function, against jax.grad
    through mha_pallas with the same backward and through mha_xla; float32,
    rel 1e-5."""
    t, dh = 128, 32
    q, k, v, w = _inputs(7, t, dh)
    valid, seg = _layout(t, packed)
    w = w * valid[:, :, None, None]
    jvalid = jnp.asarray(valid)
    jseg = None if seg is None else jnp.asarray(seg)
    want_pallas = _jax_grads(
        lambda a, b, c: mha_pallas(a, b, c, jvalid, q_block=64, backward=backward,
                                   seg_ids=jseg), q, k, v, w)
    want_xla = _jax_grads(
        lambda a, b, c: mha_xla(a, b, c, jvalid, precision="highest", seg_ids=jseg),
        q, k, v, w)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, torch.from_numpy(valid),
                          None if seg is None else torch.from_numpy(seg), "float32", backward)
    assert out.grad_fn._forward_cls is FlashAttention
    (out * torch.from_numpy(w)).sum().backward()
    for name, a, wp, wx in zip("qkv", leaves, want_pallas, want_xla):
        _assert_rel(a.grad.numpy(), np.asarray(wp), F32_REL, f"d{name} vs mha_pallas")
        _assert_rel(a.grad.numpy(), np.asarray(wx), F32_REL, f"d{name} vs mha_xla")


TINY = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=2,
                   num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
                   attn_softmax_dtype="float32", dropout=0.0)


@pytest.mark.parametrize("impl", ["auto", "pallas", "pallas_full"])
def test_kernel_impls_train_the_qkv_projection(impl):
    """The fault this slice repairs: the kernel attention used to cut
    autograd (its output had no grad_fn), so the QKV projections never
    received a gradient. Every kernel impl now returns the Function's output
    and fills in_proj_weight.grad in every layer, equal to the plain
    attention's (float32, rel 1e-5)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 40, 2, 8)).astype(np.float32))
               for _ in range(3))
    valid = torch.ones(2, 40, dtype=torch.bool)
    out = select_attention_impl(impl, "float32")(q.requires_grad_(), k, v, valid)
    assert out.grad_fn is not None and out.grad_fn._forward_cls is FlashAttention

    feats = [torch.from_numpy(rng.normal(0, 1, (2, 40, d)).astype(np.float32))
             for d in (8, 12, 4)]
    mask = torch.ones(2, 40, dtype=torch.bool)
    mask[1, 25:] = False
    grads = {}
    for name in (impl, "xla"):
        model = build_model(dataclasses.replace(TINY, attention_impl=name), "cpu", seed=3)
        model.train()
        model(*feats, mask).cls_logits[mask].sum().backward()
        grads[name] = [layer.self_attn.in_proj_weight.grad
                       for layer in model.multimodal_encoder.layers]
    for got, want in zip(grads[impl], grads["xla"]):
        assert got is not None and float(got.abs().max()) > 0
        _assert_rel(got.numpy(), want.numpy(), F32_REL, "in_proj_weight.grad")
