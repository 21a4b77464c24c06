"""Head widths without a kernel instance run zero-padded on the card:
``FlashAttention`` pads a head of Dh not in ``HEAD_DIMS`` to the narrowest
instance that holds it (``kernel_head_dim``: 8 -> 16, 48 -> 64, 192 -> 256;
past 256, the widest fixed-width instance, to the next multiple of
``CHUNK`` = 64, which the head-chunked kernels of csrc/flash_chunked.cu run:
257 -> 320, 1000 -> 1024) and hands
every wrapper the head's own scale 1/sqrt(Dh); the zero columns add nothing
to q_s k^T, p v or rowsum(g o), and out and the gradients are cut back to
Dh. The kernel wrappers stay strict and raise for such widths
(tests/test_torch_flash_gpu.py).

On the CPU the rule is checked, the padded route (forced onto CPU tensors,
where the wrappers run their plain versions) is held against ``jax.grad``
through the JAX package's ``mha_xla`` at Dh 8, 48 and 192, and the plain
versions at Dh 256 (the widest fixed-width instance) and at Dh 320 and 512
(the head-chunked kernels' widths) against ``mha_pallas`` in interpret
mode and ``jax.grad`` through it. The tests
marked ``gpu`` skip (in their fixture) where no card is visible; on a
machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_head_dims.py

Tolerances: float32 against JAX, 1e-5 x max |value| (float32 sums in another
order). On the card, against the same attention or model on the CPU (its
plain versions at the unpadded width): float32 1e-4 x max |value| (the
kernels sum in another order), bf16 1e-2 x max |value| (bf16 outputs and
gradients, one ulp 2**-7 relative).
"""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops import flash_attention as fa

F32_REL = 1e-5


def _assert_rel(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * max(scale, 1e-6), f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("dh,width", [(8, 16), (24, 32), (48, 64), (100, 128), (16, 16),
                                      (32, 32), (64, 64), (128, 128), (129, 256),
                                      (192, 256), (256, 256), (257, 320), (320, 320),
                                      (512, 512), (1000, 1024)])
def test_cuda_heads_run_at_the_narrowest_kernel_width(dh, width):
    assert fa.kernel_head_dim("cuda", dh) == width
    assert fa.kernel_head_dim(torch.device("cuda", 0), dh) == width
    assert fa.kernel_head_dim("cpu", dh) == dh  # the plain versions take every width


@pytest.mark.parametrize("dh", [8, 48, 192])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_padded_heads_match_jax_mha(monkeypatch, dh, packed, backward):
    """The route the card takes, forced onto CPU tensors: out and the
    gradients of sum(out * w) (w zero on padding rows) against jax.grad
    through the JAX ``mha_xla``; the wrappers see the padded width and the
    head's own scale."""
    import jax
    import jax.numpy as jnp

    from repurpose_tpu.ops.attention import mha_xla

    rule = fa.kernel_head_dim
    monkeypatch.setattr(fa, "kernel_head_dim", lambda device, d: rule("cuda", d))
    seen = []
    forward = fa.flash_forward

    def spy(q, *args, scale=None, **kw):
        seen.append((q.shape[-1], scale))
        return forward(q, *args, scale=scale, **kw)

    monkeypatch.setattr(fa, "flash_forward", spy)
    t = 96
    rng = np.random.default_rng(dh + 2 * packed)
    q, k, v, w = (rng.normal(0, 1, (2, t, 2, dh)).astype(np.float32) for _ in range(4))
    valid = np.zeros((2, t), bool)
    seg = None
    if packed:
        seg = np.full((2, t), -1, np.int32)
        for s, (a, b) in enumerate([(0, 30), (30, 70), (75, 90)]):
            valid[0, a:b] = True
            seg[0, a:b] = s
        valid[1, :50], seg[1, :50] = True, 0
    else:
        valid[0, : t - 20] = True
        valid[1, :40] = True
        valid[1, 10:14] = False
    w = w * valid[:, :, None, None]
    jvalid, jseg = jnp.asarray(valid), None if seg is None else jnp.asarray(seg)

    def loss(a, b, c):
        return jnp.sum(mha_xla(a, b, c, jvalid, precision="highest", seg_ids=jseg) * w)

    want_out = np.asarray(mha_xla(*(jnp.asarray(x) for x in (q, k, v)), jvalid,
                                  precision="highest", seg_ids=jseg))
    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, torch.from_numpy(valid),
                             None if seg is None else torch.from_numpy(seg), "float32", backward)
    assert out.shape == (2, t, 2, dh)
    assert seen == [(rule("cuda", dh), 1.0 / dh ** 0.5)]
    (out * torch.from_numpy(w)).sum().backward()
    live = np.arange(t)[None] < fa._kv_len(torch.from_numpy(valid)).numpy()  # rows read
    _assert_rel(out.detach().numpy()[live], want_out[live], F32_REL, "out")
    for name, a, b in zip("qkv", leaves, want):
        assert a.grad.shape == (2, t, 2, dh)
        _assert_rel(a.grad.numpy(), np.asarray(b), F32_REL, f"d{name}")


@pytest.mark.parametrize("packed", [False, True])
def test_widest_instance_plain_versions_match_mha_pallas(packed):
    """Dh 256 at T = 128 (no padding: the kernels' own width): the plain
    forward's out and lse rows that attend a key, and the gradients of
    sum(out * w) through the port's Function, against the JAX ``mha_pallas``
    run in interpret mode (its Pallas forward and backward kernels) and
    ``jax.grad`` through it; float32, 1e-5 x max |value|."""
    _plain_versions_match_mha_pallas(256, packed, seed=3 + packed)


@pytest.mark.parametrize("dh", [320, 512])
@pytest.mark.parametrize("packed", [False, True])
def test_chunked_widths_plain_versions_match_mha_pallas(dh, packed):
    """The head-chunked kernels' widths (Dh 320 and 512, multiples of
    ``CHUNK``: no padding) at T = 128: the plain versions, which the chunked
    kernels are held to on the card, against ``mha_pallas`` in interpret
    mode and ``jax.grad`` through it, as at Dh 256; float32, 1e-5 x max
    |value|."""
    assert fa.kernel_head_dim("cuda", dh) == dh
    _plain_versions_match_mha_pallas(dh, packed, seed=dh + packed)


def _plain_versions_match_mha_pallas(dh: int, packed: bool, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from repurpose_tpu.ops.flash_attention import mha_pallas

    t = 128
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(0, 1, (2, t, 2, dh)).astype(np.float32) for _ in range(4))
    valid = np.zeros((2, t), bool)
    seg = None
    if packed:
        seg = np.full((2, t), -1, np.int32)
        for s, (a, b) in enumerate([(0, 40), (40, 90), (95, 120)]):
            valid[0, a:b] = True
            seg[0, a:b] = s
        valid[1, :70], seg[1, :70] = True, 0
    else:
        valid[0, : t - 30] = True
        valid[1, :50] = True
        valid[1, 20:26] = False
    w = w * valid[:, :, None, None]
    jvalid, jseg = jnp.asarray(valid), None if seg is None else jnp.asarray(seg)

    def attend(a, b, c):
        return mha_pallas(a, b, c, jvalid, q_block=64, seg_ids=jseg)

    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    want_out = np.asarray(attend(jq, jk, jv))
    want = jax.grad(lambda a, b, c: jnp.sum(attend(a, b, c) * w), argnums=(0, 1, 2))(jq, jk, jv)
    assert fa.kernel_head_dim("cuda", dh) == dh
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*leaves, torch.from_numpy(valid),
                             None if seg is None else torch.from_numpy(seg), "float32")
    (out * torch.from_numpy(w)).sum().backward()
    live = np.arange(t)[None] < fa._kv_len(torch.from_numpy(valid)).numpy()
    if packed:
        live &= seg >= 0  # rows of padding attend no key
    _assert_rel(out.detach().numpy()[live], want_out[live], F32_REL, "out")
    for name, a, b in zip("qkv", leaves, want):
        _assert_rel(a.grad.numpy(), np.asarray(b), F32_REL, f"d{name}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, want, rel, what):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max())
    assert err <= rel * max(float(want.abs().max()), 1e-6), f"{what}: max err {err:.3g}"


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 48, 192, 320, 512])
@pytest.mark.parametrize("t,dtype", [(300, torch.float32), (2200, torch.float32),
                                     (2200, torch.bfloat16)])
def test_padded_heads_on_the_card_match_the_plain_attention(cuda, dh, t, dtype):
    """flash_attention at Dh 8 / 48 / 192 on CUDA (dense and streaming
    kernels; bf16 at 48 -> 64 takes the tensor-core stream kernels) and at
    Dh 320 / 512 (the head-chunked kernels) against the same call on CPU
    tensors, out and gradients; kernels launched."""
    rng = np.random.default_rng(dh + t)
    q, k, v, w = (torch.from_numpy(rng.normal(0, 1, (2, t, 2, dh)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    valid = torch.ones(2, t, dtype=torch.bool)
    valid[1, t // 2:] = False
    w = w * valid[:, :, None, None]
    counters = (fa.flash_forward, fa.flash_forward_stream, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fa.flash_bwd_dq_stream, fa.flash_bwd_dkv_stream)
    runs = []
    for device in (cuda, torch.device("cpu")):
        before = sum(f.launches for f in counters)
        chunked_before = sum(f.launches for f in (
            fa.flash_fwd_chunked, fa.flash_fwd_stream_chunked, fa.flash_bwd_dq_chunked,
            fa.flash_bwd_dkv_chunked, fa.flash_bwd_dq_stream_chunked,
            fa.flash_bwd_dkv_stream_chunked))
        leaves = [x.to(device).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention(*leaves, valid.to(device), None, "float32")
        (out.float() * w.to(device).float()).sum().backward()
        runs.append((out, *(x.grad for x in leaves)))
        launched = sum(f.launches for f in counters) - before
        assert (launched > 0) == (device.type == "cuda")
        if device.type == "cuda" and dh > fa.HEAD_DIMS[-1]:
            chunked = (fa.flash_fwd_chunked, fa.flash_fwd_stream_chunked,
                       fa.flash_bwd_dq_chunked, fa.flash_bwd_dkv_chunked,
                       fa.flash_bwd_dq_stream_chunked, fa.flash_bwd_dkv_stream_chunked)
            assert sum(f.launches for f in chunked) - chunked_before == launched
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    live = (torch.arange(t)[None] < fa._kv_len(valid)).to(cuda)
    for name, got, want in zip(("out", "dq", "dk", "dv"), *runs):
        assert got.shape == (2, t, 2, dh) and got.dtype == dtype
        _close(got[live], want.to(cuda)[live], rel, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [8, 48, 320, 512])
def test_models_of_head_widths_without_a_kernel_train_on_the_card(cuda, dh):
    """A two-head model of Dh 8 / 48 / 320 / 512 (d_model 16 / 96 / 640 /
    1024; the last two on the head-chunked kernels), forward and
    backward on CUDA with attention "auto": the kernels launch, and the
    logits and every gradient match the same model on the CPU."""
    cfg = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=2 * dh, self_num_layers=2,
                      num_heads=2, d_ff=64, hidden_dim=16, compute_dtype="float32",
                      attention_impl="auto", attn_softmax_dtype="float32", dropout=0.0)
    rng = np.random.default_rng(dh)
    b, t = 2, 40
    feats = [torch.from_numpy(rng.normal(0, 1, (b, t, n)).astype(np.float32))
             for n in (cfg.vis_dim, cfg.aud_dim, cfg.text_dim)]
    mask = torch.ones(b, t, dtype=torch.bool)
    mask[1, 29:] = False
    launches = (fa.flash_forward, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    outs = []
    for device in (cuda, torch.device("cpu")):
        before = [f.launches for f in launches]
        model = build_model(cfg, device, seed=5).train()
        m = mask.to(device)
        logits = model(*(x.to(device) for x in feats), m).cls_logits
        (logits.float() * m[..., None]).sum().backward()
        outs.append((logits, {n: p.grad for n, p in model.named_parameters()}))
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert all(f.launches > n for f, n in zip(launches, before))
    (got, got_grads), (want, want_grads) = outs
    _close(got, want, 1e-4, "logits")
    for name, g in want_grads.items():
        assert (g is None) == (got_grads[name] is None), name
        if g is not None:
            _close(got_grads[name], g, 1e-4, name)
