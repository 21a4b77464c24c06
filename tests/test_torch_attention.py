"""Port attention (repurpose_tpu_torch.ops) against the JAX package on the CPU.

Same numpy inputs through both. The JAX flash forward runs its Pallas
kernel in interpret mode, as its own tests run it (q_block 64).

Tolerances: float32 paths agree to float32 rounding (atol 1e-5 on outputs
of O(1), lse 1e-5). With the bf16 softmax interior, XLA on the CPU keeps
float32 between the interior's bf16 operations where PyTorch rounds each
one, so values differ by about one bf16 ulp: out atol 1e-2, lse atol 3e-3
(measured: 4e-3 and 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.ops.attention import mha_xla
from repurpose_tpu.ops.flash_attention import _flash_forward, mha_pallas
from repurpose_tpu_torch.ops.attention import mha_torch, select_attention_impl
from repurpose_tpu_torch.ops.flash_attention import (
    SKIP_LSE,
    _kv_len,
    flash_forward,
    flash_forward_reference,
)

F32 = dict(out=1e-5, lse=1e-5)
BF16_SM = dict(out=1e-2, lse=3e-3)


def _layout(t: int, packed: bool):
    """Row 0: two videos then padding; row 1: ragged (40 of t) plus, when
    packed, a second video after a gap of padding."""
    valid = np.zeros((2, t), bool)
    seg = np.full((2, t), -1, np.int32)
    valid[0, : t - 28] = True
    seg[0, :60] = 0
    seg[0, 60 : t - 28] = 1
    valid[1, :40] = True
    seg[1, :40] = 0
    if packed:
        valid[1, 70:90] = True
        seg[1, 70:90] = 1
    return valid, (seg if packed else None)


def _qkv(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, t, h, dh)).astype(np.float32) for _ in range(3)]


def _live(valid, seg):
    """Query rows both implementations compute: before the last valid key,
    and (packed) inside a video."""
    live = np.arange(valid.shape[1])[None] < _kv_len(torch.from_numpy(valid)).numpy()
    return live if seg is None else live & (seg >= 0)


@pytest.mark.parametrize("packed", [False, True])
def test_mha_torch_matches_mha_xla(packed):
    q, k, v = _qkv(0, 3, 48, 2, 16)
    valid = np.ones((3, 48), bool)
    valid[1, 30:] = False
    valid[2] = False  # an all-masked row
    seg = None
    if packed:
        seg = np.zeros((3, 48), np.int32)
        seg[0, 20:] = 1
        seg[1, 30:] = -1
        seg[2] = -1
    want = mha_xla(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid),
                   precision="highest", seg_ids=None if seg is None else jnp.asarray(seg))
    got = mha_torch(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid),
                    None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,softmax_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("packed", [False, True])
def test_flash_forward_matches_pallas_kernel(packed, dtype, softmax_dtype):
    """Out and lse on computed rows, against _flash_forward in interpret mode."""
    t = 128
    q, k, v = _qkv(1, 2, t, 2, 32)
    valid, seg = _layout(t, packed)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j_out, j_lse = _flash_forward(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(valid), 64, True,
        sm_dtype=jnp.bfloat16 if softmax_dtype == "bfloat16" else jnp.float32,
        seg_ids=None if seg is None else jnp.asarray(seg),
    )
    td = getattr(torch, dtype)
    p_out, p_lse = flash_forward(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), torch.from_numpy(valid),
        seg_ids=None if seg is None else torch.from_numpy(seg),
        softmax_dtype=softmax_dtype,
    )
    assert p_out.dtype == td and p_lse.dtype == torch.float32
    assert p_out.shape == (2, t, 2, 32) and p_lse.shape == (2, 2, t, 1)
    tol = F32 if softmax_dtype == "float32" else BF16_SM
    live = _live(valid, seg)
    np.testing.assert_allclose(
        p_out.float().numpy()[live], np.asarray(j_out.astype(jnp.float32))[live],
        atol=tol["out"], rtol=0,
    )
    lse_rows = lambda a: a[..., 0].transpose(0, 2, 1)[live]  # noqa: E731
    np.testing.assert_allclose(
        lse_rows(p_lse.numpy()), lse_rows(np.asarray(j_lse)), atol=tol["lse"], rtol=0
    )


@pytest.mark.parametrize("t", [96, 100])
def test_flash_forward_matches_pallas_odd_lengths(t):
    """T not a multiple of 64: mha_pallas tiles 96 by 32 and falls back to
    mha_xla at 100 (no legal block); it returns out only."""
    q, k, v = _qkv(2, 2, t, 2, 32)
    valid = np.ones((2, t), bool)
    valid[1, 50:] = False
    want = mha_pallas(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid), q_block=64)
    got, _ = flash_forward(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid))
    live = _live(valid, None)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=1e-5, rtol=0)


def test_skipped_rows_are_zero_with_skip_lse():
    """Rows at or past the last valid key: out 0 and lse 1e30, row by row
    (rows 40..63 of batch row 1 too, where the TPU kernel, which skips whole
    64-row blocks, computes padding values); whole skipped blocks agree with
    the Pallas kernel exactly."""
    t = 128
    q, k, v = _qkv(3, 2, t, 2, 32)
    valid, _ = _layout(t, packed=False)
    out, lse = flash_forward(*(torch.from_numpy(x) for x in (q, k, v)),
                             torch.from_numpy(valid))
    kvl = _kv_len(torch.from_numpy(valid))[:, 0].tolist()
    assert kvl == [t - 28, 40]
    for b, n in enumerate(kvl):
        assert (out[b, n:] == 0).all()
        assert (lse[b, :, n:] == SKIP_LSE).all()
        assert torch.isfinite(out[b, :n]).all() and (lse[b, :, :n] < SKIP_LSE).all()
    j_out, j_lse = _flash_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                  jnp.asarray(valid), 64, True)
    np.testing.assert_array_equal(np.asarray(j_out)[1, 64:], out.numpy()[1, 64:])
    np.testing.assert_array_equal(np.asarray(j_lse)[1, :, 64:], lse.numpy()[1, :, 64:])


def test_flash_forward_reference_on_cpu_is_the_wrapper():
    """On a CPU tensor the wrapper computes the plain version and does not
    count a kernel launch."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 64, 2, 16))
    valid = torch.ones(2, 64, dtype=torch.bool)
    before = flash_forward.launches
    a = flash_forward(q, k, v, valid)
    b = flash_forward_reference(q, k, v, valid)
    assert flash_forward.launches == before
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, atol=0, rtol=0)


def test_select_attention_impl():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 2, 64, 2, 16))
    valid = torch.ones(2, 64, dtype=torch.bool)
    assert select_attention_impl("xla") is mha_torch
    want = mha_torch(q, k, v, valid)
    for impl in ("auto", "pallas", "pallas_full"):
        got = select_attention_impl(impl, "float32")(q, k, v, valid)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    with pytest.raises(NotImplementedError):
        select_attention_impl("ring")
