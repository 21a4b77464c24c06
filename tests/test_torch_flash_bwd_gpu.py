"""The CUDA flash-attention backward kernels (dq, dk/dv) against their plain
PyTorch versions, and the autograd Function against autograd through the
plain attention, on the card. Marked ``gpu``; each test skips (in its
fixture) where no card is visible. Run on a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Inputs: o and lse from the kernel forward; the upstream gradient is random
on query rows before the last valid key and 0 past it, the model's contract.
bf16 at Dh 64 takes the tensor-core pair (``flash_bwd_{dq,dkv}_tc``, on one
``flash_bwd_stream_prep``), every other instance the first design.

Tolerances, on max |kernel - plain| as a fraction of max |plain|:
- float32 inputs with the float32 interior: 1e-4 (the kernel sums s, dp and
  the gradients in another order, ~1e-6 relative per sum);
- bf16 inputs, or the bf16 interior: 1e-2. Outputs are bf16 (one ulp is
  2**-8 relative), and a last-bit difference in s or dp can flip the bf16
  rounding of a p or ds entry. The bound scales with the gradient's size: a
  fixed bound would accept an output of zeros where gradients are small.
"""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops import flash_attention as fa
from repurpose_tpu_torch.ops.attention import mha_torch
from repurpose_tpu_torch.ops.flash_attention import (
    _kv_len,
    flash_attention,
    flash_backward,
    flash_backward_reference,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dkv_stream_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_bwd_dq_stream_reference,
    flash_bwd_stream_prep,
    flash_forward,
)

pytestmark = pytest.mark.gpu

REL_TOL = {(torch.float32, "float32"): 1e-4}  # everything else: 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, b, t, h, dh, dtype, device, packed, sm, padding_inside=False,
            split=True):
    """Row 0 full, row 1 all padding, row 2 ragged with interior key holes,
    row 3 three videos head to tail then padding (one video per row of 0-2
    when packed). Packed, row 2's holes lie on padding's segment -1, which
    splits its video's id into runs; with ``split=False`` they keep the
    video's id, so every video is one run, as packing lays them. With
    ``padding_inside`` (packed), rows 0 and 3 get a stretch of padding
    inside their first video, with a segment of its own and no valid key,
    and random g there. Returns q, k, v, key_valid, seg_ids, o, lse, g."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32))
        .to(dtype).to(device) for _ in range(4)
    )
    valid = np.zeros((b, t), bool)
    seg = np.full((b, t), -1, np.int32)
    valid[0] = True
    n = max(1, int(0.6 * t))
    valid[2, :n] = True
    valid[2, rng.integers(0, n, size=max(1, n // 8))] = False
    valid[2, 0] = True
    off = 0
    for s, ln in enumerate([max(1, t // 3), max(1, t // 4), max(1, t // 5)]):
        valid[3, off : off + ln] = True
        seg[3, off : off + ln] = s
        off += ln
    if packed:
        for r in range(3):
            seg[r, valid[r]] = 0
        if not split:
            seg[2, :n] = 0
        if padding_inside:
            for r in (0, 3):
                end = t if r == 0 else max(1, t // 3)
                a0, a1 = end // 3, end // 3 + max(1, end // 6)
                valid[r, a0:a1] = False
                seg[r, a0:a1] = 10
                seg[r, a1:end] = 11
    kv = torch.from_numpy(valid).to(device)
    sg = torch.from_numpy(seg).to(device) if packed else None
    o, lse = flash_forward(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
    past = torch.arange(t, device=device)[None, :] >= _kv_len(kv)
    g = g.masked_fill(past[:, :, None, None], 0.0)
    return q, k, v, kv, sg, o, lse, g


def _close(got, want, rel, what):
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x max {scale:.3g}"


def _check(args, sm):
    q, k, v, kv, sg, o, lse, g = args
    dq = flash_bwd_dq(q, k, v, kv, o, lse, g, sg, sm)
    dk, dv = flash_bwd_dkv(q, k, v, kv, o, lse, g, sg, sm)
    torch.cuda.synchronize()
    ref_dq = flash_bwd_dq_reference(q, k, v, kv, o, lse, g, sg, sm)
    ref_dk, ref_dv = flash_bwd_dkv_reference(q, k, v, kv, o, lse, g, sg, sm)
    rel = REL_TOL.get((q.dtype, sm), 1e-2)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.isfinite(got.float()).all(), name
        _close(got, want, rel, name)
        past = torch.arange(q.shape[1], device=q.device)[None, :] >= _kv_len(kv)
        assert (got[past] == 0).all(), f"{name}: rows past kvl are not 0"
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()


@pytest.mark.parametrize("t", [64, 100, 1000])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_kernels_match_plain(cuda, dh, t):
    for dtype, sm in ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "float32"),
                      (torch.float32, "bfloat16"), (torch.float32, "float32")):
        for packed in (False, True):
            _check(_inputs(dh + t, 4, t, 2, dh, dtype, cuda, packed, sm), sm)


def test_kernels_at_training_shape(cuda):
    """[6, 2048, 8, 64] bf16 with the bf16 interior, packed: the main path."""
    _check(_inputs(11, 6, 2048, 8, 64, torch.bfloat16, cuda, True, "bfloat16"), "bfloat16")


def test_strided_qkv_views_match_contiguous(cuda):
    b, t, h, dh = 2, 300, 4, 64
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3 * h * dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).to(cuda)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    kv = torch.ones(b, t, dtype=torch.bool, device=cuda)
    kv[1, 200:] = False
    o, lse = flash_forward(q, k, v, kv, softmax_dtype="bfloat16")
    g = torch.randn(o.shape, device=cuda).to(o.dtype)
    g[1, 200:] = 0
    got = flash_backward(q, k, v, kv, o, lse, g, None, "bfloat16")
    want = flash_backward(q.contiguous(), k.contiguous(), v.contiguous(), kv, o, lse, g,
                          None, "bfloat16")
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=0.0, rtol=0.0)


def test_cuda_tensors_launch_the_kernels(cuda):
    args = _inputs(5, 4, 128, 2, 32, torch.bfloat16, cuda, True, "bfloat16")
    q, k, v, kv, sg, o, lse, g = args
    dq0, dkv0 = flash_bwd_dq.launches, flash_bwd_dkv.launches
    flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    flash_backward(q, k, v, kv, o, lse, g, None, "bfloat16")
    torch.cuda.synchronize()
    assert flash_bwd_dq.launches == dq0 + 2 and flash_bwd_dkv.launches == dkv0 + 2


def test_cuda_wrappers_raise_on_unsupported_inputs(cuda):
    q, k, v, kv, _, o, lse, g = _inputs(6, 4, 64, 2, 32, torch.bfloat16, cuda, False,
                                        "float32")
    with pytest.raises(ValueError):  # dtype
        flash_bwd_dq(q.half(), k.half(), v.half(), kv, o.half(), lse, g.half())
    with pytest.raises(ValueError):  # g on another device
        flash_bwd_dkv(q, k, v, kv, o, lse, g.cpu())
    with pytest.raises(ValueError):  # g with a strided head-dim axis
        gt = g.transpose(1, 3).contiguous().transpose(1, 3)
        flash_bwd_dq(q, k, v, kv, o, lse, gt)
    with pytest.raises(ValueError):  # lse dtype
        flash_bwd_dkv(q, k, v, kv, o, lse.double(), g)
    with pytest.raises(ValueError):  # softmax dtype
        flash_bwd_dq(q, k, v, kv, o, lse, g, None, "float16")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("backward", ["pallas", "xla"])
def test_autograd_function_matches_plain_autograd(cuda, packed, backward):
    """Gradients of sum(out * w), w zero on padding rows (the model's g),
    through the Function against autograd through mha_torch, float32."""
    q, k, v, kv, sg, _, _, _ = _inputs(9, 4, 200, 2, 64, torch.float32, cuda, packed,
                                       "float32")
    w = torch.randn(q.shape, device=cuda).masked_fill(~kv[:, :, None, None], 0.0)
    grads = []
    for fn in (lambda *a: flash_attention(*a, "float32", backward), mha_torch):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves, kv, sg) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for name, got, want in zip("qkv", *grads):
        _close(got, want, 1e-4, f"d{name}")


# -- the tensor-core pair (bf16 at Dh 64) -----------------------------------------


def _tc_launches():
    return fa.flash_bwd_dq_tc.launches, fa.flash_bwd_dkv_tc.launches


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["unpacked", "packed_runs", "packed_split"])
@pytest.mark.parametrize("t", [64, 100, 1000, 2047, 2048])
def test_tensor_core_pair_matches_plain(cuda, t, layout, sm):
    """Against the plain versions at ragged and full T, unpacked and packed
    (every video one run, or an id split into runs by masked keys on
    segment -1), both interiors; every launch the tensor-core pair's, two
    launches equal bit for bit."""
    args = _inputs(t + 1, 4, t, 2, 64, torch.bfloat16, cuda, layout != "unpacked", sm,
                   split=layout == "packed_split")
    before = _tc_launches()
    _check(args, sm)
    q, k, v, kv, sg, o, lse, g = args
    again = (flash_bwd_dq(q, k, v, kv, o, lse, g, sg, sm),
             *flash_bwd_dkv(q, k, v, kv, o, lse, g, sg, sm))
    once = flash_backward(q, k, v, kv, o, lse, g, sg, sm)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(again, once))
    assert tuple(x - b for x, b in zip(_tc_launches(), before)) == (3, 3)


@pytest.mark.parametrize("t", [100, 1000, 2048])
def test_tensor_core_pair_keeps_the_select_form(cuda, t):
    """Padding inside kvl (a segment of its own, no valid key, random g),
    float32 interior: the pair matches the select form's plain versions and
    is far from the bias form's."""
    args = _inputs(t + 2, 4, t, 2, 64, torch.bfloat16, cuda, True, "float32",
                   padding_inside=True)
    before = _tc_launches()
    _check(args, "float32")
    assert tuple(x - b for x, b in zip(_tc_launches(), before)) == (1, 1)
    q, k, v, kv, sg, o, lse, g = args
    got = flash_backward(q, k, v, kv, o, lse, g, sg, "float32")
    bias = (flash_bwd_dq_stream_reference(q, k, v, kv, o, lse, g, sg, "float32"),
            *flash_bwd_dkv_stream_reference(q, k, v, kv, o, lse, g, sg, "float32"))
    want = flash_backward_reference(q, k, v, kv, o, lse, g, sg, "float32")
    far = [float((a.float() - b.float()).abs().max()) / float(w.float().abs().max())
           for a, b, w in zip(got, bias, want)]
    assert max(far) > 1e-2, far


@pytest.mark.parametrize("packed", [False, True])
def test_tensor_core_pair_on_strided_views_matches_contiguous(cuda, packed):
    b, t, h, dh = 4, 700, 2, 64
    rng = np.random.default_rng(13)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3 * h * dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).to(cuda)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    _, _, _, kv, sg, o, lse, g = _inputs(13, b, t, h, dh, torch.bfloat16, cuda, packed,
                                          "bfloat16")
    o, lse = flash_forward(q, k, v, kv, sg, "bfloat16")
    before = _tc_launches()
    got = flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    want = flash_backward(q.contiguous(), k.contiguous(), v.contiguous(), kv, o, lse, g, sg,
                          "bfloat16")
    torch.cuda.synchronize()
    assert tuple(x - b for x, b in zip(_tc_launches(), before)) == (2, 2)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


def test_tensor_core_pair_takes_a_given_prep_as_is(cuda):
    args = _inputs(15, 4, 1000, 2, 64, torch.bfloat16, cuda, True, "bfloat16")
    q, k, v, kv, sg, o, lse, g = args
    prep = flash_bwd_stream_prep(q, k, v, kv, o, lse, g, sg, dense=True)
    n_prep = fa.flash_bwd_stream_prep.launches
    got = (flash_bwd_dq(q, k, v, kv, o, lse, g, sg, "bfloat16", prep),
           *flash_bwd_dkv(q, k, v, kv, o, lse, g, sg, "bfloat16", prep))
    torch.cuda.synchronize()
    assert fa.flash_bwd_stream_prep.launches == n_prep
    want = flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    assert fa.flash_bwd_stream_prep.launches == n_prep + 1  # once for both kernels
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # a prep of other inputs is taken too: the kernels read its q_s
    other = flash_bwd_stream_prep(q * 2, k, v, kv, o, lse, g, sg, dense=True)
    dq = flash_bwd_dq(q, k, v, kv, o, lse, g, sg, "bfloat16", other)
    torch.cuda.synchronize()
    assert not torch.equal(dq, got[0])
    with pytest.raises(ValueError):  # not a prep of this shape
        flash_bwd_dq(q[:, :500], k[:, :500], v[:, :500], kv[:, :500], o[:, :500],
                     lse[:, :, :500].contiguous(), g[:, :500], sg[:, :500], "bfloat16", prep)
    stream = flash_bwd_stream_prep(q, k, v, kv, o, lse, g, sg)  # the streaming sweep
    with pytest.raises(ValueError):
        flash_bwd_dkv(q, k, v, kv, o, lse, g, sg, "bfloat16", stream)


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
def test_unpacked_dense_pair_equals_the_stream_pair(cuda, sm):
    """One mainloop, one function: unpacked at T = 2048 the dense pair (the
    select form) and the long-T pair (the bias form), launched directly on
    one prep, give the same bits."""
    q, k, v, kv, sg, o, lse, g = _inputs(17, 4, 2048, 2, 64, torch.bfloat16, cuda, False, sm)
    prep = flash_bwd_stream_prep(q, k, v, kv, o, lse, g)
    dense = [torch.empty_like(q) for _ in range(3)]
    stream = [torch.empty_like(q) for _ in range(3)]
    fa.flash_bwd_dq_tc(q, k, v, g, sm, None, prep, dense[0])
    fa.flash_bwd_dkv_tc(q, k, v, g, sm, None, prep, dense[1], dense[2])
    fa._tc_launch("flash_bwd_dq_tc", q, k, v, g, sm, None, prep, stream[:1], dense=False)
    fa._tc_launch("flash_bwd_dkv_tc", q, k, v, g, sm, None, prep, stream[1:], dense=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(dense, stream))


@pytest.mark.parametrize("packed", [False, True])
def test_autograd_function_takes_the_tensor_core_pair(cuda, packed):
    """Gradients of sum(out * w) through the Function in bf16 at Dh 64 (w
    zero on padding rows, the model's g) against the plain backward on the
    Function's own forward, and against autograd through mha_torch in
    float32 on the same bf16 values; the tensor-core pair launched once."""
    q, k, v, kv, sg, _, _, _ = _inputs(19, 4, 300, 2, 64, torch.bfloat16, cuda, packed,
                                       "float32")
    w = torch.randn(q.shape, device=cuda).masked_fill(~kv[:, :, None, None], 0.0)
    before = _tc_launches()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, kv, sg, "float32")
    g = (out.float() * w).sum()
    g.backward()
    torch.cuda.synchronize()
    assert tuple(x - b for x, b in zip(_tc_launches(), before)) == (1, 1)
    o, lse = flash_forward(q, k, v, kv, sg, "float32")
    upstream = w.to(torch.bfloat16)
    want = flash_backward_reference(q, k, v, kv, o, lse, upstream, sg, "float32")
    for name, leaf, ref in zip("qkv", leaves, want):
        _close(leaf.grad, ref, 1e-2, f"d{name}")
    f32 = [x.float().requires_grad_() for x in (q, k, v)]
    (mha_torch(*f32, kv, sg) * upstream.float()).sum().backward()
    for name, leaf, ref in zip("qkv", leaves, f32):
        _close(leaf.grad, ref.grad, 2e-2, f"d{name} vs mha_torch")
