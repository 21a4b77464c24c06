"""The CUDA streaming attention backward (``csrc/flash_bwd_stream.cu``, long
T) against its plain PyTorch versions, the dense backward kernels and
autograd through the plain attention, on the card. Marked ``gpu``; each test
skips (in its fixture) where no card is visible. Run on a machine with an
H100:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_bwd_stream_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Inputs: o and lse from the kernel forward; the upstream gradient is random
on the rows the model gives one (before the last valid key and, packed,
inside a video) and 0 elsewhere, the model's contract.

Tolerances, on max |kernel - plain| as a fraction of max |plain|, those of
the dense backward's GPU tests:
- float32 inputs with the float32 interior: 1e-4 (the kernel sums s, dp and
  the gradients in another order, ~1e-6 relative per sum);
- bf16 inputs, or the bf16 interior: 1e-2. Outputs are bf16 (one ulp is
  2**-8 relative), and a last-bit difference in s or dp can flip the bf16
  rounding of a p or ds entry.
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
    flash_bwd_dkv,
    flash_bwd_dkv_stream,
    flash_bwd_dkv_stream_reference,
    flash_bwd_dq,
    flash_bwd_dq_stream,
    flash_bwd_dq_stream_reference,
    flash_bwd_stream_prep,
    flash_bwd_stream_prep_reference,
    flash_forward,
)

pytestmark = pytest.mark.gpu

REL_TOL = {(torch.float32, "float32"): 1e-4}  # everything else: 1e-2
INTERIORS = ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "float32"),
             (torch.float32, "bfloat16"), (torch.float32, "float32"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, t, h, dh, dtype, device, packed, sm):
    """Four rows. 0: full (one video). 1: empty. 2: kvl ~ 0.9 T with interior
    key holes (packed: each run between holes a video of its own, since a
    video is one contiguous run of its row, as packing lays them and as
    ``packed_block_bounds`` takes them). 3: unpacked, a ragged prefix of
    T - 37; packed, videos of 1..T/5 steps head to tail from an odd offset,
    with a gap of padding between two of them. Returns q, k, v, key_valid,
    seg_ids, o, lse, g."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        torch.from_numpy(rng.normal(0, 1, (4, t, h, dh)).astype(np.float32))
        .to(dtype).to(device) for _ in range(4)
    )
    valid = np.zeros((4, t), bool)
    seg = np.full((4, t), -1, np.int32)
    valid[0] = True
    n = int(0.9 * t)
    valid[2, :n] = True
    valid[2, rng.integers(0, n, size=n // 16)] = False
    valid[2, n - 1] = True
    if packed:
        seg[0, :] = 0
        starts = valid[2] & ~np.concatenate([[False], valid[2, :-1]])
        seg[2] = np.where(valid[2], np.cumsum(starts) - 1, -1)
        pos, vid = 13, 0
        while True:
            ln = int(rng.integers(1, t // 5))
            if pos + ln > t:
                break
            valid[3, pos:pos + ln] = True
            seg[3, pos:pos + ln] = vid
            pos += ln + (101 if vid == 2 else 0)
            vid += 1
    else:
        valid[3, : t - 37] = True
    kv = torch.from_numpy(valid).to(device)
    sg = torch.from_numpy(seg).to(device) if packed else None
    o, lse = flash_forward(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
    rows = torch.arange(t, device=device)[None, :] < _kv_len(kv)
    if packed:
        rows &= sg >= 0
    g = g.masked_fill(~rows[:, :, None, None], 0.0)
    return q, k, v, kv, sg, o, lse, g


def _close(got, want, rel, what):
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= rel * scale, f"{what}: max err {err:.3g} > {rel} x max {scale:.3g}"


def _check(args, sm, empty_row=1):
    q, k, v, kv, sg, o, lse, g = args
    dq = flash_bwd_dq_stream(q, k, v, kv, o, lse, g, sg, sm)
    dk, dv = flash_bwd_dkv_stream(q, k, v, kv, o, lse, g, sg, sm)
    torch.cuda.synchronize()
    ref_dq = flash_bwd_dq_stream_reference(q, k, v, kv, o, lse, g, sg, sm)
    ref_dk, ref_dv = flash_bwd_dkv_stream_reference(q, k, v, kv, o, lse, g, sg, sm)
    rel = REL_TOL.get((q.dtype, sm), 1e-2)
    past = torch.arange(q.shape[1], device=q.device)[None, :] >= _kv_len(kv)
    for name, got, want in (("dq", dq, ref_dq), ("dk", dk, ref_dk), ("dv", dv, ref_dv)):
        assert got.dtype == q.dtype and got.shape == q.shape
        assert torch.isfinite(got.float()).all(), name
        _close(got, want, rel, name)
        assert (got[past] == 0).all(), f"{name}: rows past kvl are not 0"
        if empty_row is not None:
            assert (got[empty_row] == 0).all(), f"{name}: the empty row is not 0"


@pytest.mark.parametrize("t", [2049, 3000, 4096, 8193])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_stream_kernels_match_plain(cuda, dh, t):
    """Every T window of the TPU kernels (2048 < T <= 8192, T > 8192), ragged
    T, every head width, both dtypes and interiors, unpacked and packed."""
    for dtype, sm in INTERIORS:
        for packed in (False, True):
            _check(_inputs(dh + t, t, 2, dh, dtype, cuda, packed, sm), sm)


def test_stream_kernels_at_the_long_video_shape(cuda):
    """[1, 16384, 8, 64] bf16 with the bf16 interior (rows 0-3 of the layout
    are four batch rows here), unpacked and packed."""
    for packed in (False, True):
        _check(_inputs(17, 16384, 8, 64, torch.bfloat16, cuda, packed, "bfloat16"),
               "bfloat16")


@pytest.mark.parametrize("dtype,sm", INTERIORS)
def test_packed_stream_gradients_equal_the_dense_kernels(cuda, dtype, sm):
    """Packed rows: the bounded sweeps (bias form) give the gradients of the
    dense kernels, which sweep every key tile to kvl (select form)."""
    q, k, v, kv, sg, o, lse, g = _inputs(21, 3000, 2, 64, dtype, cuda, True, sm)
    got = (flash_bwd_dq_stream(q, k, v, kv, o, lse, g, sg, sm),
           *flash_bwd_dkv_stream(q, k, v, kv, o, lse, g, sg, sm))
    want = (flash_bwd_dq(q, k, v, kv, o, lse, g, sg, sm),
            *flash_bwd_dkv(q, k, v, kv, o, lse, g, sg, sm))
    torch.cuda.synchronize()
    rel = REL_TOL.get((dtype, sm), 1e-2)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a, w, rel, name)


def test_flash_backward_launches_the_stream_kernels_past_stream_max_t(cuda):
    counters = (flash_bwd_dq, flash_bwd_dkv, flash_bwd_dq_stream, flash_bwd_dkv_stream)
    before = [f.launches for f in counters]
    for packed in (False, True):
        q, k, v, kv, sg, o, lse, g = _inputs(5, fa.STREAM_MAX_T + 1, 2, 32, torch.bfloat16,
                                             cuda, packed, "bfloat16")
        flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [0, 0, 2, 2]
    q, k, v, kv, sg, o, lse, g = _inputs(5, fa.STREAM_MAX_T, 2, 32, torch.bfloat16, cuda,
                                         True, "bfloat16")
    flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 2, 2]


def test_strided_qkv_views_match_contiguous(cuda):
    b, t, h, dh = 2, 3000, 8, 64
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3 * h * dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).to(cuda)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    kv = torch.ones(b, t, dtype=torch.bool, device=cuda)
    kv[1, 2500:] = False
    seg = torch.zeros(b, t, dtype=torch.int32, device=cuda)
    seg[:, 1000:] = 1
    seg[1, 2500:] = -1
    for sg in (None, seg):
        o, lse = flash_forward(q, k, v, kv, sg, "bfloat16")
        g = torch.randn(o.shape, device=cuda).to(o.dtype)
        g[1, 2500:] = 0
        got = flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
        want = flash_backward(q.contiguous(), k.contiguous(), v.contiguous(), kv, o, lse, g,
                              sg, "bfloat16")
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=0.0, rtol=0.0)


def test_stream_wrappers_raise_on_unsupported_inputs(cuda):
    q, k, v, kv, _, o, lse, g = _inputs(6, 2100, 2, 32, torch.bfloat16, cuda, False,
                                        "float32")
    with pytest.raises(ValueError):  # dtype
        flash_bwd_dq_stream(q.half(), k.half(), v.half(), kv, o.half(), lse, g.half())
    with pytest.raises(ValueError):  # g on another device
        flash_bwd_dkv_stream(q, k, v, kv, o, lse, g.cpu())
    with pytest.raises(ValueError):  # head width
        wide = torch.zeros(4, 2100, 2, 48, dtype=torch.bfloat16, device=cuda)
        flash_bwd_dq_stream(wide, wide, wide, kv, wide, lse, wide)
    with pytest.raises(ValueError):  # lse dtype
        flash_bwd_dkv_stream(q, k, v, kv, o, lse.double(), g)


@pytest.mark.parametrize("packed", [False, True])
def test_autograd_function_matches_plain_autograd_past_stream_max_t(cuda, packed):
    """Gradients of sum(out * w) at T = 3000, w zero where the model's
    upstream gradient is, through the Function (stream forward and backward
    kernels) against autograd through mha_torch, float32, rel 1e-4."""
    q, k, v, kv, sg, _, _, w = _inputs(9, 3000, 2, 64, torch.float32, cuda, packed,
                                       "float32")
    grads = []
    for fn in (lambda *a: flash_attention(*a, "float32", "pallas"), mha_torch):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        (fn(*leaves, kv, sg) * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for name, got, want in zip("qkv", *grads):
        _close(got, want, 1e-4, f"d{name}")


def _edge_inputs(seed, t, h, dh, dtype, device, sm):
    """Two rows at the edges of the 64-row tiles and of 128-row blocks:
    row 0 unpacked-style with kvl = t - 60 (inside a 128-row block, off the
    64 grid); row 1 packed with video boundaries at 2100 (inside a block)
    and 2171, padding from 3010. Returns the unpacked and the packed case."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (
        torch.from_numpy(rng.normal(0, 1, (2, t, h, dh)).astype(np.float32))
        .to(dtype).to(device) for _ in range(4)
    )
    valid = np.zeros((2, t), bool)
    valid[0, : t - 60] = True
    valid[1, :3010] = True
    seg = np.full((2, t), -1, np.int32)
    seg[0, : t - 60] = 0
    seg[1, :2100], seg[1, 2100:2171], seg[1, 2171:3010] = 0, 1, 2
    kv = torch.from_numpy(valid).to(device)
    cases = []
    for sg in (None, torch.from_numpy(seg).to(device)):
        o, lse = flash_forward(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
        rows = torch.arange(t, device=device)[None, :] < _kv_len(kv)
        if sg is not None:
            rows &= sg >= 0
        cases.append((q, k, v, kv, sg, o, lse, g.masked_fill(~rows[:, :, None, None], 0.0)))
    return cases


@pytest.mark.parametrize("t", [4160, 4133])
@pytest.mark.parametrize("dh", [32, 64])
def test_stream_kernels_at_tile_and_block_edges(cuda, dh, t):
    """T a multiple of 64 but not of 128 (4160) and ragged (4133); kvl and a
    video boundary inside 128-row blocks, both dtypes and interiors."""
    for dtype, sm in INTERIORS:
        for args in _edge_inputs(dh + t, t, 2, dh, dtype, cuda, sm):
            _check(args, sm, empty_row=None)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype,sm", [(torch.bfloat16, "bfloat16"), (torch.float32, "float32")])
def test_stream_kernels_are_deterministic(cuda, dtype, sm, packed):
    """Two launches on the same inputs give the same bits (no atomics)."""
    args = _inputs(11, 8193, 4, 64, dtype, cuda, packed, sm)
    q, k, v, kv, sg, o, lse, g = args
    runs = [(flash_bwd_dq_stream(q, k, v, kv, o, lse, g, sg, sm),
             *flash_bwd_dkv_stream(q, k, v, kv, o, lse, g, sg, sm)) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("packed", [False, True])
def test_stream_prep_matches_plain(cuda, packed):
    """The prep kernel's q_s, {lse, delta} and {key flag, segment} against
    plain torch: q_s and the flags exactly, delta within float32 summation
    order (1e-5 x max |delta|), lse copied exactly; padding rows as set."""
    q, k, v, kv, sg, o, lse, g = _inputs(13, 3000, 8, 64, torch.bfloat16, cuda, packed,
                                         "bfloat16")
    qv = torch.randn(4, 3000, 3 * 8 * 64, device=cuda).to(torch.bfloat16)
    q_view = qv[..., : 8 * 64].view(4, 3000, 8, 64)  # a strided view, as the model's
    for qq in (q, q_view):
        got = flash_bwd_stream_prep(qq, k, v, kv, o, lse, g, sg)
        torch.cuda.synchronize()
        want = flash_bwd_stream_prep_reference(qq, k, v, kv, o, lse, g, sg)
        assert torch.equal(got[0], want[0]), "q_s"
        assert torch.equal(got[1][..., 0], want[1][..., 0]), "lse"
        delta = want[1][..., 1]
        err = float((got[1][..., 1] - delta).abs().max())
        assert err <= 1e-5 * float(delta.abs().max()), f"delta: max err {err:.3g}"
        assert torch.equal(got[2], want[2]), "info"
    with pytest.raises(ValueError):  # float32 keeps the first kernels, no prep
        flash_bwd_stream_prep(q.float(), k.float(), v.float(), kv, o.float(), lse, g.float(), sg)


def test_stream_kernels_take_a_given_prep(cuda):
    """flash_backward runs the prep once for both kernels; each wrapper run
    alone runs its own, with the same bits."""
    q, k, v, kv, sg, o, lse, g = _inputs(15, 4096, 2, 64, torch.bfloat16, cuda, True,
                                         "bfloat16")
    before = [f.launches for f in (flash_bwd_stream_prep, flash_bwd_dq_stream,
                                   flash_bwd_dkv_stream)]
    together = flash_backward(q, k, v, kv, o, lse, g, sg, "bfloat16")
    torch.cuda.synchronize()
    after = [f.launches for f in (flash_bwd_stream_prep, flash_bwd_dq_stream,
                                  flash_bwd_dkv_stream)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    alone = (flash_bwd_dq_stream(q, k, v, kv, o, lse, g, sg, "bfloat16"),
             *flash_bwd_dkv_stream(q, k, v, kv, o, lse, g, sg, "bfloat16"))
    torch.cuda.synchronize()
    assert flash_bwd_stream_prep.launches - after[0] == 2
    for name, a, b in zip(("dq", "dk", "dv"), together, alone):
        assert torch.equal(a, b), name
