"""The port's streaming attention backward (long T) against the JAX package
on the CPU.

``flash_bwd_dq_stream_reference`` and ``flash_bwd_dkv_stream_reference`` are
the plain versions of ``csrc/flash_bwd_stream.cu``. They are held against
the JAX ``_flash_backward`` in interpret mode with its windows forced at
T = 256 by patching the JAX module's thresholds and blocks to 64, as its own
tests do: the stream window runs ``_bwd_dq_stream_kernel`` (packed:
``_bwd_dq_packed_stream_kernel``) and ``_bwd_dkv_stream_kernel``, the HBM
window ``_bwd_dq_hbm_kernel`` (both variants) and ``_bwd_dkv_stream_kernel``.
o and lse come from the JAX forward and go to both sides; the upstream
gradient is 0 on the rows the model never gives one (at or past the last
valid key, and packed padding rows).

Tolerances, as a fraction of max |gradient|, those of the dense backward's
tests: float32 inputs with the float32 interior 1e-5 (float32 sums in
another order); bf16 inputs or the bf16 interior 2**-6 (XLA on the CPU and
PyTorch round the interior's bf16 products at slightly different points,
which moves single p / ds entries by one bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repurpose_tpu.ops.flash_attention as fa
from repurpose_tpu_torch.ops import flash_attention as port_fa
from repurpose_tpu_torch.ops.flash_attention import (
    _kv_len,
    flash_backward,
    flash_bwd_dkv,
    flash_bwd_dkv_reference,
    flash_bwd_dkv_stream,
    flash_bwd_dkv_stream_reference,
    flash_bwd_dq,
    flash_bwd_dq_reference,
    flash_bwd_dq_stream,
    flash_bwd_dq_stream_reference,
    flash_bwd_stream_prep,
    flash_bwd_stream_prep_reference,
    flash_forward_stream_reference,
    packed_block_bounds,
    stream_tc,
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
    """Three rows. Row 0: valid to t - 28, with interior key holes
    (unpacked) or four videos at odd offsets, one of them a single step
    (packed). Row 1: a ragged prefix with a hole (unpacked), or two videos
    with a gap of padding between them (packed). Row 2: empty."""
    valid = np.zeros((3, t), bool)
    seg = np.full((3, t), -1, np.int32)
    if packed:
        for vid, (a, b) in enumerate([(0, 27), (27, 61), (61, 62), (62, t - 28)]):
            valid[0, a:b] = True
            seg[0, a:b] = vid
        valid[1, :90] = True
        seg[1, :90] = 0
        valid[1, 130:200] = True
        seg[1, 130:200] = 1
        return valid, seg
    valid[0, : t - 28] = True
    valid[0, [5, 64, 65, 130]] = False
    valid[1, :150] = True
    valid[1, 70:100] = False
    return valid, None


def _inputs(seed, t, h, dh, valid, seg):
    """q, k, v and an upstream gradient that is 0 where the model's is."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(0, 1, (valid.shape[0], t, h, dh)).astype(np.float32)
                  for _ in range(4))
    g[~_grad_rows(valid, seg)] = 0.0
    return q, k, v, g


def _grad_rows(valid, seg):
    """Rows the model gives a gradient: before kvl and, packed, in a video."""
    rows = np.arange(valid.shape[1])[None] < _kv_len(torch.from_numpy(valid)).numpy()
    return rows if seg is None else rows & (seg >= 0)


def _patch_window(monkeypatch, window: str):
    """Route the JAX backward at T = 256 to ``window``'s kernels, blocks 64."""
    for name in ("STREAM_K_BLOCK", "HBM_FWD_K_BLOCK", "PACKED_K_BLOCK", "HBM_DKV_K_BLOCK",
                 "DEFAULT_Q_BLOCK", "DEFAULT_K_BLOCK", "PACKED_Q_BLOCK"):
        monkeypatch.setattr(fa, name, 64)
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    monkeypatch.setattr(fa, "HBM_STREAM_T", 128 if window == "hbm" else 8192)


def _assert_rel(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    print(f"{what}: max err {err:.3g} (bound {rel * max(scale, 1e-6):.3g})")
    assert err <= rel * max(scale, 1e-6), f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("dtype,softmax_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("window,packed,dh", [
    ("stream", False, 32), ("stream", True, 16), ("hbm", False, 16), ("hbm", True, 32),
])
def test_stream_backward_reference_matches_pallas_long_t_kernels(monkeypatch, window, packed,
                                                                 dh, dtype, softmax_dtype):
    """dq, dk, dv on every row against the stream (packed: packed-stream)
    and HBM dq kernels and the stream dk/dv kernel, in interpret mode."""
    _patch_window(monkeypatch, window)
    t = 256
    valid, seg = _layout(t, packed)
    q, k, v, g = _inputs(t + dh, t, 2, dh, valid, seg)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jsm = jnp.bfloat16 if softmax_dtype == "bfloat16" else jnp.float32
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv, jg = (jnp.asarray(x, jd) for x in (q, k, v, g))
    o, lse = fa._flash_forward(jq, jk, jv, jnp.asarray(valid), 64, True, sm_dtype=jsm,
                               seg_ids=jseg)
    want = fa._flash_backward(jq, jk, jv, jnp.asarray(valid), o, lse, jg, 64, 64, True,
                              sm_dtype=jsm, seg_ids=jseg)
    td = getattr(torch, dtype)
    as_t = lambda x: torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(td)  # noqa: E731
    args = (*(as_t(x) for x in (jq, jk, jv)), torch.from_numpy(valid), as_t(o),
            torch.from_numpy(np.array(lse)), as_t(jg),
            None if seg is None else torch.from_numpy(seg), softmax_dtype)
    got = (flash_bwd_dq_stream_reference(*args), *flash_bwd_dkv_stream_reference(*args))
    rel = F32_REL if (dtype, softmax_dtype) == ("float32", "float32") else BF16_REL
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == td and a.shape == (3, t, 2, dh)
        _assert_rel(a.float().numpy(), np.asarray(w.astype(jnp.float32)), rel, name)
    assert all(bool((a[2] == 0).all()) for a in got)  # the empty row


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_stream_backward_chunking_does_not_change_the_result(packed, softmax_dtype):
    """64-row query and key chunks against the default chunks (one chunk
    here): the same tiles and rounding points, so float32 sums differ by
    rounding only."""
    t = 256
    valid, seg = _layout(t, packed)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, t, 2, 16, valid, seg))
    kv, sg = torch.from_numpy(valid), None if seg is None else torch.from_numpy(seg)
    o, lse = flash_forward_stream_reference(q, k, v, kv, sg, softmax_dtype)
    args = (q, k, v, kv, o, lse, g, sg, softmax_dtype)
    tiny = dict(q_chunk=64, k_chunk=64)
    torch.testing.assert_close(flash_bwd_dq_stream_reference(*args, **tiny),
                               flash_bwd_dq_stream_reference(*args), atol=1e-6, rtol=1e-6)
    for a, b in zip(flash_bwd_dkv_stream_reference(*args, **tiny),
                    flash_bwd_dkv_stream_reference(*args)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_stream_backward_equals_dense_backward_in_float32(packed):
    """The streaming plain versions (bias form, bounded sweeps) against the
    dense ones (select form, every key) on every row, float32, relative
    1e-5: where the model gives a gradient the two forms give the same p."""
    t = 256
    valid, seg = _layout(t, packed)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(4, t, 4, 32, valid, seg))
    kv, sg = torch.from_numpy(valid), None if seg is None else torch.from_numpy(seg)
    o, lse = flash_forward_stream_reference(q, k, v, kv, sg)
    args = (q, k, v, kv, o, lse, g, sg)
    stream = (flash_bwd_dq_stream_reference(*args), *flash_bwd_dkv_stream_reference(*args))
    dense = (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))
    for name, a, b in zip(("dq", "dk", "dv"), stream, dense):
        _assert_rel(a.numpy(), b.numpy(), F32_REL, name)


def _random_packing(seed, b, t):
    rng = np.random.default_rng(seed)
    seg = np.full((b, t), -1, np.int32)
    for bi in range(b):
        pos, vid = 0, 0
        while pos < t:
            n = int(rng.integers(1, 90))
            if pos + n > t or rng.random() < 0.1:
                break
            seg[bi, pos:pos + n] = vid
            pos, vid = pos + n, vid + 1
    return seg


@pytest.mark.parametrize("layout", ["random", "gaps", "pathological"])
def test_dkv_query_tile_range_is_the_brute_force_overlap(layout):
    """The query tiles a key tile's dk/dv sweeps, [lo, hi) of the key tile's
    own packed_block_bounds at 64/64, are exactly the query tiles holding a
    row of one of its videos (brute force), and the pairs the TPU's rule
    lo[q tile] <= k tile < hi[q tile] keeps."""
    t = 320
    if layout == "random":
        seg = _random_packing(7, 6, t)
    elif layout == "gaps":
        seg = np.full((2, t), -1, np.int32)
        for bi, spans in enumerate([[(0, 90), (130, 200), (201, 260)],
                                    [(3, 5), (70, 300)]]):
            for vid, (a, b) in enumerate(spans):
                seg[bi, a:b] = vid
    else:  # tiny videos at odd offsets, a full-row video, an empty row
        seg = np.full((3, t), -1, np.int32)
        edges = [0, 27, 61, 64, 65, 130, 190, 191, 250, 319]
        for vid, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            seg[0, a:b] = vid
        seg[1] = 0
    lo, hi = (x.numpy() for x in packed_block_bounds(torch.from_numpy(seg), 64, 64))
    n = t // 64
    for bi in range(seg.shape[0]):
        for kt in range(n):
            keys = seg[bi, kt * 64:(kt + 1) * 64]
            brute = {qt for qt in range(n)
                     if np.intersect1d(seg[bi, qt * 64:(qt + 1) * 64], keys[keys >= 0]).size}
            tpu_rule = {qt for qt in range(n) if lo[bi, qt] <= kt < hi[bi, qt]}
            assert set(range(lo[bi, kt], hi[bi, kt])) == brute == tpu_rule, (bi, kt)


def test_flash_backward_takes_the_stream_plain_versions_past_stream_max_t(monkeypatch):
    """On CPU tensors flash_backward is the dense plain versions up to
    STREAM_MAX_T and the streaming ones past it, and counts no launch."""
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)
    t = 256
    valid, seg = _layout(t, True)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(5, t, 2, 16, valid, seg))
    kv, sg = torch.from_numpy(valid), torch.from_numpy(seg)
    counters = (flash_bwd_dq, flash_bwd_dkv, flash_bwd_dq_stream, flash_bwd_dkv_stream)
    before = [f.launches for f in counters]
    for s in (None, sg):
        o, lse = flash_forward_stream_reference(q, k, v, kv, s, "bfloat16")
        args = (q, k, v, kv, o, lse, g, s, "bfloat16")
        got = flash_backward(*args)
        want = (flash_bwd_dq_stream_reference(*args), *flash_bwd_dkv_stream_reference(*args))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(flash_bwd_dq_stream(*args), want[0])
        assert all(torch.equal(a, b) for a, b in zip(flash_bwd_dkv_stream(*args), want[1:]))
    short = [x[:, :128] for x in (q, k, v, kv)]
    o, lse = flash_forward_stream_reference(*short)
    args = (*short[:4], o, lse.contiguous(), g[:, :128])
    want = (flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args))
    assert all(torch.equal(a, b) for a, b in zip(flash_backward(*args), want))
    assert [f.launches for f in counters] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_stream_prep_reference_is_the_tpu_kernels_arithmetic(dtype, packed):
    """The prep's plain version (what the tensor-core stream kernels read
    instead of q and o) against the TPU stream kernel's own expressions:
    q_s = (q.astype(f32) * scale).astype(q.dtype) (fa:1253) exactly, delta =
    sum(g * o) over Dh in float32 (fa:1271) to 1e-6 x max |delta|; lse, the
    key flags (1 valid, 0 masked, -1 past T) and segments padded to a
    multiple of 64 rows."""
    t, dh = 200, 16
    valid, seg = _layout(t, packed)
    q, k, v, g = _inputs(6, t, 2, dh, valid, seg)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    as_t = lambda x: torch.from_numpy(x).to(td)  # noqa: E731
    o = _inputs(7, t, 2, dh, valid, seg)[0]
    lse = np.random.default_rng(8).normal(0, 1, (3, 2, t, 1)).astype(np.float32)
    sg = None if seg is None else torch.from_numpy(seg)
    prep = flash_bwd_stream_prep_reference(
        as_t(q), as_t(k), as_t(v), torch.from_numpy(valid), as_t(o), torch.from_numpy(lse),
        as_t(g), sg)
    qs, rows, info = prep.qs, prep.rows, prep.info
    assert qs.dtype == td and rows.shape == (3, 2, 256, 2) and info.shape == (3, 256, 2)
    kvl = valid.shape[1] - np.argmax(valid[:, ::-1], axis=1) * valid.any(1)
    np.testing.assert_array_equal(prep.kvl.numpy(), np.where(valid.any(1), kvl, 0))
    assert (prep.lo is None) == (seg is None) and (prep.hi is None) == (seg is None)
    want_qs = (jnp.asarray(q, jd).astype(jnp.float32) * (1.0 / dh ** 0.5)).astype(jd)
    np.testing.assert_array_equal(qs.float().numpy(), np.asarray(want_qs, np.float32))
    gf, of = (jnp.asarray(x, jd).astype(jnp.float32) for x in (g, o))
    want_delta = np.asarray(jnp.sum(gf * of, axis=-1)).transpose(0, 2, 1)  # [B, H, T]
    _assert_rel(rows[:, :, :t, 1].numpy(), want_delta, 1e-6, "delta")
    np.testing.assert_array_equal(rows[:, :, :t, 0].numpy(), lse[..., 0])
    assert bool((rows[:, :, t:, 0] == port_fa.SKIP_LSE).all() and (rows[:, :, t:, 1] == 0).all())
    np.testing.assert_array_equal(info[:, :t, 0].numpy(), valid.astype(np.int32))
    assert bool((info[:, t:, 0] == -1).all() and (info[:, t:, 1] == 0).all())
    want_seg = np.zeros((3, t), np.int32) if seg is None else seg
    np.testing.assert_array_equal(info[:, :t, 1].numpy(), want_seg)
    before = flash_bwd_stream_prep.launches
    args = (as_t(q), as_t(k), as_t(v), torch.from_numpy(valid), as_t(o),
            torch.from_numpy(lse), as_t(g), sg)
    got = flash_bwd_stream_prep(*args)  # CPU tensors: the plain version, no launch
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, prep))
    assert flash_bwd_stream_prep.launches == before


@pytest.mark.parametrize("dtype,dh,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
    (torch.bfloat16, 128, False), (torch.float32, 64, False),
])
def test_the_tensor_core_stream_kernels_take_bf16_at_dh_64(dtype, dh, tc):
    """The tensor-core design covers the model's shape; float32 (which must
    keep float32 parity) and the other head widths keep the first kernels."""
    assert stream_tc(torch.zeros(1, 4, 2, dh, dtype=dtype)) is tc
