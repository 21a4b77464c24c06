"""The port's streaming forward (long T) against the JAX package on the CPU.

``flash_forward_stream_reference`` is the plain version of
``csrc/flash_fwd_stream.cu``; it is held against the three long-T Pallas
forwards in interpret mode (``_flash_fwd_stream_kernel``,
``_flash_fwd_packed_stream_kernel``, ``_flash_fwd_hbm_kernel`` unpacked and
packed), each window forced at T = 256 by patching the JAX module's
thresholds and blocks to 64-128, as its own tests do. ``packed_block_bounds``
is held against ``_packed_block_bounds`` and a brute force.

Tolerances: float32 out and lse 1e-5 (the two sum in another order). With
the bf16 softmax interior and k_block 64 on both sides the rounding points
coincide, but XLA on the CPU keeps float32 between the interior's bf16
operations where PyTorch rounds each one: out within 2**-6 of max|out|, lse
within 3e-3 (measured values are printed).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repurpose_tpu.ops.flash_attention as fa
from repurpose_tpu.ops.attention import mha_xla
from repurpose_tpu_torch.ops import flash_attention as port_fa
from repurpose_tpu_torch.ops.flash_attention import (
    SKIP_LSE,
    _kv_len,
    flash_forward,
    flash_forward_reference,
    flash_forward_stream,
    flash_forward_stream_reference,
    packed_block_bounds,
)

F32 = dict(out=1e-5, lse=1e-5)
BF16_SM = dict(out_rel_max=2.0 ** -6, lse=3e-3)


def _qkv(seed, b, t, h, dh):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, t, h, dh)).astype(np.float32) for _ in range(3)]


def _layout(t: int, packed: bool):
    """Three rows. Row 0: full to t - 28, with interior key holes (unpacked)
    or four videos at odd offsets, one of them a single step (packed). Row
    1: a ragged prefix (unpacked), or two videos with a gap of padding
    between them, whose rows attend no key (packed). Row 2: empty."""
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


def _patch_window(monkeypatch, window: str):
    """Route the JAX forward at T = 256 to ``window``'s kernel, blocks 64."""
    for name in ("STREAM_K_BLOCK", "HBM_FWD_K_BLOCK", "PACKED_K_BLOCK",
                 "DEFAULT_Q_BLOCK", "PACKED_Q_BLOCK"):
        monkeypatch.setattr(fa, name, 64)
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    monkeypatch.setattr(fa, "HBM_STREAM_T", 128 if window == "hbm" else 8192)


def _compare(p_out, p_lse, j_out, j_lse, valid, tol):
    """Rows before kvl: out and lse against the Pallas kernel; rows at or
    past kvl: 0 and SKIP_LSE (the TPU kernel skips whole blocks there)."""
    kvl = _kv_len(torch.from_numpy(valid)).numpy()
    live = np.arange(valid.shape[1])[None] < kvl
    got, want = p_out.float().numpy(), np.asarray(j_out.astype(jnp.float32))
    got_lse = p_lse.numpy()[..., 0].transpose(0, 2, 1)  # [B, T, H]
    want_lse = np.asarray(j_lse)[..., 0].transpose(0, 2, 1)
    err = float(np.abs(got[live] - want[live]).max())
    lse_err = float(np.abs(got_lse[live] - want_lse[live]).max())
    atol = tol["out"] if "out" in tol else tol["out_rel_max"] * float(np.abs(want[live]).max())
    print(f"max |out - pallas| {err:.3g} (bound {atol:.3g}), max |lse - pallas| "
          f"{lse_err:.3g} (bound {tol['lse']})")
    assert err <= atol and lse_err <= tol["lse"]
    assert (got[~live] == 0).all() and (got_lse[~live] == SKIP_LSE).all()


@pytest.mark.parametrize("dtype,softmax_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16"),
])
@pytest.mark.parametrize("window,packed", [
    ("stream", False), ("stream", True), ("hbm", False), ("hbm", True),
])
def test_stream_reference_matches_pallas_long_t_kernels(monkeypatch, window, packed, dtype,
                                                         softmax_dtype):
    """The stream (packed: packed-stream) and HBM windows of the JAX forward,
    in interpret mode at T = 256, against the plain version of the port's
    streaming kernel on the same inputs."""
    _patch_window(monkeypatch, window)
    t = 256
    q, k, v = _qkv(11, 3, t, 2, 32)
    valid, seg = _layout(t, packed)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j_out, j_lse = fa._flash_forward(
        *(jnp.asarray(x, jd) for x in (q, k, v)), jnp.asarray(valid), 64, True,
        sm_dtype=jnp.bfloat16 if softmax_dtype == "bfloat16" else jnp.float32,
        seg_ids=None if seg is None else jnp.asarray(seg),
    )
    td = getattr(torch, dtype)
    p_out, p_lse = flash_forward_stream_reference(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), torch.from_numpy(valid),
        None if seg is None else torch.from_numpy(seg), softmax_dtype,
    )
    assert p_out.dtype == td and p_out.shape == (3, t, 2, 32)
    assert p_lse.dtype == torch.float32 and p_lse.shape == (3, 2, t, 1)
    _compare(p_out, p_lse, j_out, j_lse, valid,
             F32 if softmax_dtype == "float32" else BF16_SM)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("t", [200, 257])
def test_stream_reference_at_ragged_t_matches_mha_xla(packed, t):
    """T not a multiple of the 64-row tiles (the JAX forward has no legal
    block there and mha_pallas falls back to mha_xla): rows before kvl that
    attend a key, float32, atol 1e-5."""
    q, k, v = _qkv(12, 3, t, 2, 16)
    valid, seg = _layout(t, packed)
    want = np.asarray(mha_xla(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid),
                              precision="highest",
                              seg_ids=None if seg is None else jnp.asarray(seg)))
    got, lse = flash_forward_stream_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid),
        None if seg is None else torch.from_numpy(seg))
    live = np.arange(t)[None] < _kv_len(torch.from_numpy(valid)).numpy()
    if packed:
        live &= seg >= 0
    np.testing.assert_allclose(got.numpy()[live], want[live], atol=1e-5, rtol=0)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_stream_reference_chunking_does_not_change_the_recurrence(packed, softmax_dtype):
    """Query and key chunks of one tile against the default chunks (one
    chunk here): the same tile maxima and rounding points, so float32 sums
    differ by rounding only (1e-6) and bf16 outputs by at most one ulp."""
    t = 256
    q, k, v = (torch.from_numpy(x) for x in _qkv(13, 3, t, 2, 16))
    valid, seg = _layout(t, packed)
    args = (q, k, v, torch.from_numpy(valid), None if seg is None else torch.from_numpy(seg),
            softmax_dtype)
    whole = flash_forward_stream_reference(*args)
    tiled = flash_forward_stream_reference(*args, q_chunk=64, k_chunk=64)
    for a, b in zip(whole, tiled):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_stream_reference_equals_dense_reference_in_float32():
    """Online softmax over 64-key tiles against the whole key axis at once,
    float32, every row (fully masked packed rows excepted: the dense version
    averages over every key, the stream one over its tile range)."""
    t = 256
    q, k, v = (torch.from_numpy(x) for x in _qkv(14, 3, t, 4, 32))
    for packed in (False, True):
        valid, seg = _layout(t, packed)
        kv = torch.from_numpy(valid)
        sg = None if seg is None else torch.from_numpy(seg)
        a_out, a_lse = flash_forward_stream_reference(q, k, v, kv, sg)
        b_out, b_lse = flash_forward_reference(q, k, v, kv, sg)
        rows = torch.ones_like(kv) if sg is None else (sg >= 0) | (torch.arange(t) >= _kv_len(kv))
        torch.testing.assert_close(a_out[rows], b_out[rows], atol=1e-5, rtol=0)
        lse_rows = rows[:, None, :, None].expand_as(a_lse)
        torch.testing.assert_close(a_lse[lse_rows], b_lse[lse_rows], atol=1e-5, rtol=0)


def test_flash_forward_takes_the_stream_plain_version_past_stream_max_t(monkeypatch):
    """On CPU tensors flash_forward is the dense plain version up to
    STREAM_MAX_T and the streaming one past it, and counts no launch."""
    monkeypatch.setattr(port_fa, "STREAM_MAX_T", 128)
    q, k, v = (torch.from_numpy(x) for x in _qkv(15, 3, 256, 2, 16))
    valid, seg = _layout(256, True)
    kv, sg = torch.from_numpy(valid), torch.from_numpy(seg)
    before = (flash_forward.launches, flash_forward_stream.launches)
    for s in (None, sg):
        got = flash_forward(q, k, v, kv, s, "bfloat16")
        want = flash_forward_stream_reference(q, k, v, kv, s, "bfloat16")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(flash_forward_stream(q, k, v, kv, s),
                                                     flash_forward_stream_reference(q, k, v, kv, s)))
    short = [x[:, :128] for x in (q, k, v, kv)]
    got = flash_forward(*short)
    assert all(torch.equal(a, b) for a, b in zip(got, flash_forward_reference(*short)))
    assert (flash_forward.launches, flash_forward_stream.launches) == before


def _brute_bounds(seg, q_block, k_block):
    b, t = seg.shape
    nqb = -(-t // q_block)
    lo = np.zeros((b, nqb), np.int64)
    hi = np.zeros((b, nqb), np.int64)
    for bi in range(b):
        for i in range(nqb):
            allowed = set()
            for r in range(i * q_block, min((i + 1) * q_block, t)):
                if seg[bi, r] >= 0:
                    same = np.nonzero(seg[bi] == seg[bi, r])[0]
                    allowed.update(range(same.min(), same.max() + 1))
            if allowed:
                lo[bi, i] = min(allowed) // k_block
                hi[bi, i] = -(-(max(allowed) + 1) // k_block)
            else:
                lo[bi, i] = hi[bi, i] = -1  # empty: checked separately
    return lo, hi


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


@pytest.mark.parametrize("q_block,k_block", [(64, 64), (64, 128), (128, 64)])
@pytest.mark.parametrize("layout", ["random", "pathological"])
def test_packed_block_bounds_matches_jax_and_brute_force(layout, q_block, k_block):
    t = 256
    if layout == "random":
        seg = _random_packing(q_block + k_block, 4, t)
    else:  # tiny videos at odd offsets, a full-row video, an empty row
        seg = np.full((3, t), -1, np.int32)
        edges = [0, 27, 61, 64, 65, 130, 190, 191, 250]
        for vid, (a, b) in enumerate(zip(edges[:-1], edges[1:])):
            seg[0, a:b] = vid
        seg[1] = 0
    lo, hi = (x.numpy() for x in packed_block_bounds(torch.from_numpy(seg), q_block, k_block))
    assert lo.dtype == np.int32 and lo.shape == (seg.shape[0], t // q_block)
    j_lo, j_hi = fa._packed_block_bounds(jnp.asarray(seg), q_block, k_block)
    np.testing.assert_array_equal(lo, np.asarray(j_lo))
    np.testing.assert_array_equal(hi, np.asarray(j_hi))
    b_lo, b_hi = _brute_bounds(seg, q_block, k_block)
    some = b_lo >= 0
    np.testing.assert_array_equal(lo[some], b_lo[some])
    np.testing.assert_array_equal(hi[some], b_hi[some])
    assert (lo[~some] == hi[~some]).all()  # a tile of padding sweeps nothing


@pytest.mark.parametrize("t", [200, 257, 300])
def test_packed_block_bounds_at_ragged_t(t):
    """T not a multiple of the query tile: the last tile counts its rows
    past T as padding."""
    seg = _random_packing(t, 3, t)
    lo, hi = (x.numpy() for x in packed_block_bounds(torch.from_numpy(seg), 64, 64))
    assert lo.shape == (3, -(-t // 64))
    b_lo, b_hi = _brute_bounds(seg, 64, 64)
    some = b_lo >= 0
    np.testing.assert_array_equal(lo[some], b_lo[some])
    np.testing.assert_array_equal(hi[some], b_hi[some])
    assert (lo[~some] == hi[~some]).all()


@pytest.mark.parametrize("dtype,dh,tc", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 16, False), (torch.bfloat16, 32, False),
    (torch.bfloat16, 128, False), (torch.float32, 64, False), (torch.float32, 32, False),
])
def test_the_tensor_core_stream_forward_takes_bf16_at_dh_64(dtype, dh, tc):
    """On CUDA tensors ``flash_forward_stream`` launches the tensor-core
    kernel (``flash_fwd_stream_tc``) for bf16 at Dh 64, under either softmax
    interior, by the rule it shares with the streaming backward; float32 and
    the other head widths keep the first kernel."""
    assert port_fa.stream_tc(torch.zeros(1, 4, 2, dh, dtype=dtype)) is tc


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("packed", [False, True])
def test_cpu_tensors_take_the_stream_plain_version_at_the_tensor_core_shape(packed,
                                                                          softmax_dtype):
    """bf16 at Dh 64 on CPU tensors: ``flash_forward_stream`` is
    ``flash_forward_stream_reference`` bit for bit and counts no launch of
    either kernel."""
    t = 256
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(16, 3, t, 2, 64))
    valid, seg = _layout(t, packed)
    args = (q, k, v, torch.from_numpy(valid), None if seg is None else torch.from_numpy(seg),
            softmax_dtype)
    before = (flash_forward_stream.launches, port_fa.flash_fwd_stream_tc.launches)
    got = flash_forward_stream(*args)
    want = flash_forward_stream_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (flash_forward_stream.launches, port_fa.flash_fwd_stream_tc.launches) == before


def test_the_tensor_core_forward_steps_the_plain_versions_key_tile():
    """The online-softmax step decides where m' is rounded, so the kernel's
    key tile (``BK`` of csrc/flash_fwd_tc.cuh, one TMA box of ``ROWS`` rows)
    must be the plain version's key tile, ``STREAM_TILE``, which the tests
    above hold against the Pallas kernels."""
    import re

    csrc = Path(port_fa.__file__).resolve().parent.parent / "csrc"
    rows = re.search(r"constexpr int ROWS = (\d+);", (csrc / "hopper.cuh").read_text())
    header = (csrc / "flash_fwd_tc.cuh").read_text()
    assert re.search(r"constexpr int BK = ROWS;", header)
    assert re.search(r"constexpr int BQ = ROWS;", header)
    assert int(rows.group(1)) == port_fa.STREAM_TILE == 64


def _bf16_round(x: np.ndarray) -> np.ndarray:
    """float64 values rounded once to bf16 (to nearest, ties to even; the
    subnormals' grid 2**-133, past the largest finite value +-inf)."""
    _, e = np.frexp(x)
    quantum = np.ldexp(1.0, np.maximum(e - 8, -133))
    r = np.round(x / quantum) * quantum
    return np.where(np.abs(r) > 3.3895313892515355e38, np.copysign(np.inf, x), r)


def test_one_bf16_rounding_of_a_bf16_difference_is_the_float32_ones():
    """Under the bf16 interior csrc/flash_fwd_tc.cuh forms y = s - R(m') of
    two bf16 values as one ``sub.rn.bf16x2``: the exact difference rounded
    once to bf16. The plain version rounds the float32 difference to bf16,
    two roundings. They agree for every finite bf16 s against m' of every
    binade, both signs, and two significands each (the subnormals and the
    largest finite value among them), so the kernel keeps the plain
    version's rounding points bit for bit."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    every = bits.view(np.float32)
    s = every[np.isfinite(every)]
    rng = np.random.default_rng(0)
    exps = np.arange(-133, 128)
    sig = np.concatenate([np.ones(len(exps)), 1 + rng.integers(1, 128, len(exps)) / 128])
    m = np.ldexp(sig, np.concatenate([exps, exps])).astype(np.float64)
    m = np.concatenate([m, -m, [0.0, 3.3895313892515355e38, -3.3895313892515355e38]])
    m = m[np.isfinite(m.astype(np.float32))]
    m = m[_bf16_round(m) == m]  # bf16 values only
    assert len(m) > 1000
    s64 = s.astype(np.float64)[None, :]
    mismatched = 0
    for chunk in np.array_split(m, 16):
        with np.errstate(over="ignore", invalid="ignore"):
            f32 = (s[None, :] - chunk.astype(np.float32)[:, None]).astype(np.float32)
            u = f32.view(np.uint32)
            twice = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
                     & np.uint32(0xFFFF0000)).view(np.float32)
            twice = np.where(np.isfinite(f32), twice, f32).astype(np.float64)
            once = _bf16_round(s64 - chunk[:, None])
        mismatched += int((twice != once).sum())
    assert mismatched == 0
