"""The CUDA streaming forward (``csrc/flash_fwd_stream.cu``, long T) against
its plain PyTorch version, on the card. Marked ``gpu``; each test skips (in
its fixture) where no card is visible. Run on a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_stream_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Tolerances, those of the dense kernel's GPU tests: float32 inputs, out atol
1e-4 / rtol 1e-4 and lse atol 1e-4 (the kernel and the plain version sweep
the same 64-key tiles with the same recurrence; only the order of the sums
inside a tile differs). bf16 inputs, out atol 1e-2 * max|out| / rtol 1e-2
and lse atol 1e-2 (outputs are bf16, one ulp is 2**-7 relative, and a
last-bit difference in a score can flip the bf16 rounding of single p).
"""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops import flash_attention as fa
from repurpose_tpu_torch.ops.flash_attention import (
    SKIP_LSE,
    _kv_len,
    flash_forward,
    flash_forward_stream,
    flash_forward_stream_reference,
)

pytestmark = pytest.mark.gpu

TOL = {  # out: absolute bound, as a fraction of max|out| for bf16
    torch.float32: dict(out=1e-4, rel_to_max=False, rtol=1e-4, lse=1e-4),
    torch.bfloat16: dict(out=1e-2, rel_to_max=True, rtol=1e-2, lse=1e-2),
}
INTERIORS = ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "float32"),
             (torch.float32, "float32"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _layout(seed, t, packed):
    """Four rows. 0: full (one video). 1: empty. 2: kvl ~ 0.9 T with interior
    key holes (one video). 3: unpacked, a ragged prefix of T - 37; packed,
    videos of 1..T/5 steps head to tail from an odd offset, with a gap of
    padding between two of them (query tiles straddle videos and gaps)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros((4, t), bool)
    seg = np.full((4, t), -1, np.int32)
    valid[0] = True
    n = int(0.9 * t)
    valid[2, :n] = True
    valid[2, rng.integers(0, n, size=n // 16)] = False
    valid[2, n - 1] = True
    if packed:
        seg[0, :] = 0
        seg[2, valid[2]] = 0
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
    return valid, (seg if packed else None)


def _inputs(seed, t, h, dh, dtype, device, packed):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(0, 1, (4, t, h, dh)).astype(np.float32))
        .to(dtype).to(device) for _ in range(3)
    )
    valid, seg = _layout(seed + 1, t, packed)
    kv = torch.from_numpy(valid).to(device)
    sg = None if seg is None else torch.from_numpy(seg).to(device)
    return q, k, v, kv, sg


def _check(q, k, v, kv, sg, sm):
    out, lse = flash_forward_stream(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_forward_stream_reference(q, k, v, kv, sg, sm)
    tol = TOL[q.dtype]
    t = q.shape[1]
    skip = torch.arange(t, device=q.device)[None, :] >= _kv_len(kv)  # [B, T]
    # compared: query rows before kvl that attend a key (a packed padding
    # row inside kvl attends none)
    live = ~skip if sg is None else ~skip & (sg >= 0)
    ref_live = ref_out[live].float()
    atol = tol["out"] * (ref_live.abs().max().item() if tol["rel_to_max"] else 1.0)
    torch.testing.assert_close(out[live].float(), ref_live, atol=atol, rtol=tol["rtol"])
    lse_rows = lambda m: m[:, None, :, None].expand_as(lse)  # noqa: E731
    torch.testing.assert_close(
        lse[lse_rows(live)], ref_lse[lse_rows(live)], atol=tol["lse"], rtol=0.0
    )
    assert (out[skip] == 0).all()
    assert (lse[lse_rows(skip)] == SKIP_LSE).all()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("t", [2049, 3000, 4096, 8193, 16384])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_stream_kernel_matches_plain(cuda, dh, t):
    for dtype, sm in INTERIORS:
        for packed in (False, True):
            _check(*_inputs(dh + t, t, 2, dh, dtype, cuda, packed), sm)


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
        got = flash_forward_stream(q, k, v, kv, sg, "bfloat16")
        want = flash_forward_stream(q.contiguous(), k.contiguous(), v.contiguous(), kv, sg,
                                    "bfloat16")
        for a, b_ in zip(got, want):
            torch.testing.assert_close(a, b_, atol=0.0, rtol=0.0)


def test_flash_forward_launches_the_stream_kernel_past_stream_max_t(cuda):
    """flash_forward at T > STREAM_MAX_T launches the streaming kernel (and
    not the dense one), unpacked and packed; at T = STREAM_MAX_T the dense."""
    before = (flash_forward.launches, flash_forward_stream.launches)
    for packed in (False, True):
        flash_forward(*_inputs(5, fa.STREAM_MAX_T + 1, 2, 32, torch.bfloat16, cuda, packed))
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_forward_stream.launches) == (before[0],
                                                                       before[1] + 2)
    flash_forward(*_inputs(5, fa.STREAM_MAX_T, 2, 32, torch.bfloat16, cuda, True))
    torch.cuda.synchronize()
    assert (flash_forward.launches, flash_forward_stream.launches) == (before[0] + 1,
                                                                       before[1] + 2)


def test_stream_wrapper_raises_on_unsupported_inputs(cuda):
    q, k, v, kv, _ = _inputs(6, 2100, 2, 32, torch.bfloat16, cuda, False)
    with pytest.raises(ValueError):
        flash_forward_stream(q.half(), k.half(), v.half(), kv)
    with pytest.raises(ValueError):
        flash_forward_stream(q, k, v, kv.int())
    with pytest.raises(ValueError):
        wide = torch.zeros(4, 2100, 2, 48, dtype=torch.bfloat16, device=cuda)
        flash_forward_stream(wide, wide, wide, kv)


def _tc_layout(t, layout):
    """key_valid / seg_ids of the tensor-core tests.
    - "edges": kvl = 0, kvl inside a tile (64 n + 37) and kvl = T;
    - "two_rows": B = 2 with different kvl, the second with key holes;
    - "packed": row 0 a one-step video, then videos starting mid-tile (at
      1 and 100) head to tail; row 1 padding, a video from 77 (mid-tile), a
      gap of padding, a second video and a one-step video at T - 10."""
    if layout == "edges":
        valid = np.zeros((3, t), bool)
        valid[1, : 64 * (t // 128) + 37] = True
        valid[2] = True
        return valid, None
    if layout == "two_rows":
        valid = np.zeros((2, t), bool)
        valid[0, : t // 2 + 5] = True
        valid[1, : int(0.9 * t)] = True
        valid[1, 100:170] = False
        valid[1, np.random.default_rng(t).integers(0, int(0.9 * t), size=t // 20)] = False
        valid[1, int(0.9 * t) - 1] = True
        return valid, None
    valid = np.zeros((2, t), bool)
    seg = np.full((2, t), -1, np.int32)
    for vid, (a, b) in enumerate([(0, 1), (1, 100), (100, t // 2), (t // 2, t - 3)]):
        valid[0, a:b] = True
        seg[0, a:b] = vid
    for vid, (a, b) in enumerate([(77, t // 3), (t // 3 + 50, t // 2), (t - 10, t - 9)]):
        valid[1, a:b] = True
        seg[1, a:b] = vid
    return valid, seg


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
@pytest.mark.parametrize("layout", ["edges", "two_rows", "packed"])
@pytest.mark.parametrize("t", [2049, 4133, 8192])
def test_tensor_core_stream_kernel_matches_plain(cuda, t, layout, sm):
    """bf16 at Dh 64 takes ``flash_fwd_stream_tc`` (each call one launch of
    it): out and lse against the plain version under the bf16 tolerance on
    live rows, 0 / SKIP_LSE past kvl; a second launch gives the same bits."""
    valid, seg = _tc_layout(t, layout)
    rng = np.random.default_rng(t + len(layout))
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (valid.shape[0], t, 4, 64)).astype(np.float32))
               .to(torch.bfloat16).to(cuda) for _ in range(3))
    kv = torch.from_numpy(valid).to(cuda)
    sg = None if seg is None else torch.from_numpy(seg).to(cuda)
    before = fa.flash_fwd_stream_tc.launches
    _check(q, k, v, kv, sg, sm)
    again = flash_forward_stream(q, k, v, kv, sg, sm)
    first = flash_forward_stream(q, k, v, kv, sg, sm)
    torch.cuda.synchronize()
    assert fa.flash_fwd_stream_tc.launches == before + 3
    assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_tensor_core_stream_kernel_reads_qkv_column_views_in_place(cuda):
    """The QKV projection's column slices against contiguous copies, bit for
    bit, unpacked and packed, both interiors."""
    b, t, h, dh = 2, 4133, 8, 64
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3 * h * dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).to(cuda)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    valid, seg = _tc_layout(t, "packed")
    kv = torch.from_numpy(valid).to(cuda)
    before = fa.flash_fwd_stream_tc.launches
    for sg in (None, torch.from_numpy(seg).to(cuda)):
        for sm in ("bfloat16", "float32"):
            got = flash_forward_stream(q, k, v, kv, sg, sm)
            want = flash_forward_stream(q.contiguous(), k.contiguous(), v.contiguous(), kv, sg,
                                        sm)
            for a, b_ in zip(got, want):
                torch.testing.assert_close(a, b_, atol=0.0, rtol=0.0)
    assert fa.flash_fwd_stream_tc.launches == before + 8


def _one_tile_inputs(case, cuda):
    """q/k/v (bf16, 8 heads of 64) and key_valid: [1, 32768] at kvl 0.9 T
    with a hole of 100 keys; [1, 4096] with kvl 3628, 57 key tiles; [2, 2000],
    T not a multiple of 128 (kvl 2000 and 1337); [8, 2048] with kvl 40-100 %
    of T and a row of padding only."""
    b, t, kvls = {"T32768": (1, 32768, [int(0.9 * 32768)]), "T4096_odd_tiles": (1, 4096, [3628]),
                  "T2000": (2, 2000, [2000, 1337]),
                  "B8_T2048": (8, 2048, [int(round(f * 2048)) for f in np.linspace(0.4, 1, 7)]
                               + [0])}[case]
    rng = np.random.default_rng(t + b)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, t, 8, 64)).astype(np.float32))
               .to(torch.bfloat16).to(cuda) for _ in range(3))
    valid = np.zeros((b, t), bool)
    for i, n in enumerate(kvls):
        valid[i, :n] = True
    if t == 32768:
        valid[:, t // 3: t // 3 + 100] = False
    return q, k, v, torch.from_numpy(valid).to(cuda)


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", ["T32768", "T4096_odd_tiles", "T2000", "B8_T2048"])
def test_unpacked_and_one_segment_packed_forwards_agree_bit_for_bit(cuda, case, sm):
    """With one segment over the whole row the packed semantics are the
    unpacked ones, so the packed instance of the tensor-core forward (its
    step tests each key's segment) and the unpacked one must give the same
    out and lse bits on every row, rows past kvl (0, SKIP_LSE) included,
    under both softmax interiors, on the dense sweep (T <= 2048) and the
    stream sweep."""
    q, k, v, kv = _one_tile_inputs(case, cuda)
    one_segment = torch.zeros(kv.shape, dtype=torch.int32, device=cuda)
    before = (fa.flash_fwd_tc.launches, fa.flash_fwd_stream_tc.launches)
    got = flash_forward(q, k, v, kv, None, sm)
    want = flash_forward(q, k, v, kv, one_segment, sm)
    torch.cuda.synchronize()
    launched = (fa.flash_fwd_tc.launches - before[0], fa.flash_fwd_stream_tc.launches - before[1])
    assert launched == ((2, 0) if q.shape[1] <= fa.STREAM_MAX_T else (0, 2))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    past = torch.arange(q.shape[1], device=cuda)[None, :] >= _kv_len(kv)
    assert (got[0][past] == 0).all()
    assert (got[1][past[:, None, :, None].expand_as(got[1])] == SKIP_LSE).all()
