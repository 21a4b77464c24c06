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
