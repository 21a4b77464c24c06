"""The CUDA flash-attention forward against its plain PyTorch version, on the
card. Marked ``gpu``; each test skips (in its fixture) where no card is
visible. Run on a machine with an H100:

    python -m pytest --noconftest -m gpu tests/test_torch_flash_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Tolerances: float32 inputs, out atol 1e-4 / rtol 1e-4 and lse atol 1e-4 (the
kernel sums in another order and rescales its online softmax, ~1e-6 relative
per step). bf16 inputs, out atol 1e-2 * max|out| / rtol 1e-2 and lse atol
1e-2: the outputs are bf16 (one ulp is 2**-7 relative), and with the bf16
softmax interior the kernel rounds exp(s - m) against its running max where
the plain version uses the final max. The bf16 out bound scales with the
output because softmax over ~2000 keys averages N(0, 1) values down to ~0.03:
a fixed 2e-2 would accept an output of zeros.
"""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops.flash_attention import (
    SKIP_LSE,
    _kv_len,
    flash_forward,
    flash_forward_reference,
)

pytestmark = pytest.mark.gpu

TOL = {  # out: absolute bound, as a fraction of max|out| for bf16
    torch.float32: dict(out=1e-4, rel_to_max=False, rtol=1e-4, lse=1e-4),
    torch.bfloat16: dict(out=1e-2, rel_to_max=True, rtol=1e-2, lse=1e-2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, b, t, h, dh, dtype, device, packed):
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32))
        .to(dtype).to(device) for _ in range(3)
    )
    valid = np.zeros((b, t), bool)
    seg = np.full((b, t), -1, np.int32)
    valid[0] = True  # full row
    # row 1 stays all padding (kvl = 0)
    if b > 2:  # ragged tail plus interior key holes
        n = max(1, int(0.6 * t))
        valid[2, :n] = True
        valid[2, rng.integers(0, n, size=max(1, n // 8))] = False
        valid[2, 0] = True
    if b > 3:  # packed row: three videos head to tail, then padding
        lens = [max(1, t // 3), max(1, t // 4), max(1, t // 5)]
        off = 0
        for s, ln in enumerate(lens):
            valid[3, off : off + ln] = True
            seg[3, off : off + ln] = s
            off += ln
    if packed:
        for r in range(3):  # unpacked rows: one video each
            seg[r, valid[r]] = 0
    kv = torch.from_numpy(valid).to(device)
    sg = torch.from_numpy(seg).to(device) if packed else None
    return q, k, v, kv, sg


def _check(q, k, v, kv, sg, sm):
    out, lse = flash_forward(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_forward_reference(q, k, v, kv, sg, sm)
    tol = TOL[q.dtype]
    t = q.shape[1]
    skip = torch.arange(t, device=q.device)[None, :] >= _kv_len(kv)  # [B, T]
    # compared: query rows before kvl that attend at least one key (under
    # packing, a padding query inside kvl attends none: its row is garbage)
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


@pytest.mark.parametrize("t", [64, 100, 256, 2048])
@pytest.mark.parametrize("dh", [16, 32, 64])
def test_kernel_matches_plain(cuda, dh, t):
    for dtype, sm in ((torch.bfloat16, "bfloat16"), (torch.bfloat16, "float32"),
                      (torch.float32, "float32")):
        for packed in (False, True):
            _check(*_inputs(dh * t, 4, t, 2, dh, dtype, cuda, packed), sm)


def test_kernel_head_dim_128(cuda):
    for dtype in (torch.bfloat16, torch.float32):
        _check(*_inputs(7, 4, 192, 2, 128, dtype, cuda, True), "float32")


def test_strided_qkv_views_match_contiguous(cuda):
    b, t, h, dh = 2, 300, 4, 64
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(0, 1, (b, t, 3 * h * dh)).astype(np.float32))
    qkv = qkv.to(torch.bfloat16).to(cuda)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    kv = torch.ones(b, t, dtype=torch.bool, device=cuda)
    kv[1, 200:] = False
    got, _ = flash_forward(q, k, v, kv, softmax_dtype="bfloat16")
    want, _ = flash_forward(q.contiguous(), k.contiguous(), v.contiguous(), kv,
                            softmax_dtype="bfloat16")
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def test_cuda_tensor_launches_the_kernel(cuda):
    q, k, v, kv, sg = _inputs(5, 4, 128, 2, 32, torch.bfloat16, cuda, True)
    before = flash_forward.launches
    flash_forward(q, k, v, kv, seg_ids=sg)
    flash_forward(q, k, v, kv)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 2


def test_cuda_wrapper_raises_on_unsupported_inputs(cuda):
    q, k, v, kv, _ = _inputs(6, 4, 64, 2, 32, torch.bfloat16, cuda, False)
    with pytest.raises(ValueError):
        flash_forward(q.half(), k.half(), v.half(), kv)
    with pytest.raises(ValueError):
        flash_forward(q, k, v, kv.int())
    with pytest.raises(ValueError):
        wide = torch.zeros(4, 64, 2, 48, dtype=torch.bfloat16, device=cuda)
        flash_forward(wide, wide, wide, kv)
