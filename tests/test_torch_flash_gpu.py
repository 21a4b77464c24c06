"""The CUDA flash-attention forward against its plain PyTorch version, on the
card: bf16 at Dh 64 the tensor-core kernel (``flash_fwd_tc``) on the dense
sweep, float32 and the other head widths the first design. Marked ``gpu``;
each test skips (in its fixture) where no card is visible. Run on a machine
with an H100:

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

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repurpose_tpu_torch import native
from repurpose_tpu_torch.ops import flash_attention as fa
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


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _check(q, k, v, kv, sg, sm):
    out, lse = flash_forward(q, k, v, kv, seg_ids=sg, softmax_dtype=sm)
    torch.cuda.synchronize()
    ref_out, ref_lse = flash_forward_reference(q, k, v, kv, sg, sm)
    tol = TOL[q.dtype]
    t = q.shape[1]
    skip = torch.arange(t, device=q.device)[None, :] >= _kv_len(kv)  # [B, T]
    # compared: query rows before kvl that attend at least one key (under
    # packing, a padding query inside kvl attends none: its row is garbage)
    live = _chip_smoke()._attending_rows(kv, sg)
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
    return out, lse, live


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


def _inside_layout(t, split):
    """[3, t] packed rows with padding inside kvl: a stretch of masked keys
    inside each row's first video, on a segment of its own with the video's
    tail on another (``split=False``, rows that attend no key), or on
    segment -1 with the tail keeping the video's id, split into two runs
    (``split=True``); a second video after it, then padding."""
    valid = np.zeros((3, t), bool)
    seg = np.full((3, t), -1, np.int32)
    for r in range(3):
        end = max(8, int((0.5 + 0.1 * r) * t))
        a0, a1 = end // 3, end // 3 + max(2, end // 6)
        valid[r, :end], seg[r, :end] = True, 0
        valid[r, a0:a1] = False
        if split:
            seg[r, a0:a1] = -1
        else:
            seg[r, a0:a1], seg[r, a1:end] = 1, 2
        n = max(1, t // 5)
        valid[r, end:end + n], seg[r, end:end + n] = True, 3
    return valid, seg


def _tc_cases(device):
    """(name, q, k, v, key_valid, seg_ids) at bf16 Dh 64: unpacked and
    packed at T = 64, 100, 256 and 2048, and the padding-inside and
    split-id layouts at T = 256 and 2048."""
    for t in (64, 100, 256, 2048):
        for packed in (False, True):
            yield (f"T{t}_{'packed' if packed else 'unpacked'}",
                   *_inputs(t + packed, 4, t, 2, 64, torch.bfloat16, device, packed))
    for t in (256, 2048):
        for split in (False, True):
            valid, seg = _inside_layout(t, split)
            q, k, v, _, _ = _inputs(t + 2 + split, 3, t, 2, 64, torch.bfloat16, device, False)
            yield (f"T{t}_{'split_ids' if split else 'padding_inside'}", q, k, v,
                   torch.from_numpy(valid).to(device), torch.from_numpy(seg).to(device))


@pytest.mark.parametrize("sm", ["bfloat16", "float32"])
def test_tensor_core_dense_forward_route_and_bits(cuda, sm):
    """bf16 at Dh 64 takes the tensor-core kernel (its counter moves, the
    first design's does not) and matches the plain version; two launches
    give equal bits; packed, the bounded sweep gives the bits of the sweep
    to kvl (the same kernel on lo = 0, hi = ceil(kvl / 64)) on every row
    that attends a key; a sweep made once outside gives the wrapper's bits."""
    for name, q, k, v, kv, sg in _tc_cases(cuda):
        before = (flash_forward.launches, fa.flash_fwd_tc.launches)
        out, lse, live = _check(q, k, v, kv, sg, sm)
        again = flash_forward(q, k, v, kv, sg, sm)
        sweep = fa.attention_sweep(kv, sg)
        shared = flash_forward(q, k, v, kv, sg, sm, sweep=sweep)
        torch.cuda.synchronize()
        assert (flash_forward.launches - before[0], fa.flash_fwd_tc.launches - before[1]) \
            == (3, 3), name
        for got in (again, shared):
            assert torch.equal(got[0], out) and torch.equal(got[1], lse), name
        if sg is not None:
            to_kvl = _chip_smoke()._sweep_to_kvl(sweep)
            full_out, full_lse = flash_forward(q, k, v, kv, sg, sm, sweep=to_kvl)
            torch.cuda.synchronize()
            rows = live[:, None, :, None].expand_as(lse)
            assert torch.equal(full_out[live], out[live]), name
            assert torch.equal(full_lse[rows], lse[rows]), name


def test_first_design_keeps_float32_and_the_other_head_widths(cuda):
    """float32 at Dh 64 and bf16 at Dh 32 launch the first design: the
    tensor-core counter does not move."""
    for dtype, dh in ((torch.float32, 64), (torch.bfloat16, 32)):
        args = _inputs(21, 4, 256, 2, dh, dtype, cuda, True)
        before = (flash_forward.launches, fa.flash_fwd_tc.launches)
        _check(*args, "float32")
        assert (flash_forward.launches - before[0], fa.flash_fwd_tc.launches - before[1]) \
            == (1, 0)


def test_first_design_entry_refuses_bf16_dh_64(cuda):
    """The first design's C entry has no bf16 Dh 64 instance: it returns
    cudaErrorInvalidValue (1) and launches nothing."""
    q, k, v, kv, _ = _inputs(22, 4, 128, 2, 64, torch.bfloat16, cuda, False)
    out = torch.full_like(q, 7.0)
    lse = torch.empty((4, 2, 128, 1), device=cuda)
    err = native.load("flash_fwd").flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(x.stride(i) for x in (q, k, v) for i in range(3)),
        kv.data_ptr(), None, out.data_ptr(), lse.data_ptr(), 4, 128, 2, 64, 1, 1, 0.125,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err == 1 and bool((out == 7.0).all())


def test_a_foreign_sweep_record_raises(cuda):
    """A record of another T or batch, another device or the other sweep
    (the stream one, ``dense=False``) raises ValueError before any launch."""
    q, k, v, kv, sg = _inputs(23, 4, 256, 2, 64, torch.bfloat16, cuda, True)
    before = fa.flash_fwd_tc.launches
    for bad in (fa.attention_sweep(kv[:, :128], sg[:, :128]), fa.attention_sweep(kv[:2], sg[:2]),
                fa.attention_sweep(kv.cpu(), sg.cpu()),
                fa.attention_sweep(kv, sg, dense=False),
                fa.attention_sweep(kv)):  # an unpacked record for packed inputs
        with pytest.raises(ValueError):
            flash_forward(q, k, v, kv, sg, "bfloat16", sweep=bad)
    assert fa.flash_fwd_tc.launches == before


def test_the_shared_sweep_gives_the_model_its_bits(cuda):
    """flash_attention forward and backward on one shared record equal the
    calls that make their own, at T = 2048 (the dense kernels) and 4096
    (the streaming ones), packed."""
    for t in (2048, 4096):
        q, k, v, kv, sg = _inputs(24, 4, t, 2, 64, torch.bfloat16, cuda, True)
        w = torch.randn(q.shape, device=cuda).masked_fill(~kv[:, :, None, None], 0.0)
        grads = []
        for sweep in (None, fa.attention_sweep(kv, sg)):
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            out = fa.flash_attention(*leaves, kv, sg, "bfloat16", sweep=sweep)
            (out.float() * w).sum().backward()
            grads.append([out.detach(), *(x.grad for x in leaves)])
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*grads)), t
