"""The bench tools' CUDA kernels (csrc/flash_fwd_nt.cu, csrc/int8_matmul.cu)
against their plain PyTorch versions, on the card. Marked ``gpu``; each test
skips (in its fixture) where no card is visible. Run on a machine with an
H100:

    python -m pytest --noconftest -m gpu tests/test_torch_bench_gpu.py

(``--noconftest``: the repository's conftest imports JAX, which that machine
does not have.) This file imports neither JAX nor PyYAML.

Tolerances: ``mha_nt``, every row (rows past the last valid key and fully
masked rows included), float32 atol 1e-4 / rtol 1e-4 (the kernel sums in
another order and rescales its online softmax, ~1e-6 relative per step);
bf16 atol 1e-2 * max |out| / rtol 1e-2 (bf16 outputs, one ulp 2**-8
relative, and the kernel rounds exp(s - m) to bf16 against its running max
where the plain version uses the final max). The int8 kernels: bit for bit,
on both load routes.
"""

import pytest
import torch

from repurpose_tpu_torch.tools import bench_attention_fwd as baf
from repurpose_tpu_torch.tools import bench_int8_matmul as bim

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (1e-4, False), torch.bfloat16: (1e-2, True)}  # atol, relative to max


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _nt_inputs(seed, b, t, heads, dh, dtype, device):
    """q/k/v [b, t, heads * dh]; key_valid: row 0 full, row 1 fully masked,
    row 2 ragged with interior holes, row 3 with its first keys masked."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, t, heads * dh), generator=gen, device=device).to(dtype)
               for _ in range(3))
    kv = torch.ones((b, t), dtype=torch.bool, device=device)
    kv[1] = False
    n = max(1, int(0.6 * t))
    kv[2, n:] = False
    kv[2, torch.randint(0, n, (max(1, n // 8),), generator=gen, device=device)] = False
    kv[2, 0] = True
    kv[3, : max(1, t // 3)] = False
    return q, k, v, kv


def _check_nt(q, k, v, kv, heads, hpb):
    out = baf.mha_nt(q, k, v, kv, heads=heads, heads_per_block=hpb)
    torch.cuda.synchronize()
    ref = baf.mha_nt_reference(q, k, v, kv, heads).float()
    atol, rel = TOL[q.dtype]
    atol = atol * float(ref.abs().max()) if rel else atol
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=1e-2 if rel else 1e-4)
    assert torch.isfinite(out.float()).all()


@pytest.mark.parametrize("t", [64, 1000, 2048])
@pytest.mark.parametrize("hpb", baf.NT_HEADS_PER_BLOCK)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_mha_nt_matches_plain(cuda, t, hpb, dtype):
    _check_nt(*_nt_inputs(t + hpb, 4, t, 8, 64, dtype, cuda), 8, hpb)


@pytest.mark.parametrize("dh", [16, 32, 128])
def test_mha_nt_other_head_dims(cuda, dh):
    for hpb in baf.NT_HEADS_PER_BLOCK:
        if hpb * dh <= baf.NT_MAX_GROUP_WIDTH:
            for dtype in (torch.bfloat16, torch.float32):
                _check_nt(*_nt_inputs(dh + hpb, 4, 200, 4, dh, dtype, cuda), 4, hpb)


def test_mha_nt_strided_views_match_contiguous(cuda):
    b, t, h, dh = 4, 300, 8, 64
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(h * dh, dim=-1)
    kv = _nt_inputs(3, b, t, h, dh, torch.bfloat16, cuda)[3]
    got = baf.mha_nt(q, k, v, kv, heads=h)
    want = baf.mha_nt(q.contiguous(), k.contiguous(), v.contiguous(), kv, heads=h)
    torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)


def _int8_inputs(m, k, n, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(dtype)
    x[min(3, m - 1)] = 0  # the 1e-12 scale clamp
    wq, ws = bim.quantize_columns(torch.randn((k, n), generator=gen, device=device) * 0.02)
    return x, wq, ws


INT8_SHAPES = [*bim.SHAPES, (1000, 520, 776), (17, 16, 8), (130, 2048, 136), (5, 3, 7),
               (300, 1, 129),
               # 16-byte rows, K not a multiple of 128 (TMA past K zero-fills)
               (256, 528, 272),
               # fewer panels than SMs: column tiles split across blocks
               (2000, 256, 1000),
               # 397 panels on a persistent grid: three or four units a block
               (50693, 64, 136),
               # a panel too deep to stay resident: streamed once per column tile
               (256, 4096, 256)]


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_kernels_equal_plain_bit_for_bit(cuda, m, k, n, dtype):
    x, wq, ws = _int8_inputs(m, k, n, dtype, cuda)
    got = bim.int8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, bim.int8_matmul_reference(x, wq, ws))
    assert bim.int8_matmul.last_launch["route"] == _want_route(x)
    xq, _ = bim.quantize_rows(x)
    core = bim.int8_core(xq, wq)
    torch.cuda.synchronize()
    assert core.dtype == torch.int32
    assert torch.equal(core, bim.int8_core_reference(xq, wq))
    assert bim.int8_core.last_launch["route"] == _want_route(xq)


def _want_route(a):
    return int((a.shape[1] * a.element_size()) % 16 == 0 and a.data_ptr() % 16 == 0)


def _unaligned(t):
    """``t``'s values in a contiguous view one element past a 16-byte boundary
    (``buf[1:]`` of a larger buffer)."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_int8_kernels_read_an_unaligned_base_bit_for_bit(cuda, dtype):
    """x and xq whose storage starts off a 16-byte boundary, at a tool shape:
    the plain-load route (0), the same bits as the plain versions and as the
    aligned copies through the TMA / vector route (1)."""
    m, k, n = bim.SHAPES[0]
    x, wq, ws = _int8_inputs(m, k, n, dtype, cuda, seed=4)
    xq, _ = bim.quantize_rows(x)
    ux, uxq = _unaligned(x), _unaligned(xq)
    got, core = bim.int8_matmul(ux, wq, ws), bim.int8_core(uxq, wq)
    torch.cuda.synchronize()
    assert bim.int8_matmul.last_launch["route"] == 0 == _want_route(ux)
    assert bim.int8_core.last_launch["route"] == 0 == _want_route(uxq)
    assert torch.equal(got, bim.int8_matmul_reference(x, wq, ws))
    assert torch.equal(core, bim.int8_core_reference(xq, wq))
    assert torch.equal(got, bim.int8_matmul(x, wq, ws))
    assert bim.int8_matmul.last_launch["route"] == 1
    assert torch.equal(core, bim.int8_core(xq, wq))
    assert bim.int8_core.last_launch["route"] == 1


@pytest.mark.parametrize("bm", [64, 128])
def test_int8_kernels_on_a_forced_small_grid(cuda, bm, monkeypatch):
    """Fewer panels than SMs and more than two waves: 1000 x 520 x 776 with
    each panel's 7 column tiles split into runs of 1-2 tiles, on a grid of
    5 blocks, so that every block walks many (panel, run) units, some
    reusing a panel's slots, some not."""
    m, k, n = 1000, 520, 776
    x, wq, ws = _int8_inputs(m, k, n, torch.bfloat16, cuda, seed=5)
    xq, _ = bim.quantize_rows(x)
    _, _, _, slots, stages = bim.int8_schedule(m, k, n, 132)
    key = (m, k, n, x.device.index)
    monkeypatch.setattr(bim, "_CONFIGS", {})  # launch arguments made from the schedule
    for runs in (4, 7):
        monkeypatch.setitem(bim._SCHEDULES, key, (bm, runs, 5, slots, stages))
        bim._CONFIGS.clear()
        got, core = bim.int8_matmul(x, wq, ws), bim.int8_core(xq, wq)
        torch.cuda.synchronize()
        assert bim.int8_core.last_launch == dict(route=0, bm=bm, runs=runs, grid=5, slots=slots,
                                                 stages=stages)
        assert torch.equal(got, bim.int8_matmul_reference(x, wq, ws))
        assert torch.equal(core, bim.int8_core_reference(xq, wq))


@pytest.mark.parametrize("m,k,n", [bim.SHAPES[0], (1000, 520, 776)])
def test_int8_chained_launches_give_equal_bits(cuda, m, k, n):
    """Launches queued back to back (no synchronisation between) share one
    scratch: each writes the weight's K-major copy there and passes the grid
    barrier in it after the one before has read it, in stream order. Equal
    bits, including a launch with another weight in between."""
    x, wq, ws = _int8_inputs(m, k, n, torch.bfloat16, cuda, seed=6)
    xq, _ = bim.quantize_rows(x)
    wq2 = torch.flip(wq, dims=[0])
    before = (bim.int8_matmul.launches, bim.int8_core.launches)
    a, b = bim.int8_matmul(x, wq, ws), bim.int8_matmul(x, wq, ws)
    c, e, d = bim.int8_core(xq, wq), bim.int8_core(xq, wq2), bim.int8_core(xq, wq)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d)
    assert torch.equal(a, bim.int8_matmul_reference(x, wq, ws))
    assert torch.equal(e, bim.int8_core_reference(xq, wq2))
    assert (bim.int8_matmul.launches, bim.int8_core.launches) == (before[0] + 2, before[1] + 3)


def test_int8_core_at_the_int32_extremes(cuda):
    xq = torch.full((256, 2048), 127, dtype=torch.int8, device=cuda)
    xq[1::2] = -127
    wq = torch.full((2048, 256), -127, dtype=torch.int8, device=cuda)
    wq[:, ::3] = 127
    assert torch.equal(bim.int8_core(xq, wq), bim.int8_core_reference(xq, wq))


def test_cuda_tensors_launch_the_kernels(cuda):
    q, k, v, kv = _nt_inputs(5, 4, 128, 4, 32, torch.bfloat16, cuda)
    x, wq, ws = _int8_inputs(64, 64, 64, torch.bfloat16, cuda)
    before = (baf.mha_nt.launches, bim.int8_matmul.launches, bim.int8_core.launches)
    baf.mha_nt(q, k, v, kv, heads=4)
    bim.int8_matmul(x, wq, ws)
    bim.int8_core(bim.quantize_rows(x)[0], wq)
    torch.cuda.synchronize()
    after = (baf.mha_nt.launches, bim.int8_matmul.launches, bim.int8_core.launches)
    assert after == tuple(n + 1 for n in before)


def test_wrappers_raise_on_unsupported_inputs(cuda):
    q, k, v, kv = _nt_inputs(6, 4, 64, 4, 32, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        baf.mha_nt(q.half(), k.half(), v.half(), kv, heads=4)
    with pytest.raises(ValueError):
        baf.mha_nt(q, k.cpu(), v, kv, heads=4)
    with pytest.raises(ValueError):
        baf.mha_nt(q, k, v, kv.int(), heads=4)
    x, wq, ws = _int8_inputs(64, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        bim.int8_matmul(x.half(), wq, ws)
    with pytest.raises(ValueError):
        bim.int8_matmul(x, wq.cpu(), ws)
    with pytest.raises(ValueError):
        bim.int8_matmul(x, wq, ws.double())
    with pytest.raises(ValueError):
        bim.int8_core(x, wq)  # not int8
    with pytest.raises(ValueError):
        bim.int8_core(bim.quantize_rows(x)[0], wq[:32])  # inner sizes differ


@pytest.mark.parametrize("t", [1000, 2048])
@pytest.mark.parametrize("hpb", baf.NT_HEADS_PER_BLOCK)
def test_tensor_core_nt_kernel_matches_plain(cuda, t, hpb):
    """bf16 at Dh 64 takes ``flash_fwd_nt_tc`` (one launch per call), at the
    tool's shape (T = 2048, keys >= 1800 masked) and a ragged T = 1000 with a
    row of no valid key; two launches give the same bits."""
    q, k, v, kv = _nt_inputs(50 + t + hpb, 4, t, 8, 64, torch.bfloat16, cuda)
    if t == 2048:
        kv[0, baf.KEYS_VALID:] = False
    before = baf.flash_fwd_nt_tc.launches
    _check_nt(q, k, v, kv, 8, hpb)
    again = baf.mha_nt(q, k, v, kv, heads=8, heads_per_block=hpb)
    first = baf.mha_nt(q, k, v, kv, heads=8, heads_per_block=hpb)
    torch.cuda.synchronize()
    assert baf.flash_fwd_nt_tc.launches == before + 3
    assert torch.equal(again, first)


def test_tensor_core_nt_kernel_reads_strided_views_in_place(cuda):
    """Column slices of one [B, T, 3 D] tensor against contiguous copies, bit
    for bit, at each heads-per-block."""
    b, t, h, dh = 4, 1000, 8, 64
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.split(h * dh, dim=-1)
    kv = torch.ones((b, t), dtype=torch.bool, device=cuda)
    kv[1, 700:] = False
    kv[2] = False
    for hpb in baf.NT_HEADS_PER_BLOCK:
        got = baf.mha_nt(q, k, v, kv, heads=h, heads_per_block=hpb)
        want = baf.mha_nt(q.contiguous(), k.contiguous(), v.contiguous(), kv, heads=h,
                          heads_per_block=hpb)
        torch.testing.assert_close(got, want, atol=0.0, rtol=0.0)
