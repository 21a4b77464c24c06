"""The int8 kernels' choices and arithmetic that Python and numpy can hold on
the CPU (repurpose_tpu_torch/tools/bench_int8_matmul.py,
csrc/int8_matmul.cu):

- ``int8_route``: the A operand's load route (1 where its rows are 16-byte
  aligned: TMA for xq, vector loads for x; 0 elsewhere) on CPU tensors and
  views, strides, offsets and K = 1;
- ``int8_schedule``: panel rows, column-tile runs, grid, panel slots and
  weight stages, within the kernel's shared-memory pool and its checks;
- the kernels' quantisation, emulated in numpy step for step (the float's
  double built from its bits, one double multiply by the row's reciprocal,
  the rounding to float, rint by adding 1.5 * 2**23, the clamp on the
  integer) against ``quantize_rows`` (a true float division), exactly;
- the plain versions against the TPU tool's Pallas kernels in interpret mode
  at the ragged shapes the card's tests use, bit for bit.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu_torch.tools import bench_int8_matmul as bim

ROOT = Path(__file__).resolve().parent.parent
SMS = 132  # an H100 SXM


def _flat_view(dtype, shape, offset):
    """A contiguous [rows, cols] view starting ``offset`` elements into a
    flat buffer (what ``buf[1:]`` of a larger tensor gives)."""
    rows, cols = shape
    buf = torch.zeros(rows * cols + 64, dtype=dtype)
    return buf[offset:offset + rows * cols].view(rows, cols)


@pytest.mark.parametrize("dtype,shape,offset,route", [
    (torch.int8, (64, 512), 0, 1),     # 512-byte rows
    (torch.int8, (64, 528), 0, 1),     # K not a multiple of 128, rows still 16-byte multiples
    (torch.int8, (64, 520), 0, 0),     # 520-byte rows
    (torch.int8, (300, 1), 0, 0),      # K = 1
    (torch.int8, (64, 512), 1, 0),     # buf[1:]: the base one byte off
    (torch.int8, (64, 512), 16, 1),    # buf[16:]: the base 16 bytes on
    (torch.bfloat16, (64, 264), 0, 1),  # 528-byte rows
    (torch.bfloat16, (64, 260), 0, 0),  # 520-byte rows
    (torch.bfloat16, (64, 512), 1, 0),  # the base two bytes off
    (torch.bfloat16, (64, 512), 8, 1),
    (torch.float32, (64, 4), 0, 1),
    (torch.float32, (64, 3), 0, 0),
    (torch.float32, (64, 512), 2, 0),
])
def test_route_rule(dtype, shape, offset, route):
    a = _flat_view(dtype, shape, offset)
    assert a.is_contiguous()
    assert a.data_ptr() % 16 == (offset * a.element_size()) % 16  # the allocator aligns
    assert bim.int8_route(a) == route


def test_route_of_a_column_slice_is_that_of_its_contiguous_copy():
    """The wrappers call ``.contiguous()`` first: a strided slice is copied
    into fresh (aligned) storage, a contiguous row slice stays in place."""
    base = torch.zeros((64, 1024), dtype=torch.bfloat16)
    cols = base[:, 1:513]
    assert not cols.is_contiguous() and bim.int8_route(cols.contiguous()) == 1
    rows = base.view(-1)[1:].view(-1)[:64 * 512].view(64, 512)
    assert rows.is_contiguous() and bim.int8_route(rows.contiguous()) == 0


SCHEDULE_SHAPES = [
    *bim.SHAPES, (1000, 520, 776), (17, 16, 8), (130, 2048, 136), (5, 3, 7), (300, 1, 129),
    (256, 528, 272), (2000, 256, 1000), (50693, 64, 136), (256, 4096, 256), (64, 0, 64),
    (1, 1152, 128), (1, 1153, 128), (1, 2304, 128), (1, 2305, 128),
]


@pytest.mark.parametrize("m,k,n", SCHEDULE_SHAPES)
def test_schedule_fits_the_kernel(m, k, n):
    """What the C entry checks before a launch, and the rule's choices."""
    bm, runs, grid, slots, stages = bim.int8_schedule(m, k, n, SMS)
    kc, tiles = -(-k // bim.CHUNK), -(-n // bim.TILE_N)
    panels = -(-m // bm)
    assert bm in (64, 128)
    assert bm == (128 if k <= 1152 else 64 if k <= 2304 else 128)
    assert slots == (kc if k <= 2304 else bim.STREAM_A_SLOTS)  # resident up to 2304
    assert bim.MIN_B_STAGES <= stages <= bim.MAX_B_STAGES
    assert slots * bm * bim.CHUNK + stages * bim.TILE_N * bim.CHUNK <= bim.POOL
    per = -(-tiles // runs)
    assert 1 <= runs <= tiles and (runs - 1) * per < tiles  # no empty run
    assert 1 <= grid <= min(panels * runs, SMS)


def test_schedule_splits_columns_where_panels_are_few():
    # 8 panels of 128 rows: each panel's 7 column tiles go to 7 blocks
    assert bim.int8_schedule(1000, 520, 776, SMS)[:3] == (128, 7, 56)
    # 128 panels already fill the card: no split
    assert bim.int8_schedule(16384, 512, 2048, SMS)[:3] == (128, 1, 128)
    # 397 panels: a persistent grid of 132 blocks, three or four units each
    assert bim.int8_schedule(50693, 64, 136, SMS)[:3] == (128, 1, 132)


def _exact_double(bits: np.ndarray) -> np.ndarray:
    """csrc/int8_matmul.cu ``exact_double``: a float's double from its bits;
    zero and subnormal floats give 0, infinities and NaN stay so."""
    bits = bits.astype(np.uint64)
    e = (bits >> np.uint64(23)) & np.uint64(0xFF)
    ed = np.where(e == 0, 0, np.where(e == 0xFF, 0x7FF, e + 896)).astype(np.uint64)
    hi = (bits & np.uint64(0x80000000)) | (ed << np.uint64(20)) | np.where(
        e == 0, 0, (bits >> np.uint64(3)) & np.uint64(0xFFFFF)).astype(np.uint64)
    lo = np.where(e == 0, 0, (bits << np.uint64(29)) & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.float64)


def _bf16_double(h: np.ndarray) -> np.ndarray:
    """csrc/int8_matmul.cu ``bf16_double``: a bf16's double from its 16 bits
    (no low word; zero and subnormal give 0)."""
    h = h.astype(np.uint64)
    mag = h & np.uint64(0x7FFF)
    hi = np.where(mag < 0x80, 0, (mag << np.uint64(13)) + np.uint64(0x38000000)).astype(
        np.uint64) | ((h & np.uint64(0x8000)) << np.uint64(16))
    return (hi << np.uint64(32)).view(np.float64)


def test_bf16_double_equals_exact_double_on_every_finite_bf16():
    """The bf16 path's shortcut against the float path, on all 65536 bit
    patterns but infinities and NaN (which the kernels take no care of)."""
    h = np.arange(1 << 16, dtype=np.uint32)
    finite = ((h >> 7) & 0xFF) != 0xFF
    got = _bf16_double(h[finite])
    want = _exact_double(h[finite] << 16)
    np.testing.assert_array_equal(got, want)
    # and those are the bf16 values themselves (0 for zero and subnormals)
    values = torch.from_numpy(h[finite].astype(np.int32).astype(np.int16)).view(torch.bfloat16)
    exact = values.double().numpy()
    np.testing.assert_array_equal(got, np.where(np.abs(exact) < 2.0 ** -126, 0.0, exact))


def _kernel_quantize(x: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """csrc/int8_matmul.cu ``quantize`` on float32 values ``x`` and row
    scales ``xs`` (float32): float(double(x) * (1 / double(xs))), rint by
    the 1.5 * 2**23 addition, the clamp on the integer."""
    xr = 1.0 / xs.astype(np.float64)
    q = (_exact_double(x.view(np.uint32)) * xr).astype(np.float32)
    n = (q + np.float32(12582912.0)).astype(np.float32).view(np.int32) - 0x4B400000
    return np.clip(n, -127, 127).astype(np.int8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_kernel_quantisation_equals_the_division(dtype, scale):
    """The kernel's quantisation without a division gives ``quantize_rows``'
    int8 (IEEE division, ties to even) on every value: bf16 data puts ~0.2 %
    of x / xs within 2**-14 of a half-integer, and some exactly on one."""
    rng = np.random.default_rng(int(scale * 10) + (dtype == torch.bfloat16))
    x = torch.from_numpy(rng.normal(0, scale, (512, 512)).astype(np.float32)).to(dtype)
    x[3] = 0  # the 1e-12 clamp
    x[5, :7] = torch.tensor([1e-40, -1e-39, 0.0, -0.0, 3.0, -3.0, 0.5]).to(dtype)
    xq, xs = bim.quantize_rows(x)
    got = _kernel_quantize(x.float().numpy(), xs.numpy())
    np.testing.assert_array_equal(got, xq.numpy())


def test_bf16_data_sits_near_ties_often():
    """Why the kernels do not test for ties in floats: on bf16 data the float
    product x * float(1 / xs) lies within 2**-14 of a half-integer for ~0.2 %
    of values (~1e-4 on float32 data), so nearly every warp of 32 lanes x 64
    values would take the division."""
    rng = np.random.default_rng(0)
    shares = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(rng.normal(0, 1, (1024, 512)).astype(np.float32)).to(dtype).float()
        _, xs = bim.quantize_rows(x)
        y = (x.numpy() * (np.float32(1) / xs.numpy())).astype(np.float32)
        shares[dtype] = float((np.abs(y - np.rint(y)) > 0.5 - 2.0 ** -14).mean())
    assert 1e-3 < shares[torch.bfloat16] < 5e-3
    assert shares[torch.float32] < 5e-4
    assert 1 - (1 - shares[torch.bfloat16]) ** (32 * 64) > 0.9  # a warp's 2048 values


def test_kernel_quantisation_on_adversarial_ties():
    """Values built to sit on, and one float step either side of, x / xs =
    k + 1/2 for scales of every significand."""
    rng = np.random.default_rng(3)
    xs = rng.uniform(1e-3, 10, 50000).astype(np.float32)
    xs[::7] = np.float32(1.99999988) * np.float32(2.0) ** rng.integers(-20, 5, xs[::7].size)
    k = rng.integers(-127, 127, xs.size)
    x0 = ((k + 0.5) * xs.astype(np.float64)).astype(np.float32)
    for x in (x0, np.nextafter(x0, np.float32(np.inf)), np.nextafter(x0, np.float32(-np.inf))):
        want = np.clip(np.rint(x / xs), -127, 127).astype(np.int8)  # float32 division
        np.testing.assert_array_equal(_kernel_quantize(x, xs), want)


@pytest.fixture(scope="module")
def jax_int8():
    spec = importlib.util.spec_from_file_location(
        "_jax_bench_int8_matmul", ROOT / "tools" / "bench_int8_matmul.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RAGGED = [(64, 528, 272), (32, 3, 7), (64, 1, 129), (40, 520, 136)]


@pytest.mark.parametrize("m,k,n", RAGGED)
@pytest.mark.parametrize("jax_dtype,torch_dtype", [(jnp.float32, torch.float32),
                                                   (jnp.bfloat16, torch.bfloat16)],
                         ids=["float32", "bfloat16"])
def test_plain_fused_equals_pallas_at_ragged_shapes(jax_int8, m, k, n, jax_dtype, torch_dtype):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    x[min(3, m - 1)] = 0.0
    wq, ws = bim.quantize_columns(torch.from_numpy(rng.normal(0, 0.02, (k, n)).astype(np.float32)))
    xj = jnp.asarray(x).astype(jax_dtype)
    want = jax_int8.pallas_int8_matmul(xj, jnp.asarray(wq.numpy()), jnp.asarray(ws.numpy()),
                                       bm=m, interpret=True)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch_dtype)
    got = bim.int8_matmul(xt, wq, ws)
    assert got.dtype == torch_dtype and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_plain_core_equals_pallas_at_ragged_shapes(jax_int8, m, k, n):
    rng = np.random.default_rng(m * k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jax_int8.pallas_int8_core(jnp.asarray(xq), jnp.asarray(wq), bm=m,
                                                interpret=True))
    got = bim.int8_core(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
