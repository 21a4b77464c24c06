"""Int8 matrix products at the MMCT Dense shapes on the H100: the port of the
repository's ``tools/bench_int8_matmul.py``.

    python -m repurpose_tpu_torch.tools.bench_int8_matmul [--device cuda|cpu]

Shapes (``SHAPES``): the flagship encoder's Dense layers at batch 8 x bucket
2048 (M = 16384): (M, 512) x (512, 512) qkv/out, (M, 512) x (512, 2048)
ffn-up, (M, 2048) x (2048, 512) ffn-down. Per shape it prints the time of
one call, each the median of three runs of ``N_CHAIN`` back-to-back calls:

- ``bf16``: ``torch.matmul`` of bf16 x by bf16 w, the incumbent;
- ``xla-int8``: ``torch._int_mm``, the library's int8 GEMM (a yardstick, as
  XLA's int8 dot was; never called by the port's kernels);
- ``int8-core``: ``int8_core``, both operands already int8 (the kernel
  ``int8_core_kernel`` of ``csrc/int8_matmul.cu``, replacing the TPU kernel
  ``_int8_core_kernel``);
- ``int8-fused``: ``int8_matmul``, per-row dynamic quantisation of x, the
  int8 product and the dequantisation in one kernel (``int8_mm_kernel``,
  replacing ``_int8_mm_kernel``);

then the fused kernel's max relative error against ``x.float() @
(wq.float() * ws)``.

Rounding points, those of the TPU kernel as XLA compiles it, so that the
plain versions equal the Pallas kernels bit for bit:

- ``xs = max(max|x| * float32(1/127), 1e-12)``: XLA turns the division by
  the constant 127 into a multiplication by its float32 reciprocal;
- ``xq = clip(round_half_even(x / xs), -127, 127)`` with a true IEEE
  division (a reciprocal here moves thousands of bf16 outputs by an ulp);
- ``acc`` = the exact int32 product; ``out = (float32(acc) * xs) * ws``,
  rounded to x's dtype.

On a CPU tensor each wrapper computes its plain version; on a CUDA tensor it
launches its kernel (one launch a call) or raises. Each counts its launches
in ``.launches``. Both kernels read the weight K-major (8-bit wgmma takes no
transposed operand): the blocks of each launch first write its K-major copy
into a scratch buffer together and meet at a grid barrier. ``int8_route``
(the A operand's load route) and ``int8_schedule`` (panel rows, column-tile
runs, grid, shared-memory split) are the wrappers' choices, in Python so
that the CPU tests reach them; the last launch's are kept in
``.last_launch``.
"""

from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.tools import device_line, per_call_ms

N_CHAIN = 500
SHAPES = [(16384, 512, 512), (16384, 512, 2048), (16384, 2048, 512)]

_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # exact as a float32
_X_DTYPES = (torch.bfloat16, torch.float32)
_INT8 = (torch.int8,)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """Quantisation scale of a float32 max |x|: ``max(amax * (1/127), 1e-12)``
    (the product of two float32 values, correctly rounded, however it is
    computed)."""
    return torch.clamp_min(amax * _INV_127, 1e-12)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantisation of ``x [M, K]``: (xq int8 ``[M, K]``,
    xs float32 ``[M, 1]``)."""
    xf = x.float()
    xs = _scale(xf.abs().amax(dim=1, keepdim=True))
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq, xs


def quantize_columns(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column int8 quantisation of a weight ``w [K, N]``, as the TPU tool
    quantises its weights: (wq int8 ``[K, N]``, ws float32 ``[1, N]``)."""
    wf = w.float()
    ws = _scale(wf.abs().amax(dim=0, keepdim=True))
    return torch.clamp(torch.round(wf / ws), -127, 127).to(torch.int8), ws


def int8_core_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of the core kernel: the int32 product of int8 ``xq [M, K]``
    and ``wq [K, N]``, through float64, which holds it exactly (|acc| <=
    K * 127**2 < 2**53)."""
    return (xq.double() @ wq.double()).to(torch.int32)


def int8_matmul_reference(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """Plain version of the fused kernel: ``x [M, K]`` (bf16 or float32),
    ``wq [K, N]`` int8, ``ws [1, N]`` float32 -> ``[M, N]`` in x's dtype."""
    xq, xs = quantize_rows(x)
    acc = int8_core_reference(xq, wq)
    return ((acc.float() * xs) * ws).to(x.dtype)


# The kernels' geometry (csrc/int8_matmul.cu): 128-byte K chunks, 128-column
# tiles, and a shared-memory pool of 13 chunks of 16 KB that a launch splits
# between the panel's slots (BM x 128 bytes each) and the weight's ring.
CHUNK = 128
TILE_N = 128
POOL = 212992
SCRATCH_WT = 256  # the scratch's barrier words, then the weight's K-major copy
MIN_B_STAGES, MAX_B_STAGES = 4, 16
STREAM_A_SLOTS = 4  # the slots of a panel too deep to be resident


def int8_route(a: torch.Tensor) -> int:
    """The load route of a contiguous A operand ``[M, K]`` (xq or x): 1 where
    its rows are 16-byte aligned (the row's bytes a multiple of 16 and the
    base 16-byte aligned: TMA for xq, vector loads for x), 0 elsewhere
    (plain loads, zero-filled). Both routes are the same kernel."""
    row_bytes = a.shape[1] * a.element_size()
    return int(row_bytes % 16 == 0 and a.data_ptr() % 16 == 0)


def int8_schedule(m: int, k: int, n: int, sms: int) -> tuple[int, int, int, int, int]:
    """(panel rows BM, column-tile runs per panel, grid, panel slots, weight
    stages) of a launch at (m, k, n) on a card with ``sms`` SMs.

    BM is 128 where a 128-row panel's whole K fits the pool beside a
    4-stage weight ring (K <= 1152), else 64 where a 64-row one does
    (K <= 2304), else 128 with the panel streamed through 4 slots once per
    column tile. The weight ring takes the rest of the pool (up to 16
    stages). Each panel's tiles are split into the number of runs that
    minimises waves x (tiles per run + 1), the + 1 the panel's load, ties to
    fewer runs; the grid is persistent over (panel, run) units, at most one
    block per SM."""
    kc = -(-k // CHUNK)
    for bm in (128, 64):
        if kc * bm * CHUNK + MIN_B_STAGES * TILE_N * CHUNK <= POOL:
            slots = kc
            break
    else:
        bm, slots = 128, STREAM_A_SLOTS
    stages = min(MAX_B_STAGES, (POOL - slots * bm * CHUNK) // (TILE_N * CHUNK))
    panels, tiles = -(-m // bm), -(-n // TILE_N)
    best = None
    for runs in range(1, tiles + 1):
        per = -(-tiles // runs)
        runs = -(-tiles // per)  # no empty run
        cost = -(-panels * runs // sms) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, runs)
    runs = best[1]
    return bm, runs, min(panels * runs, sms), slots, stages


# The launch path below passes the device as its index and reads each
# tensor attribute once: a chain of small calls runs at the speed of a
# call's host work, not of its kernel.
_SMS: dict[int, int] = {}
_SCHEDULES: dict[tuple, tuple[int, int, int, int, int]] = {}
_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _schedule(m: int, k: int, n: int, index: int) -> tuple[int, int, int, int, int]:
    """``int8_schedule`` for CUDA device ``index``'s SM count, remembered per
    shape."""
    key = (m, k, n, index)
    if key not in _SCHEDULES:
        if index not in _SMS:
            _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        _SCHEDULES[key] = int8_schedule(m, k, n, _SMS[index])
    return _SCHEDULES[key]


def _scratch(index: int, stream: int, k: int, n: int) -> torch.Tensor:
    """The kernels' device scratch for a [k, n] weight, one zero-initialised
    buffer per (device, stream), grown on demand: the grid barrier's words,
    which every launch leaves as it found them, then room for the weight's
    K-major copy [n, k rounded up to 16], which every launch writes anew
    before it reads it (in the stream's order, so calls on one stream never
    see each other's). Only the memory is kept, never a weight."""
    nbytes = SCRATCH_WT + n * (-(-k // 16) * 16)
    buf = _SCRATCH.get((index, stream))
    if buf is None or buf.numel() < nbytes:
        buf = _SCRATCH[(index, stream)] = torch.zeros(
            nbytes, dtype=torch.int8, device=torch.device("cuda", index))
    return buf


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    return False


def _check_2d(name: str, x: torch.Tensor, dtypes, index: int) -> None:
    """Raises unless ``x`` is 2-d, of one of ``dtypes`` and on CUDA device
    ``index``."""
    if x.dim() != 2 or x.dtype not in dtypes or x.get_device() != index:
        raise ValueError(f"{name}: a 2-d {'/'.join(map(str, dtypes))} tensor on cuda:{index} "
                         f"is needed, not {tuple(x.shape)} {x.dtype} {x.device}")


def _check_product(x, wq) -> tuple[int, int, int]:
    m, k = x.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    return m, k, n


_CONFIGS: dict[tuple, tuple] = {}


def _config(name: str, a: torch.Tensor, m: int, k: int, n: int, index: int) -> tuple:
    """The C entry's int arguments for this call, made once per (kernel,
    shape, route, dtype, device) and kept as a ctypes array: M, K, N, Kp,
    bf16 x, route, then the schedule. Returns (array, its address, the
    launch record)."""
    route = int8_route(a)
    key = (name, m, k, n, route, a.dtype, index)
    hit = _CONFIGS.get(key)
    if hit is None:
        sched = _schedule(m, k, n, index)
        cfg = (ctypes.c_int * 11)(m, k, n, -(-k // 16) * 16, int(a.dtype == torch.bfloat16),
                                  route, *sched)
        record = dict(route=route, **dict(zip(("bm", "runs", "grid", "slots", "stages"), sched)))
        hit = _CONFIGS[key] = (cfg, ctypes.addressof(cfg), record)
    return hit


_ENTRIES: dict[str, object] = {}


def _entry(name: str):
    """The C entry ``name`` of the built library (built at first use)."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from repurpose_tpu_torch import native

        fn = _ENTRIES[name] = getattr(native.load("int8_matmul"), name)
    return fn


def _launch(name: str, a: torch.Tensor, wq: torch.Tensor, out: torch.Tensor, index: int,
            m: int, k: int, n: int, *extra) -> None:
    """One launch of kernel ``name`` (``int8_core`` or ``int8_matmul``) on the
    contiguous A operand ``a [m, k]`` and ``wq [k, n]`` on CUDA device
    ``index``, with this layout's route and this shape's schedule (kept in
    ``<wrapper>.last_launch``), on the device's current stream."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    _, cfg, record = _config(name, a, m, k, n, index)
    scratch = _scratch(index, stream, k, n)
    err = _entry(name)(
        a.data_ptr(), wq.data_ptr(), scratch.data_ptr(), *extra, out.data_ptr(), cfg, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    wrapper = int8_core if name == "int8_core" else int8_matmul
    wrapper.launches += 1
    wrapper.last_launch = record


def int8_core(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 ``[M, N]`` = int8 ``xq [M, K]`` @ int8 ``wq [K, N]``: the kernel
    ``int8_core_kernel`` of csrc/int8_matmul.cu on CUDA tensors (counted in
    ``int8_core.launches``),
    ``int8_core_reference`` on CPU ones. Any M, K and N: the kernel
    zero-fills ragged tiles."""
    if not _on_cuda(xq, "int8_core"):
        return int8_core_reference(xq, wq)
    index = xq.get_device()
    _check_2d("xq", xq, _INT8, index)
    _check_2d("wq", wq, _INT8, index)
    m, k, n = _check_product(xq, wq)
    xq, wq = xq.contiguous(), wq.contiguous()
    out = torch.empty_strided((m, n), (n, 1), dtype=torch.int32, device=xq.device)
    if out.numel() == 0:
        return out
    _launch("int8_core", xq, wq, out, index, m, k, n)
    return out


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``[M, N]`` in x's dtype = dequantised (quantise_rows(x) @ wq): the
    kernel ``int8_mm_kernel`` of csrc/int8_matmul.cu on CUDA tensors
    (counted in ``int8_matmul.launches``),
    ``int8_matmul_reference`` on CPU ones. x bf16 or float32 ``[M, K]``, wq
    int8 ``[K, N]``, ws float32 ``[1, N]``; any M, K and N."""
    if not _on_cuda(x, "int8_matmul"):
        return int8_matmul_reference(x, wq, ws)
    index = x.get_device()
    _check_2d("x", x, _X_DTYPES, index)
    _check_2d("wq", wq, _INT8, index)
    _check_2d("ws", ws, (torch.float32,), index)
    m, k, n = _check_product(x, wq)
    if ws.shape != (1, n):
        raise ValueError(f"ws must be [1, {n}], not {tuple(ws.shape)}")
    x, wq, ws = x.contiguous(), wq.contiguous(), ws.contiguous()
    out = torch.empty_strided((m, n), (n, 1), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("int8_matmul", x, wq, out, index, m, k, n, ws.data_ptr())
    return out


int8_core.launches = 0  # kernel launches; the plain CPU path does not count
int8_matmul.launches = 0
int8_core.last_launch = int8_matmul.last_launch = None  # route and schedule of the last launch


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.tools.bench_int8_matmul")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(device_line(dev), flush=True)

    for m, k, n in SHAPES:
        x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(torch.bfloat16)
        w = torch.from_numpy(rng.normal(0, 0.02, (k, n)).astype(np.float32)).to(torch.bfloat16)
        x, w = x.to(dev), w.to(dev)
        wq, ws = quantize_columns(w)
        xq, _ = quantize_rows(x)
        ops = 2.0 * m * k * n

        t_bf16 = per_call_ms(lambda: torch.matmul(x, w), dev, N_CHAIN)
        t_lib8 = per_call_ms(lambda: torch._int_mm(xq, wq), dev, N_CHAIN)
        t_core = per_call_ms(lambda: int8_core(xq, wq), dev, N_CHAIN)
        t_fused = per_call_ms(lambda: int8_matmul(x, wq, ws), dev, N_CHAIN)

        def tops(ms):
            return ops / (ms * 1e-3) / 1e12

        print(f"[{m}x{k}x{n}] bf16 {t_bf16:.3f} ms ({tops(t_bf16):.0f} T) | "
              f"xla-int8 {t_lib8:.3f} ({tops(t_lib8):.0f} T) | "
              f"int8-core {t_core:.3f} ({tops(t_core):.0f} T) | "
              f"int8-fused {t_fused:.3f} ({tops(t_fused):.0f} T)", flush=True)

        ref = x.float() @ (wq.float() * ws)
        got = int8_matmul(x, wq, ws).float()
        rel = (got - ref).abs() / (ref.abs() + 1.0)
        print(f"  fused-kernel max rel err vs fp32xQw: {float(rel.max()):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
