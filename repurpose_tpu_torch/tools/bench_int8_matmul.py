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
launches its kernel or raises. Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.tools import device_line, per_call_ms

N_CHAIN = 500
SHAPES = [(16384, 512, 512), (16384, 512, 2048), (16384, 2048, 512)]

_INV_127 = float(np.float32(1.0) / np.float32(127.0))  # exact as a float32
_X_DTYPES = (torch.bfloat16, torch.float32)


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


def _on_cuda(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {x.device}")
    return True


def _check_2d(name: str, x: torch.Tensor, dtypes, device) -> None:
    if x.dim() != 2 or x.dtype not in dtypes or x.device != device:
        raise ValueError(f"{name}: a 2-d {'/'.join(map(str, dtypes))} tensor on {device} "
                         f"is needed, not {tuple(x.shape)} {x.dtype} {x.device}")


def _check_product(x, wq) -> tuple[int, int, int]:
    m, k = x.shape
    k2, n = wq.shape
    if k != k2:
        raise ValueError(f"inner sizes differ: x {tuple(x.shape)}, wq {tuple(wq.shape)}")
    return m, k, n


def int8_core(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 ``[M, N]`` = int8 ``xq [M, K]`` @ int8 ``wq [K, N]``: the kernel
    ``int8_core_kernel`` of csrc/int8_matmul.cu on CUDA tensors (counted in
    ``int8_core.launches``), ``int8_core_reference`` on CPU ones. Any M, K
    and N: the kernel zero-fills ragged tiles."""
    if not _on_cuda(xq, "int8_core"):
        return int8_core_reference(xq, wq)
    for name, t in (("xq", xq), ("wq", wq)):
        _check_2d(name, t, (torch.int8,), xq.device)
    m, k, n = _check_product(xq, wq)
    from repurpose_tpu_torch import native

    xq, wq = xq.contiguous(), wq.contiguous()
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    if out.numel() == 0:
        return out
    err = native.load("int8_matmul").int8_core(
        xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(xq.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_core kernel launch failed: CUDA error {err}")
    int8_core.launches += 1
    return out


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """``[M, N]`` in x's dtype = dequantised (quantise_rows(x) @ wq): the
    kernel ``int8_mm_kernel`` of csrc/int8_matmul.cu on CUDA tensors
    (counted in ``int8_matmul.launches``), ``int8_matmul_reference`` on CPU
    ones. x bf16 or float32 ``[M, K]``, wq int8 ``[K, N]``, ws float32
    ``[1, N]``; any M, K and N."""
    if not _on_cuda(x, "int8_matmul"):
        return int8_matmul_reference(x, wq, ws)
    _check_2d("x", x, _X_DTYPES, x.device)
    _check_2d("wq", wq, (torch.int8,), x.device)
    _check_2d("ws", ws, (torch.float32,), x.device)
    m, k, n = _check_product(x, wq)
    if ws.shape != (1, n):
        raise ValueError(f"ws must be [1, {n}], not {tuple(ws.shape)}")
    from repurpose_tpu_torch import native

    x, wq, ws = x.contiguous(), wq.contiguous(), ws.contiguous()
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = native.load("int8_matmul").int8_matmul(
        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), out.data_ptr(), m, k, n,
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    int8_matmul.launches += 1
    return out


int8_core.launches = 0  # kernel launches; the plain CPU path does not count
int8_matmul.launches = 0


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
