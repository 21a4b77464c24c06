"""Attention-forward experiment at the headline shape [8, 2048, 8, 64] on the
H100: the port of the repository's ``tools/bench_attention_fwd.py``.

    python -m repurpose_tpu_torch.tools.bench_attention_fwd [--device cuda|cpu]

It sets the port's flash forward (``flash_forward``, csrc/flash_fwd.cu,
``[B, T, H, Dh]`` in and out) beside a "no-transpose" forward on the flat
``[B, T, D]`` layout, ``mha_nt`` (csrc/flash_fwd_nt.cu, replacing the TPU
kernel ``_fwd_kernel_nt``): one block computes ``heads_per_block`` heads of a
64-row query tile, so each K/V tile is read once for all of them and nothing
is transposed. In bf16 at Dh 64 (the tool's shape) that is the wgmma kernel
fed by TMA, ``flash_fwd_nt_tc``, one warpgroup per head of the block.
Printed, in the TPU tool's order, each time the median of three runs of
``N_CHAIN`` back-to-back calls:

- the card (name, power limit);
- ``nt-vs-current``: max |mha_nt - flash_forward| on query rows before the
  last valid key, where ``flash_forward`` writes 0 and ``mha_nt`` does not;
- ``mha_torch`` (the plain attention; the TPU tool's ``xla`` line);
- ``flash_forward`` (its ``pallas`` lines; this kernel has one tile size);
- ``no-transpose hpb=<n>`` for each heads-per-block the kernel has (its
  ``q_block`` sweep; the query tile is fixed at 64 rows);
- ``current e2e (flat->flat)``: ``flash_forward`` on views of the flat
  tensors, its output viewed flat again.

``mha_nt`` keeps the TPU kernel's semantics, which are not
``flash_forward``'s: every query row is computed (no prefix skip, no LSE),
and the -1e9 bias of a masked key is added to the float32 score, so a row
whose keys are all masked averages v over every key.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repurpose_tpu_torch import resolve_device
from repurpose_tpu_torch.ops.attention import NEG_INF, mha_torch
from repurpose_tpu_torch.ops.flash_attention import HEAD_DIMS, _kv_len, flash_forward
from repurpose_tpu_torch.tools import device_line, per_call_ms

N_CHAIN = 100
B, T, H, DH = 8, 2048, 8, 64
KEYS_VALID = 1800  # keys at or past this index are masked in every row

# Heads per block that csrc/flash_fwd_nt.cu instantiates, and the widest head
# group (heads_per_block * Dh) its shared memory holds.
NT_HEADS_PER_BLOCK = (1, 2, 4)
NT_MAX_GROUP_WIDTH = 256


def mha_nt_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     key_valid: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain version of the no-transpose kernel, with the TPU kernel's
    arithmetic (tools/bench_attention_fwd.py:73-96): q/k/v ``[B, T, D]``,
    ``key_valid [B, T]`` bool -> ``[B, T, D]`` in q's dtype.

    - q scaled by 1/sqrt(Dh) in float32, then rounded to q's dtype;
    - float32 scores plus a float32 bias of 0 / -1e9 (added, not selected);
    - e = exp(s - max) and its sum in float32;
    - e rounded to v's dtype for the product with v, summed in float32;
    - the divide after that product; every row computed."""
    b, t, d = q.shape
    dh = d // heads
    scale = 1.0 / (dh ** 0.5)
    qs = (q.float() * scale).to(q.dtype).float().view(b, t, heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k.float().view(b, t, heads, dh))
    s = s + torch.where(key_valid, 0.0, NEG_INF)[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", e.to(v.dtype).float(), v.float().view(b, t, heads, dh))
    return (o / denom).to(q.dtype).permute(0, 2, 1, 3).reshape(b, t, d)


def _check_inputs(q, k, v, key_valid, heads: int, heads_per_block: int) -> None:
    if q.dim() != 3:
        raise ValueError(f"q must be [B, T, D], not {tuple(q.shape)}")
    b, t, d = q.shape
    if heads <= 0 or d % heads:
        raise ValueError(f"D = {d} is not a multiple of heads = {heads}")
    dh = d // heads
    if (heads_per_block not in NT_HEADS_PER_BLOCK or heads % heads_per_block
            or heads_per_block * dh > NT_MAX_GROUP_WIDTH or dh not in HEAD_DIMS):
        raise ValueError(
            f"heads_per_block {heads_per_block} at Dh {dh}, {heads} heads: the kernel has "
            f"heads_per_block in {NT_HEADS_PER_BLOCK} dividing the heads, Dh in {HEAD_DIMS} "
            f"and heads_per_block * Dh <= {NT_MAX_GROUP_WIDTH}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} {x.device} does not match "
                             f"q {tuple(q.shape)} {q.dtype} {q.device}")
    if key_valid.dtype != torch.bool or key_valid.shape != (b, t):
        raise ValueError(f"key_valid must be bool [{b}, {t}]")
    if key_valid.device != q.device:
        raise ValueError("key_valid is on another device than q")


def nt_tc(q: torch.Tensor, heads: int) -> bool:
    """Whether ``mha_nt`` on CUDA tensors takes the tensor-core kernel
    (``flash_fwd_nt_tc``): bf16 at Dh 64. float32 (float32 parity) and the
    other head widths keep the first kernel of csrc/flash_fwd_nt.cu."""
    return q.dtype == torch.bfloat16 and q.shape[-1] // heads == 64


def flash_fwd_nt_tc(q, k, v, key_valid, out, heads: int, heads_per_block: int) -> None:
    """Launches ``flash_fwd_nt_tc_kernel`` of csrc/flash_fwd_nt.cu (bf16 at
    Dh 64) on the checked inputs of ``mha_nt`` into ``out``; counted in
    ``flash_fwd_nt_tc.launches`` (the caller counts it in ``mha_nt.launches``
    too)."""
    from repurpose_tpu_torch import native

    b, t, d = q.shape
    err = native.load("flash_fwd_nt").flash_fwd_nt_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        key_valid.data_ptr(), out.data_ptr(), b, t, heads, heads_per_block,
        1.0 / ((d // heads) ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_nt_tc kernel launch failed: CUDA error {err}")
    flash_fwd_nt_tc.launches += 1


flash_fwd_nt_tc.launches = 0  # kernel launches; the plain CPU path does not count


def mha_nt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
           heads: int, heads_per_block: int = 2) -> torch.Tensor:
    """The no-transpose attention forward: q/k/v ``[B, T, D]`` (D = heads *
    Dh) -> ``[B, T, D]`` in q's dtype, any T. A kernel of
    csrc/flash_fwd_nt.cu on CUDA tensors (counted in ``mha_nt.launches``),
    the tensor-core one (``flash_fwd_nt_tc``) where ``nt_tc``;
    ``mha_nt_reference`` on CPU ones. ``heads_per_block`` is the TPU tool's
    ``d_block // dh``: how many heads one block computes; a value the
    kernel does not instantiate raises, on either device. On the card q/k/v
    are bfloat16 or float32 and may be strided views whose feature axis is
    contiguous, with rows on 16-byte boundaries."""
    _check_inputs(q, k, v, key_valid, heads, heads_per_block)
    if q.device.type == "cpu":
        return mha_nt_reference(q, k, v, key_valid, heads)
    if q.device.type != "cuda":
        raise ValueError(f"mha_nt runs on CUDA or CPU tensors, not {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q/k/v dtype {q.dtype}: bfloat16 or float32 only")
    for name, x in (("q", q), ("k", k), ("v", v)):
        item = x.element_size()
        if x.stride(2) != 1 or x.data_ptr() % 16 or any(
            (x.stride(i) * item) % 16 for i in range(2)
        ):
            raise ValueError(f"{name}: contiguous feature axis and 16-byte rows needed")
    from repurpose_tpu_torch import native

    b, t, d = q.shape
    dh = d // heads
    key_valid = key_valid.contiguous()
    out = torch.empty((b, t, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if nt_tc(q, heads):
        flash_fwd_nt_tc(q, k, v, key_valid, out, heads, heads_per_block)
    else:
        err = native.load("flash_fwd_nt").flash_fwd_nt(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            key_valid.data_ptr(), out.data_ptr(), b, t, heads, dh, heads_per_block,
            int(q.dtype == torch.bfloat16), 1.0 / (dh ** 0.5),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_fwd_nt kernel launch failed: CUDA error {err}")
    mha_nt.launches += 1
    return out


mha_nt.launches = 0  # kernel launches; the plain CPU path does not count


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m repurpose_tpu_torch.tools.bench_attention_fwd")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    print(device_line(dev), flush=True)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (B, T, H, DH)).astype(np.float32))
               .to(torch.bfloat16).to(dev) for _ in range(3))
    mask = torch.ones((B, T), dtype=torch.bool)
    mask[:, KEYS_VALID:] = False
    mask = mask.to(dev)
    qf, kf, vf = (x.view(B, T, H * DH) for x in (q, k, v))

    # the no-transpose kernel against the shipping one, on the rows both compute
    cur = flash_forward(q, k, v, mask)[0].view(B, T, H * DH).float()
    nt = mha_nt(qf, kf, vf, mask, heads=H).float()
    rows = torch.arange(T, device=dev)[None, :] < _kv_len(mask)
    err = float((cur - nt).abs()[rows].max())
    print(f"nt-vs-current max abs diff (rows before the last valid key): {err:.4f}", flush=True)

    flops = 2 * 2 * B * H * T * T * DH  # qk + pv

    def line(label: str, ms: float) -> None:
        print(f"{label} {ms:7.3f} ms ({flops / (ms * 1e-3) / 1e12:.0f} TFLOP/s)", flush=True)

    line("mha_torch:     ", per_call_ms(lambda: mha_torch(q, k, v, mask), dev, N_CHAIN))
    line("flash_forward: ", per_call_ms(lambda: flash_forward(q, k, v, mask), dev, N_CHAIN))
    for hpb in NT_HEADS_PER_BLOCK:
        if H % hpb or hpb * DH > NT_MAX_GROUP_WIDTH:
            continue
        line(f"no-transpose hpb={hpb}:",
             per_call_ms(lambda hpb=hpb: mha_nt(qf, kf, vf, mask, heads=H, heads_per_block=hpb),
                         dev, N_CHAIN))
    # the shipping kernel between flat tensors: it reads [B, T, H, Dh] views
    # of them through their strides and its output is viewed flat again
    t_e2e = per_call_ms(
        lambda: flash_forward(qf.view(B, T, H, DH), kf.view(B, T, H, DH),
                              vf.view(B, T, H, DH), mask)[0].view(B, T, H * DH),
        dev, N_CHAIN)
    print(f"current e2e (flat->flat): {t_e2e:7.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
