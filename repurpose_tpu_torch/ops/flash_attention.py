"""Flash attention forward: the wrapper around the CUDA kernel and its plain
PyTorch version.

``flash_forward`` is the counterpart of ``_flash_forward`` in
``repurpose_tpu/ops/flash_attention.py``, whose dense TPU kernel
``_flash_fwd_kernel`` (unpacked and packed) it replaces with one hand-written
kernel for Hopper, ``csrc/flash_fwd.cu`` (design notes there). Contract, as
on the TPU:

- q/k/v ``[B, T, H, Dh]`` in bfloat16 or float32, ``key_valid [B, T]`` bool,
  optional ``seg_ids [B, T]`` int32 (-1 on padding) for sequence packing;
- q is scaled by 1/sqrt(Dh) in float32, then rounded to the input dtype;
- scores and sums in float32, with a -1e9 bias on masked keys;
- ``softmax_dtype="bfloat16"`` rounds the biased scores and the
  exponentials to bf16 (the production default, ``attn_softmax_dtype``);
- returns ``out [B, T, H, Dh]`` in q's dtype and ``lse [B, H, T, 1]`` float32;
- every query row at or past ``_kv_len`` (last valid key + 1) gets out = 0
  and lse = ``SKIP_LSE``. The TPU kernel does so for whole query blocks past
  it; these rows are padding either way.

On a CPU tensor the wrapper computes ``flash_forward_reference``, the plain
version. On a CUDA tensor it launches the kernel or raises: there is no
fallback.
"""

from __future__ import annotations

import torch

from repurpose_tpu_torch.ops.attention import NEG_INF

# LSE written for query rows past the last valid key: large enough that a
# backward's exp(s - lse) underflows to exactly 0, small enough to stay finite.
SKIP_LSE = 1e30

HEAD_DIMS = (16, 32, 64, 128)
_SM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _kv_len(key_valid: torch.Tensor) -> torch.Tensor:
    """[B, 1] int32: last valid key index + 1 per batch row (0 if none)."""
    t = key_valid.shape[1]
    idx = torch.arange(t, dtype=torch.int32, device=key_valid.device)[None, :]
    last = torch.where(key_valid, idx, -1).amax(dim=1) + 1
    return last.to(torch.int32)[:, None]


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the TPU kernel's arithmetic over
    the whole key axis at once (the kernel's online softmax reaches the same
    values up to rounding)."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = 1.0 / (dh ** 0.5)
    qs = (q.float() * scale).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    ok = key_valid[:, None, None, :]
    if seg_ids is not None:
        ok = ok & (seg_ids[:, None, :, None] == seg_ids[:, None, None, :])
    s = (s + torch.where(ok, 0.0, NEG_INF)).to(sm_dtype)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    out = (o / denom.permute(0, 2, 1, 3)).to(q.dtype)
    lse = m.float() + torch.log(denom)  # [B, H, T, 1]
    skip = torch.arange(t, device=q.device)[None, :] >= _kv_len(key_valid)  # [B, T]
    out = out.masked_fill(skip[:, :, None, None], 0.0)
    lse = lse.masked_fill(skip[:, None, :, None], SKIP_LSE)
    return out, lse


def _check_cuda_inputs(q, k, v, key_valid, seg_ids) -> None:
    b, t, h, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q/k/v dtype {q.dtype}: bfloat16 or float32 only")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {x.shape} {x.dtype} {x.device} does not match "
                             f"q {q.shape} {q.dtype} {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"{name}: the head-dim axis must be contiguous")
        item = x.element_size()
        if x.data_ptr() % 16 or any((x.stride(i) * item) % 16 for i in range(3)):
            raise ValueError(f"{name}: rows must start on 16-byte boundaries")
    if key_valid.dtype != torch.bool or key_valid.shape != (b, t):
        raise ValueError(f"key_valid must be bool [{b}, {t}]")
    if key_valid.device != q.device:
        raise ValueError("key_valid is on another device than q")
    if seg_ids is not None:
        if seg_ids.dtype != torch.int32 or seg_ids.shape != (b, t):
            raise ValueError(f"seg_ids must be int32 [{b}, {t}]")
        if seg_ids.device != q.device:
            raise ValueError("seg_ids is on another device than q")


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v ``[B, T, H, Dh]`` -> (out ``[B, T, H, Dh]``, lse ``[B, H, T, 1]``).

    q/k/v may be strided views (e.g. the column slices of a fused QKV
    projection) as long as the head-dim axis is contiguous and rows start on
    16-byte boundaries."""
    if softmax_dtype not in _SM_DTYPES:
        raise ValueError(f"bad softmax_dtype: {softmax_dtype}")
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, key_valid, seg_ids, softmax_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_forward runs on CUDA or CPU tensors, not {q.device}")
    _check_cuda_inputs(q, k, v, key_valid, seg_ids)
    from repurpose_tpu_torch import native

    lib = native.load("flash_fwd")
    b, t, h, dh = q.shape
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        key_valid.data_ptr(), None if seg_ids is None else seg_ids.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b, t, h, dh, int(q.dtype == torch.bfloat16),
        int(softmax_dtype == "bfloat16"), 1.0 / (dh ** 0.5), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0  # kernel launches; the plain CPU path does not count
