"""Masked multi-head self-attention: the plain path and the dispatcher.

Counterpart of ``repurpose_tpu/ops/attention.py``:

- ``mha_torch`` is ``mha_xla``: scores and softmax in float32, an additive
  -1e9 bias on masked keys (not -inf, so fully masked rows stay finite),
  block-diagonal attention under sequence packing (``seg_ids``), output in
  q's dtype. It is the correctness baseline and ``attention_impl="xla"``.
- ``select_attention_impl`` resolves ``ModelConfig.attention_impl`` as the
  JAX one does: "auto" and "pallas_full" take the flash forward and the flash
  backward kernels, "pallas" the flash forward with the plain recompute
  backward (the VJP of ``mha_torch``), both through the autograd Function of
  ops/flash_attention.py, for every T: the JAX "T >= 512 on TPU" switch and
  its odd-T fallbacks are TPU tiling artefacts, and the Hopper kernels mask
  their own ragged edge. A head width without a kernel instance runs
  zero-padded to the next one (``kernel_head_dim`` in ops/flash_attention.py),
  where the JAX package sends untileable shapes to ``mha_xla``. The kernel
  callable also takes ``sweep``, the batch's ``AttentionSweep`` (kvl and the
  key-tile bounds), which the encoder makes once for all its layers with
  the callable's ``make_sweep``. "ring" resolves to ``mha_torch``, as the
  JAX dispatcher falls through to ``mha_xla`` for it: the concat MMCT's
  self-attention sends "ring" to ``ops/ring_attention.py`` itself (it needs
  the mesh), and a model without that branch attends over its whole rows.

Masking follows torch's ``src_key_padding_mask``: padded keys are excluded
from every query's softmax; padded query rows hold finite values that no
consumer reads.
"""

from __future__ import annotations

from typing import Callable

import torch

NEG_INF = -1e9  # large-negative instead of -inf: keeps padded rows NaN-free


def mha_torch(
    q: torch.Tensor,  # [B, T, H, Dh]
    k: torch.Tensor,  # [B, T, H, Dh]
    v: torch.Tensor,  # [B, T, H, Dh]
    key_valid: torch.Tensor,  # [B, T] bool — True where the key position is real
    seg_ids: torch.Tensor | None = None,  # [B, T] int — sequence-packing segments
) -> torch.Tensor:
    """Plain attention with float32 scores and softmax; output in q.dtype.
    Products of bf16 inputs are taken in float32, as XLA's
    ``preferred_element_type=float32`` does."""
    dh = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(dh, dtype=torch.float32))  # 0-dim, f32
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    allowed = key_valid[:, None, :]
    if seg_ids is not None:
        allowed = allowed & (seg_ids[:, :, None] == seg_ids[:, None, :])
    bias = torch.where(allowed[:, None], 0.0, NEG_INF)  # [B, 1, 1|Tq, Tk]
    weights = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def select_attention_impl(impl: str, softmax_dtype: str = "float32") -> Callable:
    """Resolve ModelConfig.attention_impl to a callable
    ``(q, k, v, key_valid, seg_ids=None) -> out [B, T, H, Dh]``. The
    kernels' callable also takes ``sweep=None`` and has
    ``make_sweep(key_valid, seg_ids)``, the batch's sweep for every call."""
    if impl == "xla":
        return mha_torch
    if impl in ("auto", "pallas", "pallas_full"):
        from repurpose_tpu_torch.ops import flash_attention as fa

        backward = "xla" if impl == "pallas" else "pallas"

        def flash(q, k, v, key_valid, seg_ids=None, sweep=None):
            return fa.flash_attention(q, k, v, key_valid, seg_ids, softmax_dtype, backward, sweep)

        flash.make_sweep = lambda key_valid, seg_ids=None: fa.attention_sweep(key_valid, seg_ids)
        return flash
    if impl == "ring":
        return mha_torch
    raise ValueError(f"bad attention_impl: {impl}")

