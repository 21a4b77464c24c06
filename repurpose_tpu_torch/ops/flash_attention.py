"""Flash attention: the wrappers around the CUDA kernels, their plain
PyTorch versions, and the autograd Function that ties them together.

``flash_forward`` is the counterpart of ``_flash_forward`` in
``repurpose_tpu/ops/flash_attention.py``, whose dense TPU kernel
``_flash_fwd_kernel`` (unpacked and packed) it replaces with the kernels of
``csrc/flash_fwd.cu`` (design notes there): in bf16 at Dh 64 (``stream_tc``)
``flash_fwd_tc``, a wgmma kernel fed by TMA that sweeps, packed, only the
key tiles of each query tile's own segment ids (``segment_tile_bounds``),
else the first design, which sweeps every key tile up to kvl. Contract, as
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

``flash_backward`` is the counterpart of ``_flash_backward`` (same argument
order): up to ``STREAM_MAX_T``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace
the TPU kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (+
``_dkv_compute``), unpacked and packed, with the kernels of
``csrc/flash_bwd.cu``; past it, ``flash_bwd_dq_stream`` and
``flash_bwd_dkv_stream`` replace the four long-T TPU backward kernels
(``_bwd_dq_stream_kernel``, ``_bwd_dq_packed_stream_kernel``,
``_bwd_dq_hbm_kernel``, ``_bwd_dkv_stream_kernel``) with the kernels of
``csrc/flash_bwd_stream.cu``. In bf16 at Dh 64 (``stream_tc``), at any T,
both are the one wgmma/TMA pair of ``csrc/flash_bwd.cu`` (mainloop
``csrc/flash_bwd_tc.cuh``): as the dense backward in the TPU dense kernels'
select form, as the long-T one in the stream kernels' bias form, after
``flash_bwd_stream_prep`` has computed q_s and delta once per backward. It
sweeps 64-row tiles and, packed, only the tiles of each tile's own segment
ids: every position of each id (``segment_tile_bounds``) for the dense
backward, each id's run (``packed_block_bounds``, as the stream forward and
the TPU stream kernels) for the long-T one.
dq rows and dk/dv rows at or past
``_kv_len`` are 0. The upstream gradient must be 0 on query rows
at or past ``_kv_len``, which is what the model gives (the loss masks those
rows and masked keys carry no softmax mass): there the TPU forward leaves
real lse values where this one writes ``SKIP_LSE``, so only with that
contract do the two backwards agree on every row.

``FlashAttention`` (``flash_attention``) is the autograd Function of the
model's attention: the kernel forward, then the kernel backward or, with
``backward="xla"``, the plain recompute backward (the VJP of ``mha_torch``,
the JAX ``backward="xla"`` escape hatch). On the card it zero-pads a head
width without a kernel instance to the next one (``kernel_head_dim``) and
keeps the head's own scale 1/sqrt(Dh), which every wrapper takes as
``scale``; the zero columns add nothing to q_s k^T, p v or rowsum(g o).
Under a ``torch.profiler`` session its forward and its backward are each
an ``attention`` device span (``utils/profiling.py``): the card's time
from the first of their launches to the last, whatever kernels they are
(a remat recompute calls the forward again).

Heads wider than the widest fixed-width instance (``HEAD_DIMS[-1]`` = 256)
run on the head-chunked instances of the first designs
(``csrc/flash_chunked.cu``: ``flash_fwd_chunked``,
``flash_fwd_stream_chunked``, ``flash_bwd_{dq,dkv}_chunked`` and
``flash_bwd_{dq,dkv}_stream_chunked``), which walk the head in chunks of
``CHUNK`` columns and keep their float32 accumulators in a workspace in
device memory; ``kernel_head_dim`` pads such a head to a multiple of
``CHUNK``, so every width runs on the card.

Long sequences (T > ``STREAM_MAX_T``, the long-video buckets of
``configs/longvideo.yaml``) go to ``flash_forward_stream``, the counterpart of
the three long-T TPU forwards (``_flash_fwd_stream_kernel``,
``_flash_fwd_packed_stream_kernel``, ``_flash_fwd_hbm_kernel``), which one
kernel replaces: ``csrc/flash_fwd_stream.cu``. It runs the TPU stream
kernels' online-softmax recurrence over 64-key tiles and, packed, sweeps
only the key tiles ``[lo, hi)`` of each query tile's own videos
(``packed_block_bounds``); in bf16 at Dh 64 (``stream_tc``) that is
``flash_fwd_stream_tc``, the dense forward's wgmma kernel of
``csrc/flash_fwd.cu`` handed this sweep.

The sweeps, kvl and the key-tile bounds, depend only on ``key_valid``,
``seg_ids`` and T, so the model makes them once per batch
(``attention_sweep``, an ``AttentionSweep``) and hands the record to every
layer's forward and backward (the ``sweep`` argument of the wrappers); a call
without one makes its own.

On a CPU tensor each wrapper computes its plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repurpose_tpu_torch.ops.attention import NEG_INF, mha_torch
from repurpose_tpu_torch.utils.profiling import device_span

# LSE written for query rows past the last valid key: large enough that a
# backward's exp(s - lse) underflows to exactly 0, small enough to stay finite.
SKIP_LSE = 1e30

# Longest T served by the dense forward (``flash_fwd``); longer sequences take
# the streaming forward, as on the TPU (repurpose_tpu/ops/flash_attention.py:88).
STREAM_MAX_T = 2048
STREAM_TILE = 64  # query and key tile of csrc/flash_fwd_stream.cu
M_INIT = -1e30  # initial running max of the stream recurrence (finite: see fa:647)

HEAD_DIMS = (16, 32, 64, 128, 256)
CHUNK = 64  # head columns per chunk of the head-chunked kernels (csrc/flash_chunked.cu)
_SM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def kernel_head_dim(device: torch.device | str, head_dim: int) -> int:
    """The width ``FlashAttention`` runs a head of ``head_dim`` at: on the
    card the narrowest kernel instance in ``HEAD_DIMS`` that holds it and,
    past the widest, the next multiple of ``CHUNK`` (the head-chunked
    kernels; the head is zero-padded to it), on the CPU ``head_dim`` itself
    (the plain versions take every width)."""
    if torch.device(device).type != "cuda" or head_dim in HEAD_DIMS:
        return head_dim
    if head_dim > HEAD_DIMS[-1]:
        return -(-head_dim // CHUNK) * CHUNK
    return next(width for width in HEAD_DIMS if width > head_dim)


def head_chunked(q: torch.Tensor) -> bool:
    """Whether the kernels on CUDA tensors take their head-chunked instances
    (csrc/flash_chunked.cu): every head wider than ``HEAD_DIMS[-1]``."""
    return q.shape[-1] > HEAD_DIMS[-1]


def _scale(q: torch.Tensor, scale: float | None) -> float:
    """1/sqrt(Dh) of q, unless the caller gives the scale (a zero-padded head
    keeps its own)."""
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else scale


def _kv_len(key_valid: torch.Tensor) -> torch.Tensor:
    """[B, 1] int32: last valid key index + 1 per batch row (0 if none)."""
    t = key_valid.shape[1]
    idx = torch.arange(t, dtype=torch.int32, device=key_valid.device)[None, :]
    last = torch.where(key_valid, idx, -1).amax(dim=1) + 1
    return last.to(torch.int32)[:, None]


def flash_forward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32", *,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the TPU kernel's arithmetic over
    the whole key axis at once (the kernel's online softmax reaches the same
    values up to rounding)."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    qs = (q.float() * _scale(q, scale)).to(q.dtype)
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
    if dh not in HEAD_DIMS and not (dh > HEAD_DIMS[-1] and dh % CHUNK == 0):
        raise ValueError(f"head dim {dh}: neither in {HEAD_DIMS} nor a multiple of {CHUNK} "
                         f"past {HEAD_DIMS[-1]} (the head-chunked kernels)")
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


def _on_cuda(q, softmax_dtype: str, name: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if softmax_dtype not in _SM_DTYPES:
        raise ValueError(f"bad softmax_dtype: {softmax_dtype}")
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {q.device}")
    return True


def flash_forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32", *,
    scale: float | None = None, sweep: AttentionSweep | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v ``[B, T, H, Dh]`` -> (out ``[B, T, H, Dh]``, lse ``[B, H, T, 1]``).

    T <= ``STREAM_MAX_T`` runs the dense forward (``flash_fwd_dense``), longer
    T the streaming one (``flash_forward_stream``), unpacked and packed, each
    on ``sweep`` (``attention_sweep(key_valid, seg_ids)``, made here when not
    given). q/k/v may be strided views (e.g. the column slices of a fused
    QKV projection) as long as the head-dim axis is contiguous and rows start
    on 16-byte boundaries. ``scale`` replaces 1/sqrt(Dh) (a zero-padded
    head's own)."""
    if q.shape[1] > STREAM_MAX_T:
        return flash_forward_stream(q, k, v, key_valid, seg_ids, softmax_dtype, scale=scale,
                                    sweep=sweep)
    return flash_fwd_dense(q, k, v, key_valid, seg_ids, softmax_dtype, scale=scale, sweep=sweep)


def flash_fwd_dense(q, k, v, key_valid, seg_ids=None, softmax_dtype: str = "float32", *,
                    scale: float | None = None, sweep: AttentionSweep | None = None):
    """The dense forward at any T, counted in ``flash_forward.launches`` on
    CUDA tensors: where ``stream_tc(q)`` the tensor-core kernel
    (``flash_fwd_tc``) on the dense sweep ``sweep`` (``attention_sweep``
    with ``dense=True``, made here when not given), else the first design of
    csrc/flash_fwd.cu, which sweeps every key tile up to kvl (past Dh 256
    its head-chunked instance, ``flash_fwd_chunked``). On CPU tensors
    its plain version over every key (a given ``sweep`` is checked; on a
    row that attends a key the bounded sweep gives the same values).
    ``flash_forward`` takes it up to ``STREAM_MAX_T``."""
    if not _on_cuda(q, softmax_dtype, "flash_forward"):
        if sweep is not None:
            _sweep_for(key_valid, seg_ids, sweep, dense=True)
        return flash_forward_reference(q, k, v, key_valid, seg_ids, softmax_dtype, scale=scale)
    _check_cuda_inputs(q, k, v, key_valid, seg_ids)
    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    if stream_tc(q):
        flash_fwd_tc(q, k, v, key_valid, seg_ids, _sweep_for(key_valid, seg_ids, sweep, dense=True),
                     out, lse, softmax_dtype, _scale(q, scale))
    elif head_chunked(q):
        flash_fwd_chunked(q, k, v, key_valid, seg_ids,
                          _sweep_for(key_valid, seg_ids, sweep, dense=True), out, lse,
                          softmax_dtype, _scale(q, scale))
    else:
        err = native.load("flash_fwd").flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            key_valid.data_ptr(), _ptr(seg_ids), out.data_ptr(), lse.data_ptr(),
            b, t, h, dh, int(q.dtype == torch.bfloat16), int(softmax_dtype == "bfloat16"),
            _scale(q, scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    flash_forward.launches += 1
    return out, lse


def flash_fwd_tc(q, k, v, key_valid, seg_ids, sweep: AttentionSweep, out, lse,
                 softmax_dtype: str, scale: float) -> None:
    """Launches the tensor-core dense forward (``flash_fwd_tc_kernel`` of
    csrc/flash_fwd.cu, bf16 at Dh 64) on the checked inputs of
    ``flash_fwd_dense`` and its dense sweep into ``out`` / ``lse``; counted
    in ``flash_fwd_tc.launches`` (the caller counts it in
    ``flash_forward.launches`` too)."""
    _fwd_tc_launch(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype, scale)
    flash_fwd_tc.launches += 1


def _fwd_tc_launch(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype: str,
                   scale: float) -> None:
    """Calls ``flash_fwd_tc`` of csrc/flash_fwd.cu, the one kernel of the
    tensor-core forward with its LSE (csrc/flash_fwd_tc.cuh), on ``sweep``:
    the dense forward's and the long-T forward's, each with its own sweep."""
    import ctypes

    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))
    err = native.load("flash_fwd").flash_fwd_tc(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, key_valid.data_ptr(), _ptr(seg_ids),
        sweep.kvl.data_ptr(), _ptr(sweep.lo), _ptr(sweep.hi), out.data_ptr(), lse.data_ptr(),
        b, t, h, int(softmax_dtype == "bfloat16"), scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_tc kernel launch failed: CUDA error {err}")


def _workspace(q: torch.Tensor) -> torch.Tensor:
    """The float32 accumulator workspace [B, H, Tp, Dh] of a head-chunked
    kernel, Tp = T rounded up to 64 (every row is written before it is
    read)."""
    b, t, h, dh = q.shape
    tp = -(-t // STREAM_TILE) * STREAM_TILE
    return torch.empty((b, h, tp, dh), dtype=torch.float32, device=q.device)


def _fwd_chunked_launch(q, k, v, key_valid, seg_ids, sweep: AttentionSweep, out, lse,
                        softmax_dtype: str, scale: float, stream: bool) -> None:
    """Calls ``flash_fwd_chunked`` of csrc/flash_chunked.cu on the checked
    inputs of a forward wrapper and ``sweep``: with ``stream`` the stream
    forward's sweep and rounding points, else the dense forward's."""
    import ctypes

    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, k, v) for i in range(3)))
    workspace = _workspace(q)
    err = native.load("flash_chunked").flash_fwd_chunked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), strides, key_valid.data_ptr(), _ptr(seg_ids),
        sweep.kvl.data_ptr(), _ptr(sweep.lo), _ptr(sweep.hi), out.data_ptr(), lse.data_ptr(),
        workspace.data_ptr(), b, t, h, dh, int(q.dtype == torch.bfloat16),
        int(softmax_dtype == "bfloat16"), int(stream), scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_chunked kernel launch failed: CUDA error {err}")


def flash_fwd_chunked(q, k, v, key_valid, seg_ids, sweep: AttentionSweep, out, lse,
                      softmax_dtype: str, scale: float) -> None:
    """Launches the head-chunked dense forward (``flash_fwd_chunked_kernel``
    of csrc/flash_chunked.cu, every Dh past 256) on the checked inputs of
    ``flash_fwd_dense`` into ``out`` / ``lse``; counted in
    ``flash_fwd_chunked.launches`` (the caller counts it in
    ``flash_forward.launches`` too)."""
    _fwd_chunked_launch(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype, scale,
                        stream=False)
    flash_fwd_chunked.launches += 1


flash_forward.launches = 0  # kernel launches; the plain CPU path does not count
flash_fwd_tc.launches = 0  # the part of the above on the tensor-core kernel
flash_fwd_chunked.launches = 0  # the part of the above on the head-chunked kernel


# -- the sweep: kvl and the key-tile bounds, made once per batch -------------------


def packed_block_bounds(
    seg_ids: torch.Tensor, q_block: int, k_block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-tile bounds ``[lo, hi)`` per (batch row, query tile), each int32
    ``[B, ceil(T / q_block)]``: the smallest run of ``k_block``-key tiles
    holding every video that owns a row of the query tile (``_packed_block_bounds``,
    fa:486). Videos lie head to tail, so a position's video spans
    ``[start_of, end_of)``, a running max of video starts and a reverse
    running min of video ends (each run of an id counts as a video of its
    own, as on the TPU). A ragged last query tile counts as padding past T;
    a tile of padding only gets an empty range."""
    b, t = seg_ids.shape
    seg = seg_ids.long()
    t_idx = torch.arange(t, device=seg.device).expand(b, t)
    valid = seg >= 0
    edge = torch.full((b, 1), -2, dtype=seg.dtype, device=seg.device)
    is_start = valid & (seg != torch.cat([edge, seg[:, :-1]], dim=1))
    is_end = valid & (seg != torch.cat([seg[:, 1:], edge], dim=1))
    start_of = torch.cummax(torch.where(is_start, t_idx, 0), dim=1).values
    end_of = torch.cummin(torch.where(is_end, t_idx + 1, t).flip(1), dim=1).values.flip(1)
    return _tile_bounds(valid, start_of, end_of, q_block, k_block)


def segment_tile_bounds(
    seg_ids: torch.Tensor, q_block: int, k_block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-tile bounds ``[lo, hi)`` per (batch row, query tile), each int32
    ``[B, ceil(T / q_block)]``: the smallest run of ``k_block``-key tiles
    holding every position of each segment id (padding's included) that
    owns a row of the query tile, wherever the id's positions lie. The sweep
    of the dense backward's tensor-core pair, exact for any layout in the
    select form. Where each video is one run and padding follows the last
    valid key, as packing lays them, it sweeps what ``packed_block_bounds``
    sweeps before kvl."""
    b, t = seg_ids.shape
    # each id's slot; ids a multiple of T + 1 apart share one, which only
    # widens their spans (the sweep stays exact)
    slot = torch.remainder(seg_ids.long(), t + 1)
    pos = torch.arange(t, device=seg_ids.device).expand(b, t)
    first = torch.full((b, t + 1), t, dtype=torch.long, device=seg_ids.device)
    last = torch.full((b, t + 1), -1, dtype=torch.long, device=seg_ids.device)
    first.scatter_reduce_(1, slot, pos, "amin")
    last.scatter_reduce_(1, slot, pos, "amax")
    return _tile_bounds(torch.ones_like(pos, dtype=torch.bool), first.gather(1, slot),
                        last.gather(1, slot) + 1, q_block, k_block)


def _tile_bounds(valid, start_of, end_of, q_block: int, k_block: int):
    """lo / hi of the two functions above from each position's key span
    ``[start_of, end_of)``, over the positions ``valid`` marks. A ragged last
    query tile counts as padding past T; a tile with no marked row gets an
    empty range."""
    b, t = valid.shape
    nqb = -(-t // q_block)
    pad = (0, nqb * q_block - t)
    lo_pos = torch.nn.functional.pad(torch.where(valid, start_of, t), pad, value=t)
    hi_pos = torch.nn.functional.pad(torch.where(valid, end_of, 0), pad, value=0)
    lo = lo_pos.view(b, nqb, q_block).amin(-1) // k_block
    hi = -(-hi_pos.view(b, nqb, q_block).amax(-1) // k_block)
    return lo.to(torch.int32), torch.maximum(hi, lo).to(torch.int32)


class AttentionSweep(NamedTuple):
    """The key tiles each 64-row query tile of a batch sweeps, for every
    attention kernel that takes a bounded sweep (the tensor-core forwards,
    the backward's prep, the first-design stream kernels). It depends only
    on ``key_valid``, ``seg_ids`` and T, so the model makes it once per
    batch (``attention_sweep``) for all its layers, forward and backward."""

    kvl: torch.Tensor  # [B] int32: last valid key + 1 (``_kv_len``)
    lo: torch.Tensor | None  # [B, ceil(T / 64)] int32, packed: first key tile, else None
    hi: torch.Tensor | None  # one past the last, at most ceil(kvl / 64)
    dense: bool  # lo / hi from segment_tile_bounds (True) or packed_block_bounds


def attention_sweep(key_valid: torch.Tensor, seg_ids: torch.Tensor | None = None,
                    dense: bool | None = None) -> AttentionSweep:
    """The sweep of these inputs at 64/64 tiles, on their device and with no
    host sync: each query tile sweeps key tiles ``[0, ceil(kvl / 64))``
    unpacked and ``[lo, hi)`` packed, hi clamped to ``ceil(kvl / 64)``:
    with ``dense`` (by default T <= ``STREAM_MAX_T``, the dense kernels')
    ``segment_tile_bounds``, else the stream kernels' ``packed_block_bounds``
    (the TPU kernels' scalar-prefetch operands)."""
    if dense is None:
        dense = key_valid.shape[1] <= STREAM_MAX_T
    kvl = _kv_len(key_valid)[:, 0].contiguous()
    if seg_ids is None:
        return AttentionSweep(kvl, None, None, dense)
    lo, hi = (segment_tile_bounds if dense else packed_block_bounds)(seg_ids, STREAM_TILE,
                                                                     STREAM_TILE)
    n_live = (kvl + STREAM_TILE - 1) // STREAM_TILE
    return AttentionSweep(kvl, lo.contiguous(), torch.minimum(hi, n_live[:, None]).contiguous(),
                          dense)


def _sweep_for(key_valid, seg_ids, sweep: AttentionSweep | None, dense: bool) -> AttentionSweep:
    """``sweep``, checked to be the ``dense`` (else the stream) sweep of
    inputs of this shape and device, or ``attention_sweep`` of these inputs
    when None. Raises on a record that cannot belong to them."""
    if sweep is None:
        return attention_sweep(key_valid, seg_ids, dense)
    b, t = key_valid.shape
    parts = [(sweep.kvl, (b,))] + [(x, (b, -(-t // STREAM_TILE))) for x in (sweep.lo, sweep.hi)
                                   if x is not None]
    if (sweep.dense != dense or (sweep.lo is None) != (seg_ids is None)
            or (sweep.hi is None) != (seg_ids is None)
            or not all(x.shape == shape and x.dtype == torch.int32 and x.is_contiguous()
                       and x.device == key_valid.device for x, shape in parts)):
        raise ValueError(f"sweep: not the {'dense' if dense else 'stream'} sweep of inputs "
                         f"[{b}, {t}] on {key_valid.device} (attention_sweep)")
    return sweep


def _tile_ranges(sweep: AttentionSweep, t: int):
    """lo, hi ``[B, ceil(T / 64)]`` long: the key tiles of each query tile."""
    if sweep.lo is not None:
        return sweep.lo.long(), sweep.hi.long()
    n_live = (sweep.kvl.long() + STREAM_TILE - 1) // STREAM_TILE
    hi = n_live[:, None].expand(-1, -(-t // STREAM_TILE))
    return torch.zeros_like(hi), hi


# -- long T: the streaming forward ---------------------------------------------


def _stream_ranges(key_valid: torch.Tensor, seg_ids: torch.Tensor | None,
                   sweep: AttentionSweep | None = None):
    """The sweep of the stream kernels as the plain versions loop over it:
    kvl per batch row (a list) and, per batch row, the key-tile range
    ``[lo, hi)`` of each 64-row tile (two long ``[n_tiles]`` tensors), from
    ``sweep`` (the stream sweep, made here when None)."""
    sweep = _sweep_for(key_valid, seg_ids, sweep, dense=False)
    lo, hi = _tile_ranges(sweep, key_valid.shape[1])
    return sweep.kvl.tolist(), list(zip(lo, hi))


def _stream_keys(b_idx, k, v, key_valid, seg_ids, tp):
    """Keys of batch row ``b_idx`` padded to ``tp``: k, v ``[H, Tp, Dh]``
    float32, key_valid and seg_ids (-1) ``[Tp]``, and whether a key exists."""
    t = k.shape[1]
    pad_rows = (0, 0, 0, 0, 0, tp - t)
    k_b = torch.nn.functional.pad(k[b_idx], pad_rows).float().permute(1, 0, 2)
    v_b = torch.nn.functional.pad(v[b_idx], pad_rows).float().permute(1, 0, 2)
    ok_key = torch.nn.functional.pad(key_valid[b_idx], (0, tp - t))
    seg_k = (None if seg_ids is None
             else torch.nn.functional.pad(seg_ids[b_idx], (0, tp - t), value=-1))
    return k_b, v_b, ok_key, seg_k, torch.arange(tp, device=k.device) < t


def flash_forward_stream_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
    q_chunk: int = 4096, k_chunk: int = 8192, *,
    scale: float | None = None, sweep: AttentionSweep | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streaming kernel: the online-softmax
    recurrence of the TPU stream kernels (fa:623-654) over ``STREAM_TILE``-key
    tiles, with their rounding points:

    - s = q_s k^T in float32 plus the -1e9 bias, rounded to the softmax dtype;
    - m_new = max(m, max(s)) in float32, from ``M_INIT``;
    - alpha = exp(m - m_new) in float32;
    - p = exp(s - m_new rounded to the softmax dtype), in the softmax dtype;
    - l = l alpha + sum(p) and acc = acc alpha + round_v(p) v, in float32;
    - out = acc / l, lse = m + log(l).

    Each query tile of ``STREAM_TILE`` rows sweeps key tiles ``[0, ceil(kvl /
    64))`` unpacked and ``[lo, min(hi, ceil(kvl / 64)))`` packed
    (``packed_block_bounds``; ``sweep``, made here when None); keys past T
    do not exist (p = 0). Rows at or
    past kvl, and tiles with an empty range, get out = 0 and lse =
    ``SKIP_LSE``. The loop runs over ``q_chunk`` query rows and ``k_chunk``
    keys at a time, so the live score block stays near H * q_chunk * k_chunk
    floats (1 GB at 8 heads); within a key chunk the running max is a
    cumulative max over its tiles, which gives each tile the max the
    sequential sweep would have."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = _scale(q, scale)
    dev = q.device
    q_block = k_block = STREAM_TILE  # the kernel's tiles
    tp = -(-t // k_block) * k_block
    q_chunk = max(q_block, q_chunk // q_block * q_block)
    tiles_per_chunk = max(1, k_chunk // k_block)
    kvl, ranges = _stream_ranges(key_valid, seg_ids, sweep)
    out = torch.zeros((b, t, h, dh), dtype=q.dtype, device=dev)
    lse = torch.full((b, h, t, 1), SKIP_LSE, dtype=torch.float32, device=dev)
    for bi in range(b):
        tile_lo, tile_hi = ranges[bi]
        k_b, v_b, ok_key, seg_k, key_exists = _stream_keys(bi, k, v, key_valid, seg_ids, tp)
        for r0 in range(0, kvl[bi], q_chunk):
            r1 = min(r0 + q_chunk, kvl[bi])
            tile = torch.arange(r0, r1, device=dev) // q_block
            row_lo, row_hi = tile_lo[tile], tile_hi[tile]  # [R]
            live = row_lo < row_hi
            if not bool(live.any()):
                continue
            kt0, kt1 = int(row_lo[live].min()), int(row_hi[live].max())
            n_rows = r1 - r0
            qs = (q[bi, r0:r1].float() * scale).to(q.dtype).float().permute(1, 0, 2)
            m = torch.full((h, n_rows), M_INIT, dtype=torch.float32, device=dev)
            l = torch.zeros((h, n_rows), dtype=torch.float32, device=dev)
            acc = torch.zeros((h, n_rows, dh), dtype=torch.float32, device=dev)
            for c0 in range(kt0, kt1, tiles_per_chunk):
                c1 = min(c0 + tiles_per_chunk, kt1)
                n, j0, j1 = c1 - c0, c0 * k_block, c1 * k_block
                s = torch.matmul(qs, k_b[:, j0:j1].transpose(1, 2))  # [H, R, K] float32
                ok = ok_key[None, j0:j1]
                if seg_ids is not None:
                    ok = ok & (seg_ids[bi, r0:r1, None] == seg_k[None, j0:j1])
                s += torch.where(ok, 0.0, NEG_INF)
                s = s.masked_fill(~key_exists[j0:j1], float("-inf"))
                s = s.to(sm_dtype).view(h, n_rows, n, k_block)
                tiles = torch.arange(c0, c1, device=dev)
                active = (row_lo[:, None] <= tiles) & (tiles < row_hi[:, None])  # [R, n]
                t_max = s.amax(-1).float().masked_fill(~active, float("-inf"))
                m_run = torch.maximum(torch.cummax(t_max, dim=-1).values, m[..., None])
                p = torch.exp(s - m_run.to(sm_dtype)[..., None])
                p = p.masked_fill(~active[None, :, :, None], 0.0)
                m_new = m_run[..., -1]
                w = torch.exp(m_run - m_new[..., None])  # rescale of each tile to m_new
                alpha = torch.exp(m - m_new)
                l = l * alpha + (p.sum(-1, dtype=torch.float32) * w).sum(-1)
                pw = (p.to(v.dtype).float() * w[..., None]).view(h, n_rows, n * k_block)
                acc = acc * alpha[..., None] + torch.matmul(pw, v_b[:, j0:j1])
                m = m_new
                del s, p, pw
            o = (acc / l[..., None]).permute(1, 0, 2)  # [R, H, Dh]
            out[bi, r0:r1][live] = o[live].to(q.dtype)
            lse[bi, :, r0:r1, 0][:, live] = (m + torch.log(l))[:, live]
    return out, lse


def stream_tc(q: torch.Tensor) -> bool:
    """Whether the kernels on CUDA tensors take their tensor-core design:
    bf16 at Dh 64, the model's shape, under either softmax interior
    (``flash_fwd_tc`` / ``flash_fwd_stream_tc``; the backward, dense and
    streaming, after ``flash_bwd_stream_prep``). float32 (which would lose
    its parity on TF32 tensor cores) and bf16 at Dh 16, 32 and 128 keep the
    first kernels of csrc/flash_fwd.cu, csrc/flash_fwd_stream.cu,
    csrc/flash_bwd.cu and csrc/flash_bwd_stream.cu."""
    return q.dtype == torch.bfloat16 and q.shape[-1] == 64


def flash_fwd_stream_tc(q, k, v, key_valid, seg_ids, sweep: AttentionSweep, out, lse,
                        softmax_dtype: str, scale: float) -> None:
    """Launches the tensor-core streaming forward (``flash_fwd_tc_kernel``
    of csrc/flash_fwd.cu, bf16 at Dh 64, the dense forward's kernel) on the
    checked inputs of ``flash_forward_stream`` and its stream sweep into
    ``out`` / ``lse``; counted in ``flash_fwd_stream_tc.launches`` (the
    caller counts it in ``flash_forward_stream.launches`` too)."""
    _fwd_tc_launch(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype, scale)
    flash_fwd_stream_tc.launches += 1


def flash_fwd_stream_chunked(q, k, v, key_valid, seg_ids, sweep: AttentionSweep, out, lse,
                             softmax_dtype: str, scale: float) -> None:
    """Launches the head-chunked streaming forward (``flash_fwd_chunked_kernel``
    of csrc/flash_chunked.cu with the stream sweep) on the checked inputs of
    ``flash_forward_stream``; counted in ``flash_fwd_stream_chunked.launches``
    (the caller counts it in ``flash_forward_stream.launches`` too)."""
    _fwd_chunked_launch(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype, scale,
                        stream=True)
    flash_fwd_stream_chunked.launches += 1


flash_fwd_stream_tc.launches = 0  # kernel launches; the plain CPU path does not count
flash_fwd_stream_chunked.launches = 0


def flash_forward_stream(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32", *,
    scale: float | None = None, sweep: AttentionSweep | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming forward, same contract as ``flash_forward``: a kernel
    on CUDA tensors (counted in ``flash_forward_stream.launches``), the
    tensor-core one (``flash_fwd_stream_tc``) where ``stream_tc(q)``, else
    the first design of csrc/flash_fwd_stream.cu (past Dh 256 its
    head-chunked instance, ``flash_fwd_stream_chunked``);
    ``flash_forward_stream_reference`` on CPU ones. Each takes kvl and,
    packed, the tile bounds from ``sweep`` (the stream sweep of
    ``attention_sweep``, made here when not given: the TPU kernels'
    scalar-prefetch operands)."""
    if not _on_cuda(q, softmax_dtype, "flash_forward_stream"):
        return flash_forward_stream_reference(q, k, v, key_valid, seg_ids, softmax_dtype,
                                              scale=scale, sweep=sweep)
    _check_cuda_inputs(q, k, v, key_valid, seg_ids)
    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    sweep = _sweep_for(key_valid, seg_ids, sweep, dense=False)
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    if stream_tc(q):
        flash_fwd_stream_tc(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype,
                            _scale(q, scale))
    elif head_chunked(q):
        flash_fwd_stream_chunked(q, k, v, key_valid, seg_ids, sweep, out, lse, softmax_dtype,
                                 _scale(q, scale))
    else:
        err = native.load("flash_fwd_stream").flash_fwd_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            key_valid.data_ptr(), _ptr(seg_ids), sweep.kvl.data_ptr(), _ptr(sweep.lo),
            _ptr(sweep.hi), out.data_ptr(), lse.data_ptr(), b, t, h, dh,
            int(q.dtype == torch.bfloat16),
            int(softmax_dtype == "bfloat16"), _scale(q, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"flash_fwd_stream kernel launch failed: CUDA error {err}")
    flash_forward_stream.launches += 1
    return out, lse


flash_forward_stream.launches = 0  # kernel launches; the plain CPU path does not count


def _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, scale):
    """(q_s, p, ds) of the plain backward: the TPU kernels' rounding points
    over the whole key axis at once."""
    sm_dtype = _SM_DTYPES[softmax_dtype]
    qs = (q.float() * _scale(q, scale)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    ok = key_valid[:, None, None, :]
    if seg_ids is not None:
        # select form: masked entries are chosen away after the exp (which
        # may overflow there), never multiplied by a mask
        ok = ok & (seg_ids[:, None, :, None] == seg_ids[:, None, None, :])
        p = torch.where(ok, torch.exp((s - lse).to(sm_dtype)), 0.0)
    else:
        p = torch.exp((s + torch.where(ok, 0.0, NEG_INF) - lse).to(sm_dtype))
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    delta = (g.float() * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [B, H, T, 1]
    ds = p * (dp - delta).to(sm_dtype)
    return qs, p, ds


def _zero_past_kv_len(x: torch.Tensor, key_valid: torch.Tensor) -> torch.Tensor:
    skip = torch.arange(x.shape[1], device=x.device)[None, :] >= _kv_len(key_valid)
    return x.masked_fill(skip[:, :, None, None], 0.0)


def flash_bwd_dq_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                           softmax_dtype: str = "float32", *,
                           scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel."""
    _, _, ds = _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * _scale(q, scale)
    return _zero_past_kv_len(dq.to(q.dtype), key_valid)


def flash_bwd_dkv_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                            softmax_dtype: str = "float32", *, scale: float | None = None):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv)."""
    qs, p, ds = _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    return (_zero_past_kv_len(dk.to(k.dtype), key_valid),
            _zero_past_kv_len(dv.to(v.dtype), key_valid))


def flash_backward_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                             softmax_dtype: str = "float32", *, scale: float | None = None):
    """Plain PyTorch version of both backward kernels: (dq, dk, dv)."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dq = flash_bwd_dq_reference(*args, scale=scale)
    dk, dv = flash_bwd_dkv_reference(*args, scale=scale)
    return dq, dk, dv


def _check_bwd_inputs(q, k, v, key_valid, o, lse, g, seg_ids) -> None:
    """Raises on inputs no backward kernel takes."""
    _check_cuda_inputs(q, k, v, key_valid, seg_ids)
    for x_name, x in (("o", o), ("g", g)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{x_name} {x.shape} {x.dtype} {x.device} does not match "
                             f"q {q.shape} {q.dtype} {q.device}")
        item = x.element_size()
        if x.stride(3) != 1 or x.data_ptr() % 16 or any(
            (x.stride(i) * item) % 16 for i in range(3)
        ):
            raise ValueError(f"{x_name}: contiguous head-dim axis and 16-byte rows needed")
    b, t, h, dh = q.shape
    if (lse.dtype != torch.float32 or lse.shape != (b, h, t, 1)
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous float32 [{b}, {h}, {t}, 1] on {q.device}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _bwd_launch(name: str, q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, scale,
                outs, sweep: AttentionSweep | None = None):
    """Checks the inputs and launches kernel ``name`` of csrc/flash_bwd.cu
    or, for a ``*_stream`` name, of csrc/flash_bwd_stream.cu, into the
    preallocated ``outs``. A stream kernel also gets kvl and, packed, the
    64/64 tile bounds of the stream sweep ``sweep`` (made here when None)."""
    import ctypes

    _check_bwd_inputs(q, k, v, key_valid, o, lse, g, seg_ids)
    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    stream_kernel = name.endswith("_stream")
    lib = native.load("flash_bwd_stream" if stream_kernel else "flash_bwd")
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (q, k, v, g, o) for i in range(3))
    )
    bounds = ()
    if stream_kernel:
        bounds = tuple(_ptr(x) for x in _sweep_for(key_valid, seg_ids, sweep, dense=False)[:3])
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(), strides,
        key_valid.data_ptr(), None if seg_ids is None else seg_ids.data_ptr(), *bounds,
        lse.data_ptr(), *(x.data_ptr() for x in outs),
        b, t, h, dh, int(q.dtype == torch.bfloat16), int(softmax_dtype == "bfloat16"),
        _scale(q, scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _bwd_chunked_launch(name: str, q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype,
                        scale, outs, sweep: AttentionSweep | None, stream: bool) -> None:
    """Checks the inputs and launches ``name`` (``flash_bwd_dq_chunked`` or
    ``flash_bwd_dkv_chunked`` of csrc/flash_chunked.cu) into the
    preallocated ``outs``, with a float32 workspace per output: with
    ``stream`` on the stream sweep ``sweep`` in the bias form, else as the
    dense backward (every key to kvl; select form when packed). ``sweep`` is
    made here when None."""
    import ctypes

    _check_bwd_inputs(q, k, v, key_valid, o, lse, g, seg_ids)
    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    sweep = _sweep_for(key_valid, seg_ids, sweep, dense=not stream)
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (q, k, v, g, o) for i in range(3))
    )
    workspaces = [_workspace(q) for _ in outs]
    err = getattr(native.load("flash_chunked"), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(), strides,
        key_valid.data_ptr(), _ptr(seg_ids), sweep.kvl.data_ptr(), _ptr(sweep.lo),
        _ptr(sweep.hi), lse.data_ptr(), *(x.data_ptr() for x in outs),
        *(x.data_ptr() for x in workspaces), b, t, h, dh, int(q.dtype == torch.bfloat16),
        int(softmax_dtype == "bfloat16"), int(stream), _scale(q, scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_bwd_dq_chunked(*args, dq, sweep=None) -> None:
    """Launches the head-chunked dq kernel (``flash_bwd_dq_chunked_kernel``
    of csrc/flash_chunked.cu, every Dh past 256) as the dense backward on
    ``args`` (``flash_bwd_dq``'s, the scale last) into ``dq``; counted in
    ``flash_bwd_dq_chunked.launches`` (the caller counts it in
    ``flash_bwd_dq.launches`` too)."""
    _bwd_chunked_launch("flash_bwd_dq_chunked", *args, (dq,), sweep, stream=False)
    flash_bwd_dq_chunked.launches += 1


def flash_bwd_dkv_chunked(*args, dk, dv, sweep=None) -> None:
    """The head-chunked dk/dv kernel (``flash_bwd_dkv_chunked_kernel``) as
    the dense backward, as ``flash_bwd_dq_chunked``; counted in
    ``flash_bwd_dkv_chunked.launches``."""
    _bwd_chunked_launch("flash_bwd_dkv_chunked", *args, (dk, dv), sweep, stream=False)
    flash_bwd_dkv_chunked.launches += 1


def flash_bwd_dq_stream_chunked(*args, dq, sweep=None) -> None:
    """The head-chunked dq kernel as the streaming backward (the stream
    sweep, the bias form); counted in ``flash_bwd_dq_stream_chunked.launches``
    (the caller counts it in ``flash_bwd_dq_stream.launches`` too)."""
    _bwd_chunked_launch("flash_bwd_dq_chunked", *args, (dq,), sweep, stream=True)
    flash_bwd_dq_stream_chunked.launches += 1


def flash_bwd_dkv_stream_chunked(*args, dk, dv, sweep=None) -> None:
    """The head-chunked dk/dv kernel as the streaming backward; counted in
    ``flash_bwd_dkv_stream_chunked.launches``."""
    _bwd_chunked_launch("flash_bwd_dkv_chunked", *args, (dk, dv), sweep, stream=True)
    flash_bwd_dkv_stream_chunked.launches += 1


def flash_bwd_dq(q, k, v, key_valid, o, lse, g, seg_ids=None,
                 softmax_dtype: str = "float32", prep: StreamPrep | None = None, *,
                 scale: float | None = None, sweep: AttentionSweep | None = None) -> torch.Tensor:
    """dq ``[B, T, H, Dh]`` in q's dtype (contiguous), the dense backward at
    any T: on CUDA tensors a kernel of csrc/flash_bwd.cu (counted in
    ``flash_bwd_dq.launches``), the tensor-core one (``flash_bwd_dq_tc``) on
    ``prep`` (the outputs of ``flash_bwd_stream_prep`` with ``dense=True``,
    run here on ``sweep`` when not given) where ``stream_tc(q)``, the
    head-chunked one (``flash_bwd_dq_chunked``, on ``sweep``'s kvl) past Dh
    256; ``flash_bwd_dq_reference`` on CPU ones. ``flash_backward`` takes it up
    to ``STREAM_MAX_T``."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dq"):
        return flash_bwd_dq_reference(*args, scale=scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if stream_tc(q):
        if prep is None:
            prep = flash_bwd_stream_prep(*args[:-1], scale=scale, dense=True, sweep=sweep)
        flash_bwd_dq_tc(q, k, v, g, softmax_dtype, scale, prep, dq)
    elif head_chunked(q):
        flash_bwd_dq_chunked(*args, scale, dq=dq, sweep=sweep)
    else:
        _bwd_launch("flash_bwd_dq", *args, scale, (dq,))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, key_valid, o, lse, g, seg_ids=None,
                  softmax_dtype: str = "float32", prep: StreamPrep | None = None, *,
                  scale: float | None = None, sweep: AttentionSweep | None = None):
    """(dk, dv), each ``[B, T, H, Dh]`` in the input dtype (contiguous), the
    dense backward at any T: on CUDA tensors a kernel of csrc/flash_bwd.cu
    (counted in ``flash_bwd_dkv.launches``), the tensor-core one
    (``flash_bwd_dkv_tc``) on ``prep`` as for ``flash_bwd_dq``;
    ``flash_bwd_dkv_reference`` on CPU ones."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dkv"):
        return flash_bwd_dkv_reference(*args, scale=scale)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if stream_tc(q):
        if prep is None:
            prep = flash_bwd_stream_prep(*args[:-1], scale=scale, dense=True, sweep=sweep)
        flash_bwd_dkv_tc(q, k, v, g, softmax_dtype, scale, prep, dk, dv)
    elif head_chunked(q):
        flash_bwd_dkv_chunked(*args, scale, dk=dk, dv=dv, sweep=sweep)
    else:
        _bwd_launch("flash_bwd_dkv", *args, scale, (dk, dv))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq_tc(q, k, v, g, softmax_dtype: str, scale, prep: StreamPrep, dq) -> None:
    """Launches the tensor-core dq kernel (``flash_bwd_dq_tc_kernel`` of
    csrc/flash_bwd.cu, bf16 at Dh 64) as the dense backward, in the select
    form, on ``prep`` into ``dq``; counted in ``flash_bwd_dq_tc.launches``
    (the caller counts it in ``flash_bwd_dq.launches`` too)."""
    _tc_launch("flash_bwd_dq_tc", q, k, v, g, softmax_dtype, scale, prep, (dq,), dense=True)
    flash_bwd_dq_tc.launches += 1


def flash_bwd_dkv_tc(q, k, v, g, softmax_dtype: str, scale, prep: StreamPrep, dk, dv) -> None:
    """Launches the tensor-core dk/dv kernel (``flash_bwd_dkv_tc_kernel`` of
    csrc/flash_bwd.cu) as ``flash_bwd_dq_tc`` does; counted in
    ``flash_bwd_dkv_tc.launches``."""
    _tc_launch("flash_bwd_dkv_tc", q, k, v, g, softmax_dtype, scale, prep, (dk, dv),
               dense=True)
    flash_bwd_dkv_tc.launches += 1


flash_bwd_dq.launches = 0  # kernel launches; the plain CPU path does not count
flash_bwd_dkv.launches = 0
flash_bwd_dq_tc.launches = 0  # the part of the above on the tensor-core kernels
flash_bwd_dkv_tc.launches = 0  # (the stream wrappers' launches of them are not counted here)
flash_bwd_dq_chunked.launches = 0  # the part of the above on the head-chunked kernels
flash_bwd_dkv_chunked.launches = 0


# -- long T: the streaming backward ----------------------------------------------


def _stream_probs(qs, gf, delta, lse, kc, vc, ok, active, sm_dtype):
    """(p, ds) ``[H, R, K]`` of the TPU stream kernels for query rows
    (``qs``, ``gf`` ``[H, R, Dh]`` float32, ``delta``, ``lse`` ``[H, R, 1]``)
    against keys ``kc``/``vc`` ``[H, K, Dh]`` float32, in the bias form
    (fa:891-903, 1257-1272): p = exp(R(s + bias - lse)), ds = p R(dp - delta),
    R the softmax dtype. ``ok`` ([R or 1, K]) chooses the bias, ``active``
    ([R, K]) the pairs of the sweep; others get p = ds = 0."""
    s = torch.matmul(qs, kc.transpose(1, 2))
    p = torch.exp((s + torch.where(ok, 0.0, NEG_INF) - lse).to(sm_dtype))
    p = p.masked_fill(~active, 0.0)
    ds = p * (torch.matmul(gf, vc.transpose(1, 2)) - delta).to(sm_dtype)
    return p, ds


def _stream_rows(b_idx, r0, r1, q, o, lse, g, scale):
    """float32 ``[H, R, *]`` operands of query rows r0..r1 of batch row
    ``b_idx``: q scaled and rounded to its dtype, g, delta = rowsum(g o), lse."""
    qs = (q[b_idx, r0:r1].float() * scale).to(q.dtype).float().permute(1, 0, 2)
    gf = g[b_idx, r0:r1].float().permute(1, 0, 2)
    delta = (gf * o[b_idx, r0:r1].float().permute(1, 0, 2)).sum(-1, keepdim=True)
    return qs, gf, delta, lse[b_idx, :, r0:r1]


def flash_bwd_dq_stream_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                                  softmax_dtype: str = "float32", q_chunk: int = 4096,
                                  k_chunk: int = 4096, *, scale: float | None = None,
                                  sweep: AttentionSweep | None = None) -> torch.Tensor:
    """Plain PyTorch version of the streaming dq kernel: the TPU kernels
    ``_bwd_dq_stream_kernel``, ``_bwd_dq_packed_stream_kernel`` and
    ``_bwd_dq_hbm_kernel`` (fa:859-1103) at 64-key tiles. dq accumulates in
    float32 over the key tiles of each 64-row query tile's sweep (``[0,
    ceil(kvl / 64))``, packed ``[lo, min(hi, ceil(kvl / 64)))``: the stream
    sweep ``sweep``, made here when None), every
    tile normalised by the saved lse with no running max; ds is rounded to
    k's dtype for the product and dq = scale * sum in q's dtype. Query rows
    at or past kvl, and tiles with an empty range, get 0. The loop runs over
    ``q_chunk`` query rows and ``k_chunk`` keys at a time (a few GB live at
    T = 32768, 8 heads)."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = _scale(q, scale)
    tile = STREAM_TILE
    tp = -(-t // tile) * tile
    q_chunk = max(tile, q_chunk // tile * tile)
    tiles_per_chunk = max(1, k_chunk // tile)
    kvl, ranges = _stream_ranges(key_valid, seg_ids, sweep)
    dq = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
    for bi in range(b):
        tile_lo, tile_hi = ranges[bi]
        k_b, v_b, ok_key, seg_k, key_exists = _stream_keys(bi, k, v, key_valid, seg_ids, tp)
        for r0 in range(0, kvl[bi], q_chunk):
            r1 = min(r0 + q_chunk, kvl[bi])
            row_tile = torch.arange(r0, r1, device=q.device) // tile
            row_lo, row_hi = tile_lo[row_tile], tile_hi[row_tile]  # [R]
            live = row_lo < row_hi
            if not bool(live.any()):
                continue
            qs, gf, delta, lse_r = _stream_rows(bi, r0, r1, q, o, lse, g, scale)
            acc = torch.zeros((h, r1 - r0, dh), dtype=torch.float32, device=q.device)
            kt0, kt1 = int(row_lo[live].min()), int(row_hi[live].max())
            for c0 in range(kt0, kt1, tiles_per_chunk):
                j0, j1 = c0 * tile, min(c0 + tiles_per_chunk, kt1) * tile
                key_tile = torch.arange(j0, j1, device=q.device) // tile
                active = ((row_lo[:, None] <= key_tile) & (key_tile < row_hi[:, None])
                          & key_exists[j0:j1])
                ok = ok_key[None, j0:j1]
                if seg_k is not None:
                    ok = ok & (seg_ids[bi, r0:r1, None] == seg_k[None, j0:j1])
                _, ds = _stream_probs(qs, gf, delta, lse_r, k_b[:, j0:j1], v_b[:, j0:j1],
                                      ok, active, sm_dtype)
                acc += torch.matmul(ds.to(k.dtype).float(), k_b[:, j0:j1])
                del ds
            dq_rows = (acc * scale).permute(1, 0, 2).to(q.dtype)
            dq[bi, r0:r1][live] = dq_rows[live]
    return dq


def flash_bwd_dkv_stream_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                                   softmax_dtype: str = "float32", q_chunk: int = 4096,
                                   k_chunk: int = 4096, *, scale: float | None = None,
                                   sweep: AttentionSweep | None = None):
    """Plain PyTorch version of the streaming dk/dv kernel: the TPU kernel
    ``_bwd_dkv_stream_kernel`` (fa:1200-1282) at 64-row tiles, (dk, dv).
    Each 64-key tile accumulates in float32 over the query tiles that meet
    its videos: ``[0, ceil(kvl / 64))`` unpacked and, packed, ``[lo,
    min(hi, ceil(kvl / 64)))`` of the key tile's own ``packed_block_bounds``
    (the mask seg_q == seg_k is symmetric, so at 64/64 tiles these are the
    query tiles whose videos overlap the key tile, the TPU's lo <= ki < hi).
    dv += round_g(p)^T g and dk += round_q(ds)^T q_s. Key rows at or past
    kvl, and key tiles with an empty range, get 0. The loop runs over
    ``k_chunk`` keys and ``q_chunk`` query rows at a time."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = _scale(q, scale)
    tile = STREAM_TILE
    tp = -(-t // tile) * tile
    q_chunk = max(tile, q_chunk // tile * tile)
    k_chunk = max(tile, k_chunk // tile * tile)
    kvl, ranges = _stream_ranges(key_valid, seg_ids, sweep)
    dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    for bi in range(b):
        tile_lo, tile_hi = ranges[bi]  # query tiles per key tile
        k_b, v_b, ok_key, seg_k, key_exists = _stream_keys(bi, k, v, key_valid, seg_ids, tp)
        for j0 in range(0, kvl[bi], k_chunk):
            j1 = min(j0 + k_chunk, -(-kvl[bi] // tile) * tile)
            key_tile = torch.arange(j0, j1, device=k.device) // tile
            col_lo, col_hi = tile_lo[key_tile], tile_hi[key_tile]  # [K]
            live = col_lo < col_hi
            if not bool(live.any()):
                continue
            acc_k = torch.zeros((h, j1 - j0, dh), dtype=torch.float32, device=k.device)
            acc_v = torch.zeros_like(acc_k)
            r_end = min(int(col_hi[live].max()) * tile, t)
            for r0 in range(int(col_lo[live].min()) * tile, r_end, q_chunk):
                r1 = min(r0 + q_chunk, r_end)
                row_tile = torch.arange(r0, r1, device=k.device) // tile
                active = ((col_lo <= row_tile[:, None]) & (row_tile[:, None] < col_hi)
                          & key_exists[j0:j1])
                ok = ok_key[None, j0:j1]
                if seg_k is not None:
                    ok = ok & (seg_ids[bi, r0:r1, None] == seg_k[None, j0:j1])
                qs, gf, delta, lse_r = _stream_rows(bi, r0, r1, q, o, lse, g, scale)
                p, ds = _stream_probs(qs, gf, delta, lse_r, k_b[:, j0:j1], v_b[:, j0:j1],
                                      ok, active, sm_dtype)
                acc_v += torch.matmul(p.to(g.dtype).float().transpose(1, 2), gf)
                acc_k += torch.matmul(ds.to(q.dtype).float().transpose(1, 2), qs)
                del p, ds
            rows = min(j1, kvl[bi]) - j0  # keys at or past kvl stay 0
            dk[bi, j0:j0 + rows] = acc_k[:, :rows].permute(1, 0, 2).to(k.dtype)
            dv[bi, j0:j0 + rows] = acc_v[:, :rows].permute(1, 0, 2).to(v.dtype)
    return dk, dv


class StreamPrep(NamedTuple):
    """Everything the tensor-core backward kernels (dense and streaming) read
    besides k, v and g, made once per backward by ``flash_bwd_stream_prep``;
    Tp = T rounded up to 64."""

    qs: torch.Tensor  # [B, T, H, Dh] q's dtype: round(float(q) * scale)
    rows: torch.Tensor  # [B, H, Tp, 2] float32: (lse, delta = rowsum(g o))
    info: torch.Tensor  # [B, Tp, 2] int32: (key flag 1 / 0 / -1 past T, segment)
    kvl: torch.Tensor  # [B] int32 (of an ``AttentionSweep``)
    lo: torch.Tensor | None  # [B, ceil(T / 64)] int32 packed tile bounds, else None
    hi: torch.Tensor | None


class DensePrep(StreamPrep):
    """A ``StreamPrep`` whose lo / hi are the dense backward's sweep
    (``segment_tile_bounds``); a plain one holds the streaming backward's
    (``packed_block_bounds``)."""

    __slots__ = ()


def flash_bwd_stream_prep_reference(q, k, v, key_valid, o, lse, g, seg_ids=None, *,
                                    scale: float | None = None, dense: bool = False,
                                    sweep: AttentionSweep | None = None) -> StreamPrep:
    """Plain PyTorch version of the prep kernel: ``StreamPrep`` with rows
    past T holding (``SKIP_LSE``, 0) and (-1, 0), the segment 0 unpacked,
    and the sweep ``sweep`` (``dense`` or the stream one, made here when
    None)."""
    b, t, h, dh = q.shape
    tp = -(-t // STREAM_TILE) * STREAM_TILE
    qs = (q.float() * _scale(q, scale)).to(q.dtype)
    rows = torch.zeros((b, h, tp, 2), dtype=torch.float32, device=q.device)
    rows[..., 0] = SKIP_LSE
    rows[:, :, :t, 0] = lse[..., 0]
    rows[:, :, :t, 1] = (g.float() * o.float()).sum(-1).permute(0, 2, 1)
    info = torch.zeros((b, tp, 2), dtype=torch.int32, device=q.device)
    info[..., 0] = -1
    info[:, :t, 0] = key_valid.to(torch.int32)
    if seg_ids is not None:
        info[:, :t, 1] = seg_ids
    return (DensePrep if dense else StreamPrep)(
        qs, rows, info, *_sweep_for(key_valid, seg_ids, sweep, dense)[:3])


def flash_bwd_stream_prep(q, k, v, key_valid, o, lse, g, seg_ids=None, *,
                          scale: float | None = None, dense: bool = False,
                          sweep: AttentionSweep | None = None) -> StreamPrep:
    """What the tensor-core backward kernels, dense (``dense``, the backward
    up to ``STREAM_MAX_T``) or streaming, read besides k, v and g, made once
    per backward: q_s, rows and info by the kernel
    ``flash_bwd_stream_prep`` of csrc/flash_bwd_stream.cu on CUDA tensors
    (counted in ``flash_bwd_stream_prep.launches``), with that pair's sweep
    ``sweep`` (``attention_sweep``, made here when None);
    ``flash_bwd_stream_prep_reference`` on CPU ones. Checks the backward's
    inputs."""
    if not _on_cuda(q, "float32", "flash_bwd_stream_prep"):
        return flash_bwd_stream_prep_reference(q, k, v, key_valid, o, lse, g, seg_ids,
                                               scale=scale, dense=dense, sweep=sweep)
    import ctypes

    _check_bwd_inputs(q, k, v, key_valid, o, lse, g, seg_ids)
    if not stream_tc(q):
        raise ValueError(f"the stream prep takes bf16 at Dh 64, not {q.dtype} at "
                         f"Dh {q.shape[-1]}")
    from repurpose_tpu_torch import native

    lib = native.load("flash_bwd_stream")
    b, t, h, dh = q.shape
    tp = -(-t // STREAM_TILE) * STREAM_TILE
    qs = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    rows = torch.empty((b, h, tp, 2), dtype=torch.float32, device=q.device)
    info = torch.empty((b, tp, 2), dtype=torch.int32, device=q.device)
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (q, g, o) for i in range(3)))
    err = lib.flash_bwd_stream_prep(
        q.data_ptr(), g.data_ptr(), o.data_ptr(), strides, lse.data_ptr(),
        key_valid.data_ptr(), _ptr(seg_ids), qs.data_ptr(), rows.data_ptr(), info.data_ptr(),
        b, t, h, dh, _scale(q, scale), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_stream_prep kernel launch failed: CUDA error {err}")
    flash_bwd_stream_prep.launches += 1
    return (DensePrep if dense else StreamPrep)(
        qs, rows, info, *_sweep_for(key_valid, seg_ids, sweep, dense)[:3])


def _tc_launch(name: str, q, k, v, g, softmax_dtype, scale, prep: StreamPrep, outs, *,
               dense: bool):
    """Launches tensor-core backward kernel ``name`` (``flash_bwd_dq_tc`` or
    ``flash_bwd_dkv_tc`` of csrc/flash_bwd.cu) on ``prep`` (the outputs of
    ``flash_bwd_stream_prep`` for these inputs, which checked them) into the
    preallocated ``outs``: as the dense backward (``dense``: the select
    form) or as the streaming one (the bias form). A packed ``prep`` must
    hold that pair's sweep."""
    import ctypes

    from repurpose_tpu_torch import native

    b, t, h, dh = q.shape
    tp = -(-t // STREAM_TILE) * STREAM_TILE
    qs, rows, info, kvl, lo, hi = prep
    if (qs.shape != q.shape or qs.dtype != q.dtype or not qs.is_contiguous()
            or rows.shape != (b, h, tp, 2) or rows.dtype != torch.float32
            or info.shape != (b, tp, 2) or info.dtype != torch.int32 or kvl.shape != (b,)
            or (lo is None) != (hi is None)
            or not all(x.is_contiguous() and x.device == q.device
                       for x in prep if x is not None)):
        raise ValueError("prep: not the outputs of flash_bwd_stream_prep for these inputs")
    if lo is not None and isinstance(prep, DensePrep) != dense:
        raise ValueError(f"prep: made with dense={not dense} for the "
                         f"{'dense' if dense else 'streaming'} backward")
    lib = native.load("flash_bwd")
    strides = (ctypes.c_longlong * 9)(*(x.stride(i) for x in (k, v, g) for i in range(3)))
    err = getattr(lib, name)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), strides, rows.data_ptr(),
        info.data_ptr(), kvl.data_ptr(), _ptr(lo), _ptr(hi), *(x.data_ptr() for x in outs),
        b, t, h, int(softmax_dtype == "bfloat16"), int(dense), _scale(q, scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_bwd_dq_stream(q, k, v, key_valid, o, lse, g, seg_ids=None,
                        softmax_dtype: str = "float32", prep: StreamPrep | None = None, *,
                        scale: float | None = None,
                        sweep: AttentionSweep | None = None) -> torch.Tensor:
    """dq of the streaming backward, ``[B, T, H, Dh]`` in q's dtype: on CUDA
    tensors a kernel of csrc/flash_bwd_stream.cu (counted in
    ``flash_bwd_dq_stream.launches``) or, where ``stream_tc(q)``, the
    tensor-core one of csrc/flash_bwd.cu in the bias form, on ``prep`` (the
    outputs of ``flash_bwd_stream_prep``, run here when not given), each on
    the stream sweep ``sweep`` (made here when None);
    ``flash_bwd_dq_stream_reference`` on CPU ones."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dq_stream"):
        return flash_bwd_dq_stream_reference(*args, scale=scale, sweep=sweep)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if stream_tc(q):
        if prep is None:
            prep = flash_bwd_stream_prep(*args[:-1], scale=scale, sweep=sweep)
        _tc_launch("flash_bwd_dq_tc", q, k, v, g, softmax_dtype, scale, prep, (dq,),
                   dense=False)
    elif head_chunked(q):
        flash_bwd_dq_stream_chunked(*args, scale, dq=dq, sweep=sweep)
    else:
        _bwd_launch("flash_bwd_dq_stream", *args, scale, (dq,), sweep)
    flash_bwd_dq_stream.launches += 1
    return dq


def flash_bwd_dkv_stream(q, k, v, key_valid, o, lse, g, seg_ids=None,
                         softmax_dtype: str = "float32", prep: StreamPrep | None = None, *,
                         scale: float | None = None, sweep: AttentionSweep | None = None):
    """(dk, dv) of the streaming backward, each ``[B, T, H, Dh]`` in the
    input dtype: on CUDA tensors a kernel of csrc/flash_bwd_stream.cu
    (counted in ``flash_bwd_dkv_stream.launches``) or the tensor-core one
    of csrc/flash_bwd.cu as for ``flash_bwd_dq_stream``;
    ``flash_bwd_dkv_stream_reference`` on CPU ones."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dkv_stream"):
        return flash_bwd_dkv_stream_reference(*args, scale=scale, sweep=sweep)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if stream_tc(q):
        if prep is None:
            prep = flash_bwd_stream_prep(*args[:-1], scale=scale, sweep=sweep)
        _tc_launch("flash_bwd_dkv_tc", q, k, v, g, softmax_dtype, scale, prep, (dk, dv),
                   dense=False)
    elif head_chunked(q):
        flash_bwd_dkv_stream_chunked(*args, scale, dk=dk, dv=dv, sweep=sweep)
    else:
        _bwd_launch("flash_bwd_dkv_stream", *args, scale, (dk, dv), sweep)
    flash_bwd_dkv_stream.launches += 1
    return dk, dv


flash_bwd_dq_stream.launches = 0  # kernel launches; the plain CPU path does not count
flash_bwd_dkv_stream.launches = 0
flash_bwd_dq_stream_chunked.launches = 0  # the part of the above on the head-chunked kernels
flash_bwd_dkv_stream_chunked.launches = 0
flash_bwd_stream_prep.launches = 0


def flash_backward(q, k, v, key_valid, o, lse, g, seg_ids=None,
                   softmax_dtype: str = "float32", *, scale: float | None = None,
                   sweep: AttentionSweep | None = None):
    """(dq, dk, dv) of ``out = flash_forward(q, k, v, key_valid, seg_ids)[0]``
    for the upstream gradient ``g``, given the forward's ``o`` and ``lse``:
    the dense kernels up to ``STREAM_MAX_T``, the streaming ones past it, as
    on the TPU (fa:1340-1341, 1461-1468), on ``sweep`` (the forward's
    ``attention_sweep``, made where needed when not given). Where
    ``stream_tc(q)`` holds on CUDA (bf16 at Dh 64, any T) both kernels are
    the tensor-core ones, and ``flash_bwd_stream_prep`` runs once for the
    two. q/k/v may be strided views as for ``flash_forward``; ``g`` and
    ``o`` need a contiguous head-dim axis and 16-byte rows."""
    args = (q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    prep = None
    if _on_cuda(q, softmax_dtype, "flash_backward") and stream_tc(q):  # once for both
        prep = flash_bwd_stream_prep(*args[:-1], scale=scale, dense=q.shape[1] <= STREAM_MAX_T,
                                     sweep=sweep)
    if q.shape[1] > STREAM_MAX_T:
        dq = flash_bwd_dq_stream(*args, prep, scale=scale, sweep=sweep)
        dk, dv = flash_bwd_dkv_stream(*args, prep, scale=scale, sweep=sweep)
    else:
        dq = flash_bwd_dq(*args, prep, scale=scale, sweep=sweep)
        dk, dv = flash_bwd_dkv(*args, prep, scale=scale, sweep=sweep)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel forward and, for ``backward="pallas"``, the
    kernel backward; ``backward="xla"`` recomputes the plain attention and
    takes its VJP instead. Returns out ``[B, T, H, Dh]``. A head width
    without a kernel instance runs zero-padded to ``kernel_head_dim`` with
    its own scale 1/sqrt(Dh); out and the gradients are cut back to Dh."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, seg_ids, softmax_dtype, backward, sweep):
        with device_span("attention", q):
            dh = q.shape[-1]
            width = kernel_head_dim(q.device, dh)
            if width != dh:
                q, k, v = (torch.nn.functional.pad(x, (0, width - dh)) for x in (q, k, v))
            scale = 1.0 / (dh ** 0.5)
            out, lse = flash_forward(q, k, v, key_valid, seg_ids, softmax_dtype, scale=scale,
                                     sweep=sweep)
            ctx.save_for_backward(q, k, v, out, lse, key_valid, seg_ids)
            ctx.softmax_dtype, ctx.head_dim, ctx.scale, ctx.sweep = softmax_dtype, dh, scale, sweep
            ctx.recompute = backward == "xla"
            return out if width == dh else out[..., :dh].contiguous()

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, key_valid, seg_ids = ctx.saved_tensors
        with device_span("attention", q):
            dh, width = ctx.head_dim, q.shape[-1]
            if ctx.recompute:
                with torch.enable_grad():
                    qkv = [x[..., :dh].detach().requires_grad_() for x in (q, k, v)]
                    ref = mha_torch(*qkv, key_valid, seg_ids)
                    dq, dk, dv = torch.autograd.grad(ref, qkv, g)
                return dq, dk, dv, None, None, None, None, None
            g = torch.nn.functional.pad(g, (0, width - dh)) if width != dh else g.contiguous()
            grads = flash_backward(q, k, v, key_valid, out, lse, g, seg_ids, ctx.softmax_dtype,
                                   scale=ctx.scale, sweep=ctx.sweep)
            if width != dh:
                grads = tuple(x[..., :dh] for x in grads)
            return *grads, None, None, None, None, None


def flash_attention(q, k, v, key_valid, seg_ids=None, softmax_dtype: str = "float32",
                    backward: str = "pallas", sweep: AttentionSweep | None = None) -> torch.Tensor:
    """Differentiable flash attention: out ``[B, T, H, Dh]``, forward and
    backward on ``sweep`` (``attention_sweep(key_valid, seg_ids)``; each
    kernel call makes its own when not given)."""
    if backward not in ("pallas", "xla"):
        raise ValueError(f"bad backward: {backward}")
    return FlashAttention.apply(q, k, v, key_valid, seg_ids, softmax_dtype, backward, sweep)
