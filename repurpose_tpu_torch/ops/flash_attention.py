"""Flash attention: the wrappers around the CUDA kernels, their plain
PyTorch versions, and the autograd Function that ties them together.

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

``flash_backward`` is the counterpart of ``_flash_backward`` (same argument
order): ``flash_bwd_dq`` and ``flash_bwd_dkv`` replace the TPU kernels
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` (+ ``_dkv_compute``), unpacked and
packed, with the two kernels of ``csrc/flash_bwd.cu``. dq rows and dk/dv rows
at or past ``_kv_len`` are 0. The upstream gradient must be 0 on query rows
at or past ``_kv_len``, which is what the model gives (the loss masks those
rows and masked keys carry no softmax mass): there the TPU forward leaves
real lse values where this one writes ``SKIP_LSE``, so only with that
contract do the two backwards agree on every row.

``FlashAttention`` (``flash_attention``) is the autograd Function of the
model's attention: the kernel forward, then the kernel backward or, with
``backward="xla"``, the plain recompute backward (the VJP of ``mha_torch``,
the JAX ``backward="xla"`` escape hatch).

Long sequences (T > ``STREAM_MAX_T``, the long-video buckets of
``configs/longvideo.yaml``) go to ``flash_forward_stream``, the counterpart of
the three long-T TPU forwards (``_flash_fwd_stream_kernel``,
``_flash_fwd_packed_stream_kernel``, ``_flash_fwd_hbm_kernel``), which one
kernel replaces: ``csrc/flash_fwd_stream.cu``. It runs the TPU stream
kernels' online-softmax recurrence over 64-key tiles and, packed, sweeps
only the key tiles ``[lo, hi)`` of each query tile's own videos
(``packed_block_bounds``).

On a CPU tensor each wrapper computes its plain version. On a CUDA tensor it
launches the kernel or raises: there is no fallback.
"""

from __future__ import annotations

import torch

from repurpose_tpu_torch.ops.attention import NEG_INF, mha_torch

# LSE written for query rows past the last valid key: large enough that a
# backward's exp(s - lse) underflows to exactly 0, small enough to stay finite.
SKIP_LSE = 1e30

# Longest T served by the dense forward (``flash_fwd``); longer sequences take
# the streaming forward, as on the TPU (repurpose_tpu/ops/flash_attention.py:88).
STREAM_MAX_T = 2048
STREAM_TILE = 64  # query and key tile of csrc/flash_fwd_stream.cu
M_INIT = -1e30  # initial running max of the stream recurrence (finite: see fa:647)

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
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """q/k/v ``[B, T, H, Dh]`` -> (out ``[B, T, H, Dh]``, lse ``[B, H, T, 1]``).

    T <= ``STREAM_MAX_T`` runs the dense forward (``flash_fwd``), longer T the
    streaming one (``flash_forward_stream``), unpacked and packed. q/k/v may
    be strided views (e.g. the column slices of a fused QKV projection) as
    long as the head-dim axis is contiguous and rows start on 16-byte
    boundaries."""
    if q.shape[1] > STREAM_MAX_T:
        return flash_forward_stream(q, k, v, key_valid, seg_ids, softmax_dtype)
    return flash_fwd_dense(q, k, v, key_valid, seg_ids, softmax_dtype)


def flash_fwd_dense(q, k, v, key_valid, seg_ids=None, softmax_dtype: str = "float32"):
    """The dense forward at any T: the kernel of csrc/flash_fwd.cu on CUDA
    tensors (counted in ``flash_forward.launches``), its plain version on CPU
    ones. ``flash_forward`` takes it up to ``STREAM_MAX_T``."""
    if not _on_cuda(q, softmax_dtype, "flash_forward"):
        return flash_forward_reference(q, k, v, key_valid, seg_ids, softmax_dtype)
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


# -- long T: the streaming forward ---------------------------------------------


def packed_block_bounds(
    seg_ids: torch.Tensor, q_block: int, k_block: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Key-tile bounds ``[lo, hi)`` per (batch row, query tile), each int32
    ``[B, ceil(T / q_block)]``: the smallest run of ``k_block``-key tiles
    holding every video that owns a row of the query tile (``_packed_block_bounds``,
    fa:486). Videos lie head to tail, so a position's video spans
    ``[start_of, end_of)``, a running max of video starts and a reverse
    running min of video ends. A ragged last query tile counts as padding
    past T; a tile of padding only gets an empty range."""
    b, t = seg_ids.shape
    seg = seg_ids.long()
    t_idx = torch.arange(t, device=seg.device).expand(b, t)
    valid = seg >= 0
    edge = torch.full((b, 1), -2, dtype=seg.dtype, device=seg.device)
    is_start = valid & (seg != torch.cat([edge, seg[:, :-1]], dim=1))
    is_end = valid & (seg != torch.cat([seg[:, 1:], edge], dim=1))
    start_of = torch.cummax(torch.where(is_start, t_idx, 0), dim=1).values
    end_of = torch.cummin(torch.where(is_end, t_idx + 1, t).flip(1), dim=1).values.flip(1)
    nqb = -(-t // q_block)
    pad = (0, nqb * q_block - t)
    lo_pos = torch.nn.functional.pad(torch.where(valid, start_of, t), pad, value=t)
    hi_pos = torch.nn.functional.pad(torch.where(valid, end_of, 0), pad, value=0)
    lo = lo_pos.view(b, nqb, q_block).amin(-1) // k_block
    hi = -(-hi_pos.view(b, nqb, q_block).amax(-1) // k_block)
    return lo.to(torch.int32), torch.maximum(hi, lo).to(torch.int32)


def flash_forward_stream_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
    k_block: int = STREAM_TILE, q_chunk: int = 4096, k_chunk: int = 8192,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the streaming kernel: the online-softmax
    recurrence of the TPU stream kernels (fa:623-654) over ``k_block``-key
    tiles, with their rounding points:

    - s = q_s k^T in float32 plus the -1e9 bias, rounded to the softmax dtype;
    - m_new = max(m, max(s)) in float32, from ``M_INIT``;
    - alpha = exp(m - m_new) in float32;
    - p = exp(s - m_new rounded to the softmax dtype), in the softmax dtype;
    - l = l alpha + sum(p) and acc = acc alpha + round_v(p) v, in float32;
    - out = acc / l, lse = m + log(l).

    Each query tile of ``STREAM_TILE`` rows sweeps key tiles ``[0, ceil(kvl /
    k_block))`` unpacked and ``[lo, min(hi, ceil(kvl / k_block)))`` packed
    (``packed_block_bounds``); keys past T do not exist (p = 0). Rows at or
    past kvl, and tiles with an empty range, get out = 0 and lse =
    ``SKIP_LSE``. The loop runs over ``q_chunk`` query rows and ``k_chunk``
    keys at a time, so the live score block stays near H * q_chunk * k_chunk
    floats (1 GB at 8 heads); within a key chunk the running max is a
    cumulative max over its tiles, which gives each tile the max the
    sequential sweep would have."""
    b, t, h, dh = q.shape
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = 1.0 / (dh ** 0.5)
    dev = q.device
    q_block = STREAM_TILE  # the kernel's query tile: what packed bounds are taken over
    nqt, nkt = -(-t // q_block), -(-t // k_block)
    tp = nkt * k_block
    q_chunk = max(q_block, q_chunk // q_block * q_block)
    tiles_per_chunk = max(1, k_chunk // k_block)
    kvl = _kv_len(key_valid)[:, 0].tolist()
    if seg_ids is not None:
        lo, hi = (x.long() for x in packed_block_bounds(seg_ids, q_block, k_block))
    out = torch.zeros((b, t, h, dh), dtype=q.dtype, device=dev)
    lse = torch.full((b, h, t, 1), SKIP_LSE, dtype=torch.float32, device=dev)
    key_exists = torch.arange(tp, device=dev) < t
    pad_rows = (0, 0, 0, 0, 0, tp - t)
    for bi in range(b):
        n_live = -(-kvl[bi] // k_block)
        if seg_ids is None:
            tile_lo = torch.zeros(nqt, dtype=torch.long, device=dev)
            tile_hi = torch.full((nqt,), n_live, dtype=torch.long, device=dev)
        else:
            tile_lo, tile_hi = lo[bi], hi[bi].clamp(max=n_live)
            seg_k = torch.nn.functional.pad(seg_ids[bi], (0, tp - t), value=-1)
        k_b = torch.nn.functional.pad(k[bi], pad_rows).float().permute(1, 0, 2)  # [H, Tp, Dh]
        v_b = torch.nn.functional.pad(v[bi], pad_rows).float().permute(1, 0, 2)
        ok_key = torch.nn.functional.pad(key_valid[bi], (0, tp - t))
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


def flash_forward_stream(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_valid: torch.Tensor,
    seg_ids: torch.Tensor | None = None, softmax_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming forward, same contract as ``flash_forward``: the kernel
    of csrc/flash_fwd_stream.cu on CUDA tensors (counted in
    ``flash_forward_stream.launches``), ``flash_forward_stream_reference`` on
    CPU ones. The wrapper computes kvl and, packed, the tile bounds once
    (the TPU kernels' scalar-prefetch operands) and hands them to the kernel."""
    if not _on_cuda(q, softmax_dtype, "flash_forward_stream"):
        return flash_forward_stream_reference(q, k, v, key_valid, seg_ids, softmax_dtype)
    _check_cuda_inputs(q, k, v, key_valid, seg_ids)
    from repurpose_tpu_torch import native

    lib = native.load("flash_fwd_stream")
    b, t, h, dh = q.shape
    key_valid = key_valid.contiguous()
    kvl = _kv_len(key_valid)[:, 0].contiguous()
    lo = hi = None
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
        lo, hi = (x.contiguous() for x in packed_block_bounds(seg_ids, STREAM_TILE,
                                                               STREAM_TILE))
    out = torch.empty((b, t, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd_stream(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        key_valid.data_ptr(), None if seg_ids is None else seg_ids.data_ptr(),
        kvl.data_ptr(), None if lo is None else lo.data_ptr(),
        None if hi is None else hi.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t, h, dh, int(q.dtype == torch.bfloat16),
        int(softmax_dtype == "bfloat16"), 1.0 / (dh ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd_stream kernel launch failed: CUDA error {err}")
    flash_forward_stream.launches += 1
    return out, lse


flash_forward_stream.launches = 0  # kernel launches; the plain CPU path does not count


def _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype):
    """(q_s, p, ds) of the plain backward: the TPU kernels' rounding points
    over the whole key axis at once."""
    sm_dtype = _SM_DTYPES[softmax_dtype]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    qs = (q.float() * scale).to(q.dtype)
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
                           softmax_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the dq kernel."""
    _, _, ds = _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    scale = 1.0 / (q.shape[-1] ** 0.5)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float()) * scale
    return _zero_past_kv_len(dq.to(q.dtype), key_valid)


def flash_bwd_dkv_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                            softmax_dtype: str = "float32"):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv)."""
    qs, p, ds = _bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    return (_zero_past_kv_len(dk.to(k.dtype), key_valid),
            _zero_past_kv_len(dv.to(v.dtype), key_valid))


def flash_backward_reference(q, k, v, key_valid, o, lse, g, seg_ids=None,
                             softmax_dtype: str = "float32"):
    """Plain PyTorch version of both backward kernels: (dq, dk, dv)."""
    dq = flash_bwd_dq_reference(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dk, dv = flash_bwd_dkv_reference(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    return dq, dk, dv


def _bwd_launch(name: str, q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, outs):
    """Checks the inputs and launches kernel ``name`` of csrc/flash_bwd.cu
    into the preallocated ``outs``."""
    import ctypes

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
    from repurpose_tpu_torch import native

    lib = native.load("flash_bwd")
    key_valid = key_valid.contiguous()
    if seg_ids is not None:
        seg_ids = seg_ids.contiguous()
    strides = (ctypes.c_longlong * 15)(
        *(x.stride(i) for x in (q, k, v, g, o) for i in range(3))
    )
    err = getattr(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), o.data_ptr(), strides,
        key_valid.data_ptr(), None if seg_ids is None else seg_ids.data_ptr(),
        lse.data_ptr(), *(x.data_ptr() for x in outs),
        b, t, h, dh, int(q.dtype == torch.bfloat16), int(softmax_dtype == "bfloat16"),
        1.0 / (dh ** 0.5), torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def flash_bwd_dq(q, k, v, key_valid, o, lse, g, seg_ids=None,
                 softmax_dtype: str = "float32") -> torch.Tensor:
    """dq ``[B, T, H, Dh]`` in q's dtype (contiguous)."""
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dq"):
        return flash_bwd_dq_reference(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, (dq,))
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, key_valid, o, lse, g, seg_ids=None,
                  softmax_dtype: str = "float32"):
    """(dk, dv), each ``[B, T, H, Dh]`` in the input dtype (contiguous)."""
    if not _on_cuda(q, softmax_dtype, "flash_bwd_dkv"):
        return flash_bwd_dkv_reference(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype,
                (dk, dv))
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0  # kernel launches; the plain CPU path does not count
flash_bwd_dkv.launches = 0


def flash_backward(q, k, v, key_valid, o, lse, g, seg_ids=None,
                   softmax_dtype: str = "float32"):
    """(dq, dk, dv) of ``out = flash_forward(q, k, v, key_valid, seg_ids)[0]``
    for the upstream gradient ``g``, given the forward's ``o`` and ``lse``.
    q/k/v may be strided views as for ``flash_forward``; ``g`` and ``o`` need
    a contiguous head-dim axis and 16-byte rows."""
    dq = flash_bwd_dq(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    dk, dv = flash_bwd_dkv(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the kernel forward and, for ``backward="pallas"``, the
    kernel backward; ``backward="xla"`` recomputes the plain attention and
    takes its VJP instead. Returns out ``[B, T, H, Dh]``."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid, seg_ids, softmax_dtype, backward):
        out, lse = flash_forward(q, k, v, key_valid, seg_ids, softmax_dtype)
        ctx.save_for_backward(q, k, v, out, lse, key_valid, seg_ids)
        ctx.softmax_dtype = softmax_dtype
        ctx.recompute = backward == "xla"
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, key_valid, seg_ids = ctx.saved_tensors
        if ctx.recompute:
            with torch.enable_grad():
                qkv = [x.detach().requires_grad_() for x in (q, k, v)]
                ref = mha_torch(*qkv, key_valid, seg_ids)
                dq, dk, dv = torch.autograd.grad(ref, qkv, g)
        else:
            dq, dk, dv = flash_backward(q, k, v, key_valid, out, lse, g.contiguous(),
                                        seg_ids, ctx.softmax_dtype)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, key_valid, seg_ids=None, softmax_dtype: str = "float32",
                    backward: str = "pallas") -> torch.Tensor:
    """Differentiable flash attention: out ``[B, T, H, Dh]``."""
    if backward not in ("pallas", "xla"):
        raise ValueError(f"bad backward: {backward}")
    return FlashAttention.apply(q, k, v, key_valid, seg_ids, softmax_dtype, backward)
