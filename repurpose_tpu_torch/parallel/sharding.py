"""Sharding rules (``repurpose_tpu/parallel/sharding.py``): the Megatron
tensor-parallel split of the encoder's parameters over the mesh's ``model``
axis, the two operators that close a tensor-parallel region, ZeRO-1's
partition of the Adam moments over ``data``, and each rank's rows of a
global batch (and, under ring attention, its columns of them).

Tensor-parallel layout, in the port's (torch MHA) parameter names:

- ``self_attn.in_proj_weight`` ``[3d, d]`` / ``in_proj_bias`` ``[3d]``:
  column-parallel by heads. q, k and v are stacked in one matrix, so a rank
  takes ITS HEADS' rows from each of the three blocks, not a contiguous
  third: rank r of M keeps rows ``[b * d + r * d / M, b * d + (r + 1) * d / M)``
  of block b = q, k, v, and the local ``view(b, t, H / M, Dh)`` holds heads
  ``[r * H / M, (r + 1) * H / M)``, the heads the JAX rule's
  ``P(None, "model")`` on the ``qkv`` kernel leaves on rank r after the
  reshape to heads;
- ``self_attn.out_proj.weight`` ``[d, d]`` and ``linear2.weight``
  ``[d, d_ff]``: row-parallel (their input columns split); their biases are
  replicated and added once, after the reduce;
- ``linear1.weight`` / ``bias``: column-parallel (rows split);
- everything else (LayerNorms, the input projection, the heads):
  replicated.

The collectives are ``all_reduce`` only: a shard is gathered by placing it
into zeros of the full shape and summing over the axis.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_ENCODER = "multimodal_encoder.layers."


def param_sharding_rule(name: str) -> str | None:
    """How parameter ``name`` splits over ``model``: "heads" (the stacked
    q/k/v projection, by heads), "rows" (dim 0), "cols" (dim 1), or None
    (replicated)."""
    if not name.startswith(_ENCODER):
        return None
    if ".self_attn.in_proj_" in name:
        return "heads"
    if name.endswith((".self_attn.out_proj.weight", ".linear2.weight")):
        return "cols"
    if ".linear1." in name:
        return "rows"
    return None


def _pieces(rule: str, full_len: int, rank: int, size: int) -> list[tuple[int, int]]:
    """(start, length) along the split dim of rank ``rank``'s shard."""
    if rule == "heads":
        d = full_len // 3
        n = d // size
        return [(b * d + rank * n, n) for b in range(3)]
    n = full_len // size
    return [(rank * n, n)]


def shard_tensor(name: str, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s shard (of ``size``) of parameter ``name``'s full value."""
    rule = param_sharding_rule(name)
    if rule is None or size == 1:
        return full
    dim = 1 if rule == "cols" else 0
    if full.shape[dim] % (3 * size if rule == "heads" else size):
        raise ValueError(f"{name} {tuple(full.shape)} does not split {size} ways")
    return torch.cat([full.narrow(dim, s, n) for s, n in
                      _pieces(rule, full.shape[dim], rank, size)], dim=dim).contiguous()


def place_shard(name: str, local: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Parameter ``name``'s full shape with rank ``rank``'s shard ``local`` in
    place and zeros elsewhere: the shards of all ranks sum to the full value."""
    rule = param_sharding_rule(name)
    if rule is None or size == 1:
        return local
    dim = 1 if rule == "cols" else 0
    shape = list(local.shape)
    shape[dim] *= size
    full = torch.zeros(shape, dtype=local.dtype, device=local.device)
    at = 0
    for s, n in _pieces(rule, shape[dim], rank, size):
        full.narrow(dim, s, n).copy_(local.narrow(dim, at, n))
        at += n
    return full


def shard_state_dict(sd: dict, mesh) -> dict:
    """This rank's shard of a full, reference-named state dict."""
    rank, size = mesh.coord("model"), mesh.size("model")
    return {k: shard_tensor(k, v, rank, size) for k, v in sd.items()}


def gather_tensor(name: str, local: torch.Tensor, mesh) -> torch.Tensor:
    """Parameter ``name``'s full value from every model rank's shard (a
    collective over ``model``: every model rank must call it)."""
    size = mesh.size("model")
    if param_sharding_rule(name) is None or size == 1:
        return local
    full = place_shard(name, local, mesh.coord("model"), size)
    dist.all_reduce(full, group=mesh.group("model"))
    return full


def gather_state_dict(sd: dict, mesh) -> dict:
    """The full, reference-named state dict from every model rank's shard
    (a collective over ``model``)."""
    return {k: gather_tensor(k, v, mesh) for k, v in sd.items()}


class _CopyToModel(torch.autograd.Function):
    """Opens a tensor-parallel region: identity forward, the input gradient
    summed over the model group in the backward (each rank holds the part
    that flows through its heads or its FFN columns)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = g.float().clone()
        dist.all_reduce(g32, group=ctx.group)
        return g32.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Closes a tensor-parallel region: the partial outputs summed over the
    model group in the forward, in float32 (the one-process product
    accumulates in float32 too); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        y = x.float().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 sum of ``x`` over the model group."""
    return _ReduceFromModel.apply(x, group)


def zero1_dim(shape, dp: int) -> int | None:
    """The dim along which ZeRO-1 splits a moment of local shape ``shape``
    over ``dp`` data ranks: the first one that ``dp`` divides (the JAX
    ``zero1_opt_specs`` rule; a rank's tensor-parallel shard is already
    local), or None (a scalar or no such dim: every rank keeps it whole)."""
    if dp == 1:
        return None
    for i, n in enumerate(shape):
        if n % dp == 0 and n >= dp:
            return i
    return None


def seq_split(cfg, mesh) -> bool:
    """Whether ranks hold ``T / seq`` positions each: the concat-fusion MMCT
    with ring attention on a mesh whose ``seq`` axis is > 1. Otherwise the
    ``seq`` ranks hold the whole rows, as the JAX Trainer stages them
    unsharded. A fusion variant (``fusion`` cross or bottleneck) always
    does: it has no ring and no global positions, so a rank holding its
    columns alone would attend within them; the JAX variants ignore the mesh
    and GSPMD computes their attention over whole rows."""
    return cfg.fusion == "concat" and cfg.attention_impl == "ring" and mesh.size("seq") > 1


def local_columns(batch, mesh):
    """Columns ``[c T / n, (c + 1) T / n)`` of every [B, T, ...] field of
    ``batch``, c this rank's ``seq`` coordinate of n (the JAX
    ``make_global_batch(..., seq_sharded=True)``); [B] fields stay whole."""
    n, c = mesh.size("seq"), mesh.coord("seq")
    t = batch.mask.shape[1]
    if t % n:
        raise ValueError(f"bucket {t} not divisible by the seq axis {n}")
    w = t // n
    return type(batch)(*[x if x is None or x.ndim < 2 else x[:, c * w : (c + 1) * w]
                         for x in batch])


def gather_columns(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole rows [B, T, ...] of every ``seq`` rank's columns ``x``
    [B, T / n, ...]: placed into zeros and summed over ``seq`` (in float32;
    a collective)."""
    n, c = mesh.size("seq"), mesh.coord("seq")
    if n == 1:
        return x
    w = x.shape[1]
    full = torch.zeros((x.shape[0], w * n, *x.shape[2:]), dtype=torch.float32, device=x.device)
    full[:, c * w : (c + 1) * w] = x
    return mesh.all_reduce(full, "seq").to(x.dtype)


def local_rows(batch, mesh, seq: bool = False):
    """This rank's rows of a global batch: rows ``data_coord::data`` (the
    loader's strided slice), the counterpart of ``make_global_batch``. Model
    and pipe ranks of one data coordinate keep the same rows; with ``seq``
    each ``seq`` rank its columns of them (``local_columns``)."""
    dp, r = mesh.size("data"), mesh.coord("data")
    if dp > 1:
        batch = type(batch)(*[None if x is None else x[r::dp] for x in batch])
    return local_columns(batch, mesh) if seq and mesh.size("seq") > 1 else batch


def all_reduce_grads(params, mesh, bucket_bytes: int = 64 << 20, axis: str = "data") -> None:
    """Sums every parameter's gradient over ``axis`` (``data``, or ``seq``
    under ring attention), in float32 buckets of at most ``bucket_bytes``
    (one all_reduce each). Parameters without a gradient are skipped; every
    rank of the axis has the same ones."""
    if mesh.size(axis) == 1:
        return
    group = mesh.group(axis)
    grads = [p.grad for p in params if p.grad is not None]
    bucket: list[torch.Tensor] = []
    nbytes = 0

    def flush():
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        dist.all_reduce(flat, group=group)
        at = 0
        for g in bucket:
            g.copy_(flat[at : at + g.numel()].view_as(g))
            at += g.numel()

    for g in grads:
        if bucket and nbytes + 4 * g.numel() > bucket_bytes:
            flush()
            bucket, nbytes = [], 0
        bucket.append(g)
        nbytes += 4 * g.numel()
    if bucket:
        flush()
