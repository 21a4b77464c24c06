"""Pre-LN transformer encoder (``repurpose_tpu/models/encoder.py``).

Parameters carry the reference MMCTransformer's state-dict names
(``multimodal_encoder.layers.{i}.self_attn.in_proj_weight`` ...), so
reference checkpoints load strictly. Numerics follow the JAX model:

- parameters are float32 and cast to the compute dtype at use (bf16 Dense);
- LayerNorms compute in float32 and are cast back to the compute dtype;
- the packed QKV projection's output is split into q/k/v views that go to
  the attention kernel without a copy;
- dropout where the JAX encoder has it: after the attention output
  projection, after the FFN ReLU and after the FFN output (none on the
  attention weights, which the fused kernels do not expose). It is active in
  ``model.train()`` only, with masks from the generator that
  ``MMCT.set_dropout_generator`` hands out;
- rematerialisation (``ModelConfig.remat``, ``nn.remat(EncoderLayer)`` in
  the JAX encoder): with gradients on, each layer runs under
  ``torch.utils.checkpoint`` and keeps only its input; the backward
  recomputes the layer. The recompute draws the same dropout masks as the
  forward did, as Flax replays the same dropout key: checkpoint restores
  only torch's default generators, so the layer's own dropout generator is
  set back to its state at the forward for the recompute and then returned
  to where the recompute found it.
- the attention kernels' sweep (kvl and the key-tile bounds) depends only
  on the mask, the segments and T: where the attention callable has a
  ``make_sweep`` (the kernel ``attention_impl`` values) the encoder makes it
  once per forward and hands it to every layer, whose forward, remat
  recompute and backward all take it;
- tensor parallelism (a mesh whose ``model`` axis is M > 1,
  ``parallel/sharding.py``): each layer holds its rank's H / M heads and
  d_ff / M FFN columns, under the same parameter names with local shapes.
  The attention is the same dispatcher, launched at H / M heads. The two
  Megatron operators open and close each region: ``copy_to_model`` before
  ``in_proj`` and ``linear1``, ``reduce_from_model`` after ``out_proj`` and
  ``linear2``, whose replicated biases are added once, after the sum. The
  replicated dropouts draw the one-process masks on every rank; the FFN
  hidden's draws the one-process model's whole mask and keeps its columns,
  so every mask equals the one-process model's;
- ring attention (``attention_impl="ring"``, ``ops/ring_attention.py``): each
  rank of the mesh's ``seq`` axis holds ``T / seq`` positions of every
  activation and the attention runs around the ring. It needs the mesh
  (ValueError without one) and takes no packed batch (ValueError), as the
  JAX encoder requires. Everything else in a layer is per position.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.ops.attention import select_attention_impl
from repurpose_tpu_torch.ops.ring_attention import ring_attention
from repurpose_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model

LN_EPS = 1e-5


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """Flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Flax ``nn.LayerNorm(dtype=float32)``: float32 in, float32 out."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: zero each element with probability ``p`` and scale
    the rest by 1/(1-p), in train mode only. The masks come from
    ``generator`` (None: torch's default generator). With ``shard`` = (rank,
    size) the input is rank ``rank``'s columns of a last dim ``size`` times
    wider: the whole mask is drawn and those columns kept."""

    def __init__(self, p: float, shard: tuple[int, int] | None = None):
        super().__init__()
        self.p = p
        self.shard = shard
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.shard is None:
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) < 1.0 - self.p
        else:
            rank, size = self.shard
            n = x.shape[-1]
            whole = torch.rand((*x.shape[:-1], n * size), generator=self.generator,
                               device=x.device)
            keep = whole[..., rank * n : (rank + 1) * n] < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


def _model_axis(cfg: ModelConfig, mesh) -> tuple[int, int, object]:
    """(rank, size, group) of the mesh's ``model`` axis; (0, 1, None) without
    tensor parallelism. Raises where heads or the FFN hidden do not split."""
    if mesh is None or mesh.size("model") == 1:
        return 0, 1, None
    size = mesh.size("model")
    if cfg.num_heads % size or cfg.d_ff % size:
        raise ValueError(f"num_heads {cfg.num_heads} and d_ff {cfg.d_ff} must split "
                         f"over model={size}")
    return mesh.coord("model"), size, mesh.group("model")


def row_parallel_linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
                        group) -> torch.Tensor:
    """``linear`` of a row-parallel layer: the local product summed over the
    model group in float32, then the replicated bias, rounded once."""
    y = reduce_from_model(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return (y + layer.bias.float()).to(dtype)


class SelfAttention(nn.Module):
    """Packed-QKV multi-head self-attention in torch MHA's parameter layout;
    on a mesh with ``model`` = M > 1, this rank's H / M heads."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        _, size, self.group = _model_axis(cfg, mesh)
        d = cfg.d_model // size  # local width of q, k, v: H / M heads
        self.cfg = cfg
        self.heads = cfg.num_heads // size
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, cfg.d_model))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, cfg.d_model)
        self.attn = select_attention_impl(cfg.attention_impl, cfg.attn_softmax_dtype)
        self.ring = cfg.attention_impl == "ring"
        self.ring_mesh = mesh if self.ring else None

    def forward(self, x, key_valid, seg_ids=None, sweep=None):
        b, t, _ = x.shape
        h, d = self.heads, self.in_proj_bias.shape[0] // 3
        if self.group is not None:
            x = copy_to_model(x, self.group)
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (z.view(b, t, h, d // h) for z in qkv.split(d, dim=-1))
        if self.ring:
            if self.ring_mesh is None:
                raise ValueError('attention_impl="ring" needs build_model(cfg, mesh=...)')
            if seg_ids is not None:
                raise ValueError("sequence packing is not supported with ring attention")
            out = ring_attention(q, k, v, key_valid, self.ring_mesh).reshape(b, t, d)
        else:
            kw = {} if sweep is None else {"sweep": sweep}
            out = self.attn(q, k, v, key_valid, seg_ids=seg_ids, **kw).reshape(b, t, d)
        if self.group is not None:
            return row_parallel_linear(out, self.out_proj, x.dtype, self.group)
        return linear(out, self.out_proj, x.dtype)


class EncoderLayer(nn.Module):
    """x + Drop(SA(LN1(x))); x + Drop(FFN(LN2(x))) — pre-LN residual block
    (dropout module names as in torch's TransformerEncoderLayer); on a mesh
    with ``model`` > 1, tensor-parallel."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        rank, size, self.group = _model_axis(cfg, mesh)
        d_ff = cfg.d_ff // size
        self.self_attn = SelfAttention(cfg, mesh)
        self.linear1 = nn.Linear(cfg.d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, cfg.d_model)
        self.norm1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.dropout1 = Dropout(cfg.dropout)  # attention output
        self.dropout = Dropout(cfg.dropout, None if size == 1 else (rank, size))  # FFN hidden
        self.dropout2 = Dropout(cfg.dropout)  # FFN output

    def forward(self, x, key_valid, seg_ids=None, sweep=None):
        dtype = x.dtype
        y = layer_norm(x, self.norm1).to(dtype)
        x = x + self.dropout1(self.self_attn(y, key_valid, seg_ids, sweep))
        y = layer_norm(x, self.norm2).to(dtype)
        if self.group is None:
            y = self.dropout(torch.relu(linear(y, self.linear1, dtype)))
            return x + self.dropout2(linear(y, self.linear2, dtype))
        y = self.dropout(torch.relu(linear(copy_to_model(y, self.group), self.linear1, dtype)))
        return x + self.dropout2(row_parallel_linear(y, self.linear2, dtype, self.group))


def _replaying_dropout(layer: nn.Module):
    """``context_fn`` for ``torch.utils.checkpoint`` of ``layer``: nothing
    around the forward; around the recompute, the layer's dropout generators
    back at their state of this forward, then returned to their state before
    the recompute."""
    gens = list({id(m.generator): m.generator for m in layer.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    at_forward = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def replay():
        before = [g.get_state() for g in gens]
        for g, state in zip(gens, at_forward):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(gens, before):
                g.set_state(state)

    return lambda: (contextlib.nullcontext(), replay())


def apply_layer(layer: EncoderLayer, x, key_valid, seg_ids, sweep, remat: bool):
    """``layer``'s forward, rematerialised in the backward (replaying its
    dropout masks) when ``remat`` is on and gradients are."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            layer, x, key_valid, seg_ids, sweep, use_reentrant=False,
            context_fn=_replaying_dropout(layer))
    return layer(x, key_valid, seg_ids, sweep)


class Encoder(nn.Module):
    """Stack of pre-LN layers (reference: 16, models/MMCTransformer.py:51-55),
    each rematerialised in the backward when ``cfg.remat`` is on. With a
    kernel attention one sweep per forward (``make_sweep``) serves every
    layer. ``mesh``: tensor-parallel layers where its ``model`` axis > 1."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.remat = cfg.remat
        attn = select_attention_impl(cfg.attention_impl, cfg.attn_softmax_dtype)
        self.make_sweep = getattr(attn, "make_sweep", None)  # None: no kernel takes a sweep
        self.layers = nn.ModuleList(EncoderLayer(cfg, mesh) for _ in range(cfg.self_num_layers))

    def forward(self, x, key_valid, seg_ids=None):
        sweep = None if self.make_sweep is None else self.make_sweep(key_valid, seg_ids)
        for layer in self.layers:
            x = apply_layer(layer, x, key_valid, seg_ids, sweep, self.remat)
        return x
