"""Cross-modal fusion variant (``repurpose_tpu/models/cross_modal.py``,
``fusion: cross``): the reference's unused transformer library made
runnable.

``MMCTCross``: a ``UniModalEncoder`` per modality (projection MLP, the
sinusoidal PE from position 0 of each row, ``max(text_num_layers, 1)``
pre-LN self layers), then ``max(cross_num_layers, 1)`` ``CrossSelfEncoderLayer``
blocks in which the visual stream self-attends and cross-attends into the
context ``[audio ; text]`` (the mask repeated), then MMCT's feature map and
cls / reg heads.

Modules carry the JAX module tree's names (``visual_encoder.proj.fc1``,
``cross_0.cross_attn.q`` ...; the heads keep the port's reference indices),
so ``state_dict_from_jax_params`` maps the JAX params one to one. Numerics
are the JAX module's:

- Dense layers in the compute dtype on float32 parameters; LayerNorms in
  float32, cast back;
- ``CrossAttention`` calls the attention ``ModelConfig.attention_impl``
  selects (``ops/attention.py:select_attention_impl``), as the MMCT encoder
  does. Under "xla" that is ``mha_torch``: products and softmax in
  float32, a -1e9 bias on masked keys, the scores scaled after the product,
  the JAX module's values. Under the kernel values ("auto" ...) the
  self-attentions take ``flash_attention`` and so does the cross-attention,
  whose context is two key blocks of the query's length sharing its mask
  (one kernel a block, merged by their LSEs); ``MMCTCross`` makes one
  sweep a forward for all its attentions. The kernel route departs from the JAX module
  where PARITY.md says: query rows past the last valid key get 0 (they are
  padding, which no loss reads), and the softmax interior follows
  ``attn_softmax_dtype``;
- ``MMCTBottleneck`` builds its layers with ``kernels=False``: its key mask
  ``[mask ; bottleneck tokens]`` is not one the kernels' sweep describes,
  so it keeps ``mha_torch`` under every value;
- ``CrossSelfEncoderLayer`` keeps the reference's norm-in-residual quirk
  (the cross-attention and FFN residuals add to the already-normed tensor)
  and its FFN's inner dropout.

Like the JAX variants they take no ``seg_ids`` / ``positions``: a packed
batch raises in the train step and the inference pipeline
(``require_unpacked``).
"""

from __future__ import annotations

import torch
from torch import nn

from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models.encoder import LN_EPS, Dropout, layer_norm, linear
from repurpose_tpu_torch.models.mmct import MMCTOutput, _Head
from repurpose_tpu_torch.models.positional import sinusoidal_positional_encoding
from repurpose_tpu_torch.ops.attention import mha_torch, select_attention_impl
from repurpose_tpu_torch.utils.profiling import span


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=float32)(x).astype(x.dtype)``."""
    return layer_norm(x, norm).to(x.dtype)


class MLP(nn.Module):
    """fc1(hidden) -> relu -> fc2(out), no dropout (the reference MLP)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(torch.relu(linear(x, self.fc1, x.dtype)), self.fc2, x.dtype)


class FFN(nn.Module):
    """lin1(d_ff) -> relu -> [dropout] -> lin2(d_model); ``inner_dropout``
    adds the dropout the reference places only in CrossSelfEncoderLayer's."""

    def __init__(self, cfg: ModelConfig, inner_dropout: bool = False):
        super().__init__()
        self.lin1 = nn.Linear(cfg.d_model, cfg.d_ff)
        self.lin2 = nn.Linear(cfg.d_ff, cfg.d_model)
        self.drop = Dropout(cfg.dropout) if inner_dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(linear(x, self.lin1, x.dtype))
        if self.drop is not None:
            y = self.drop(y)
        return linear(y, self.lin2, x.dtype)


class CrossAttention(nn.Module):
    """Explicit-QKV multi-head attention; queries and keys/values may come
    from different streams. The keys are the rows of ``kv_in`` in blocks of
    the query's length, each masked by the query's mask. No dropout on the
    weights (the reference has none). ``kernels=False`` keeps ``mha_torch``
    whatever ``attention_impl`` says."""

    def __init__(self, cfg: ModelConfig, kernels: bool = True):
        super().__init__()
        d = cfg.d_model
        self.num_heads = cfg.num_heads
        self.q, self.k, self.v, self.out = (nn.Linear(d, d) for _ in range(4))
        self.attn = (select_attention_impl(cfg.attention_impl, cfg.attn_softmax_dtype)
                     if kernels else mha_torch)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, valid: torch.Tensor,
                sweep=None) -> torch.Tensor:
        dtype = q_in.dtype
        b, tq, d = q_in.shape
        tk, h = kv_in.shape[1], self.num_heads
        q = linear(q_in, self.q, dtype).view(b, tq, h, d // h)
        k = linear(kv_in, self.k, dtype).view(b, tk, h, d // h)
        v = linear(kv_in, self.v, dtype).view(b, tk, h, d // h)
        if self.attn is mha_torch:  # the mask of every key
            o = mha_torch(q, k, v, valid.repeat(1, tk // tq))
        else:  # the kernels take the key blocks' shared mask
            o = self.attn(q, k, v, valid, sweep=sweep)
        return linear(o.reshape(b, tq, d), self.out, dtype)


class EncoderLayer(nn.Module):
    """x + drop(attn(LN1(x))) then x + drop(ffn(LN2(x))): the reference
    EncoderLayer, with ``ModelConfig.dropout`` on the residual adds."""

    def __init__(self, cfg: ModelConfig, kernels: bool = True):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.self_attn = CrossAttention(cfg, kernels)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.ffn = FFN(cfg)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, sweep=None) -> torch.Tensor:
        x2 = _ln(x, self.ln1)
        x = x + self.drop(self.self_attn(x2, x2, valid, sweep))
        return x + self.drop(self.ffn(_ln(x, self.ln2)))


class CrossSelfEncoderLayer(nn.Module):
    """Self-attention -> cross-attention -> FFN with the reference's
    norm-in-residual quirk: the first residual adds to the un-normed input,
    the cross and FFN residuals to the already-normed tensor; the FFN has an
    inner dropout. The context's key blocks share the query's mask."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.self_attn = CrossAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.cross_attn = CrossAttention(cfg)
        self.ln3 = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.ffn = FFN(cfg, inner_dropout=True)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor, valid: torch.Tensor, context: torch.Tensor,
                sweep=None) -> torch.Tensor:
        x2 = _ln(x, self.ln1)
        x = x + self.drop(self.self_attn(x2, x2, valid, sweep))
        x = _ln(x, self.ln2)
        x = x + self.drop(self.cross_attn(x, context, valid, sweep))
        x = _ln(x, self.ln3)
        return x + self.drop(self.ffn(x))


class UniModalEncoder(nn.Module):
    """MLP(input, d_ff, d_model) projection + PE + ``num_layers`` pre-LN
    self layers (``layer_0`` ...)."""

    def __init__(self, cfg: ModelConfig, in_dim: int, num_layers: int, kernels: bool = True):
        super().__init__()
        self.d_model = cfg.d_model
        self.proj = MLP(in_dim, cfg.d_ff, cfg.d_model)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, kernels))
        self.num_layers = num_layers

    def forward(self, feats: torch.Tensor, valid: torch.Tensor, sweep=None) -> torch.Tensor:
        x = self.proj(feats)
        pe = sinusoidal_positional_encoding(x.shape[1], self.d_model, x.device)
        x = x + pe[None].to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, valid, sweep)
        return x


class FusionVariant(nn.Module):
    """What the fusion variants share with MMCT's interface: the three
    per-modality encoders, the feature map and the heads, the compute dtype
    and the dropout generator the train step re-seeds."""

    def __init__(self, cfg: ModelConfig, kernels: bool = True):
        super().__init__()
        self.cfg = cfg
        self.dropout_generator: torch.Generator | None = None
        n_uni = max(cfg.text_num_layers, 1)
        self.visual_encoder = UniModalEncoder(cfg, cfg.vis_dim, n_uni, kernels)
        self.audio_encoder = UniModalEncoder(cfg, cfg.aud_dim, n_uni, kernels)
        self.text_encoder = UniModalEncoder(cfg, cfg.text_dim, n_uni, kernels)
        self.feature_map = nn.Linear(cfg.d_model, cfg.d_model)
        self.feature_norm = nn.LayerNorm(cfg.d_model, eps=LN_EPS)
        self.feature_drop = Dropout(cfg.dropout)
        self.cls_head = _Head(cfg, 1, final_relu=False)
        self.reg_head = _Head(cfg, 2, final_relu=True)

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.compute_dtype == "bfloat16" else torch.float32

    def set_dropout_generator(self, generator: torch.Generator | None) -> None:
        """Draw every dropout mask from ``generator`` (see ``MMCT``)."""
        self.dropout_generator = generator
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = generator

    def encode(self, visual, audio, text, mask, sweep=None) -> dict:
        dtype = self.compute_dtype
        with span("fusion.encode"):
            return {"visual": self.visual_encoder(visual.to(dtype), mask, sweep),
                    "audio": self.audio_encoder(audio.to(dtype), mask, sweep),
                    "text": self.text_encoder(text.to(dtype), mask, sweep)}

    def heads(self, x: torch.Tensor) -> MMCTOutput:
        dtype = self.compute_dtype
        f = layer_norm(linear(x, self.feature_map, dtype), self.feature_norm).to(dtype)
        f = self.feature_drop(torch.relu(f))
        return MMCTOutput(cls_logits=self.cls_head(f), offsets=self.reg_head(f), feats=f)


class MMCTCross(FusionVariant):
    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.num_cross = max(cfg.cross_num_layers, 1)
        for i in range(self.num_cross):
            self.add_module(f"cross_{i}", CrossSelfEncoderLayer(cfg))
        attn = select_attention_impl(cfg.attention_impl, cfg.attn_softmax_dtype)
        self.make_sweep = getattr(attn, "make_sweep", None)  # None: no kernel takes a sweep

    def forward(self, visual: torch.Tensor, audio: torch.Tensor, text: torch.Tensor,
                mask: torch.Tensor) -> MMCTOutput:
        # every attention of the variant is masked by ``mask``: one sweep serves all
        sweep = None if self.make_sweep is None else self.make_sweep(mask)
        streams = self.encode(visual, audio, text, mask, sweep)
        x = streams["visual"]
        context = torch.cat([streams["audio"], streams["text"]], dim=1)
        for i in range(self.num_cross):
            x = getattr(self, f"cross_{i}")(x, mask, context, sweep)
        return self.heads(x)
