"""The cross-modal fusion variant (``fusion: cross``) on the kernel route,
on the CPU, where every kernel wrapper computes its plain version:

- (a) ``MMCTCross`` under "auto" (the self-attentions on ``flash_attention``,
  the cross-attention on it too, over two key blocks) against "xla"
  (``mha_torch``), on the dense and on the streaming route, with a padded
  row: forward outputs at valid rows and every parameter's gradient; one
  sweep a forward; ``MMCTBottleneck`` unchanged under "auto";
- (b) the two-block route against one softmax over the 2T context: out,
  lse, dq, dk and dv, with a padded row, a row whose blocks are both empty
  and T not a multiple of the 64-row tile;
- (c) the port ("xla" and "auto") against the benchmark's plain reference
  (``gpubench/reference/cross.py``) on its seeded weights: logits, the
  first step's loss and every gradient, at dropout 0 and 0.1 (the
  reference redraws the masks in the layers' order);
- (d) the ``attention.cross`` records' counts, and nothing recorded with
  the profiler off.

Tolerances (everything in float32): outputs 1e-5 x max |value|, gradients
1e-4 x max |value| of the leaf (or of a thousandth of the largest leaf, for
a gradient that is 0 in exact arithmetic, such as the key biases'): the
kernels' plain versions scale q before the product and take the softmax by
its running max, ``mha_torch`` and the reference scale after it, so the
values differ by float32 rounding, summed in another order through the
backward; (b) 2e-6 x max |value|, one merge of two softmaxes against one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.reference import cross as ref_cross
from gpubench.reference import model as ref_model
from repurpose_tpu_torch.config import ModelConfig
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops import flash_attention as fa
from repurpose_tpu_torch.utils import profiling

TINY = dict(vis_dim=8, aud_dim=12, text_dim=4, d_model=16, text_num_layers=2,
            cross_num_layers=2, num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
            attn_softmax_dtype="float32")
REF_M = {**TINY, "dropout": 0.0}


def _cfg(fusion="cross", impl="auto", dropout=0.0):
    return ModelConfig(**TINY, fusion=fusion, attention_impl=impl, dropout=dropout)


def _batch(t, seed=0, b=2):
    g = torch.Generator().manual_seed(seed)
    feats = [torch.randn((b, t, n), generator=g) for n in (8, 12, 4)]
    mask = torch.ones((b, t), dtype=torch.bool)
    mask[1, t - t // 3 :] = False  # a padded row
    labels = (torch.rand((b, t), generator=g) < 0.3).float()
    return feats, mask, labels


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-12)


def _grads(model):
    return {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in model.named_parameters()}


def _check_grads(got: dict, want: dict):
    top = max(float(g.abs().max()) for g in want.values())
    for n, w in want.items():
        err = float((got[n] - w).abs().max())
        assert err <= 1e-4 * max(float(w.abs().max()), 1e-3 * top), (n, err)


def _run(model, feats, mask, labels, weights):
    model.zero_grad()
    out = model(*feats, mask)
    loss = ((out.cls_logits * weights[..., None]).sum(-1) + out.offsets.sum(-1))[mask].sum()
    loss.backward()
    return out, _grads(model)


@pytest.fixture
def stream_at_64(monkeypatch):
    """The streaming route from T = 65 on (the long-video route at tiny T)."""
    monkeypatch.setattr(fa, "STREAM_MAX_T", 64)


@pytest.mark.parametrize("route,t", [("dense", 40), ("stream", 100)])
def test_auto_equals_xla_on_the_cpu(route, t, request):
    if route == "stream":
        request.getfixturevalue("stream_at_64")
    feats, mask, labels = _batch(t, seed=t)
    xla = build_model(_cfg(impl="xla"), "cpu", seed=5).train()
    auto = build_model(_cfg(impl="auto"), "cpu", seed=5).train()
    weights = torch.randn((2, t), generator=torch.Generator().manual_seed(1))
    want, want_g = _run(xla, feats, mask, labels, weights)
    got, got_g = _run(auto, feats, mask, labels, weights)
    for name in ("cls_logits", "offsets", "feats"):
        g, w = getattr(got, name)[mask], getattr(want, name)[mask]
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))
    _check_grads(got_g, want_g)


def test_one_sweep_serves_every_attention_of_a_forward(monkeypatch):
    made = []
    real = fa.attention_sweep
    monkeypatch.setattr(fa, "attention_sweep", lambda *a, **k: made.append(1) or real(*a, **k))
    feats, mask, labels = _batch(24)
    model = build_model(_cfg(), "cpu").train()
    _run(model, feats, mask, labels, torch.ones((2, 24)))
    assert len(made) == 1


def test_the_bottleneck_variant_keeps_the_plain_attention_under_auto():
    feats, mask, labels = _batch(24, seed=3)
    weights = torch.ones((2, 24))
    want, want_g = _run(build_model(_cfg("bottleneck", "xla"), "cpu", seed=2), feats, mask,
                        labels, weights)
    got, got_g = _run(build_model(_cfg("bottleneck", "auto"), "cpu", seed=2), feats, mask,
                      labels, weights)
    assert torch.equal(got.cls_logits, want.cls_logits)
    assert torch.equal(got.offsets, want.offsets)
    assert all(torch.equal(got_g[n], g) for n, g in want_g.items())


def _one_softmax(q, k, v, key_valid, n):
    """The 2T context as one softmax, float32: (out, lse [B, H, T])."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q * dh ** -0.5, k)
    s = s + torch.where(key_valid.repeat(1, n), 0.0, fa.NEG_INF)[:, None, None, :]
    lse = torch.logsumexp(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]), v)
    return out, lse


@pytest.mark.parametrize("route,t", [("dense", 70), ("stream", 150)])
def test_two_blocks_equal_one_softmax_over_the_context(route, t, request):
    if route == "stream":
        request.getfixturevalue("stream_at_64")
    b, h, dh, n = 3, 2, 16, 2
    g = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn((b, tk, h, dh), generator=g) for tk in (t, n * t, n * t))
    key_valid = torch.ones((b, t), dtype=torch.bool)
    key_valid[1, t - 29 :] = False  # a padded row
    key_valid[2] = False  # both key blocks empty
    kvl = [t, t - 29, 0]
    qkv = [x.clone().requires_grad_() for x in (q, k, v)]
    got = fa.flash_attention(*qkv, key_valid)
    upstream = torch.randn(got.shape, generator=g)
    for i, n_rows in enumerate(kvl):
        upstream[i, n_rows:] = 0.0  # the kernels' contract: no gradient past kvl
    got.backward(upstream)

    out, lse = fa.flash_forward(q, k, v, key_valid)
    parts = [fa.flash_forward(q, k[:, i * t : (i + 1) * t], v[:, i * t : (i + 1) * t],
                              key_valid) for i in range(n)]
    merged = fa.merge_blocks(*zip(*parts))
    assert torch.equal(out, got.detach()) and torch.equal(out, merged[0])
    assert torch.equal(lse, merged[1])

    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    want, want_lse = _one_softmax(*ref, key_valid, n)
    want.backward(upstream)
    for i, n_rows in enumerate(kvl):
        if n_rows:
            assert _rel(out[i, :n_rows], want[i, :n_rows]) <= 2e-6
            assert _rel(lse[i, :, :n_rows, 0], want_lse[i, :, :n_rows]) <= 2e-6
        assert torch.all(out[i, n_rows:] == 0) and torch.all(lse[i, :, n_rows:] == fa.SKIP_LSE)
    for name, x, r in zip("qkv", qkv, ref):
        assert torch.isfinite(x.grad).all(), name
        assert _rel(x.grad, r.grad) <= 2e-6, (name, _rel(x.grad, r.grad))
    assert torch.all(qkv[0].grad[2] == 0) and torch.all(qkv[1].grad[2] == 0)


def test_a_merge_of_skipped_rows_keeps_them_skipped():
    out = torch.zeros((1, 3, 2, 8))
    lse = torch.full((1, 2, 3, 1), fa.SKIP_LSE)
    merged, merged_lse = fa.merge_blocks((out, out), (lse, lse))
    assert torch.all(merged == 0) and torch.all(merged_lse == fa.SKIP_LSE)


@pytest.mark.parametrize("tk,packed", [(50, False), (60, True), (40, False)])
def test_key_blocks_must_be_unpacked_blocks_of_the_query_length(tk, packed):
    """k and v of n T rows are n blocks of q's length T = 20 masked as q,
    so a key length that is no multiple of T, packing (whose segments the
    blocks could not share) and k and v of different lengths are refused."""
    q = torch.zeros((1, 20, 2, 16))
    k = torch.zeros((1, tk, 2, 16))
    v = torch.zeros((1, 60 if tk == 40 else tk, 2, 16))
    seg = torch.zeros((1, 20), dtype=torch.int32) if packed else None
    with pytest.raises(ValueError, match="not unpacked blocks"):
        fa.flash_attention(q, k, v, torch.ones((1, 20), dtype=torch.bool), seg)


def _port(impl, dropout, w):
    model = build_model(_cfg(impl=impl, dropout=dropout), "cpu")
    model.load_state_dict(w, strict=True)
    return model.train()


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_the_port_matches_the_plain_reference(impl, dropout):
    t = 30
    feats, mask, labels = _batch(t, seed=9)
    m = {**REF_M, "dropout": dropout}
    w = ref_cross.weights(m, 17, "cpu")
    model = _port(impl, dropout, w)
    model.set_dropout_generator(torch.Generator().manual_seed(23))
    out = model(*feats, mask)
    loss = ref_model.focal_loss_sum(out.cls_logits[..., 0], labels, mask)
    loss.backward()

    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    drops = ref_model.DropStream(dropout, torch.Generator().manual_seed(23))
    cls, offsets = ref_cross.forward(leaves, m, *feats, mask, drops)
    want_loss = ref_model.focal_loss_sum(cls, labels, mask)
    grads = torch.autograd.grad(want_loss, list(leaves.values()), allow_unused=True)

    assert _rel(out.cls_logits[..., 0][mask], cls[mask].detach()) <= 1e-5
    assert _rel(out.offsets[mask], offsets[mask].detach()) <= 1e-5
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want_g = {k: (g if g is not None else torch.zeros_like(leaves[k]))
              for k, g in zip(leaves, grads)}
    _check_grads(_grads(model), want_g)


def test_cross_records_count_the_batch(monkeypatch):
    """The kernel route's ``attention.cross`` spans as a CPU run records
    them (``device_span`` times only CUDA work, so the span stands in for
    it here): one a forward and one a backward per cross block, each with
    the valid pairs per head and the valid context keys; the self-attentions'
    ``attention`` spans lie outside them; nothing with the profiler off."""
    monkeypatch.setattr(fa, "device_span", lambda name, x, **ids: profiling.span(name, **ids))
    t = 20
    feats, mask, labels = _batch(t)
    model = build_model(_cfg(), "cpu").train()
    profiling.clear()
    _run(model, feats, mask, labels, torch.ones((2, t)))
    assert profiling.records() == []

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _run(model, feats, mask, labels, torch.ones((2, t)))
    recs = profiling.records()
    profiling.clear()
    n = mask.sum(dim=1)
    cross = [r for r in recs if r.name == "attention.cross"]
    assert len(cross) == 2 * TINY["cross_num_layers"]
    assert sorted(r.ids["backward"] for r in cross) == [0, 0, 1, 1]
    for r in cross:
        assert r.ids["pairs"] == int(2 * (n * n).sum()) and r.ids["keys"] == int(2 * n.sum())
        assert r.ids["queries"] == int(n.sum())
    inner = [a for a in recs if a.name == "attention"]
    assert len(inner) == 2 * (3 * TINY["text_num_layers"] + TINY["cross_num_layers"])
    assert not any(c.start_ns <= a.start_ns and a.end_ns <= c.end_ns for a in inner for c in cross)
    assert len([r for r in recs if r.name == "fusion.encode"]) == 1


def test_the_reference_weights_load_into_the_port_strictly():
    m = {**REF_M, "text_num_layers": 3, "cross_num_layers": 3}
    model = build_model(ModelConfig(**{**TINY, "text_num_layers": 3, "cross_num_layers": 3},
                                    fusion="cross"), "cpu")
    w = ref_cross.weights(m, 4, "cpu")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in w.items()}
    mats = [v for v in w.values() if v.ndim == 2]
    assert all(0 < float(x.abs().max()) <= np.sqrt(6.0 / sum(x.shape)) for x in mats)
