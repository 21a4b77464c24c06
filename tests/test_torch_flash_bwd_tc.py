"""The dense attention backward's tensor-core pair (``flash_bwd_dq_tc`` /
``flash_bwd_dkv_tc``, bf16 at Dh 64) on the CPU: which design a call takes,
that the bounded sweep the pair runs adds exactly what the full sweep of the
plain versions adds, and that the padding-inside-kvl layout of the card's
check separates the two mask forms. The kernels themselves run only on the
card (``tests/test_torch_flash_bwd_gpu.py``, marked ``gpu``).

The sweep (``attention_sweep(..., dense=True)``, at 64-row tiles): dq's query
tile qt sweeps key tiles ``[0, ceil(kvl / 64))`` and, packed, only
``[lo[qt], min(hi[qt], ceil(kvl / 64)))`` (``segment_tile_bounds`` at 64/64:
every position of each segment id owning a row of the tile); dk/dv's key
tile kt sweeps query tiles by the same rule on its own ``[lo[kt], hi[kt])``.
In the select form a pair left out has p = 0 and ds = 0 exactly, so the
bounded sums equal the full ones bit for bit (float32 here), on any layout,
a segment id split into runs included. The streaming backward's sweep
(``packed_block_bounds``, each id's run) would miss pairs there.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops import flash_attention as fa

ROOT = Path(__file__).resolve().parents[1]
TILE = fa.STREAM_TILE


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _ragged_layout(t: int):
    """[3, t]: row 0 three videos head to tail then padding, row 1 one video
    with masked keys inside it (its own id throughout) then padding, row 2
    two videos with a stretch of padding between them (a segment of its own,
    no valid key) and none after."""
    valid = np.zeros((3, t), bool)
    seg = np.full((3, t), -1, np.int32)
    off = 0
    for s, n in enumerate((t // 3, t // 4, t // 5)):
        valid[0, off:off + n] = True
        seg[0, off:off + n] = s
        off += n
    n = int(0.7 * t)
    valid[1, :n] = True
    valid[1, 5:n:7] = False
    seg[1, :n] = 0
    a, b = t // 2, t // 2 + t // 10
    valid[2, :a] = True
    seg[2, :a] = 0
    seg[2, a:b] = 1
    valid[2, b:] = True
    seg[2, b:] = 2
    return valid, seg


def _split_layout(t: int):
    """[3, t] with segment ids split into runs: row 0 one video whose
    masked keys lie on segment -1 (padding's id) inside it, row 1 a video,
    another, then the first one's id again, then padding, row 2 two videos
    with the first's id again after a stretch of the second's masked keys
    and valid keys on segment -1 at the end."""
    rng = np.random.default_rng(t)
    valid = np.zeros((3, t), bool)
    seg = np.full((3, t), -1, np.int32)
    n = int(0.8 * t)
    valid[0, :n] = True
    valid[0, rng.integers(1, n, size=n // 8)] = False
    seg[0, valid[0]] = 0
    cuts = (0, t // 4, t // 2, int(0.7 * t))
    for s, (a, b) in zip((3, 1, 3), zip(cuts[:-1], cuts[1:])):
        valid[1, a:b] = True
        seg[1, a:b] = s
    a, b, c = t // 3, t // 2, int(0.9 * t)
    valid[2, :a] = True
    seg[2, :a] = 0
    valid[2, a:b] = True
    valid[2, a + 3:b:5] = False
    seg[2, a:b] = 1
    valid[2, b:c] = True
    seg[2, b:c] = 0
    valid[2, c:] = True
    return valid, seg


def _bounds_brute_force(seg, block):
    """``segment_tile_bounds`` at block/block by its definition, numpy."""
    b, t = seg.shape
    n = -(-t // block)
    lo, hi = np.zeros((b, n), np.int64), np.zeros((b, n), np.int64)
    for r in range(b):
        for i in range(n):
            pos = np.flatnonzero(np.isin(seg[r], seg[r, i * block:(i + 1) * block]))
            lo[r, i], hi[r, i] = pos.min() // block, -(-(pos.max() + 1) // block)
    return lo, hi


def _inputs(seed, valid, h, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    b, t = valid.shape
    return [torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(dtype)) for _ in range(4)]


def _sweep_masks(key_valid, seg_ids, dense=True):
    """[B, T, T] bool: the (query, key) pairs the dq kernel's sweep reaches
    and those the dk/dv kernel's sweep reaches, from ``attention_sweep`` (the
    bounds the prep hands the pair; ``dense=False``: the streaming
    backward's)."""
    b, t = key_valid.shape
    kvl, lo, hi, _ = fa.attention_sweep(key_valid, seg_ids, dense)
    n_live = (kvl.long() + TILE - 1) // TILE  # [B]
    n_tiles = -(-t // TILE)
    if lo is None:
        lo = torch.zeros((b, n_tiles), dtype=torch.long)
        hi = n_live[:, None].expand(b, n_tiles)
    lo, hi = lo.long(), torch.minimum(hi.long(), n_live[:, None])
    tile = torch.arange(t) // TILE
    own_lo, own_hi = lo[:, tile], hi[:, tile]  # [B, T]: each row's tile's range
    dq_mask = (own_lo[:, :, None] <= tile[None, None, :]) & (tile[None, None, :] < own_hi[:, :, None])
    dkv_mask = (own_lo[:, None, :] <= tile[None, :, None]) & (tile[None, :, None] < own_hi[:, None, :])
    return dq_mask, dkv_mask


def _swept_backward(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, dense=True):
    """The plain backward (``flash_bwd_{dq,dkv}_reference``'s arithmetic)
    summed only over the pairs of the pair's bounded sweeps."""
    qs, p, ds = fa._bwd_terms(q, k, v, key_valid, o, lse, g, seg_ids, softmax_dtype, None)
    dq_mask, dkv_mask = _sweep_masks(key_valid, seg_ids, dense)
    ds_q = ds * dq_mask[:, None]
    p_kv, ds_kv = p * dkv_mask[:, None], ds * dkv_mask[:, None]
    scale = fa._scale(q, None)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_q.to(k.dtype).float(), k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_kv.to(q.dtype).float(), qs.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_kv.to(g.dtype).float(), g.float())
    return tuple(fa._zero_past_kv_len(x.to(q.dtype), key_valid) for x in (dq, dk, dv))


@pytest.mark.parametrize("device,dtype,dh,route", [
    ("cuda", torch.bfloat16, 64, "tensor_core"),
    ("cuda", torch.bfloat16, 16, "first_design"),
    ("cuda", torch.bfloat16, 32, "first_design"),
    ("cuda", torch.bfloat16, 128, "first_design"),
    ("cuda", torch.float32, 64, "first_design"),
    ("cpu", torch.bfloat16, 64, "plain"),
    ("cpu", torch.float32, 64, "plain"),
])
def test_the_dense_backward_takes_the_tensor_core_pair_at_bf16_dh_64(
    monkeypatch, device, dtype, dh, route
):
    """bf16 at Dh 64 on CUDA takes the tensor-core pair on one prep (run by
    ``flash_backward`` once for both kernels); float32 and the other head
    widths the first design; CPU tensors the plain versions, with no launch
    counted. CUDA is stood in for on CPU tensors by patching ``_on_cuda``,
    the prep and the two launchers. The prep holds the dense sweep."""
    t = 100
    valid, seg = _ragged_layout(t)
    q, k, v, g = (x.to(dtype) for x in _inputs(7, valid, 2, dh))
    kv, sg = torch.from_numpy(valid), torch.from_numpy(seg)
    o, lse = fa.flash_forward_reference(q, k, v, kv, sg)
    args = (q, k, v, kv, o, lse, g, sg, "float32")
    counters = (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dq_tc, fa.flash_bwd_dkv_tc,
                fa.flash_bwd_stream_prep)
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
    launched, preps = [], []
    if device == "cuda":
        monkeypatch.setattr(fa, "_on_cuda", lambda *a: True)
        monkeypatch.setattr(fa, "flash_bwd_stream_prep",
                            lambda *a, **kw: preps.append((kw["scale"], kw["dense"])) or "prep")
        monkeypatch.setattr(fa, "_tc_launch", lambda name, *a, dense: launched.append(
            (name, a[-2], dense)))
        monkeypatch.setattr(fa, "_bwd_launch", lambda name, *a: launched.append(
            (name, None, None)))
    got = fa.flash_backward(*args, scale=0.25)
    want = {"tensor_core": [("flash_bwd_dq_tc", "prep", True),
                            ("flash_bwd_dkv_tc", "prep", True)],
            "first_design": [("flash_bwd_dq", None, None), ("flash_bwd_dkv", None, None)],
            "plain": []}[route]
    assert launched == want
    assert preps == ([(0.25, True)] if route == "tensor_core" else [])
    counts = [c.launches for c in counters]
    assert counts == {"tensor_core": [1, 1, 1, 1, 0], "first_design": [1, 1, 0, 0, 0],
                      "plain": [0, 0, 0, 0, 0]}[route]
    if route == "plain":
        ref = fa.flash_backward_reference(*args, scale=0.25)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    if route == "tensor_core":  # a given prep is taken as is, with no prep of its own
        fa.flash_bwd_dq(*args, prep="given")
        fa.flash_bwd_dkv(*args, prep="given")
        assert launched[2:] == [("flash_bwd_dq_tc", "given", True),
                                ("flash_bwd_dkv_tc", "given", True)]
        assert preps == [(0.25, True)]
        fa.flash_bwd_dq(*args)  # no prep given: one of its own, with the dense sweep
        assert preps[1:] == [(None, True)] and launched[-1] == ("flash_bwd_dq_tc", "prep", True)


def _layout(name):
    if name.startswith("phase3"):
        cs = _chip_smoke()
        return cs.packed_attention_layout(6, 2048, padding_inside=name.endswith("inside"),
                                          split_ids=name.endswith("split"))
    return (_split_layout if name.startswith("split") else _ragged_layout)(1000)


@pytest.mark.parametrize("layout", ["phase3_packed", "phase3_padding_inside", "ragged_packed",
                                    "ragged_unpacked", "phase3_split", "split_packed"])
@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
def test_the_bounded_sweep_is_exact_in_the_select_form(layout, softmax_dtype):
    """The plain backward summed only over the tensor-core pair's sweeps
    equals the full plain backward bit for bit (float32 inputs): on phase
    3's packed [6, 2048] layout (chip_smoke.py), with padding inside kvl and
    with split segment ids, on a ragged T = 1000 layout, packed and
    unpacked, and on T = 1000 rows whose ids are split into runs."""
    valid, seg = _layout(layout)
    packed = layout != "ragged_unpacked"
    for r in range(valid.shape[0]):  # a row at a time: [1, H, T, T] scores
        kv = torch.from_numpy(valid[r:r + 1])
        sg = torch.from_numpy(seg[r:r + 1]) if packed else None
        q, k, v, g = _inputs(r, valid[r:r + 1], 1, 16)
        o, lse = fa.flash_forward_reference(q, k, v, kv, sg, softmax_dtype)
        g = g.masked_fill(~(torch.arange(kv.shape[1])[None] < fa._kv_len(kv))[..., None, None],
                          0.0)
        args = (q, k, v, kv, o, lse, g, sg, softmax_dtype)
        full = fa.flash_backward_reference(*args)
        swept = _swept_backward(*args)
        for name, a, b in zip(("dq", "dk", "dv"), swept, full):
            assert torch.equal(a, b), (layout, r, name, float((a - b).abs().max()))
        if packed and "split" not in layout:  # the sweeps do leave pairs out
            dq_mask, _ = _sweep_masks(kv, sg)  # (on rows with more than one segment)
            live = torch.arange(kv.shape[1]) < fa._kv_len(kv)[0, 0]
            assert bool((~dq_mask[0][live][:, live]).any()) == (len(set(seg[r]) - {-1}) > 1)


@pytest.mark.parametrize("layout", ["phase3_split", "split_packed"])
def test_the_streaming_sweep_misses_pairs_of_split_ids(layout):
    """The same sums over the streaming backward's sweep (each id's run,
    ``packed_block_bounds``) differ from the full plain backward on every
    row whose ids are split: the layouts above that the dense sweep gets
    right have teeth."""
    valid, seg = _layout(layout)
    for r in range(valid.shape[0]):
        kv, sg = torch.from_numpy(valid[r:r + 1]), torch.from_numpy(seg[r:r + 1])
        q, k, v, g = _inputs(r, valid[r:r + 1], 1, 16)
        o, lse = fa.flash_forward_reference(q, k, v, kv, sg)
        g = g.masked_fill(~(torch.arange(kv.shape[1])[None] < fa._kv_len(kv))[..., None, None],
                          0.0)
        args = (q, k, v, kv, o, lse, g, sg, "float32")
        full = fa.flash_backward_reference(*args)
        swept = _swept_backward(*args, dense=False)
        assert not all(torch.equal(a, b) for a, b in zip(swept, full)), (layout, r)


@pytest.mark.parametrize("layout", ["phase3_packed", "phase3_padding_inside", "phase3_split",
                                    "ragged_packed", "split_packed"])
@pytest.mark.parametrize("block", [64, 100])
def test_segment_tile_bounds(layout, block):
    """``segment_tile_bounds`` against its definition by brute force; where
    each video is one run (as packing lays them), its sweep before kvl
    equals ``packed_block_bounds``' (the streaming backward's, and what the
    TPU kernels sweep)."""
    valid, seg = _layout(layout)
    sg = torch.from_numpy(seg)
    lo, hi = fa.segment_tile_bounds(sg, block, block)
    assert lo.dtype == hi.dtype == torch.int32
    want_lo, want_hi = _bounds_brute_force(seg, block)
    assert np.array_equal(lo.numpy(), want_lo) and np.array_equal(hi.numpy(), want_hi)
    if "split" in layout:
        return
    p_lo, p_hi = (x.long() for x in fa.packed_block_bounds(sg, block, block))
    n_live = (fa._kv_len(torch.from_numpy(valid)).long() + block - 1) // block  # [B, 1]
    lo, hi = lo.long(), torch.minimum(hi.long(), n_live)
    p_hi = torch.minimum(p_hi, n_live)
    live = torch.arange(lo.shape[1])[None] < n_live  # tiles before kvl
    same = (lo == p_lo) & (hi == p_hi) | (lo >= hi) & (p_lo >= p_hi)
    assert bool(same[live].all())


def test_padding_inside_kvl_separates_the_select_and_the_bias_form():
    """On the padding-inside row of phase 3 (chip_smoke.py), with bf16
    inputs and the float32 interior and g random on the padding, the select
    form's plain versions (the dense kernels' contract) and the bias form's
    (``flash_bwd_{dq,dkv}_stream_reference``) differ by more than the card's
    bf16 bound: a kernel in the wrong form fails there."""
    cs = _chip_smoke()
    valid, seg = cs.packed_attention_layout(6, 2048, padding_inside=True)
    kv, sg = torch.from_numpy(valid[:1]), torch.from_numpy(seg[:1])
    q, k, v, g = (x.to(torch.bfloat16) for x in _inputs(3, valid[:1], 2, 16))
    o, lse = fa.flash_forward_reference(q, k, v, kv, sg, "float32")
    past = torch.arange(kv.shape[1])[None] >= fa._kv_len(kv)
    g = g.masked_fill(past[..., None, None], 0.0)
    pad = ~kv & ~past
    assert bool(pad.any()) and bool((g[pad] != 0).any())
    args = (q, k, v, kv, o, lse, g, sg, "float32")
    select = fa.flash_backward_reference(*args)
    bias = (fa.flash_bwd_dq_stream_reference(*args), *fa.flash_bwd_dkv_stream_reference(*args))
    for name, s_, b_ in zip(("dq", "dk", "dv"), select, bias):
        rel = float((s_.float() - b_.float()).abs().max()) / float(s_.float().abs().max())
        assert rel > cs.BWD_REL_BF16, (name, rel)


def test_segment_tile_bounds_widen_where_ids_share_a_slot():
    """Ids a multiple of T + 1 apart share a slot: their spans join, which
    widens the sweep past the definition's and keeps it exact."""
    t = 300
    valid, seg = _ragged_layout(t)
    seg[0][seg[0] == 1] = t + 1  # row 0's second video now shares the first one's slot
    lo, hi = (x.numpy() for x in fa.segment_tile_bounds(torch.from_numpy(seg), TILE, TILE))
    want_lo, want_hi = _bounds_brute_force(seg, TILE)
    assert (lo <= want_lo).all() and (hi >= want_hi).all()
    assert (lo[0] < want_lo[0]).any() or (hi[0] > want_hi[0]).any()
    kv, sg = torch.from_numpy(valid[:1]), torch.from_numpy(seg[:1])
    q, k, v, g = _inputs(5, valid[:1], 1, 16)
    o, lse = fa.flash_forward_reference(q, k, v, kv, sg)
    args = (q, k, v, kv, o, lse, g.masked_fill(~kv[..., None, None], 0.0), sg, "float32")
    for a, b in zip(_swept_backward(*args), fa.flash_backward_reference(*args)):
        assert torch.equal(a, b)
