"""The fused long-T attention backward (``flash_bwd_fused_tc``, bf16 at Dh
64) on the CPU: its plain version against the pair's, and which kernels
``flash_backward`` and the stream wrappers launch. The kernel itself runs
only on the card (``tests/test_torch_flash_bwd_stream_gpu.py``, marked
``gpu``).

``flash_bwd_fused_stream_reference`` is the fused kernel's arithmetic in its
order: per block of 128 keys (two 64-key tiles, each swept over the query
tiles of its own range), p and ds once a pair, dk and dv in float32 over the
block's sweep, and each query tile's dq partial added into a float32
accumulator that is scaled and rounded once. It is the function of
``flash_bwd_dq_stream_reference`` / ``flash_bwd_dkv_stream_reference``
with the sums in another order, so in float32 the two agree to 1e-5 of max
|gradient| (float32 summation order); under the bf16 interior p and ds are
the same bf16 values from the same s and dp, so the bound is the same.
"""

import numpy as np
import pytest
import torch

from repurpose_tpu_torch.ops import flash_attention as fa

F32_REL = 1e-5
TILE = fa.STREAM_TILE


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(name: str):
    """(valid, seg or None) of two rows at T, by case:
    - ``unpacked``: T = 384; row 0 full, row 1 valid to 300 with key holes;
    - ``packed``: T = 384; row 0 three videos head to tail, row 1 two videos
      with padding between them;
    - ``ragged``: T = 333 (not a multiple of 64), unpacked, row 0 full;
    - ``short_kvl``: T = 448, kvl 200 and 263: key tiles and whole 128-key
      blocks past kvl;
    - ``one_live_half``: T = 448; row 0 unpacked with kvl = 296 (the last
      block's second tile past kvl), row 1 packed: video [0, 200), padding
      [200, 330) (tile [256, 320) padding only, an empty range), video
      [330, 448)."""
    t = {"unpacked": 384, "packed": 384, "ragged": 333, "short_kvl": 448,
         "one_live_half": 448}[name]
    valid = np.zeros((2, t), bool)
    seg = np.full((2, t), -1, np.int32)
    packed = name in ("packed", "one_live_half")
    if name in ("unpacked", "ragged"):
        valid[0] = True
        valid[1, :300] = True
        valid[1, [7, 64, 65, 190]] = False
    elif name == "packed":
        for vid, (a, b) in enumerate([(0, 150), (150, 151), (151, 370)]):
            valid[0, a:b] = True
            seg[0, a:b] = vid
        valid[1, :90], seg[1, :90] = True, 0
        valid[1, 170:330], seg[1, 170:330] = True, 1
    elif name == "short_kvl":
        valid[0, :200] = True
        valid[1, :263] = True
        valid[1, 100:120] = False
    else:
        valid[0, :296] = True
        valid[1, :200], seg[1, :200] = True, 0
        valid[1, 330:], seg[1, 330:] = True, 1
        seg[0, :296] = 0
    return valid, (seg if packed else None)


def _args(name: str, softmax_dtype: str, seed: int = 0, h: int = 2, dh: int = 16):
    """Inputs of a case: float32 q, k, v, the upstream gradient 0 where the
    model's is (at or past kvl and, packed, off every video), o and lse from
    the plain stream forward."""
    valid, seg = _layout(name)
    rng = np.random.default_rng(seed)
    b, t = valid.shape
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32))
                  for _ in range(4))
    kv = torch.from_numpy(valid)
    sg = None if seg is None else torch.from_numpy(seg)
    rows = torch.arange(t)[None, :] < fa._kv_len(kv)
    if sg is not None:
        rows &= sg >= 0
    g = g.masked_fill(~rows[:, :, None, None], 0.0)
    o, lse = fa.flash_forward_stream_reference(q, k, v, kv, sg, softmax_dtype)
    return q, k, v, kv, o, lse, g, sg, softmax_dtype


def _assert_rel(got, want, rel, what):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= rel * max(scale, 1e-6), f"{what}: max err {err:.3g} > {rel} x {scale:.3g}"


@pytest.mark.parametrize("softmax_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["unpacked", "packed", "ragged", "short_kvl", "one_live_half"])
def test_fused_reference_equals_the_pair_references_in_float32(name, softmax_dtype):
    """dq, dk and dv of the fused plain version against the pair's plain
    versions, float32 inputs under either interior, relative 1e-5; rows at
    or past kvl exactly 0 in all three."""
    args = _args(name, softmax_dtype)
    got = fa.flash_bwd_fused_stream_reference(*args)
    want = (fa.flash_bwd_dq_stream_reference(*args), *fa.flash_bwd_dkv_stream_reference(*args))
    past = torch.arange(args[0].shape[1])[None, :] >= fa._kv_len(args[3])
    for what, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        _assert_rel(a, w, F32_REL, f"{name} {what}")
        assert bool((a[past] == 0).all()), f"{name} {what}: rows past kvl are not 0"
        assert float(w.abs().max()) > 0


@pytest.mark.parametrize("q_chunk", [64, 128, 192])
def test_fused_reference_chunking_does_not_change_the_result(q_chunk):
    """Query chunks of 64-192 rows against the default (one chunk here): the
    same pairs and rounding points, the float32 sums split differently."""
    args = _args("one_live_half", "bfloat16", seed=1)
    whole = fa.flash_bwd_fused_stream_reference(*args)
    for what, a, w in zip(("dq", "dk", "dv"),
                          fa.flash_bwd_fused_stream_reference(*args, q_chunk=q_chunk), whole):
        _assert_rel(a, w, F32_REL, what)


def test_one_live_half_layout_has_blocks_with_one_dead_tile():
    """The ``one_live_half`` case holds what it names: a 128-key block whose
    second tile lies past kvl (row 0) and one whose first tile is padding
    only, with an empty range, beside a live second tile (row 1)."""
    valid, seg = _layout("one_live_half")
    kv, sg = torch.from_numpy(valid), torch.from_numpy(seg)
    kvl, ranges = fa._stream_ranges(kv, sg)
    assert kvl[0] == 296 and 256 < kvl[0] <= 320  # block [256, 384): tile 5 past kvl
    lo, hi = ranges[1]
    assert lo[4] >= hi[4] and lo[5] < hi[5]  # block [256, 384): tile 4 dead, tile 5 live


class _Prep:
    """Stands in for a ``StreamPrep`` on the CPU: the fused route writes dq
    into ``qs``."""

    def __init__(self, q):
        self.qs = torch.empty_like(q)


@pytest.mark.parametrize("t,dtype,dh,route", [
    (200, torch.bfloat16, 64, "fused"),
    (128, torch.bfloat16, 64, "pair_tc"),
    (200, torch.float32, 64, "stream_first"),
    (200, torch.bfloat16, 32, "stream_first"),
])
def test_flash_backward_takes_the_fused_kernel_past_stream_max_t(monkeypatch, t, dtype, dh,
                                                                 route):
    """With CUDA stood in for (``_on_cuda``, the prep and the launchers
    patched, ``STREAM_MAX_T`` at 128): bf16 at Dh 64 past ``STREAM_MAX_T``
    takes one fused launch on the stream prep and no kernel of the pair,
    with dq in the prep's q_s; at ``STREAM_MAX_T`` the dense tensor-core
    pair; float32, or another head width, the first-design stream pair."""
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.normal(0, 1, (1, t, 2, dh)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    kv = torch.ones(1, t, dtype=torch.bool)
    o, lse = q.clone(), torch.zeros(1, 2, t, 1)
    counters = (fa.flash_bwd_fused_tc, fa.flash_bwd_dq_tc, fa.flash_bwd_dkv_tc,
                fa.flash_bwd_dq_stream, fa.flash_bwd_dkv_stream, fa.flash_bwd_dq,
                fa.flash_bwd_dkv)
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
    launched, preps = [], []

    def prep(*a, **kw):
        p = _Prep(a[0])
        preps.append(kw["dense"])
        return p

    monkeypatch.setattr(fa, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(fa, "flash_bwd_stream_prep", prep)
    monkeypatch.setattr(fa, "_tc_launch", lambda name, *a: launched.append((name, len(a[-1]))))
    monkeypatch.setattr(fa, "_bwd_launch", lambda name, *a: launched.append((name, None)))
    dq, dk, dv = fa.flash_backward(q, k, v, kv, o, lse, g, None, "bfloat16", scale=0.125)
    want = {"fused": [("flash_bwd_fused_tc", 4)],
            "pair_tc": [("flash_bwd_dq_tc", 1), ("flash_bwd_dkv_tc", 2)],
            "stream_first": [("flash_bwd_dq_stream", None), ("flash_bwd_dkv_stream", None)]}[route]
    assert launched == want
    assert preps == {"fused": [False], "pair_tc": [True], "stream_first": []}[route]
    counts = [c.launches for c in counters]
    assert counts == {"fused": [1, 0, 0, 0, 0, 0, 0], "pair_tc": [0, 1, 1, 0, 0, 1, 1],
                      "stream_first": [0, 0, 0, 1, 1, 0, 0]}[route]
    assert all(x.shape == q.shape and x.dtype == q.dtype for x in (dq, dk, dv))
    if route == "fused":
        assert dq.data_ptr() != dk.data_ptr() != dv.data_ptr()


@pytest.mark.parametrize("wrapper", ["dq", "dkv"])
def test_the_stream_wrappers_take_the_fused_kernel_past_stream_max_t(monkeypatch, wrapper):
    """With CUDA stood in for (``_on_cuda``, the prep and ``_tc_launch``
    patched, ``STREAM_MAX_T`` at 128): ``flash_bwd_dq_stream`` and
    ``flash_bwd_dkv_stream`` in bf16 at Dh 64 past ``STREAM_MAX_T`` each make
    one fused launch on a stream prep (no kernel of the pair), write their
    own gradients into the fused kernel's outputs and the others into
    scratch, and count in their own counter and the fused kernel's."""
    monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    t = 200
    q, k, v, g = (torch.zeros(1, t, 2, 64, dtype=torch.bfloat16) for _ in range(4))
    kv = torch.ones(1, t, dtype=torch.bool)
    o, lse = q.clone(), torch.zeros(1, 2, t, 1)
    counters = (fa.flash_bwd_fused_tc, fa.flash_bwd_dq_tc, fa.flash_bwd_dkv_tc,
                fa.flash_bwd_dq_stream, fa.flash_bwd_dkv_stream)
    for c in counters:
        monkeypatch.setattr(c, "launches", 0)
    launched, preps = [], []

    def prep(*a, **kw):
        preps.append(kw.get("dense", False))
        return _Prep(a[0])

    monkeypatch.setattr(fa, "_on_cuda", lambda *a: True)
    monkeypatch.setattr(fa, "flash_bwd_stream_prep", prep)
    monkeypatch.setattr(fa, "_tc_launch", lambda name, *a: launched.append((name, a[-2], a[-1])))
    monkeypatch.setattr(fa, "_bwd_launch", lambda name, *a: launched.append((name, None, None)))
    fn = {"dq": fa.flash_bwd_dq_stream, "dkv": fa.flash_bwd_dkv_stream}[wrapper]
    got = fn(q, k, v, kv, o, lse, g, None, "bfloat16", scale=0.125)
    got = got if isinstance(got, tuple) else (got,)
    assert preps == [False]  # a prep of its own, on the stream sweep
    assert [(name, type(p)) for name, p, _ in launched] == [("flash_bwd_fused_tc", _Prep)]
    acc, *outs = launched[0][2]
    assert acc.dtype == torch.float32 and acc.shape == (1, 2, 256, 64)
    mine = outs[:1] if wrapper == "dq" else outs[1:]
    assert [x.data_ptr() for x in got] == [x.data_ptr() for x in mine]
    assert len({x.data_ptr() for x in outs}) == 3  # the scratch is apart from the gradients
    assert all(x.shape == q.shape and x.dtype == q.dtype and x.is_contiguous() for x in outs)
    counts = [c.launches for c in counters]
    assert counts == ([1, 0, 0, 1, 0] if wrapper == "dq" else [1, 0, 0, 0, 1])
    given = _Prep(q)  # a given prep is taken as is
    fn(q, k, v, kv, o, lse, g, None, "bfloat16", given, scale=0.125)
    assert preps == [False] and launched[-1][:2] == ("flash_bwd_fused_tc", given)


def test_the_fused_wrapper_refuses_outputs_of_another_shape(monkeypatch):
    """dq, dk and dv must each be a contiguous tensor of q's shape and type."""
    monkeypatch.setattr(fa, "_tc_launch", lambda *a, **kw: None)
    q = torch.zeros(1, 200, 2, 64, dtype=torch.bfloat16)
    good = torch.zeros_like(q)
    for bad in (torch.zeros(1, 199, 2, 64, dtype=torch.bfloat16), good.float(),
                torch.zeros(1, 2, 200, 64, dtype=torch.bfloat16).transpose(1, 2)):
        with pytest.raises(ValueError):
            fa.flash_bwd_fused_tc(q, q, q, q, "bfloat16", 0.125, None, bad, good, good)
    before = fa.flash_bwd_fused_tc.launches
    fa.flash_bwd_fused_tc(q, q, q, q, "bfloat16", 0.125, None, good, good.clone(), good.clone())
    assert fa.flash_bwd_fused_tc.launches == before + 1
