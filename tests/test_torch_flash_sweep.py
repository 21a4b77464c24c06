"""The attention sweep made once per batch (``attention_sweep``, an
``AttentionSweep``) on the CPU, against the per-call sweeps and the JAX
package:

- (a) the record equals, bit for bit, what each kernel call made for itself
  before it was shared: kvl (the JAX ``_kv_len``) and, packed, the dense
  kernels' ``segment_tile_bounds`` (T <= 2048; against its definition by
  brute force) or the stream kernels' ``packed_block_bounds`` (T > 2048;
  against the JAX ``_packed_block_bounds``), hi clamped to ceil(kvl / 64)
  as the kernels clamp it; on unpacked rows, the port's packing, and packed
  rows with padding inside kvl on a segment of its own or on segment -1
  (which splits a video's id into two runs);
- (b) a plain version of the tensor-core dense forward's bounded sweep
  (``_bounded_reference``: keys outside each query tile's key tiles take no
  part) against the JAX ``_flash_fwd_kernel`` in
  interpret mode (the JAX package's own test route, q_block 64), packed
  and unpacked, on rows that attend a key: float32, out within 1e-5 x max
  |out| and lse within 1e-5 (sums in another order). On the split-id
  layout the stream sweep (``packed_block_bounds``, each id's run) misses
  keys of the video's other run and is far off: the comparison has teeth.
  The wrapper on CPU tensors (the plain version over every key, the record
  only checked) gives the same bits on those rows;
- (c) a model with a kernel attention makes the sweep once per forward and
  once per remat training step (not once per layer), and its outputs and
  gradients equal, bit for bit, those of the calls that make their own.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repurpose_tpu.ops.flash_attention as jfa
from repurpose_tpu_torch.config import ModelConfig, TrainConfig
from repurpose_tpu_torch.data.batching import collate
from repurpose_tpu_torch.data.loader import BatchLoader
from repurpose_tpu_torch.data.synthetic import SyntheticDataset
from repurpose_tpu_torch.models import build_model
from repurpose_tpu_torch.ops import flash_attention as fa
from repurpose_tpu_torch.train.step import batch_to_device, loss_fn

ROOT = Path(__file__).resolve().parents[1]
TILE = fa.STREAM_TILE
KINDS = ["unpacked", "packed", "padding_inside", "split_ids"]


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


def _layout(kind: str, t: int, b: int = 4):
    """key_valid / seg_ids (None unpacked) numpy ``[b, t]``: unpacked rows of
    40-100 % of T and one of padding; else chip_smoke's packed rows (the
    port's packing of videos of T/10..9T/10 steps), with its padding-inside
    and split-id variants."""
    rng = np.random.default_rng(t + KINDS.index(kind))
    if kind == "unpacked":
        valid = np.zeros((b, t), bool)
        for r, f in enumerate(np.linspace(0.4, 1.0, b - 1)):
            valid[r, : int(f * t)] = True
        valid[0, rng.integers(0, t // 3, size=t // 20)] = False  # holes
        return valid, None
    durs = [int(d) for d in rng.integers(t // 10, t * 9 // 10, size=3 * b)]
    return _chip_smoke().packed_attention_layout(
        b, t, padding_inside=kind == "padding_inside", split_ids=kind == "split_ids", durs=durs)


def _bounded_reference(q, k, v, key_valid, seg_ids, softmax_dtype, sweep):
    """``flash_forward_reference`` with the tensor-core kernel's bounded
    sweep: keys outside each query tile's key tiles of ``sweep`` take no
    part, and the rows of a tile with an empty range get 0 / ``SKIP_LSE``.
    On a row that attends a key inside its sweep that changes no value (a
    key left out would add exp(-1e9 - m) = 0)."""
    t = q.shape[1]
    sm_dtype = fa._SM_DTYPES[softmax_dtype]
    qs = (q.float() * fa._scale(q, None)).to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), k.float())
    ok = key_valid[:, None, None, :]
    if seg_ids is not None:
        ok = ok & (seg_ids[:, None, :, None] == seg_ids[:, None, None, :])
    s = s + torch.where(ok, 0.0, fa.NEG_INF)
    tile = torch.arange(t) // TILE
    lo, hi = (x[:, tile] for x in fa._tile_ranges(sweep, t))  # [B, T]: each row's tile's
    swept = (lo[:, :, None] <= tile) & (tile < hi[:, :, None])  # [B, Tq, Tk]
    s = s.masked_fill(~swept[:, None], float("-inf")).to(sm_dtype)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True, dtype=torch.float32)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    out = (o / denom.permute(0, 2, 1, 3)).to(q.dtype)
    lse = m.float() + torch.log(denom)  # [B, H, T, 1]
    skip = (torch.arange(t)[None, :] >= fa._kv_len(key_valid)) | (lo >= hi)  # [B, T]
    out = out.masked_fill(skip[:, :, None, None], 0.0)
    lse = lse.masked_fill(skip[:, None, :, None], fa.SKIP_LSE)
    return out, lse


def _brute_dense_bounds(seg):
    """``segment_tile_bounds`` at 64/64 by its definition."""
    b, t = seg.shape
    n = -(-t // TILE)
    lo, hi = np.zeros((b, n), np.int64), np.zeros((b, n), np.int64)
    for r in range(b):
        for i in range(n):
            pos = np.flatnonzero(np.isin(seg[r], seg[r, i * TILE:(i + 1) * TILE]))
            lo[r, i], hi[r, i] = pos.min() // TILE, -(-(pos.max() + 1) // TILE)
    return lo, hi


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [100, 256, 2048, 4096])
def test_the_shared_record_equals_the_per_call_sweeps(kind, t):
    valid, seg = _layout(kind, t, b=2 if t > 2048 else 4)
    kv = torch.from_numpy(valid)
    sg = None if seg is None else torch.from_numpy(seg)
    record = fa.attention_sweep(kv, sg)
    assert record.dense == (t <= fa.STREAM_MAX_T)
    kvl = np.asarray(jfa._kv_len(jnp.asarray(valid)))[:, 0]
    assert record.kvl.dtype == torch.int32 and np.array_equal(record.kvl.numpy(), kvl)
    if sg is None:
        assert record.lo is None and record.hi is None
        return
    if record.dense:  # what the dense backward's prep made for itself per call
        lo, hi = (x.numpy() for x in fa.segment_tile_bounds(sg, TILE, TILE))
        assert all(np.array_equal(a, b) for a, b in zip((lo, hi), _brute_dense_bounds(seg)))
    else:  # what the stream forward's wrapper and the stream backward's prep made
        lo, hi = (x.numpy() for x in fa.packed_block_bounds(sg, TILE, TILE))
        j_lo, j_hi = jfa._packed_block_bounds(jnp.asarray(seg), TILE, TILE)
        assert np.array_equal(lo, np.asarray(j_lo)) and np.array_equal(hi, np.asarray(j_hi))
    n_live = -(-kvl // TILE)
    for x in (record.lo, record.hi):
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert np.array_equal(record.lo.numpy(), lo)
    assert np.array_equal(record.hi.numpy(), np.minimum(hi, n_live[:, None]))
    # the plain stream versions loop over the same ranges
    got_kvl, ranges = fa._stream_ranges(kv, sg, fa.attention_sweep(kv, sg, dense=False))
    assert got_kvl == kvl.tolist() and len(ranges) == len(kvl)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t", [128, 256])
def test_the_bounded_dense_sweep_matches_the_pallas_dense_kernel(kind, t):
    valid, seg = _layout(kind, t, b=3)
    rng = np.random.default_rng(t)
    q, k, v = (rng.normal(0, 1, (3, t, 2, 16)).astype(np.float32) for _ in range(3))
    jseg = None if seg is None else jnp.asarray(seg)
    j_out, j_lse = jfa._flash_forward(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(valid),
                                      64, True, sm_dtype=jnp.float32, seg_ids=jseg)
    args = (*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(valid),
            None if seg is None else torch.from_numpy(seg))
    sweep = fa.attention_sweep(args[3], args[4], dense=True)
    out, lse = _bounded_reference(*args, "float32", sweep)
    rows = _chip_smoke()._attending_rows(args[3], args[4]).numpy()
    j_out, j_lse = np.asarray(j_out), np.asarray(j_lse)[..., 0].transpose(0, 2, 1)
    scale = float(np.abs(j_out[rows]).max())
    assert float(np.abs(out.numpy()[rows] - j_out[rows]).max()) <= 1e-5 * scale
    assert float(np.abs(lse[..., 0].permute(0, 2, 1).numpy()[rows] - j_lse[rows]).max()) <= 1e-5
    # the wrapper on CPU tensors, the plain version over every key, gives
    # the same bits on those rows
    got = fa.flash_forward(*args, "float32", sweep=sweep)
    live = torch.from_numpy(rows)
    lse_rows = live[:, None, :, None].expand_as(lse)
    assert torch.equal(got[0][live], out[live]) and torch.equal(got[1][lse_rows], lse[lse_rows])
    if kind == "split_ids" and t == 256:  # (at 128 both sweeps take both tiles)
        # the stream sweep takes each run of an id alone and misses the other
        stream = fa.attention_sweep(args[3], args[4], dense=False)
        assert bool((stream.hi - stream.lo < sweep.hi - sweep.lo).any())
        wrong, _ = _bounded_reference(*args, "float32", stream)
        assert float(np.abs(wrong.numpy()[rows] - j_out[rows]).max()) > 1e-2 * scale


MODEL = ModelConfig(vis_dim=8, aud_dim=12, text_dim=4, d_model=64, self_num_layers=2,
                    num_heads=2, d_ff=64, hidden_dim=8, compute_dtype="float32",
                    attention_impl="pallas_full", attn_softmax_dtype="float32",
                    dropout=0.0, remat=True)


def _run(monkeypatch, batch, train_cfg, per_call: bool = False):
    """(sweeps in one forward, sweeps in one remat training step, outputs,
    loss, gradients) of the tiny model; ``per_call``: every attention call
    makes its own sweep."""
    calls = []
    make = fa.attention_sweep
    with monkeypatch.context() as m:
        m.setattr(fa, "attention_sweep", lambda *a, **kw: calls.append(1) or make(*a, **kw))
        model = build_model(MODEL, "cpu", seed=3)
        if per_call:
            model.multimodal_encoder.make_sweep = None
        kw = {} if batch.seg_ids is None else dict(seg_ids=batch.seg_ids,
                                                   positions=batch.positions)
        with torch.no_grad():
            out = model.eval()(batch.visual, batch.audio, batch.text, batch.mask, **kw)
        n_forward = len(calls)
        total, _ = loss_fn(model.train(), train_cfg, batch)
        total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return n_forward, len(calls) - n_forward, out, total.detach(), grads


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("stream", [False, True])
def test_one_sweep_per_forward_and_per_remat_step(monkeypatch, packed, stream):
    """Dense (T = 256) and, with ``STREAM_MAX_T`` patched to 128, streaming:
    one sweep per forward and per remat training step, where the streaming
    calls that make their own take one per layer and more (the dense plain
    versions on CPU tensors take none); the bits of both."""
    if stream:
        monkeypatch.setattr(fa, "STREAM_MAX_T", 128)
    ds = SyntheticDataset([250, 90, 140], MODEL, seed=4)
    train_cfg = TrainConfig(batch_size=2, buckets=(256,), pack_sequences=packed,
                            loss_norm="batch_size")
    if packed:
        batch = next(iter(BatchLoader(ds, 2, (256,), shuffle=False, pack=True).epoch(0)))
    else:
        batch = collate([ds[i] for i in range(2)], (256,), 2)
    batch = batch_to_device(batch, "cpu")
    shared = _run(monkeypatch, batch, train_cfg)
    per_call = _run(monkeypatch, batch, train_cfg, per_call=True)
    assert shared[:2] == (1, 1)
    layers = MODEL.self_num_layers
    if stream:  # forward and recompute; the dense plain versions sweep every key
        assert per_call[0] == layers and per_call[1] >= 2 * layers
    else:
        assert per_call[:2] == (0, 0)
    for a, b in zip(shared[2], per_call[2]):
        assert torch.equal(a, b)
    assert torch.equal(shared[3], per_call[3])
    assert shared[4].keys() == per_call[4].keys() and len(shared[4]) > 0
    for name, g in shared[4].items():
        assert torch.equal(g, per_call[4][name]), name


def test_a_foreign_record_raises_on_cpu_tensors():
    """A record of other inputs, or of the other sweep, raises ValueError in
    the plain versions too."""
    valid, seg = _layout("packed", 256)
    kv, sg = torch.from_numpy(valid), torch.from_numpy(seg)
    q = torch.zeros((4, 256, 2, 16))
    for bad in (fa.attention_sweep(kv[:, :128], sg[:, :128]), fa.attention_sweep(kv, sg, False),
                fa.attention_sweep(kv)):
        with pytest.raises(ValueError):
            fa.flash_forward(q, q, q, kv, sg, sweep=bad)
    with pytest.raises(ValueError):  # a dense record for the stream plain version
        fa.flash_forward_stream(q, q, q, kv, sg, sweep=fa.attention_sweep(kv, sg))
