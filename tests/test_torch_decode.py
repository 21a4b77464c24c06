"""Port decode and Soft-NMS (repurpose_tpu_torch.ops) against the reference
goldens, the JAX package's numpy oracle (``soft_nms_cpu``) and its decode,
on the CPU.

Selections (kept indices, labels, keep masks) must agree exactly; float
outputs to float32 rounding (atol 1e-6: sigmoid and the segment arithmetic
may differ by an ulp between XLA and PyTorch).
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repurpose_tpu.config import TestConfig as JaxTestConfig
from repurpose_tpu.ops.decode import decode_batch as jax_decode_batch
from repurpose_tpu.ops.decode import decode_packed as jax_decode_packed
from repurpose_tpu.ops.softnms import soft_nms_cpu
from repurpose_tpu_torch.config import TestConfig
from repurpose_tpu_torch.ops.decode import (
    decode_batch,
    decode_packed,
    max_segments_for_duration,
    unpack_rows,
)
from repurpose_tpu_torch.ops.softnms import soft_nms_batch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "softnms.json")
CASES = json.load(open(GOLDEN))


def _keep_indices(res, row=0):
    return res.orig_idx[row][res.keep[row]].numpy()


def _padded(scores_list, segments_list, k):
    b = len(scores_list)
    s = np.zeros((b, k), np.float32)
    g = np.zeros((b, k, 2), np.float32)
    for i, (sc, sg) in enumerate(zip(scores_list, segments_list)):
        s[i, : len(sc)] = sc
        g[i, : len(sc)] = sg
    return torch.from_numpy(s), torch.from_numpy(g)


@pytest.mark.parametrize("case", CASES, ids=[str(c["case_id"]) for c in CASES])
def test_soft_nms_matches_reference_golden(case):
    s, g = _padded([np.asarray(case["scores"], np.float32)],
                   [np.asarray(case["segments"], np.float32)], 256)
    res = soft_nms_batch(s, g, torch.tensor([case["max_seg_num"]]),
                         sigma=case["sigma"], thresh=case["thresh"])
    np.testing.assert_array_equal(_keep_indices(res), np.asarray(case["keep"], np.int64))


def test_soft_nms_batch_matches_oracle_on_random_sets():
    """One batched call over many random sets, each row with its own budget;
    includes a 0/0 row (zero-length intervals, no overlap) and a stale-length
    row (unsorted scores force swaps before decays)."""
    rng = np.random.default_rng(1234)
    scores, segments, budgets = [], [], []
    for _ in range(24):
        n = int(rng.integers(1, 80))
        sc = rng.uniform(0.0, 1.0, size=n).astype(np.float32)
        centers = rng.uniform(0, 400, size=n)
        durs = rng.uniform(10, 90, size=n)
        scores.append(sc)
        segments.append(np.stack([centers - durs / 2, centers + durs / 2], 1).astype(np.float32))
        budgets.append(int(rng.integers(1, 15)))
    scores.append(np.asarray([0.5, 0.9, 0.8, 0.7], np.float32))  # 0/0
    segments.append(np.asarray([[5, 5], [5, 5], [9, 9], [5, 5]], np.float32))
    budgets.append(4)
    scores.append(np.asarray([0.3, 0.95, 0.2, 0.9, 0.85], np.float32))  # stale lengths
    segments.append(np.asarray([[0, 100], [10, 20], [15, 90], [12, 30], [0, 14]], np.float32))
    budgets.append(5)
    s, g = _padded(scores, segments, 96)
    res = soft_nms_batch(s, g, torch.tensor(budgets), sigma=0.5, thresh=0.01)
    for row, (sc, sg, m) in enumerate(zip(scores, segments, budgets)):
        want = soft_nms_cpu(sc, sg, 0.5, 0.01, m)
        np.testing.assert_array_equal(_keep_indices(res, row), want, err_msg=f"row {row}")


def test_soft_nms_empty_and_single():
    res = soft_nms_batch(torch.zeros(2, 16), torch.zeros(2, 16, 2), torch.tensor([5, 0]))
    assert not res.keep.any()
    s, g = _padded([np.asarray([0.9], np.float32)], [np.asarray([[0.0, 30.0]], np.float32)], 8)
    res = soft_nms_batch(s, g, torch.tensor([5]), sigma=0.5, thresh=0.01)
    np.testing.assert_array_equal(_keep_indices(res), [0])


@pytest.mark.parametrize("duration,want", [(0, 0), (59, 0), (60, 1), (119, 1), (600, 3), (1800, 9)])
def test_max_segments_budget(duration, want):
    assert int(max_segments_for_duration(torch.tensor(duration), 0.3)) == want


@pytest.mark.parametrize("rate", [0.3, 0.1, 0.5, 0.7, 1.5])
def test_max_segments_budget_float64_exact(rate):
    mins = np.arange(0, 2001, dtype=np.int64)
    got = max_segments_for_duration(torch.from_numpy(mins * 60), rate).numpy()
    want = np.asarray([math.ceil(m * np.float64(rate)) for m in mins])
    np.testing.assert_array_equal(got, want)


def _logits(seed, b, t, lengths):
    """Logits on a coarse grid (ties between seconds) with offsets that pass
    and fail the duration gates."""
    rng = np.random.default_rng(seed)
    logits = np.round(rng.normal(0.5, 1.0, (b, t)) * 4) / 4
    offsets = rng.uniform(0, 40, (b, t, 2)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    return logits.astype(np.float32), offsets, mask


CFG = dict(pre_nms_topk=64, pre_nms_thresh=0.5, duration_thresh=10.0,
           duration_thresh_max=60.0, max_seg_per_min=3.0, nms_sigma=0.5, min_score=0.01)


def _assert_same(got, want):
    keep = want.keep
    np.testing.assert_array_equal(got.keep.numpy(), np.asarray(keep))
    for g, w in ((got.segments, want.segments), (got.scores, want.scores),
                 (got.labels, want.labels)):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g[np.asarray(keep)], w[np.asarray(keep)], atol=1e-6, rtol=0)


def test_decode_batch_matches_jax():
    lengths = [128, 100, 37, 0]
    logits, offsets, mask = _logits(0, 4, 128, lengths)
    durs = np.asarray(lengths, np.int32) * 30  # budgets of 0..64 segments
    want = jax_decode_batch(jnp.asarray(logits), jnp.asarray(offsets), jnp.asarray(mask),
                            jnp.asarray(durs), JaxTestConfig(**CFG))
    got = decode_batch(torch.from_numpy(logits), torch.from_numpy(offsets),
                       torch.from_numpy(mask), torch.from_numpy(durs), TestConfig(**CFG))
    assert got.keep.any()
    _assert_same(got, want)


def test_decode_packed_matches_jax():
    logits, offsets, _ = _logits(1, 2, 128, [128, 128])
    row_of = np.asarray([0, 0, 1, 1, 0, 0], np.int32)
    start = np.asarray([0, 70, 0, 50, 0, 0], np.int32)
    length = np.asarray([70, 58, 50, 78, 0, 0], np.int32)  # two capacity dummies
    want = jax_decode_packed(jnp.asarray(logits), jnp.asarray(offsets), jnp.asarray(row_of),
                             jnp.asarray(start), jnp.asarray(length), JaxTestConfig(**CFG))
    got = decode_packed(*(torch.from_numpy(a) for a in (logits, offsets, row_of, start, length)),
                        TestConfig(**CFG))
    assert got.keep[:4].any() and not got.keep[4:].any()
    _assert_same(got, want)


def test_unpack_rows_inverts_packing():
    packed = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10, 3)
    out, mask = unpack_rows(packed, torch.tensor([1, 0]), torch.tensor([4, 0]),
                            torch.tensor([6, 3]))
    torch.testing.assert_close(out[0, :6], packed[1, 4:10])
    torch.testing.assert_close(out[1, :3], packed[0, :3])
    assert mask.sum(dim=1).tolist() == [6, 3]
