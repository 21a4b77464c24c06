"""The work counter against hand counts, for packed and unpacked rows, and
the trace's sums on a hand-made stretch."""

from __future__ import annotations

import pytest

from gpubench import workcount
from gpubench.readers import attn_roofline, h2d_ms_per_video, idle_pct, mfu
from gpubench.trace import SHORT_LABEL, Event, Trace

# one layer, two heads of 4: small enough to count by hand
M = {"vis_dim": 3, "aud_dim": 2, "text_dim": 1, "d_model": 8, "self_num_layers": 1,
     "num_heads": 2, "d_ff": 16, "hidden_dim": 4}


def test_linear_flops_by_hand():
    got = workcount.linear_flops_per_position(M)
    assert got["input"] == 2 * 6 * 8
    assert got["encoder"] == 2 * (3 * 64 + 64 + 2 * 8 * 16)
    assert got["cls"] == 2 * 64 + 2 * (8 * 4 + 4 * 4) + 2 * 4
    assert got["reg"] == 2 * (8 * 4 + 4 * 4) + 2 * 4 * 2


@pytest.mark.parametrize("rows,pairs,positions", [
    ([[5]], 25, 5),            # unpacked: one video, every pair of it
    ([[3, 2]], 9 + 4, 5),      # packed: block-diagonal, no pair across videos
    ([[3, 2], [4]], 9 + 4 + 16, 9),
])
def test_attention_work_by_hand(rows, pairs, positions):
    dh, heads = 4, 2
    flops, nbytes = workcount.attention_needed(rows, M, backward=False)
    assert flops == 4 * dh * heads * pairs
    assert nbytes == 4 * positions * heads * dh * 2 + positions * heads * 4
    flops_b, nbytes_b = workcount.attention_needed(rows, M, backward=True)
    assert flops_b == (4 + 10) * dh * heads * pairs
    assert nbytes_b == nbytes + 8 * positions * heads * dh * 2 + positions * heads * 4


def test_model_flops_by_hand():
    lin = workcount.linear_flops_per_position(M)
    per = sum(lin.values())
    assert workcount.forward_flops([3, 2], M) == per * 5 + 4 * 4 * 2 * (9 + 4)
    train = 2 * lin["input"] + 3 * (lin["encoder"] + lin["cls"]) + lin["reg"]
    assert workcount.train_flops([3], M) == train * 3 + 12 * 4 * 2 * 9


def test_least_seconds_takes_the_binding_bound():
    assert workcount.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert workcount.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def stretch():
    ev = [Event("gpubench.stretch", False, 0.0, 1.0),
          Event("aten::copy_", False, 0.05, 0.30),
          Event("cudaMemcpyAsync", False, 0.10, 0.30),
          Event("Memcpy HtoD (Pageable -> Device)", True, 0.1, 0.3),
          Event("void flash_fwd_tc_kernel<64>(Params)", True, 0.3, 0.5),
          Event("void flash_bwd_dq_tc_kernel<64>(Params)", True, 0.4, 0.6),
          Event("ampere_bf16_gemm", True, 0.6, 0.6 + 10e-6 / 2),
          Event("elementwise", True, 0.6 + 15e-6, 0.8)]
    return Trace(events=ev, span=(0.0, 1.0), wall_s=1.0)


def test_trace_sums():
    tr = stretch()
    assert tr.busy_s() == pytest.approx(0.8 - 0.1 - 10e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(0.1)  # 0.0-0.1: covered by the copy
    assert gaps[SHORT_LABEL] == pytest.approx(10e-6)
    assert tr.top_device_ops()[0][1] == pytest.approx(0.2)


def test_readers():
    ctx = {"trace": stretch(), "kind": "train", "videos": 4, "rows": [[[3, 2]]], "model": M}
    assert idle_pct(ctx, "train") == pytest.approx(100 * (1 - (0.8 - 0.1 - 10e-6)))
    assert idle_pct(ctx, "serve") is None
    assert h2d_ms_per_video(ctx, "train") == pytest.approx(1e3 * 0.2 / 4)
    least = workcount.least_seconds(*workcount.attention_needed([[3, 2]], M, True))
    assert attn_roofline(ctx, "train") == pytest.approx(100 * least / 0.4)
    assert mfu(ctx, "train") == pytest.approx(
        100 * workcount.train_flops([3, 2], M) / workcount.PEAK_BF16_FLOPS)
    assert attn_roofline({**ctx, "trace": None}, "train") is None
