"""Port InferencePipeline (repurpose_tpu_torch.infer) on the CPU: against the
reference's inference goldens, the reference's trained checkpoint, and the
JAX InferencePipeline on the same weights; packed against unpacked serving.

Tolerances as tests/test_decode.py and tests/test_train_parity.py hold the
JAX pipeline: segments atol 2e-3, scores atol 1e-4, labels and tIoU exact.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repurpose_tpu.config import ModelConfig as JaxModelConfig
from repurpose_tpu.config import TestConfig as JaxTestConfig
from repurpose_tpu.infer import InferencePipeline as JaxPipeline
from repurpose_tpu.models import MMCT as JaxMMCT
from repurpose_tpu.utils.metrics import calculate_tiou
from repurpose_tpu_torch.config import ModelConfig, TestConfig
from repurpose_tpu_torch.infer import InferencePipeline
from repurpose_tpu_torch.models import (
    build_model,
    load_reference_checkpoint,
    state_dict_from_jax_params,
)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

TINY = dict(
    vis_dim=32, aud_dim=64, text_dim=16, d_model=64,
    self_num_layers=2, num_heads=4, d_ff=128,
    compute_dtype="float32", matmul_precision="highest", attn_softmax_dtype="float32",
)
SMALL = dict(
    vis_dim=8, aud_dim=12, text_dim=4, d_model=16, self_num_layers=1,
    num_heads=2, d_ff=32, hidden_dim=8, compute_dtype="float32",
    attn_softmax_dtype="float32",
)
SERVE_CFG = dict(pre_nms_topk=64, pre_nms_thresh=0.2, duration_thresh=0.001,
                 duration_thresh_max=90, max_seg_per_min=1.0)


@pytest.mark.parametrize("impl", ["xla", "auto"])
def test_score_batch_matches_reference_inference(impl):
    data = np.load(os.path.join(GOLDEN_DIR, "tiny_model.npz"))
    golden = json.load(open(os.path.join(GOLDEN_DIR, "tiny_inference.json")))
    sd = {k[3:]: data[k] for k in data.files if k.startswith("sd/")}
    pipe = InferencePipeline(ModelConfig(**TINY, attention_impl=impl), sd,
                             TestConfig(**golden["test_cfg"]), device="cpu")
    results = pipe.score_batch(
        data["visual"], data["audio"], data["text"], data["mask"],
        [r["duration"] for r in golden["results"]],
        [r["video_id"] for r in golden["results"]],
    )
    assert len(results) == len(golden["results"])
    for got, want in zip(results, golden["results"]):
        assert got["video_id"] == want["video_id"]
        want_segs = np.asarray(want["segments"], np.float32)
        assert got["segments"].shape == want_segs.shape
        np.testing.assert_allclose(got["segments"], want_segs, atol=2e-3)
        np.testing.assert_allclose(got["scores"], np.asarray(want["scores"], np.float32),
                                   atol=1e-4)
        np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))


def test_trained_reference_checkpoint_decode_and_tiou():
    """The reference's trained .pth loads strictly and reproduces its kept
    segments, scores and tIoU."""
    data = np.load(os.path.join(GOLDEN_DIR, "tiny_trained.npz"))
    meta = json.load(open(os.path.join(GOLDEN_DIR, "tiny_trained_decode.json")))
    sd = load_reference_checkpoint(os.path.join(GOLDEN_DIR, "tiny_trained.pth"))
    pipe = InferencePipeline(ModelConfig(**TINY, dropout=0.0), sd,
                             TestConfig(**meta["test_cfg"]), device="cpu")
    results = pipe.score_batch(
        data["eval/visual"], data["eval/audio"], data["eval/text"],
        data["eval/mask"][:, 0, :], data["eval/lens"],
        [r["video_id"] for r in meta["results"]],
    )
    thresholds = (0.5, 0.6, 0.7, 0.8, 0.9)
    for r, g, gt in zip(results, meta["results"], meta["gt_segments"]):
        assert len(r["scores"]) == len(g["scores"]), (r, g)
        order = np.argsort(-np.asarray(r["scores"]))
        np.testing.assert_allclose(
            np.asarray(r["segments"])[order],
            np.asarray(g["segments"])[np.argsort(-np.asarray(g["scores"]))], atol=2e-3,
        )
        np.testing.assert_allclose(np.sort(r["scores"])[::-1], np.sort(g["scores"])[::-1],
                                   atol=1e-4)
        tiou = calculate_tiou(gt, r["segments"].tolist(), thresholds)
        for t in thresholds:
            assert tiou[t] == pytest.approx(g["tiou"][str(t)], abs=1e-6)


def _videos(seed, lengths, cfg):
    rng = np.random.default_rng(seed)
    return [
        {"visual": rng.normal(0, 1, (t, cfg["vis_dim"])).astype(np.float32),
         "audio": rng.normal(0, 1, (t, cfg["aud_dim"])).astype(np.float32),
         "text": rng.normal(0, 1, (t, cfg["text_dim"])).astype(np.float32),
         "video_id": f"vid{i}"}
        for i, t in enumerate(lengths)
    ]


@pytest.fixture(scope="module")
def small_pipe():
    cfg = ModelConfig(**SMALL)
    sd = build_model(cfg, "cpu", seed=0).state_dict()
    return InferencePipeline(cfg, sd, TestConfig(**SERVE_CFG), device="cpu")


def test_score_videos_routes_buckets_and_preserves_order(small_pipe):
    lengths = [30, 200, 64, 70, 130, 500]  # 500 > the largest bucket: truncates
    videos = _videos(1, lengths, SMALL)
    results = small_pipe.score_videos(videos, buckets=(64, 256), batch_size=2)
    assert [r["video_id"] for r in results] == [f"vid{i}" for i in range(6)]
    assert [r["duration"] for r in results] == [30, 200, 64, 70, 130, 256]
    for i in (0, 1, 5):
        t = min(lengths[i], 256)
        bucket = 64 if t <= 64 else 256
        pad = lambda a: np.pad(a[:t], ((0, bucket - t), (0, 0)))[None]  # noqa: E731
        mask = np.zeros((1, bucket), bool)
        mask[0, :t] = True
        v = videos[i]
        direct = small_pipe.score_batch(pad(v["visual"]), pad(v["audio"]), pad(v["text"]),
                                        mask, [t], [f"vid{i}"])[0]
        np.testing.assert_array_equal(results[i]["segments"], direct["segments"])
        np.testing.assert_array_equal(results[i]["scores"], direct["scores"])


@pytest.mark.parametrize("buckets", [(64, 128, 256), (256,)])
def test_score_videos_packed_equals_unpacked(small_pipe, buckets):
    """pack=True gives the unpacked results per video, in input order; with
    one 256 bucket several videos share each packed row."""
    videos = _videos(2, [30, 55, 100, 62, 200, 17, 90, 140], SMALL)
    plain = small_pipe.score_videos(videos, buckets=buckets, batch_size=4)
    packed = small_pipe.score_videos(videos, buckets=buckets, batch_size=4, pack=True)
    assert [r["video_id"] for r in packed] == [f"vid{i}" for i in range(8)]
    assert sum(len(r["labels"]) for r in plain) > 0
    for a, b in zip(plain, packed):
        assert a["duration"] == b["duration"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["scores"], b["scores"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a["segments"], b["segments"], rtol=1e-5, atol=1e-5)


def test_score_videos_row_bucketing_value_identical(small_pipe):
    videos = _videos(7, [30, 55, 40, 62], SMALL)
    for pack in (False, True):
        full = small_pipe.score_videos(videos, buckets=(64,), batch_size=4, pack=pack)
        for n in (1, 3):
            sub = small_pipe.score_videos(videos[:n], buckets=(64,), batch_size=4, pack=pack)
            for got, ref in zip(sub, full[:n]):
                np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
                np.testing.assert_allclose(got["segments"], ref["segments"],
                                           rtol=1e-5, atol=1e-5)


def test_raw_outputs_match_forward():
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg, "cpu", seed=5)
    pipe = InferencePipeline(cfg, model.state_dict(), TestConfig(**SERVE_CFG),
                             raw_outputs=True, device="cpu")
    rng = np.random.default_rng(5)
    vis, aud, txt = (rng.normal(0, 1, (2, 64, d)).astype(np.float32) for d in (8, 12, 4))
    durs = np.asarray([64, 40], np.int32)
    mask = np.arange(64)[None] < durs[:, None]
    results = pipe.score_batch(vis, aud, txt, mask, durs, ["a", "b"])
    with torch.inference_mode():
        fwd = model(*(torch.from_numpy(a) for a in (vis, aud, txt)), torch.from_numpy(mask))
    for i, r in enumerate(results):
        d = int(durs[i])
        np.testing.assert_allclose(r["raw_logits"], fwd.cls_logits[i, :d, 0].numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["raw_offsets"], fwd.offsets[i, :d].numpy(),
                                   rtol=1e-6, atol=1e-6)
    videos = [{"visual": vis[i, :d], "audio": aud[i, :d], "text": txt[i, :d],
               "video_id": "ab"[i]} for i, d in enumerate(durs)]
    packed = pipe.score_videos(videos, buckets=(128,), pack=True)
    for r, p in zip(results, packed):
        np.testing.assert_allclose(p["raw_logits"], r["raw_logits"], rtol=1e-5, atol=1e-5)


def test_score_stream_matches_score_batch(small_pipe):
    rng = np.random.default_rng(0)
    batches = []
    for i in range(3):
        vis, aud, txt = (rng.normal(0, 1, (2, 128, d)).astype(np.float32) for d in (8, 12, 4))
        mask = np.arange(128)[None] < np.asarray([[100], [120]])
        batches.append((vis, aud, txt, mask, [100, 120], [f"v{i}a", f"v{i}b"]))
    streamed = [r for out in small_pipe.score_stream(iter(batches)) for r in out]
    direct = [r for bt in batches for r in small_pipe.score_batch(*bt)]
    assert [r["video_id"] for r in streamed] == [r["video_id"] for r in direct]
    for s, d in zip(streamed, direct):
        np.testing.assert_array_equal(s["segments"], d["segments"])
        np.testing.assert_array_equal(s["scores"], d["scores"])


def test_params_override_uses_the_given_weights(small_pipe):
    videos = _videos(3, [60, 90], SMALL)
    other = build_model(ModelConfig(**SMALL), "cpu", seed=9).state_dict()
    want = InferencePipeline(ModelConfig(**SMALL), other, TestConfig(**SERVE_CFG),
                             device="cpu").score_videos(videos, buckets=(128,))
    got = small_pipe.score_videos(videos, buckets=(128,), params=other)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["scores"], b["scores"])


@pytest.mark.parametrize("pack", [False, True])
def test_pipeline_matches_jax_pipeline(pack):
    """Port and JAX pipelines on the same (carried-over) weights serve the
    same clips."""
    jcfg = JaxModelConfig(**{**SMALL, "attention_impl": "xla",
                             "matmul_precision": "highest"})
    params = JaxMMCT(jcfg).init_params(jax.random.key(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape).astype(np.float32), params
    )
    videos = _videos(4, [30, 55, 100, 62, 200], SMALL)
    want = JaxPipeline(jcfg, params, JaxTestConfig(**SERVE_CFG)).score_videos(
        videos, buckets=(64, 256), batch_size=2, pack=pack)
    got = InferencePipeline(ModelConfig(**SMALL), state_dict_from_jax_params(params),
                            TestConfig(**SERVE_CFG), device="cpu").score_videos(
        videos, buckets=(64, 256), batch_size=2, pack=pack)
    assert sum(len(r["labels"]) for r in want) > 0
    for a, b in zip(got, want):
        assert a["video_id"] == b["video_id"] and a["duration"] == b["duration"]
        np.testing.assert_array_equal(a["labels"], b["labels"])
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-4)
        np.testing.assert_allclose(a["segments"], b["segments"], atol=2e-3)
