"""The plain reference against ``repurpose_tpu_torch`` on seeded weights, on
the CPU at small widths with everything in float32: the forward (packed
and unpacked, with the program's dropout masks), decode with Soft-NMS, and
three training steps through the port's ``make_train_step``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gpubench.reference import model as ref
from gpubench.reference import serve as ref_serve
from gpubench.reference import train as ref_train
from gpubench.tests.tiny import TINY_MODEL
from gpubench.weights import make_weights

M = {**TINY_MODEL, "dropout": 0.1}


def program_model(train: bool):
    from repurpose_tpu_torch.config import ModelConfig
    from repurpose_tpu_torch.models.mmct import MMCT

    cfg = ModelConfig(**{k: v for k, v in M.items()}, compute_dtype="float32",
                      attention_impl="xla", attn_softmax_dtype="float32")
    model = MMCT(cfg)
    model.load_state_dict(make_weights(M, 3, "cpu"))
    return model.train(train)


def rows(packed: bool):
    g = torch.Generator().manual_seed(0)
    b, t = 2, 40
    feats = [torch.randn((b, t, M[k]), generator=g) for k in ("vis_dim", "aud_dim", "text_dim")]
    valid = torch.zeros((b, t), dtype=torch.bool)
    seg = torch.full((b, t), -1)
    pos = torch.zeros((b, t), dtype=torch.long)
    layout = [[17, 20], [33]] if packed else [[40], [29]]
    for r, lengths in enumerate(layout):
        at = 0
        for j, n in enumerate(lengths):
            valid[r, at : at + n] = True
            seg[r, at : at + n] = j
            pos[r, at : at + n] = torch.arange(n)
            at += n
    return feats, valid, seg, pos


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_program(packed, train):
    feats, valid, seg, pos = rows(packed)
    model = program_model(train)
    gen = torch.Generator().manual_seed(11)
    model.set_dropout_generator(gen)
    kw = {"seg_ids": seg.to(torch.int32), "positions": pos} if packed else {}
    with torch.no_grad():
        out = model(*feats, valid, **kw)
    drops = ref.DropStream(M["dropout"], torch.Generator().manual_seed(11)) if train else None
    w = make_weights(M, 3, "cpu")
    with torch.no_grad():
        cls, off = ref.forward(w, M, *feats, valid, seg, pos, drops)
    v = valid
    torch.testing.assert_close(cls[v], out.cls_logits[..., 0][v], atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(off[v], out.offsets[v], atol=2e-4, rtol=2e-5)


def test_decode_and_soft_nms_match_the_program():
    from repurpose_tpu_torch.config import TestConfig
    from repurpose_tpu_torch.ops.decode import decode_batch

    tcfg = TestConfig()
    rng = np.random.default_rng(4)
    for duration in (200, 700, 1300):
        logits = rng.normal(0, 2, duration).astype(np.float32)
        offsets = np.abs(rng.normal(15, 10, (duration, 2))).astype(np.float32)
        res = decode_batch(torch.from_numpy(logits)[None], torch.from_numpy(offsets)[None],
                           torch.ones((1, duration), dtype=torch.bool),
                           torch.tensor([duration]), tcfg)
        keep = res.keep[0].numpy()
        mine = ref_serve.clips(logits, offsets, duration, dataclasses.asdict(tcfg))
        np.testing.assert_array_equal(res.labels[0].numpy()[keep], mine["labels"])
        np.testing.assert_allclose(res.scores[0].numpy()[keep], mine["scores"], rtol=1e-6)
        np.testing.assert_allclose(res.segments[0].numpy()[keep], mine["segments"], rtol=1e-6)
        assert len(mine["labels"]) > 0
        served = {"labels": mine["labels"], "scores": mine["scores"],
                  "segments": mine["segments"], "duration": duration}
        gaps = ref_serve.judge_video(served, logits, offsets, dataclasses.asdict(tcfg))
        assert gaps.pop("logit_gap") < 1e-3  # the score's float32 rounding
        assert gaps == {"score_gap": 0.0, "bound_gap_s": 0.0, "forced_gap": 0.0,
                        "count_gap": 0.0}


def test_three_steps_match_the_programs_step(tmp_path):
    from repurpose_tpu_torch.config import DatasetConfig, ModelConfig, TrainConfig
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.models.mmct import MMCT
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    from gpubench import traffic

    seed = 21
    lengths = traffic.durations({"quantiles": [20, 50, 90, 120]}, 10, seed)
    dims = {"visual": M["vis_dim"], "audio": M["aud_dim"], "text": M["text_dim"]}
    corpus = traffic.write_corpus(str(tmp_path / "c"), lengths, dims, seed, "cpu")
    tc = {"batch_size": 2, "buckets": [64, 128], "pack_sequences": True, "loss_norm": "batch_size",
          "lr": 1e-3, "epochs": 50, "weight_decay": 1e-4}
    mcfg = ModelConfig(**M, compute_dtype="float32", attention_impl="xla",
                       attn_softmax_dtype="float32")
    tcfg = TrainConfig(seed=seed, batch_size=2, buckets=(64, 128), pack_sequences=True,
                       loss_norm="batch_size")
    d = corpus["dirs"]
    ds = RepurposeDataset(DatasetConfig(corpus["label_path"], d["visual"], d["audio"], d["text"]))
    loader = BatchLoader(ds, batch_size=2, buckets=(64, 128), seed=seed, pack=True)
    model = MMCT(mcfg)
    w0 = make_weights(M, seed, "cpu")
    model.load_state_dict(w0)
    model.set_dropout_generator(torch.Generator().manual_seed(seed))
    opt, schedule = make_optimizer(model, tcfg, loader.batches_per_epoch(0))
    state = TrainState(model=model, optimizer=opt)
    step = make_train_step(mcfg, tcfg, schedule)
    losses, grads, logits = [], None, []
    hook = model.cls_head.register_forward_hook(lambda m, i, out: logits.append(out[..., 0]))
    for i, batch in zip(range(3), loader.epoch(0)):
        losses.append(float(step(state, batch_to_device(batch, "cpu"))["loss"]))
        if grads is None:  # the first step's logits, the first gradient as Adam got it
            hook.remove()
            logits = logits[0].detach()[torch.as_tensor(batch.mask)]
            grads = ref_train.leaves((n, opt.state[p]["exp_avg"] / 0.1)
                                     for n, p in model.named_parameters() if p in opt.state)
            grads = {k: v.clone() for k, v in grads.items()}
    got = ref_train.summary(ref_train.follow(corpus, {"model": M, "train": tc}, seed, w0, 3,
                                             "cpu"), w0)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    prog = {"losses": losses, "logits": logits, "grads": grads,
            "grad_norms": ref_train.norms(grads),
            "update_norms": ref_train.norms(ref_train.leaves(
                (n, p.detach() - w0[n]) for n, p in model.named_parameters()))}
    gaps = ref_train.judge(prog, got)
    assert gaps["logit_gap"] < 1e-4
    assert gaps["grad_err"] < 1e-4 and gaps["grad_gap"] < 1e-4
    assert gaps["update_gap"] < 1e-3


def test_served_heads_follow_their_law():
    from gpubench.weights import served_weights

    g = np.random.default_rng(2)
    feats = {k: g.normal(0, 1, (300, M[d])).astype(np.float32)
             for k, d in (("visual", "vis_dim"), ("audio", "aud_dim"), ("text", "text_dim"))}
    law = {"cls": {"mean": -1.0, "std": 2.0}, "reg": {"mean": 15.0, "std": 8.0}}
    w = served_weights(M, 9, "cpu", law, feats)
    x = {k: torch.from_numpy(a)[None] for k, a in feats.items()}
    t = 300
    with torch.no_grad():
        cls, off = ref.forward(w, M, x["visual"], x["audio"], x["text"],
                               torch.ones((1, t), dtype=torch.bool),
                               torch.zeros((1, t), dtype=torch.long), torch.arange(t)[None])
    assert abs(float(cls.mean()) + 1.0) < 1e-3 and abs(float(cls.std()) - 2.0) < 1e-3
    # the ReLU clips little of a law this far above zero
    assert torch.allclose(off.mean(dim=(0, 1)), torch.tensor([15.0, 15.0]), atol=0.2)
