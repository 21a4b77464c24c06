#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints no
verdict line):

1. card and build: print the card's name and power limit, build every
   kernel of ``repurpose_tpu_torch/csrc`` with nvcc for sm_90a;
2. kernel vs plain: the flash forward against its plain PyTorch version at
   the main path's shapes ([8, 2048, 8, 64] bf16, unpacked and packed, bf16
   and float32 softmax interior; T = 1000 in float32), with times of the
   kernel, the plain version, ``scaled_dot_product_attention`` (yardstick
   only) and the card's bound for the same work;
3. main path: the flagship MMCT (d_model 512, 16 layers, 8 heads, bf16,
   random weights from a numpy seed) serves requests of synthetic videos
   through ``InferencePipeline.score_videos``, unpacked and packed; the
   kernel's launch count must be 16 per forward batch;
4. a JSON line listing every ported kernel, then the verdict line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# One H100 SXM, dense peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # bf16 tensor cores; f32 FMA
HBM_BYTES_PER_S = 3.35e12

# Kernel vs plain tolerances. float32: the kernel sums in another order and
# rescales its online softmax (~1e-6 relative). bf16: outputs are bf16 (one
# ulp is 2**-7 relative) and with the bf16 softmax interior the kernel rounds
# exp(s - m) against its running max, the plain version against the final
# max; the out bound scales with max|out| because softmax over ~2000 keys
# averages N(0, 1) values down to ~0.03.
TOL = {
    "float32": dict(out_atol=1e-4, out_rtol=1e-4, lse_atol=1e-4),
    "bfloat16": dict(out_atol_rel_max=1e-2, out_rtol=1e-2, lse_atol=1e-2),
}
# Whole-model bound on the cls logits (O(1) values) where bf16 rounding
# differs: the kernel's bf16 softmax interior against the plain float32
# softmax, or packed rows against unpacked ones. Sixteen bf16 layers give
# ~1e-2 differences; 0.1 max / 0.02 mean leave room and still catch a wrong
# mask or a dropped key tile, which move logits by O(1).
BF16_LOGIT_MAX = 0.1
BF16_LOGIT_MEAN = 0.02


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# -- phase 1 ------------------------------------------------------------------


def phase_card_and_build() -> str:
    from repurpose_tpu_torch import native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    t0 = time.perf_counter()
    names = native.build_all()
    for n in names:
        native.load(n)
    print(f"[build] {', '.join(n + '.cu' for n in names)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for n, log in native.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {n}: {line.strip()}")
    return smi


# -- phase 2 ------------------------------------------------------------------


def _packed_layout(b: int, t: int):
    """seg_ids / key_valid of one packed batch from the port's own packing:
    synthetic video lengths of 200-1800 s, first-fit decreasing into rows of
    ``t`` (only the layout matters here, so the features are one wide)."""
    import numpy as np

    from repurpose_tpu_torch.data.batching import pack_batch, plan_packing

    rng = np.random.default_rng(SEED + 1)
    durs = [int(d) for d in rng.integers(200, 1801, size=24)]
    rows = plan_packing(durs, t, b)[0]
    samples = [
        {m: np.zeros((d, 1), np.float32) for m in ("visual", "audio", "text")}
        | {"duration": d} for d in durs
    ]
    batch = pack_batch(samples, rows, t, batch_size=b)
    return batch.mask, batch.seg_ids


def _attention_inputs(variant: dict, gen):
    import numpy as np
    import torch

    b, t, h, dh = variant["shape"]
    dtype = getattr(torch, variant["dtype"])
    # q/k/v as the main path gives them: column views of one fused projection
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dtype)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    if variant["packed"]:
        mask, seg = _packed_layout(b, t)
        seg = torch.from_numpy(seg).cuda()
    else:
        # lengths spread over 40-100 % of T, plus one all-padding row
        lens = [int(round(f * t)) for f in np.linspace(0.4, 1.0, b - 1)] + [0]
        mask = np.zeros((b, t), bool)
        for i, n in enumerate(lens):
            mask[i, :n] = True
        seg = None
    return q, k, v, torch.from_numpy(mask).cuda(), seg


def _bound(q, kv, seg):
    """Least time for the work these inputs need: the two products over the
    allowed (valid query, key) pairs, against q/k/v rows up to each batch
    row's last valid key read once and out/lse written once."""
    import torch

    b, t, h, dh = q.shape
    if seg is None:
        n = kv.sum(dim=1).double()
        pairs = float((n * n).sum())
    else:
        counts = torch.stack([(seg == s).sum(dim=1) for s in range(int(seg.max()) + 1)])
        pairs = float((counts.double() ** 2).sum())
    flops = 4.0 * pairs * h * dh
    idx = torch.arange(t, device=kv.device)
    kvl = torch.where(kv, idx + 1, 0).amax(dim=1)
    elem = q.element_size()
    bytes_ = (3 * float(kvl.sum()) * h * dh * elem + kv.numel()
              + (0 if seg is None else seg.numel() * 4)
              + q.numel() * elem + b * h * t * 4)
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, bytes_)


def phase_kernel_vs_plain() -> list[dict]:
    import torch
    import torch.nn.functional as F

    from repurpose_tpu_torch.ops.flash_attention import (
        SKIP_LSE,
        _kv_len,
        flash_forward,
        flash_forward_reference,
    )

    variants = [
        dict(name="unpacked_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=False),
        dict(name="unpacked_bf16_softmax_f32", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=False),
        dict(name="packed_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True),
        dict(name="packed_bf16_softmax_f32", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=True),
        dict(name="unpacked_f32_T1000", shape=(8, 1000, 8, 64),
             dtype="float32", sm="float32", packed=False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for var in variants:
        q, k, v, kv, seg = _attention_inputs(var, gen)
        out, lse = flash_forward(q, k, v, kv, seg_ids=seg, softmax_dtype=var["sm"])
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_reference(q, k, v, kv, seg, var["sm"])
        t = q.shape[1]
        skip = torch.arange(t, device="cuda")[None, :] >= _kv_len(kv)
        live = ~skip if seg is None else ~skip & (seg >= 0)
        got, want = out[live].float(), ref_out[live].float()
        lse_rows = lambda m: m[:, None, :, None].expand_as(lse)  # noqa: E731
        err = float((got - want).abs().max())
        lse_err = float((lse[lse_rows(live)] - ref_lse[lse_rows(live)]).abs().max())
        tol = TOL[var["dtype"]]
        atol = tol.get("out_atol", 0.0) or tol["out_atol_rel_max"] * float(want.abs().max())
        bad = int(((got - want).abs() > atol + tol["out_rtol"] * want.abs()).sum())
        check(bad == 0, f"{var['name']}: {bad} out elements past atol {atol:.3g} "
                        f"rtol {tol['out_rtol']} (max err {err:.3g})")
        check(lse_err <= tol["lse_atol"], f"{var['name']}: lse err {lse_err:.3g}")
        check(bool((out[skip] == 0).all()) and bool((lse[lse_rows(skip)] == SKIP_LSE).all()),
              f"{var['name']}: rows past kvl are not 0 / SKIP_LSE")
        check(bool(torch.isfinite(out.float()).all()), f"{var['name']}: non-finite out")

        ms = median_ms(lambda: flash_forward(q, k, v, kv, seg_ids=seg,
                                             softmax_dtype=var["sm"]), reps=20, warmup=3)
        plain_ms = median_ms(lambda: flash_forward_reference(q, k, v, kv, seg, var["sm"]),
                             reps=3, warmup=1)
        # yardstick: one PyTorch call computing the same attention, boolean mask
        allowed = kv[:, None, None, :]
        if seg is not None:
            allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        library_ms = median_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed),
            reps=10, warmup=2)
        bound_ms, bound_by, flops, bytes_ = _bound(q, kv, seg)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=var["sm"], packed=var["packed"], max_abs_err=err,
                   lse_max_abs_err=lse_err, out_atol=atol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=bytes_)
        print(f"[kernel] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, ref_out, ref_lse, allowed
        torch.cuda.empty_cache()
    return rows


# -- phase 3 ------------------------------------------------------------------


def _requests(cfg, n_requests: int):
    """Synthetic requests: 4-8 videos of 200-1800 s each, from a numpy seed."""
    import numpy as np

    from repurpose_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(SEED + 2)
    reqs = []
    for _ in range(n_requests):
        n = int(rng.integers(4, 9))
        reqs.append([synthetic_sample(rng, int(rng.integers(200, 1801)), cfg)
                     for _ in range(n)])
    return reqs


def phase_main_path(card: str) -> dict:
    import numpy as np
    import torch

    from repurpose_tpu_torch.config import ModelConfig, TestConfig
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops.decode import (
        decode_batch,
        decode_candidates,
        max_segments_for_duration,
    )
    from repurpose_tpu_torch.ops.flash_attention import flash_forward
    from repurpose_tpu_torch.ops.softnms import soft_nms_batch

    cfg = ModelConfig()  # the flagship: 512 wide, 16 layers, 8 heads, bf16
    # the decode thresholds of the repository's serving tests: with random
    # weights the default 10 s duration gate would leave no candidate
    test_cfg = TestConfig(duration_thresh=0.001)
    weights = build_model(cfg, "cpu", seed=SEED).state_dict()
    pipe = InferencePipeline(cfg, weights, test_cfg, raw_outputs=True, device="cuda")
    forwards = [0]
    pipe.model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    requests = _requests(cfg, 4)

    latencies = []
    served = []
    flash_forward.launches = 0
    for i, videos in enumerate(requests):
        t0 = time.perf_counter()
        unpacked = pipe.score_videos(videos, pack=False)
        t1 = time.perf_counter()
        packed = pipe.score_videos(videos, pack=True)
        t2 = time.perf_counter()
        latencies.append(dict(request=i, videos=len(videos),
                              seconds=sum(v["duration"] for v in videos),
                              unpacked_ms=(t1 - t0) * 1e3, packed_ms=(t2 - t1) * 1e3,
                              unpacked_videos_per_s=len(videos) / (t1 - t0),
                              packed_videos_per_s=len(videos) / (t2 - t1)))
        print(f"[serve] {card}: {json.dumps(latencies[-1])}")
        served.append((videos, unpacked, packed))
    # One more request in a single 2048 bucket, where packing lays several
    # videos in one row (with the four default buckets every video is longer
    # than half its bucket, so no two ever share a row).
    mixed = requests[0] + requests[1]
    mixed_unpacked = pipe.score_videos(mixed, buckets=(2048,), pack=False)
    mixed_packed = pipe.score_videos(mixed, buckets=(2048,), pack=True)
    launches = flash_forward.launches
    check(forwards[0] > 0, "no forward ran")
    check(launches == cfg.self_num_layers * forwards[0],
          f"flash_fwd launched {launches} times for {forwards[0]} forward batches "
          f"(want {cfg.self_num_layers} per batch)")
    print(f"[serve] flash_fwd launches {launches} = {cfg.self_num_layers} x "
          f"{forwards[0]} forward batches")

    def well_formed(v, r):
        check(r["video_id"] == v["video_id"] and r["duration"] == min(v["duration"], 2048),
              "result out of order")
        check(r["raw_logits"].shape == (r["duration"],)
              and bool(np.isfinite(r["raw_logits"]).all())
              and bool(np.isfinite(r["raw_offsets"]).all()), "bad raw outputs")
        check(bool(np.isfinite(r["scores"]).all()) and len(r["scores"]) == len(r["labels"])
              and bool(((r["labels"] >= 0) & (r["labels"] < r["duration"])).all()),
              "bad decoded result")

    # Default buckets: each packed row holds one video at the offset it has
    # unpacked, so the packed forward repeats the unpacked arithmetic exactly
    # (same key tiles, same matrix shapes) and the results must be equal.
    n_videos, kept = 0, 0
    for videos, unpacked, packed in served:
        for v, a, b in zip(videos, unpacked, packed):
            well_formed(v, a)
            well_formed(v, b)
            n_videos += 1
            kept += len(a["labels"])
            check(np.array_equal(a["labels"], b["labels"])
                  and np.array_equal(a["scores"], b["scores"])
                  and np.array_equal(a["segments"], b["segments"])
                  and np.array_equal(a["raw_logits"], b["raw_logits"]),
                  f"{v['video_id']}: packed result differs from unpacked")
    print(f"[serve] packed == unpacked in {n_videos}/{n_videos} videos "
          f"({kept} kept segments)")
    # Shared rows: the kernel's key tiles fall elsewhere in each video and the
    # matrix shapes differ, so bf16 rounding differs; held to the bf16 bound
    # below, the same as against the plain-attention model.
    mixed_err, same = 0.0, 0
    for v, a, b in zip(mixed, mixed_unpacked, mixed_packed):
        well_formed(v, a)
        well_formed(v, b)
        mixed_err = max(mixed_err, float(np.abs(a["raw_logits"] - b["raw_logits"]).max()))
        same += int(np.array_equal(a["labels"], b["labels"]))
    check(mixed_err <= BF16_LOGIT_MAX, f"shared-row packing: max |d logit| {mixed_err:.4g}")
    print(f"[serve] shared-row packing, {len(mixed)} videos in one 2048 bucket: max "
          f"|d logit| {mixed_err:.4g}; identical kept labels in {same}/{len(mixed)}")

    # the full-width forward against the same model with plain attention
    model_xla = build_model(dataclasses.replace(cfg, attention_impl="xla"), "cuda")
    model_xla.load_state_dict(pipe.model.state_dict())
    batch = collate(requests[0], (2048,), batch_size=8)
    args = [torch.from_numpy(a).cuda() for a in (batch.visual, batch.audio, batch.text)]
    mask = torch.from_numpy(batch.mask).cuda()
    with torch.inference_mode():
        out = pipe.model(*args, mask)
        ref = model_xla(*args, mask)
        d = (out.cls_logits - ref.cls_logits)[..., 0][mask].abs()
        fwd_ms = median_ms(lambda: pipe.model(*args, mask), reps=5)
        cand = decode_candidates(out.cls_logits[..., 0], out.offsets, mask, test_cfg)
        durs = torch.from_numpy(batch.durations).cuda()
        budget = max_segments_for_duration(durs, test_cfg.max_seg_per_min)
        nms_ms = median_ms(lambda: soft_nms_batch(cand[1], cand[0], budget,
                                                  test_cfg.nms_sigma, test_cfg.min_score),
                           reps=5)
        decode_ms = median_ms(lambda: decode_batch(out.cls_logits[..., 0], out.offsets,
                                                   mask, durs, test_cfg), reps=5)
    xla_max, xla_mean = float(d.max()), float(d.mean())
    check(xla_max <= BF16_LOGIT_MAX and xla_mean <= BF16_LOGIT_MEAN,
          f"kernel vs plain-attention model: max {xla_max:.4g} mean {xla_mean:.4g}")
    print(f"[forward] {card}: kernel vs plain-attention model, cls logits on valid rows: "
          f"max |d| {xla_max:.4g}, mean |d| {xla_mean:.4g}")
    print(f"[forward] {card}: [8, 2048] batch of {int(batch.mask.sum())} valid seconds: "
          f"forward {fwd_ms:.3f} ms, decode {decode_ms:.3f} ms "
          f"(of which Soft-NMS {nms_ms:.3f} ms)")
    _profile_request(pipe, requests[2], card)
    return dict(launches=launches, forwards=forwards[0])


def _profile_request(pipe, videos, card: str) -> None:
    """Where one packed request's time goes: device time by kernel against
    the host clock (torch.profiler with CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.score_videos(videos, pack=True)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"[profile] {card}: packed request of {len(videos)} videos: {wall_ms:.1f} ms "
          f"on the host clock, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "repurpose_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import repurpose_tpu_torch  # noqa: F401  (switches TF32 off)

    card = phase_card_and_build()
    variants = phase_kernel_vs_plain()
    served = phase_main_path(card)
    head = next(r for r in variants if r["name"] == "packed_bf16_softmax_bf16")
    kernels = [dict(
        name="flash_fwd", route="cuda", source="repurpose_tpu_torch/csrc/flash_fwd.cu",
        replaces="repurpose_tpu/ops/flash_attention.py:227", launches=served["launches"],
        max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], variant=head["name"], variants=variants,
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
