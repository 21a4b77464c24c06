#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints no
verdict line):

1. card and build: print the card's name and power limit, build every
   kernel of ``repurpose_tpu_torch/csrc`` (one nvcc per source, in parallel)
   for sm_90a;
2. forward kernel vs plain: the flash forward against its plain PyTorch
   version at [8, 2048, 8, 64] bf16 (unpacked and packed, bf16 and float32
   softmax interior) and T = 1000 in float32, with times of the kernel, the
   plain version, ``scaled_dot_product_attention`` (yardstick only) and the
   card's bound for the same work;
3. backward kernels vs plain: dq and dk/dv against their plain versions at
   the training shapes ([6, 2048, 8, 64] bf16, unpacked and packed, both
   interiors; [6, 1000, 8, 64] float32), timed likewise, with SDPA's
   backward as the yardstick;
4. serving: the flagship MMCT (d_model 512, 16 layers, 8 heads, bf16,
   random weights from a numpy seed) serves requests of synthetic videos
   through ``InferencePipeline.score_videos``, unpacked and packed; 16 flash
   forward launches per forward batch;
5. training: the production config (packed [6, 2048] batches, bf16, dropout
   0.1) trains one epoch of synthetic videos through the CLI's ``run``:
   finite losses, the val probe, a checkpoint that ``resume()`` restores,
   the tIoU evaluation, and exactly 16 launches of each kernel per forward
   or step; then the step time, videos/s and a profiler breakdown of one
   step;
6. gradients: one packed [6, 2048] step of the kernel model against the
   plain-attention model, parameter by parameter;
7. long videos (``configs/longvideo.yaml``, buckets 2048..32768 at batch 1):
   a. the streaming forward kernel against its plain version at [1, 4096] and
      [1, 32768] unpacked, packed rows of [1, 8192] and [1, 32768], bf16 and
      float32, timed with the plain version, SDPA and (packed 32768) the dense
      kernel's packed variant;
   b. the flagship serves request A (one video per bucket) unpacked and
      packed, bit-identical, and request B (12 videos) in shared packed rows;
      the [1, 32768] forward against the plain-stream model; exactly 16
      launches of the streaming kernel per forward past T = 2048; the
      latency of each request and a profile of the 32768 batch;
   c. the inference CLI's ``run`` with ``--synthetic 4``, unpacked and packed;
8. a JSON line listing every ported kernel, then the verdict line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
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
# Backward kernels vs plain, on max |kernel - plain| as a fraction of max
# |plain gradient|. float32 with the float32 interior: 1e-4 (sums in another
# order, ~1e-6 relative each). bf16 inputs or the bf16 interior: 1e-2; the
# gradients are bf16 (one ulp is 2**-8 relative), and a last-bit difference
# in s or dp can flip the bf16 rounding of single p / ds entries. Relative to
# the maximum because gradients of ~2000-key softmaxes are small: a fixed
# bound would accept gradients of zeros.
BWD_REL = {("float32", "float32"): 1e-4}
BWD_REL_BF16 = 1e-2
# One training step's parameter gradients, kernel model against the
# plain-attention model (mha_torch), same weights and batch, dropout 0:
# relative L2 error per parameter.
# - Production setting (bf16 activations, the kernels' bf16 softmax interior
#   against the plain model's float32 softmax): 0.25. Every attention
#   probability differs by bf16 rounding (2**-8 relative) in each of 16
#   layers, and the residual stream carries it to the input side: the input
#   projection's gradient was 0.142 off on the first run, the in_proj
#   weights ~0.01. A missing gradient or a wrong mask is off by ~1.
# - float32 activations and interior (the kernels' float32 path): 1e-2. The
#   two differ only by float32 summation order, ~1e-4 per parameter (median
#   1.1e-4, in_proj weights <= 1.5e-4 on the first run), but the input side
#   sums random-sign terms over every position after 16 layers and showed
#   1.7e-3 (input projection).
GRAD_REL_BOUND = {"bfloat16": 0.25, "float32": 1e-2}

# Whole-model bound on the cls logits (O(1) values) where bf16 rounding
# differs: the kernel's bf16 softmax interior against the plain float32
# softmax, or packed rows against unpacked ones. Sixteen bf16 layers give
# ~1e-2 differences; 0.1 max / 0.02 mean leave room and still catch a wrong
# mask or a dropped key tile, which move logits by O(1).
BF16_LOGIT_MAX = 0.1
BF16_LOGIT_MEAN = 0.02


def production_config():
    """``load_config("configs/repurpose.yaml")`` built in Python: the card's
    machine has no PyYAML (a CPU test holds the two equal)."""
    from repurpose_tpu_torch.config import (
        Config, DatasetConfig, MeshConfig, ModelConfig, TestConfig, TrainConfig,
    )

    def split(name: str) -> DatasetConfig:
        return DatasetConfig(label_path=f"data/{name}.json",
                             video_path="data/video_clip_features",
                             audio_path="data/audio_pann_features",
                             text_path="data/caption_features")

    return Config(
        train_dataset=split("train"), val_dataset=split("val"), test_dataset=split("test"),
        model=ModelConfig(attention_impl="auto", compute_dtype="bfloat16"),
        train=TrainConfig(seed=1234, lr=1e-3, epochs=50, weight_decay=1e-4,
                          warmup_epochs=0, save_epochs=5, batch_size=6, eval_freq=1,
                          intra_epoch_eval_freq=50, buckets=(256, 512, 1024, 2048),
                          pack_sequences=True, loss_norm="batch_size"),
        mesh=MeshConfig(data=-1, model=1, seq=1, pipe=1),
        test_cfg=TestConfig(pre_nms_topk=1000, pre_nms_thresh=0.5, duration_thresh=10,
                            duration_thresh_max=90, max_seg_per_min=0.3, nms_sigma=0.5,
                            min_score=0.01),
    )


def longvideo_config():
    """``load_config("configs/longvideo.yaml")`` built in Python (a CPU test
    holds the two equal): the production model with ``remat`` (which serving
    ignores), buckets to 32768 at batch 1, unpacked by default."""
    from repurpose_tpu_torch.config import TrainConfig

    cfg = production_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=True),
        train=TrainConfig(seed=1234, lr=1e-3, epochs=50, weight_decay=1e-4,
                          warmup_epochs=0, save_epochs=5, batch_size=1, eval_freq=1,
                          intra_epoch_eval_freq=50,
                          buckets=(2048, 4096, 8192, 16384, 32768)))


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


def _counted_wrappers() -> dict:
    """Every kernel wrapper by kernel name; each counts its launches in
    ``.launches``."""
    from repurpose_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_forward, "flash_fwd_stream": fa.flash_forward_stream,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv}


def reset_launches() -> None:
    """Sets every kernel's launch count to 0: called just before a path runs."""
    for wrapper in _counted_wrappers().values():
        wrapper.launches = 0


def read_launches(*names: str) -> dict:
    """Launch counts of the kernels ``names``, read just after a path ran."""
    wrappers = _counted_wrappers()
    return {n: wrappers[n].launches for n in names}


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


def _packed_layout(b: int, t: int, durs: list[int]):
    """key_valid / seg_ids of the first packed batch of videos of ``durs``
    steps from the port's own packing, first-fit decreasing into ``b`` rows
    of ``t`` (only the layout matters here, so the features are one wide),
    and the number of videos it holds."""
    import numpy as np

    from repurpose_tpu_torch.data.batching import pack_batch, plan_packing

    rows = plan_packing(durs, t, b)[0]
    samples = [
        {m: np.zeros((d, 1), np.float32) for m in ("visual", "audio", "text")}
        | {"duration": d} for d in durs
    ]
    batch = pack_batch(samples, rows, t, batch_size=b)
    return batch.mask, batch.seg_ids, sum(len(r) for r in rows)


def _attention_inputs(variant: dict, gen):
    import numpy as np
    import torch

    b, t, h, dh = variant["shape"]
    dtype = getattr(torch, variant["dtype"])
    # q/k/v as the main path gives them: column views of one fused projection
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dtype)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    if variant["packed"]:
        # synthetic videos of 200-1800 s
        durs = [int(d) for d in np.random.default_rng(SEED + 1).integers(200, 1801, size=24)]
        mask, seg, _ = _packed_layout(b, t, durs)
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


def _hold_forward(name: str, out, lse, ref_out, ref_lse, kv, seg, dtype: str):
    """Holds a forward kernel's (out, lse) against its plain version under
    ``TOL``: query rows before kvl that attend a key are compared, rows at or
    past kvl must hold 0 / ``SKIP_LSE``. Returns (max |out error|, max |lse
    error|, the out atol, the compared rows [B, T])."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import SKIP_LSE, _kv_len

    skip = torch.arange(out.shape[1], device=out.device)[None, :] >= _kv_len(kv)
    live = ~skip if seg is None else ~skip & (seg >= 0)
    got, want = out[live].float(), ref_out[live].float()
    lse_rows = lambda m: m[:, None, :, None].expand_as(lse)  # noqa: E731
    err = float((got - want).abs().max())
    lse_err = float((lse[lse_rows(live)] - ref_lse[lse_rows(live)]).abs().max())
    tol = TOL[dtype]
    atol = tol.get("out_atol", 0.0) or tol["out_atol_rel_max"] * float(want.abs().max())
    bad = int(((got - want).abs() > atol + tol["out_rtol"] * want.abs()).sum())
    check(bad == 0, f"{name}: {bad} out elements past atol {atol:.3g} "
                    f"rtol {tol['out_rtol']} (max err {err:.3g})")
    check(lse_err <= tol["lse_atol"], f"{name}: lse err {lse_err:.3g}")
    check(bool((out[skip] == 0).all()) and bool((lse[lse_rows(skip)] == SKIP_LSE).all()),
          f"{name}: rows past kvl are not 0 / SKIP_LSE")
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite out")
    return err, lse_err, atol, live


def _sdpa_ms(q, k, v, kv, seg, reps: int) -> float:
    """Yardstick only: one PyTorch call computing the same attention,
    ``scaled_dot_product_attention`` on the same boolean mask."""
    import torch.nn.functional as F

    allowed = kv[:, None, None, :]
    if seg is not None:
        allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    return median_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed),
                     reps=reps)


def phase_kernel_vs_plain() -> list[dict]:
    import torch

    from repurpose_tpu_torch.ops.flash_attention import flash_forward, flash_forward_reference

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
        err, lse_err, atol, _ = _hold_forward(var["name"], out, lse, ref_out, ref_lse, kv,
                                              seg, var["dtype"])

        ms = median_ms(lambda: flash_forward(q, k, v, kv, seg_ids=seg,
                                             softmax_dtype=var["sm"]), reps=20, warmup=3)
        plain_ms = median_ms(lambda: flash_forward_reference(q, k, v, kv, seg, var["sm"]),
                             reps=3, warmup=1)
        library_ms = _sdpa_ms(q, k, v, kv, seg, reps=10)
        bound_ms, bound_by, flops, bytes_ = _bound(q, kv, seg)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=var["sm"], packed=var["packed"], max_abs_err=err,
                   lse_max_abs_err=lse_err, out_atol=atol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=bytes_)
        print(f"[kernel] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, ref_out, ref_lse
        torch.cuda.empty_cache()
    return rows


def _bwd_bound(q, kv, seg, products: int, outputs: int):
    """Least time for one backward kernel's work on these inputs: ``products``
    products of 2*Dh operations per allowed (valid query, key) pair and head
    (dq: s, dp, dq; dk/dv: s, dp, dv, dk), against q/k/v/g/o rows up to each
    batch row's last valid key read once, lse read once and ``outputs``
    gradients written once."""
    import torch

    b, t, h, dh = q.shape
    if seg is None:
        n = kv.sum(dim=1).double()
        pairs = float((n * n).sum())
    else:
        counts = torch.stack([(seg == s).sum(dim=1) for s in range(int(seg.max()) + 1)])
        pairs = float((counts.double() ** 2).sum())
    flops = products * 2.0 * pairs * h * dh
    idx = torch.arange(t, device=kv.device)
    kvl = torch.where(kv, idx + 1, 0).amax(dim=1)
    elem = q.element_size()
    bytes_ = (5 * float(kvl.sum()) * h * dh * elem + b * h * t * 4 + kv.numel()
              + (0 if seg is None else seg.numel() * 4) + outputs * q.numel() * elem)
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, bytes_)


def phase_backward_vs_plain() -> list[dict]:
    """The dq and dk/dv kernels against their plain versions at the training
    shapes, on o / lse from the kernel forward and an upstream gradient that
    is random before each row's last valid key and 0 past it (the model's)."""
    import torch
    import torch.nn.functional as F

    from repurpose_tpu_torch.ops.flash_attention import (
        _kv_len,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
        flash_forward,
    )

    variants = [
        dict(name="packed_bf16_softmax_bf16", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True),
        dict(name="unpacked_bf16_softmax_bf16", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=False),
        dict(name="packed_bf16_softmax_f32", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=True),
        dict(name="unpacked_bf16_softmax_f32", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=False),
        dict(name="unpacked_f32_T1000", shape=(6, 1000, 8, 64),
             dtype="float32", sm="float32", packed=False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for var in variants:
        q, k, v, kv, seg = _attention_inputs(var, gen)
        sm = var["sm"]
        o, lse = flash_forward(q, k, v, kv, seg_ids=seg, softmax_dtype=sm)
        past = torch.arange(q.shape[1], device="cuda")[None, :] >= _kv_len(kv)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        g = g.masked_fill(past[:, :, None, None], 0.0)
        args = (q, k, v, kv, o, lse, g, seg, sm)
        got = dict(dq=flash_bwd_dq(*args))
        got["dk"], got["dv"] = flash_bwd_dkv(*args)
        torch.cuda.synchronize()
        want = dict(dq=flash_bwd_dq_reference(*args))
        want["dk"], want["dv"] = flash_bwd_dkv_reference(*args)
        rel = BWD_REL.get((var["dtype"], sm), BWD_REL_BF16)
        errs = {}
        for name in ("dq", "dk", "dv"):
            a, w = got[name].float(), want[name].float()
            scale = float(w.abs().max())
            errs[name] = float((a - w).abs().max())
            check(errs[name] <= rel * scale,
                  f"{var['name']} {name}: max err {errs[name]:.3g} > {rel} x max {scale:.3g}")
            check(bool(torch.isfinite(a).all()), f"{var['name']} {name}: non-finite")
            check(bool((got[name][past] == 0).all()),
                  f"{var['name']} {name}: rows past kvl are not 0")

        # yardstick, never called by the port: the backward alone of SDPA on
        # the same boolean mask
        allowed = kv[:, None, None, :]
        if seg is not None:
            allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
        leaves = [z.transpose(1, 2).detach().requires_grad_() for z in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        g_t = g.transpose(1, 2)
        library_ms = median_ms(
            lambda: torch.autograd.grad(out, leaves, g_t, retain_graph=True), reps=10)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"], library_ms=library_ms)
        for kname, fn, ref_fn, products, outputs, keys in (
            ("dq", flash_bwd_dq, flash_bwd_dq_reference, 3, 1, ("dq",)),
            ("dkv", flash_bwd_dkv, flash_bwd_dkv_reference, 4, 2, ("dk", "dv")),
        ):
            bound_ms, bound_by, flops, bytes_ = _bwd_bound(q, kv, seg, products, outputs)
            row[kname] = dict(
                max_abs_err=max(errs[x] for x in keys),
                ms=median_ms(lambda: fn(*args), reps=20, warmup=3),
                plain_ms=median_ms(lambda: ref_fn(*args), reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
        print(f"[backward] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, kv, seg, o, lse, g, got, want, args, allowed, leaves, out, g_t
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
    reset_launches()
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


def _profile_request(pipe, videos, card: str, label: str | None = None, **score_kw) -> None:
    """Where one request's time goes (packed unless ``score_kw`` says
    otherwise): device time by kernel against the host clock (torch.profiler
    with CUDA activity)."""
    from torch.profiler import ProfilerActivity, profile

    score_kw = {"pack": True, **score_kw}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.score_videos(videos, **score_kw)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    label = label or f"packed request of {len(videos)} videos"
    print(f"[profile] {card}: {label}: {wall_ms:.1f} ms "
          f"on the host clock, device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")


# -- phase 4 ------------------------------------------------------------------


TRAIN_VIDEOS = 64  # synthetic training videos: about six packed [6, 2048] steps


def _training_config(steps_per_epoch: int | None = None):
    """The production config, one epoch that saves, evaluates and runs the
    val probe once (at its last step)."""
    cfg = production_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=1, save_epochs=1, eval_freq=1,
        intra_epoch_eval_freq=steps_per_epoch or cfg.train.intra_epoch_eval_freq))


def phase_training(card: str, workdir: str) -> dict:
    """The flagship model trains through ``python -m repurpose_tpu_torch.train``'s
    entry (``run(cfg, args)``) on synthetic videos: packed [6, 2048] batches,
    bf16, dropout 0.1, one epoch with the val probe, a checkpoint and the
    tIoU evaluation. Every MMCT forward launches the flash forward 16 times,
    every training step the two backward kernels 16 times each."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.models.mmct import MMCT
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.loop import Trainer

    cfg = _training_config()
    train_ds, _, _ = cli.build_datasets(cfg, TRAIN_VIDEOS)
    steps = BatchLoader(train_ds, cfg.train.batch_size, cfg.train.buckets,
                        seed=cfg.train.seed, pack=True).batches_per_epoch(0)
    cfg = _training_config(steps)
    args = cli.parse_args(["--synthetic", str(TRAIN_VIDEOS), "--epochs", "1",
                           "--workdir", workdir])
    forwards = {"all": 0, "grad": 0}

    def count(module, inputs, output):
        if isinstance(module, MMCT):
            forwards["all"] += 1
            forwards["grad"] += int(torch.is_grad_enabled() and module.training)

    hook = torch.nn.modules.module.register_module_forward_hook(count)
    reset_launches()
    t0 = time.perf_counter()
    try:
        summary = cli.run(cfg, args)
    finally:
        hook.remove()
    wall_s = time.perf_counter() - t0
    launches = read_launches("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    layers = cfg.model.self_num_layers
    check(summary["step"] == steps == forwards["grad"] and steps > 0,
          f"{summary['step']} steps, {forwards['grad']} training forwards, plan {steps}")
    check(launches["flash_fwd"] == layers * forwards["all"],
          f"flash_fwd launched {launches['flash_fwd']} times for {forwards['all']} forwards")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == layers * steps,
              f"{name} launched {launches[name]} times for {steps} steps")
    print(f"[train] {card}: {steps} steps of packed [6, 2048] batches, {forwards['all']} "
          f"forwards (val probe and eval included), launches {json.dumps(launches)} = "
          f"{layers} per forward / per step; run {wall_s:.1f} s on the host clock")

    lines = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    losses = [m["batch/loss"] for m in lines if "batch/loss" in m]
    check(len(losses) > 0 and all(np.isfinite(x) for x in losses)
          and np.isfinite(summary["final_loss"]), f"non-finite losses {losses}")
    check(any("val/loss" in m and np.isfinite(m["val/loss"]) for m in lines),
          "the val probe did not run")
    tiou_keys = {f"tiou/{t}" for t in (0.5, 0.6, 0.7, 0.8, 0.9)} | {"tiou/mean"}
    check(tiou_keys <= set(summary), f"evaluate returned {sorted(summary)}")
    blob = torch.load(os.path.join(workdir, "ckpt", f"{steps}.pt"), map_location="cpu",
                      weights_only=True)
    check(blob["nonfinite_count"] == 0 and blob["step"] == steps, "bad checkpoint")

    trainer = Trainer(cfg, workdir, train_ds, device="cuda")
    check(trainer.resume() and trainer.state.step == steps and trainer.start_epoch == 1,
          "resume() did not restore the checkpoint's step")
    print(f"[train] {card}: final loss {summary['final_loss']:.4f}, val probe ran, "
          f"checkpoint at step {steps} restored by resume(); eval "
          f"{json.dumps({k: summary[k] for k in sorted(tiou_keys)})}")

    # step time after warm-up: staging (H2D) + forward + backward + Adam,
    # synchronised, on the epoch's own packed batches
    times, videos = [], []
    for i, batch in enumerate(trainer.train_loader.epoch(1)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = trainer.train_step(trainer.state, trainer._device_batch(batch))
        torch.cuda.synchronize()
        if i >= 2:
            times.append(time.perf_counter() - t1)
            videos.append(int(m["n_real"]))
    step_ms = statistics.median(times) * 1e3
    videos_per_s = sum(videos) / sum(times)
    print(f"[train] {card}: step {step_ms:.2f} ms median over {len(times)} steps after "
          f"2 warm-up, {videos_per_s:.2f} videos/s ({sum(videos)} videos)")
    profile = _profile_step(trainer, card)
    trainer.close()
    return dict(launches=launches, steps=steps, step_ms=step_ms,
                videos_per_s=videos_per_s, **profile)


def _profile_step(trainer, card: str) -> dict:
    """Where one training step's time goes: device time by kernel against
    the host clock (torch.profiler with CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = trainer._device_batch(next(iter(trainer.train_loader.epoch(2))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"[profile] {card}: one training step: {wall_ms:.1f} ms on the host clock, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    return dict(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms)


def _step_grads(cfg, train_cfg, batch, impl: str) -> dict:
    """Parameter gradients of one step (dropout 0) with ``impl`` attention."""
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.step import loss_fn

    model = build_model(dataclasses.replace(cfg, dropout=0.0, attention_impl=impl),
                        "cuda", seed=SEED).train()
    loss_fn(model, train_cfg, batch)[0].backward()
    return {n: p.grad for n, p in model.named_parameters()}


def phase_gradients(card: str) -> None:
    """Every parameter gradient of one step of the kernel model (flash forward
    and backward kernels) against the same model with the plain attention
    (autograd through mha_torch), same weights, on a packed [6, 2048] batch:
    in the production setting (bf16, bf16 interior), and in float32 on two of
    its rows (the kernels' float32 path, where only summation order
    differs)."""
    from repurpose_tpu_torch.data.batching import Batch
    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.step import batch_to_device

    cfg = _training_config()
    train_ds, _, _ = cli.build_datasets(cfg, 16)
    batch = next(iter(BatchLoader(train_ds, cfg.train.batch_size, cfg.train.buckets,
                                  seed=cfg.train.seed, pack=True).epoch(0)))
    batch = batch_to_device(batch, "cuda")
    layers = cfg.model.self_num_layers
    qkv = [f"multimodal_encoder.layers.{i}.self_attn.in_proj_weight" for i in range(layers)]
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32",
                              attn_softmax_dtype="float32")
    two_rows = Batch(*[None if x is None else x[:2] for x in batch])
    for dtype, model_cfg, b in (("bfloat16", cfg.model, batch), ("float32", f32, two_rows)):
        kernel = _step_grads(model_cfg, cfg.train, b, "auto")
        plain = _step_grads(model_cfg, cfg.train, b, "xla")
        rels = {}
        for name, g_plain in plain.items():
            if g_plain is None:  # the reg head: no loss reaches it
                check(kernel[name] is None, f"{name}: gradient where the plain model has none")
                continue
            check(kernel[name] is not None, f"{name}: no gradient through the kernels")
            rels[name] = float((kernel[name] - g_plain).norm() / g_plain.norm())
        worst = sorted(rels, key=rels.get)[-3:]
        print(f"[grad] {card}: {dtype}, kernel vs plain-attention model, one packed "
              f"[{b.visual.shape[0]}, {b.visual.shape[1]}] step: {len(rels)} parameter "
              f"gradients, relative L2 error median {statistics.median(rels.values()):.4g}, "
              f"worst " + ", ".join(f"{n} {rels[n]:.4g}" for n in worst)
              + f"; in_proj_weight {min(rels[n] for n in qkv):.4g}.."
              f"{max(rels[n] for n in qkv):.4g} over {layers} layers")
        check(all(float(kernel[n].abs().max()) > 0 for n in qkv),
              "an in_proj_weight gradient is zero")
        bound = GRAD_REL_BOUND[dtype]
        bad = {n: r for n, r in rels.items() if not r <= bound}
        check(not bad, f"{dtype}: relative gradient errors past {bound}: {bad}")
        del kernel, plain


# -- phase 7: long videos -------------------------------------------------------


LONG_REQUEST_A = (1900, 3000, 6000, 12000, 30000)  # seconds: one video per long bucket
# Packed rows of phase 7a: video lengths (steps) per bucket, drawn from a seed;
# the 12 of the 32768 row are also request B of phase 7b.
LONG_PACKED = {8192: (4, 1500, 2000), 32768: (12, 1000, 2500)}


def _long_packed_lengths(t: int) -> list[int]:
    import numpy as np

    n, lo, hi = LONG_PACKED[t]
    rng = np.random.default_rng(SEED + 5 + t)
    return [int(d) for d in rng.integers(lo, hi + 1, size=n)]


def _long_attention_inputs(var: dict, gen):
    """q/k/v as column views of one QKV projection; unpacked: kvl = 0.9 T
    with one interior hole of 100 keys; packed: the ``_long_packed_lengths``
    videos first-fit into one row."""
    import numpy as np
    import torch

    b, t, h, dh = var["shape"]
    dtype = getattr(torch, var["dtype"])
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dtype)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    seg = None
    if var["packed"]:
        lens = _long_packed_lengths(t)
        mask, seg, held = _packed_layout(b, t, lens)
        check(held == len(lens), f"{var['name']}: {len(lens)} videos do not fit {b} rows")
        seg = torch.from_numpy(seg).cuda()
    else:
        mask = np.zeros((b, t), bool)
        mask[:, : int(0.9 * t)] = True
        mask[:, t // 3 : t // 3 + 100] = False
    return q, k, v, torch.from_numpy(mask).cuda(), seg


def phase_long_kernel_vs_plain() -> list[dict]:
    """7a: the streaming kernel against its plain version at the long-video
    shapes, timed with the plain version, SDPA on the same boolean mask
    (yardstick only) and, at the packed 32768 row, the dense kernel's packed
    variant, which sweeps every key tile up to kvl."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        flash_forward_stream,
        flash_forward_stream_reference,
        flash_fwd_dense,
    )

    variants = [
        dict(name="unpacked_T4096", shape=(1, 4096, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="unpacked_T32768", shape=(1, 32768, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="packed_T8192", shape=(1, 8192, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
        dict(name="packed_T32768", shape=(1, 32768, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
        dict(name="unpacked_f32_T4096", shape=(1, 4096, 8, 64), dtype="float32",
             sm="float32", packed=False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    rows = []
    for var in variants:
        q, k, v, kv, seg = _long_attention_inputs(var, gen)
        sm = var["sm"]
        out, lse = flash_forward_stream(q, k, v, kv, seg, sm)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_forward_stream_reference(q, k, v, kv, seg, sm)
        err, lse_err, atol, live = _hold_forward(f"long {var['name']}", out, lse, ref_out,
                                                 ref_lse, kv, seg, var["dtype"])
        del ref_out, ref_lse

        ms = median_ms(lambda: flash_forward_stream(q, k, v, kv, seg, sm), reps=10)
        plain_ms = median_ms(lambda: flash_forward_stream_reference(q, k, v, kv, seg, sm),
                             reps=3, warmup=1)
        library_ms = _sdpa_ms(q, k, v, kv, seg, reps=5)
        bound_ms, bound_by, flops, bytes_ = _bound(q, kv, seg)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"], max_abs_err=err,
                   lse_max_abs_err=lse_err, out_atol=atol, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                   flops=flops, bytes=bytes_)
        if var["packed"] and q.shape[1] == 32768:
            # the dense kernel on the same inputs: what the bounded sweep saves
            dense_out, _ = flash_fwd_dense(q, k, v, kv, seg, sm)
            row["flash_fwd_packed_ms"] = median_ms(
                lambda: flash_fwd_dense(q, k, v, kv, seg, sm), reps=5)
            row["flash_fwd_packed_max_abs_diff"] = float(
                (dense_out[live].float() - out[live].float()).abs().max())
            check(row["flash_fwd_packed_ms"] > ms,
                  f"packed 32768: the bounded sweep ({ms:.3f} ms) is not faster than "
                  f"flash_fwd's packed variant ({row['flash_fwd_packed_ms']:.3f} ms)")
            del dense_out
        print(f"[long-kernel] {json.dumps(row)}")
        rows.append(row)
        del q, k, v, kv, seg, out, lse
        torch.cuda.empty_cache()
    return rows


def _plain_stream_attention(softmax_dtype: str):
    """Attention callable of the plain-stream model: the streaming kernel's
    plain version (query and key chunks; the dense plain attention at
    T = 32768 would need ~34 GB of scores per layer)."""
    from repurpose_tpu_torch.ops.flash_attention import flash_forward_stream_reference

    def attn(q, k, v, key_valid, seg_ids=None):
        return flash_forward_stream_reference(q, k, v, key_valid, seg_ids, softmax_dtype)[0]

    return attn


def phase_long_video_serving(card: str) -> dict:
    """7b: the flagship serves long videos with ``configs/longvideo.yaml``'s
    buckets at batch 1. Request A (one video per bucket 2048..32768) unpacked
    and packed, bit-identical; request B (12 videos of 1000-2500 s) in one
    32768 bucket and in 8192 buckets, packed rows shared, held against
    unpacked; the 32768 forward against the plain-stream model. Every
    forward launches the streaming kernel 16 times past T = 2048 and the
    dense one 16 times at 2048."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.config import TestConfig
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import synthetic_sample
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops import flash_attention as fa

    cfg = longvideo_config()
    model_cfg, buckets, bs = cfg.model, cfg.train.buckets, cfg.train.batch_size
    layers = model_cfg.self_num_layers
    # phase 4's serving thresholds, so that random weights leave candidates
    test_cfg = TestConfig(duration_thresh=0.001)
    weights = build_model(model_cfg, "cpu", seed=SEED).state_dict()
    pipe = InferencePipeline(model_cfg, weights, test_cfg, raw_outputs=True, device="cuda")

    forwards = []  # (T, dense launches, stream launches) per forward

    def counts():
        return tuple(read_launches("flash_fwd", "flash_fwd_stream").values())

    def before(module, args):
        forwards.append(counts())

    def after(module, args, output):
        d0, s0 = forwards.pop()
        d1, s1 = counts()
        forwards.append((int(args[0].shape[1]), d1 - d0, s1 - s0))

    pipe.model.register_forward_pre_hook(before)
    pipe.model.register_forward_hook(after)

    rng = np.random.default_rng(SEED + 4)
    req_a = [synthetic_sample(rng, d, model_cfg) for d in LONG_REQUEST_A]
    req_b = [synthetic_sample(rng, n - 1, model_cfg) for n in _long_packed_lengths(32768)]
    reset_launches()
    t0 = time.perf_counter()
    a_unpacked = pipe.score_videos(req_a, buckets=buckets, batch_size=bs)
    t1 = time.perf_counter()
    a_packed = pipe.score_videos(req_a, buckets=buckets, batch_size=bs, pack=True)
    t2 = time.perf_counter()
    served = {"A unpacked": (t1 - t0) * 1e3, "A packed": (t2 - t1) * 1e3}
    b_results = {}
    for b_buckets in ((32768,), (8192,)):
        t0 = time.perf_counter()
        un = pipe.score_videos(req_b, buckets=b_buckets, batch_size=bs)
        t1 = time.perf_counter()
        pk = pipe.score_videos(req_b, buckets=b_buckets, batch_size=bs, pack=True)
        t2 = time.perf_counter()
        served[f"B {b_buckets[0]} unpacked"] = (t1 - t0) * 1e3
        served[f"B {b_buckets[0]} packed"] = (t2 - t1) * 1e3
        b_results[b_buckets[0]] = (un, pk)
    launches = read_launches("flash_fwd", "flash_fwd_stream")
    for t, dense, stream in forwards:
        want = (0, layers) if t > fa.STREAM_MAX_T else (layers, 0)
        check((dense, stream) == want, f"a forward at T = {t} launched flash_fwd {dense} and "
                                       f"flash_fwd_stream {stream} times (want {want})")
    n_served = len(forwards)
    by_t = {t: sum(1 for f in forwards if f[0] == t) for t in sorted({f[0] for f in forwards})}
    print(f"[long-serve] launches {json.dumps(launches)} over {len(forwards)} forwards "
          f"(by T: {json.dumps(by_t)}): {layers} per forward, flash_fwd_stream past "
          f"T = {fa.STREAM_MAX_T}, flash_fwd at 2048")
    for name, ms in served.items():
        print(f"[long-serve] {card}: request {name}: {ms:.1f} ms on the host clock")

    def well_formed(v, r, bucket_max):
        check(r["video_id"] == v["video_id"]
              and r["duration"] == min(v["duration"], bucket_max), "result out of order")
        check(r["raw_logits"].shape == (r["duration"],)
              and bool(np.isfinite(r["raw_logits"]).all())
              and bool(np.isfinite(r["raw_offsets"]).all()), "bad raw outputs")
        check(bool(np.isfinite(r["scores"]).all()) and len(r["scores"]) == len(r["labels"])
              and bool(((r["labels"] >= 0) & (r["labels"] < r["duration"])).all()),
              "bad decoded result")

    # Request A: one video per row at offset 0, so the packed forward sweeps
    # the key tiles the unpacked one sweeps, in the same order: equal bits.
    kept = 0
    for v, a, b in zip(req_a, a_unpacked, a_packed):
        well_formed(v, a, buckets[-1])
        well_formed(v, b, buckets[-1])
        kept += len(a["labels"])
        check(np.array_equal(a["labels"], b["labels"])
              and np.array_equal(a["scores"], b["scores"])
              and np.array_equal(a["segments"], b["segments"])
              and np.array_equal(a["raw_logits"], b["raw_logits"]),
              f"request A {v['duration']} s: packed result differs from unpacked")
    print(f"[long-serve] request A: packed == unpacked bit for bit in {len(req_a)}/"
          f"{len(req_a)} videos of {json.dumps([v['duration'] for v in req_a])} steps "
          f"({kept} kept segments)")
    # Request B: shared rows put each video's key tiles elsewhere, so bf16
    # rounding differs; the bf16 bound of phase 4.
    for bucket, (un, pk) in b_results.items():
        d = np.concatenate([np.abs(a["raw_logits"] - b["raw_logits"]) for a, b in zip(un, pk)])
        same = 0
        for v, a, b in zip(req_b, un, pk):
            well_formed(v, a, bucket)
            well_formed(v, b, bucket)
            same += int(np.array_equal(a["labels"], b["labels"]))
        check(float(d.max()) <= BF16_LOGIT_MAX and float(d.mean()) <= BF16_LOGIT_MEAN,
              f"request B, buckets ({bucket},): max |d logit| {d.max():.4g} "
              f"mean {d.mean():.4g}")
        print(f"[long-serve] request B, {len(req_b)} videos, buckets ({bucket},): packed vs "
              f"unpacked max |d logit| {d.max():.4g}, mean {d.mean():.4g}; identical kept "
              f"labels in {same}/{len(req_b)}")

    # the T = 32768 forward against the same model with plain-stream attention
    plain = build_model(model_cfg, "cuda")
    plain.load_state_dict(pipe.model.state_dict())
    for layer in plain.multimodal_encoder.layers:
        layer.self_attn.attn = _plain_stream_attention(model_cfg.attn_softmax_dtype)
    batch = collate([req_a[-1]], (buckets[-1],), batch_size=1)
    args = [torch.from_numpy(a).cuda() for a in (batch.visual, batch.audio, batch.text)]
    mask = torch.from_numpy(batch.mask).cuda()
    with torch.inference_mode():
        out = pipe.model(*args, mask)
        t0 = time.perf_counter()
        ref = plain(*args, mask)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        d = (out.cls_logits - ref.cls_logits)[..., 0][mask].abs()
        fwd_ms = median_ms(lambda: pipe.model(*args, mask), reps=3, warmup=1)
    check(all(f[1:] == (0, layers) for f in forwards[n_served:]),
          "a T = 32768 forward did not launch flash_fwd_stream 16 times")
    p_max, p_mean = float(d.max()), float(d.mean())
    check(p_max <= BF16_LOGIT_MAX and p_mean <= BF16_LOGIT_MEAN,
          f"T = 32768: kernel vs plain-stream model: max {p_max:.4g} mean {p_mean:.4g}")
    print(f"[long-forward] {card}: [1, 32768] batch of {int(batch.mask.sum())} valid steps: "
          f"kernel vs plain-stream model, cls logits on valid rows: max |d| {p_max:.4g}, "
          f"mean |d| {p_mean:.4g}; forward {fwd_ms:.3f} ms (plain-stream model "
          f"{plain_s:.1f} s)")
    del plain, out, ref, args, mask
    torch.cuda.empty_cache()
    _profile_request(pipe, [req_a[-1]], card, label="request A's 32768 batch (1 video)",
                     buckets=buckets, batch_size=bs, pack=False)
    return dict(launches=launches, forwards=n_served, latency_ms=served)


def phase_long_cli(card: str) -> dict:
    """7c: ``python -m repurpose_tpu_torch.inference``'s ``run`` on the
    long-video config with ``--synthetic 4``, unpacked and ``--pack``."""
    import contextlib
    import io

    from repurpose_tpu_torch import inference as cli

    cfg = longvideo_config()
    launches = {}
    for extra in ([], ["--pack"]):
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            means = cli.run(cfg, cli.parse_args(["--synthetic", "4", *extra]))
        wall_s = time.perf_counter() - t0
        lines = [x for x in buf.getvalue().splitlines() if "precision@tIoU" in x]
        check(len(lines) == 6 and len(means) == 6, f"CLI {extra}: printed {lines}")
        name = "packed" if extra else "unpacked"
        launches[name] = read_launches("flash_fwd", "flash_fwd_stream")
        check(launches[name]["flash_fwd_stream"] > 0, f"CLI {extra}: no streaming launch")
        print(f"[long-cli] {card}: --synthetic 4 {' '.join(extra)}: {wall_s:.1f} s, launches "
              f"{json.dumps(launches[name])}; " + "; ".join(lines))
    return launches


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
    bwd_variants = phase_backward_vs_plain()
    served = phase_main_path(card)
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "runs"))
    try:
        trained = phase_training(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    phase_gradients(card)
    long_variants = phase_long_kernel_vs_plain()
    long_served = phase_long_video_serving(card)
    long_cli = phase_long_cli(card)

    head = next(r for r in variants if r["name"] == "packed_bf16_softmax_bf16")
    bwd_head = next(r for r in bwd_variants if r["name"] == "packed_bf16_softmax_bf16")
    source = "repurpose_tpu_torch/csrc/"
    kernels = [dict(
        name="flash_fwd", route="cuda", source=source + "flash_fwd.cu",
        replaces="repurpose_tpu/ops/flash_attention.py:227",
        launches=trained["launches"]["flash_fwd"],
        launches_by_path=dict(serving=served["launches"],
                              training=trained["launches"]["flash_fwd"],
                              long_video_serving=long_served["launches"]["flash_fwd"],
                              long_video_cli=long_cli),
        max_abs_err=head["max_abs_err"], ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        library_ms=head["library_ms"], variant=head["name"], variants=variants,
    )]
    for name, key, line in (("flash_bwd_dq", "dq", 783), ("flash_bwd_dkv", "dkv", 1109)):
        r = bwd_head[key]
        kernels.append(dict(
            name=name, route="cuda", source=source + "flash_bwd.cu",
            replaces=f"repurpose_tpu/ops/flash_attention.py:{line}",
            launches=trained["launches"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=bwd_head["library_ms"],
            variant=bwd_head["name"],
            variants=[dict(name=v["name"], **v[key], library_ms=v["library_ms"])
                      for v in bwd_variants],
        ))
    long_head = next(r for r in long_variants if r["name"] == "unpacked_T32768")
    kernels.append(dict(
        name="flash_fwd_stream", route="cuda", source=source + "flash_fwd_stream.cu",
        replaces="repurpose_tpu/ops/flash_attention.py:592",
        also_replaces=["repurpose_tpu/ops/flash_attention.py:512",
                       "repurpose_tpu/ops/flash_attention.py:657"],
        launches=long_served["launches"]["flash_fwd_stream"],
        launches_by_path=dict(long_video_serving=long_served["launches"],
                              long_video_cli=long_cli),
        max_abs_err=long_head["max_abs_err"], ms=long_head["ms"],
        plain_ms=long_head["plain_ms"], bound_ms=long_head["bound_ms"],
        bound_by=long_head["bound_by"], library_ms=long_head["library_ms"],
        variant=long_head["name"], variants=long_variants,
    ))
    print(f"[time] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
