#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints no
verdict line):

1. card and build: print the card's name and power limit, build every
   kernel of ``repurpose_tpu_torch/csrc`` (one nvcc per source, in parallel)
   for sm_90a;
2. forward kernel vs plain: the dense flash forward against its plain
   PyTorch version at [8, 2048, 8, 64] bf16 (unpacked and packed, bf16 and
   float32 softmax interior, and packed rows with padding inside kvl and
   with a video's id split into two runs: the tensor-core kernel, which each
   call must have launched) and T = 1000 in float32 (the first design); two
   launches equal bit for bit, and on the packed rows the tensor-core
   kernel's bounded sweep equal bit for bit to its sweep to kvl on every row
   that attends a key; times of the kernel (with the sweep made inside the
   wrapper, what a direct caller pays, and made once outside the chain,
   what the model pays) and ``scaled_dot_product_attention`` (yardstick
   only) per launch of a chain of back-to-back launches, the plain
   version's, and the card's bound for the same work;
3. backward kernels vs plain: dq and dk/dv against their plain versions at
   the training shapes ([6, 2048, 8, 64] bf16, unpacked and packed, both
   interiors: the tensor-core pair on one ``flash_bwd_stream_prep``, held
   against its plain version too; a packed bf16 row with padding inside kvl,
   where the select form of the dense kernels and the stream kernels' bias
   form differ; [6, 1000, 8, 64] float32: the first design), two launches
   equal bit for bit; the prep, dq and dk/dv timed likewise, with SDPA's
   backward as the yardstick, and one backward's device time split by
   kernel against the host clock;
4. serving: the flagship MMCT (d_model 512, 16 layers, 8 heads, bf16,
   random weights from a numpy seed) serves requests of synthetic videos
   through ``InferencePipeline.score_videos``, unpacked and packed; 16 flash
   forward launches per forward batch, every one the tensor-core kernel;
5. training: the production config (packed [6, 2048] batches, bf16, dropout
   0.1) trains one epoch of synthetic videos through the CLI's ``run``:
   finite losses, the val probe, a checkpoint that ``resume()`` restores,
   the tIoU evaluation, and exactly 16 launches of each kernel per forward
   or step (the forward; the prep, dq and dk/dv; every one the tensor-core
   kernels'); then the step time, videos/s and a profiler breakdown of one
   step with the calls and host time of the attention sweep
   (``attention_sweep``: once a step, shared by the 16 layers' forwards and
   backwards);
6. gradients: one packed [6, 2048] step of the kernel model against the
   plain-attention model, parameter by parameter (bf16: the tensor-core
   forward and backward kernels; float32 on two rows: the first designs);
7. long videos (``configs/longvideo.yaml``, buckets 2048..32768 at batch 1):
   a. the streaming forward kernel against its plain version at [1, 4096] and
      [1, 32768] unpacked, packed rows of [1, 8192], [1, 16384] and
      [1, 32768], bf16 (the tensor-core kernel) and float32 (the first
      design); two launches give equal bits; at packed 32768 the dense
      forward (the tensor-core kernel on the dense sweep, which lays the
      same tiles where each video is one run) gives the stream kernel's
      bits on every live row; the kernel (with the stream sweep made once
      outside the chain, what the model pays, and made inside the wrapper),
      SDPA and (packed 32768) the dense forward each timed over >= 5 chains
      of back-to-back launches (median, min, max per launch) with each
      time's ratio to SDPA in this run, the plain version over single calls;
   b. the flagship serves request A (one video per bucket) unpacked and
      packed, bit-identical, and request B (12 videos) in shared packed rows;
      the [1, 32768] forward against the plain-stream model; exactly 16
      launches of the streaming kernel per forward past T = 2048 and of the
      dense one at 2048, every one the tensor-core kernel; the latency of
      each request and a profile of the 32768 batch;
   c. the inference CLI's ``run`` with ``--synthetic 4``, unpacked and packed;
8. long-video training (``configs/longvideo.yaml``, remat on, batch 1):
   a. the streaming backward kernels (the prep, dq, dk/dv) against their
      plain versions at [1, 4096] (bf16 and float32), [1, 16384] and
      [1, 32768] unpacked and packed rows of [1, 8192], [1, 16384] and
      [1, 32768]; two launches of each kernel give equal bits; each kernel
      timed over >= 5 chains of back-to-back launches (median, min, max per
      launch; with the stream sweep made once outside the chain and made
      inside the wrapper) with the plain versions, SDPA's backward timed the
      same way and each time's ratio to it in this run, and (packed
      32768) the dense backward pair on the same prep, which must give the
      same gradients bit for bit, and SDPA, which must be slower;
   b. the flagship trains through the CLI's ``run`` (``--synthetic 7``,
      unpacked: buckets 4096..32768) and ``Trainer`` (12 videos packed into
      rows of 32768 and of 8192), each with the val probe, a checkpoint and
      the tIoU evaluation, and exactly 32 / 16 / 16 / 16 launches of
      ``flash_fwd_stream`` / ``flash_bwd_dq_stream`` / ``flash_bwd_dkv_stream``
      / ``flash_bwd_stream_prep`` per step (forward and remat recompute, the
      forwards all tensor-core; backward) and no dense backward launch; then
      step time, videos/s and peak memory per bucket, the [1, 16384] step
      without remat (a higher peak) and a profile of the [1, 32768] step,
      which makes the attention sweep once;
   c. every parameter gradient of a [1, 8192] step, unpacked and packed, bf16
      and float32, against the plain-stream model (the streaming forward:
      the tensor-core kernel in bf16, the first design in float32); remat on
      vs off with dropout on, bit-identical;
9. the bench tools (``repurpose_tpu_torch.tools``):
   a. the no-transpose forward ``mha_nt`` against its plain version at the
      tool's [8, 2048, 8 * 64] bf16 (keys >= 1800 masked; the tensor-core
      kernel) at each heads-per-block the kernel has, and at [2, 1000, 8 * 64]
      float32 (the first design) with key holes and a fully masked row, every
      row compared, two launches equal; the kernel, ``flash_forward`` and
      SDPA on the same inputs timed over >= 5 chains, the plain version over
      single calls;
   b. ``int8_core`` and ``int8_matmul`` against their plain versions, bit for
      bit, at the tool's three shapes and a ragged one (bf16 x), float32 x
      and unaligned x / xq at the first tool shape, each launch's load route
      checked against the rule; timed per launch of a chain with the plain
      versions, ``torch._int_mm`` (core) and ``torch.matmul``, a
      ``[int8-time]`` line per row with each kernel's share of its bound;
   c. each tool's ``main([])`` on the card, with its launches (every
      ``mha_nt`` launch the tensor-core kernel), then ``mha_nt`` on float32
      inputs of the tool's shape (the first design);
10. wide heads: the Dh 256 instances of the first designs (the dense and the
   streaming forward and backward) against their plain versions at
   [2, 1024, 2, 256] and [1, 4096, 2, 256], unpacked and packed, bf16 and
   float32, timed beside SDPA and the bound, and the model's route at
   Dh 192 (zero-padded to 256) against the same call on the CPU;
11. the serving daemon (``python -m repurpose_tpu_torch.serve``) at the
   production width: its classes in this process, each answer equal bit for
   bit to ``score_videos`` one client at a time, every forward the
   tensor-core kernel; 4 concurrent clients, unpacked and ``--pack``; the
   module as a subprocess with ``--warmup``, SIGTERM exit 0; request latency
   and videos/s;
12. ``python -m repurpose_tpu_torch.campaign --smoke 8`` at the production
   width: the packed cross-check passes, the report names the card, the
   temporary split is removed;
13. the train CLI with ``--profile --async-ckpt`` (12 synthetic videos): the
   trace and the host-time split of the profiled epoch by operator, the
   asynchronous checkpoint against a synchronous save bit for bit, and
   ``load_batch``'s native route against ``collate`` bit for bit;
14. a JSON line listing every ported kernel, then the verdict line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# One H100 SXM, dense peaks (NVIDIA data sheet, at the 700 W limit).
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12,  # bf16 tensor cores; f32 FMA
            "int8": 1979e12}
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


def spread_ms(fn, reps: int, warmup: int = 2, chain: int = 1) -> dict:
    """Median, min and max over ``reps`` timings with CUDA events, each of
    one call or, with ``chain`` > 1, the time per call of ``chain``
    back-to-back calls queued behind one more: the card's own time per call
    wherever the host queues a call faster than the card runs it, since each
    call's host work (argument checks, small launches) then overlaps the
    kernel before it. One call alone also counts the host work before its
    launch."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if chain > 1:
            torch.cuda.synchronize()
            fn()  # keeps the card busy while the chain is queued
        start.record()
        for _ in range(chain):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / chain)
    return dict(ms=statistics.median(times), min_ms=min(times), max_ms=max(times), reps=reps,
                chain=chain)


def _triple(t: dict) -> str:
    """[median, min, max] of a ``spread_ms`` result, as JSON."""
    return json.dumps([round(t[x], 4) for x in ("ms", "min_ms", "max_ms")])


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` single calls, each timed with CUDA events."""
    return spread_ms(fn, reps, warmup)["ms"]


def _counted_wrappers() -> dict:
    """Every kernel wrapper by kernel name; each counts its launches in
    ``.launches``. ``flash_fwd``, ``flash_fwd_stream``, ``flash_fwd_nt``,
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` count every launch of their
    wrapper; ``flash_fwd_tc``, ``flash_fwd_stream_tc``, ``flash_fwd_nt_tc``,
    ``flash_bwd_dq_tc`` and ``flash_bwd_dkv_tc`` the part of them that took
    the tensor-core kernel (bf16 at Dh 64; ``flash_fwd_tc`` and
    ``flash_fwd_stream_tc`` launch one kernel of csrc/flash_fwd.cu, on the
    dense and on the stream sweep), so the first design's launches are the
    difference."""
    from repurpose_tpu_torch.ops import flash_attention as fa
    from repurpose_tpu_torch.tools import bench_attention_fwd, bench_int8_matmul

    return {"flash_fwd": fa.flash_forward, "flash_fwd_tc": fa.flash_fwd_tc,
            "flash_fwd_stream": fa.flash_forward_stream,
            "flash_fwd_stream_tc": fa.flash_fwd_stream_tc,
            "flash_bwd_dq": fa.flash_bwd_dq, "flash_bwd_dkv": fa.flash_bwd_dkv,
            "flash_bwd_dq_tc": fa.flash_bwd_dq_tc, "flash_bwd_dkv_tc": fa.flash_bwd_dkv_tc,
            "flash_bwd_dq_stream": fa.flash_bwd_dq_stream,
            "flash_bwd_dkv_stream": fa.flash_bwd_dkv_stream,
            "flash_bwd_stream_prep": fa.flash_bwd_stream_prep,
            "flash_fwd_nt": bench_attention_fwd.mha_nt,
            "flash_fwd_nt_tc": bench_attention_fwd.flash_fwd_nt_tc,
            "int8_matmul": bench_int8_matmul.int8_matmul,
            "int8_core": bench_int8_matmul.int8_core}


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
        kernel = "?"
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:  # the kernel's own name follows its length in the mangled name
                name = re.search(r"\d\d((?:flash|int8)\w*?_kernel)", entry.group(1))
                rest = entry.group(1)[name.end():] if name else ""
                kernel = (name.group(1) if name else entry.group(1)) + (
                    rest.split("Ev")[0] if rest.startswith("I") else "")
            elif "registers" in line or "spill" in line:
                print(f"[build] {n}: {kernel}: {line.strip()}")
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


def packed_attention_layout(b: int, t: int, padding_inside: bool = False,
                            split_ids: bool = False, durs: list[int] | None = None):
    """key_valid / seg_ids (numpy) of the packed rows of phases 2 and 3: the
    port's packing of synthetic videos of 200-1800 s (or of ``durs`` steps)
    into ``b`` rows of ``t``. With ``padding_inside``, a stretch of padding
    tokens inside each
    row's first video: masked keys with a segment of their own, which holds
    no valid key, and the video's tail after them takes another new segment
    (every run its own id, as packing gives them). With ``split_ids``, the
    stretch lies on padding's segment -1 and the tail keeps the video's id,
    which is then split into two runs."""
    import numpy as np

    if durs is None:
        durs = [int(d) for d in np.random.default_rng(SEED + 1).integers(200, 1801, size=24)]
    mask, seg, _ = _packed_layout(b, t, durs)
    if padding_inside or split_ids:
        for r in range(b):
            if seg[r, 0] < 0:  # an empty row
                continue
            end = int(np.argmax(seg[r] != seg[r, 0])) or t  # the first video's end
            a0, a1 = end // 3, end // 3 + max(1, end // 6)
            top = int(seg[r].max())
            mask[r, a0:a1] = False
            if split_ids:
                seg[r, a0:a1] = -1
            else:
                seg[r, a0:a1] = top + 1
                seg[r, a1:end] = top + 2
    return mask, seg


def _attention_inputs(variant: dict, gen):
    import numpy as np
    import torch

    b, t, h, dh = variant["shape"]
    dtype = getattr(torch, variant["dtype"])
    # q/k/v as the main path gives them: column views of one fused projection
    qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dtype)
    q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
    if variant["packed"]:
        mask, seg = packed_attention_layout(b, t, variant.get("padding_inside", False),
                                            variant.get("split_ids", False))
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
    allowed (query, valid key) pairs, against q/k/v rows up to each batch
    row's last valid key read once and out/lse written once."""
    import torch

    b, t, h, dh = q.shape
    if seg is None:
        n = kv.sum(dim=1).double()
        pairs = float((n * n).sum())
    else:
        pairs = sum(float(((seg == s).sum(dim=1).double() * ((seg == s) & kv).sum(dim=1)).sum())
                    for s in range(int(seg.max()) + 1))
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


def _attending_rows(kv, seg):
    """[B, T]: the query rows before kvl that attend a key, i.e. whose
    segment (packed) holds a valid key. Rows of padding inside kvl attend
    none: the kernels average v over their sweep there, the plain version
    over all T keys, and nothing reads them."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import _kv_len

    b, t = kv.shape
    rows = torch.arange(t, device=kv.device)[None, :] < _kv_len(kv)
    if seg is None:
        return rows
    slot = torch.remainder(seg.long(), t + 1)
    keys = torch.zeros((b, t + 1), dtype=torch.long, device=kv.device)
    keys.scatter_add_(1, slot, kv.long())
    return rows & (keys.gather(1, slot) > 0)


def _hold_forward(name: str, out, lse, ref_out, ref_lse, kv, seg, dtype: str):
    """Holds a forward kernel's (out, lse) against its plain version under
    ``TOL``: query rows that attend a key (``_attending_rows``) are
    compared, rows at or past kvl must hold 0 / ``SKIP_LSE``, every row
    must be finite. Returns (max |out error|, max |lse error|, the out atol,
    the compared rows [B, T])."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import SKIP_LSE, _kv_len

    skip = torch.arange(out.shape[1], device=out.device)[None, :] >= _kv_len(kv)
    live = _attending_rows(kv, seg)
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


def _sdpa_spread(q, k, v, kv, seg, reps: int, chain: int = 1) -> dict:
    """Yardstick only: one PyTorch call computing the same attention,
    ``scaled_dot_product_attention`` on the same boolean mask, timed as
    ``spread_ms`` times with ``chain``."""
    import torch.nn.functional as F

    allowed = kv[:, None, None, :]
    if seg is not None:
        allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
    qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
    return spread_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed),
                     reps=reps, chain=chain)



def _sdpa_bwd_ms(q, k, v, kv, seg, g, reps: int, chain: int = 1):
    """Yardstick only, never called by the port: the backward alone of
    ``scaled_dot_product_attention`` on the same boolean mask, timed as
    ``spread_ms`` times with ``chain``. Returns (ms, None), or (None, the
    reason) where PyTorch cannot run the shape."""
    import torch
    import torch.nn.functional as F

    allowed = kv[:, None, None, :]
    if seg is not None:
        allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
    leaves = [z.transpose(1, 2).detach().requires_grad_() for z in (q, k, v)]
    try:
        out = F.scaled_dot_product_attention(*leaves, attn_mask=allowed)
        g_t = g.transpose(1, 2)
        return spread_ms(lambda: torch.autograd.grad(out, leaves, g_t, retain_graph=True),
                         reps=reps, chain=chain)["ms"], None
    except RuntimeError as e:  # out of memory, or no backend for the shape
        return None, str(e).splitlines()[0][:160]
    finally:
        del allowed, leaves
        torch.cuda.empty_cache()


def _sweep_to_kvl(sweep):
    """The packed ``sweep`` widened to every key tile before kvl: the sweep
    of the first design, through the tensor-core kernel."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import STREAM_TILE, AttentionSweep

    n_live = (sweep.kvl + STREAM_TILE - 1) // STREAM_TILE
    return AttentionSweep(sweep.kvl, torch.zeros_like(sweep.lo),
                          n_live[:, None].expand_as(sweep.hi).contiguous(), sweep.dense)


def phase_kernel_vs_plain() -> list[dict]:
    """2: the dense forward against its plain version (bf16 at Dh 64: the
    tensor-core kernel, which each call must have launched, and whose
    bounded sweep must give, packed, the bits of its sweep to kvl on every
    row that attends a key; float32: the first design), two launches equal
    bit for bit. Timed per launch of a chain (``spread_ms``): the kernel
    with the sweep made once outside the chain (``ms``: the card's time,
    what the model pays) and made inside the wrapper (``wrapper_ms``: what
    a direct caller pays), and SDPA; the plain version over single calls."""
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    variants = [
        dict(name="unpacked_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=False),
        dict(name="unpacked_bf16_softmax_f32", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=False),
        dict(name="packed_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True),
        dict(name="packed_bf16_softmax_f32", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=True),
        # padding inside kvl on a segment of its own (rows that attend no
        # key), and a video's id split into two runs by masked keys on
        # segment -1: the dense sweep spans every position of each id
        dict(name="packed_padding_inside_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True, padding_inside=True),
        dict(name="packed_split_ids_bf16_softmax_bf16", shape=(8, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True, split_ids=True),
        dict(name="unpacked_f32_T1000", shape=(8, 1000, 8, 64),
             dtype="float32", sm="float32", packed=False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for var in variants:
        q, k, v, kv, seg = _attention_inputs(var, gen)
        sm = var["sm"]
        tc = fa.stream_tc(q)
        before = (fa.flash_forward.launches, fa.flash_fwd_tc.launches)
        out, lse = fa.flash_forward(q, k, v, kv, seg_ids=seg, softmax_dtype=sm)
        again = fa.flash_forward(q, k, v, kv, seg_ids=seg, softmax_dtype=sm)
        torch.cuda.synchronize()
        launched = (fa.flash_forward.launches - before[0], fa.flash_fwd_tc.launches - before[1])
        check(launched == (2, 2 if tc else 0),
              f"{var['name']}: flash_fwd / flash_fwd_tc launched {launched} (want "
              f"{(2, 2 if tc else 0)})")
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"{var['name']}: two launches of the forward kernel differ")
        del again
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, kv, seg, sm)
        err, lse_err, atol, live = _hold_forward(var["name"], out, lse, ref_out, ref_lse, kv,
                                                 seg, var["dtype"])
        del ref_out, ref_lse
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"],
                   kernel="flash_fwd_tc" if tc else "flash_fwd (first design)",
                   max_abs_err=err, lse_max_abs_err=lse_err, out_atol=atol,
                   compared_rows=int(live.sum()), deterministic=True)
        sweep = fa.attention_sweep(kv, seg)
        if tc and seg is not None:
            # the sweep to kvl through the same kernel: a tile the bounded
            # sweep leaves out adds nothing to a row that attends a key
            to_kvl = _sweep_to_kvl(sweep)
            full_out, full_lse = fa.flash_forward(q, k, v, kv, seg, sm, sweep=to_kvl)
            torch.cuda.synchronize()
            lse_live = live[:, None, :, None].expand_as(lse)
            check(torch.equal(full_out[live], out[live])
                  and torch.equal(full_lse[lse_live], lse[lse_live]),
                  f"{var['name']}: the bounded sweep differs from the sweep to kvl on rows "
                  "that attend a key")
            row["bounded_sweep_equals_sweep_to_kvl"] = True
            row["sweep_to_kvl_ms"] = spread_ms(
                lambda: fa.flash_forward(q, k, v, kv, seg, sm, sweep=to_kvl), reps=5,
                chain=8)["ms"]
            del full_out, full_lse, to_kvl
        kernel = spread_ms(lambda: fa.flash_forward(q, k, v, kv, seg, sm, sweep=sweep), reps=7,
                           chain=8)
        wrapper = spread_ms(lambda: fa.flash_forward(q, k, v, kv, seg, sm), reps=7, chain=8)
        library = _sdpa_spread(q, k, v, kv, seg, reps=7, chain=8)
        bound_ms, bound_by, flops, bytes_ = _bound(q, kv, seg)
        row.update(ms=kernel["ms"], min_ms=kernel["min_ms"], max_ms=kernel["max_ms"], chain=8,
                   wrapper_ms=wrapper["ms"],
                   wrapper_min_max_ms=[wrapper["min_ms"], wrapper["max_ms"]],
                   plain_ms=median_ms(lambda: fa.flash_forward_reference(q, k, v, kv, seg, sm),
                                      reps=3, warmup=1),
                   library_ms=library["ms"], library_min_ms=library["min_ms"],
                   library_max_ms=library["max_ms"],
                   ratio_to_library=kernel["ms"] / library["ms"],
                   wrapper_ratio_to_library=wrapper["ms"] / library["ms"],
                   bound_ms=bound_ms, bound_by=bound_by, ratio_to_bound=kernel["ms"] / bound_ms,
                   flops=flops, bytes=bytes_)
        print(f"[kernel] {json.dumps(row)}")
        print(f"[forward-time] {var['name']} ({row['kernel']}): ms per call of 8 chained, "
              f"[median, min, max]: sweep made once outside {_triple(kernel)}, made inside the "
              f"wrapper {_triple(wrapper)}; SDPA {_triple(library)}; kernel / SDPA "
              f"{row['ratio_to_library']:.3f} ({row['wrapper_ratio_to_library']:.3f} with the "
              f"sweep inside); kernel / bound {row['ratio_to_bound']:.2f}")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, sweep
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


def _hold_backward(label: str, got: dict, want: dict, rel: float, past) -> dict:
    """Holds backward kernels' gradients (``dq``/``dk``/``dv``) against their
    plain versions: max |kernel - plain| within ``rel`` x max |plain|, finite,
    0 on the rows ``past`` kvl. Returns the max errors."""
    import torch

    errs = {}
    for name in got:
        a, w = got[name].float(), want[name].float()
        scale = float(w.abs().max())
        errs[name] = float((a - w).abs().max())
        check(errs[name] <= rel * scale,
              f"{label} {name}: max err {errs[name]:.3g} > {rel} x max {scale:.3g}")
        check(bool(torch.isfinite(a).all()), f"{label} {name}: non-finite")
        check(bool((got[name][past] == 0).all()), f"{label} {name}: rows past kvl are not 0")
    return errs


def _backward_device_split(args, sm: str, calls: int = 8) -> dict:
    """Where one ``flash_backward`` call's time goes on the tensor-core path:
    device time per call by kernel (the prep, dq, dk/dv, and the small
    launches of the sweep, ``attention_sweep``), from torch.profiler over
    ``calls`` back-to-back calls, against the host clock per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repurpose_tpu_torch.ops.flash_attention import flash_backward

    flash_backward(*args, sm)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            flash_backward(*args, sm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    split = dict(prep=0.0, dq=0.0, dkv=0.0, sweep_and_other=0.0)
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        key = ("prep" if "stream_prep_kernel" in e.key else "dq" if "dq_tc_kernel" in e.key
               else "dkv" if "dkv_tc_kernel" in e.key else "sweep_and_other")
        split[key] += e.self_device_time_total / 1e3 / calls
    return dict(host_ms_per_call=wall_ms, device_ms_per_call=split,
                device_busy_ms_per_call=sum(split.values()))


def phase_backward_vs_plain() -> list[dict]:
    """3: the dq and dk/dv kernels against their plain versions at the
    training shapes, on o / lse from the kernel forward and an upstream
    gradient that is random before each row's last valid key and 0 past it
    (the model's). The bf16 rows take the tensor-core pair on one
    ``flash_bwd_stream_prep`` (held against its plain version); two launches
    must give equal bits; one packed row has padding inside kvl (its own
    segment, no valid key, random g), where the select form the dense
    kernels keep and the stream kernels' bias form differ. Each kernel (the
    prep, dq, dk/dv) and SDPA's backward timed per launch of a chain
    (``spread_ms``), the plain versions over single calls; the float32 row
    times the first design."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        _kv_len,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dkv_stream_reference,
        flash_bwd_dkv_tc,
        flash_bwd_dq,
        flash_bwd_dq_reference,
        flash_bwd_dq_stream_reference,
        flash_bwd_dq_tc,
        flash_bwd_stream_prep,
        flash_bwd_stream_prep_reference,
        flash_forward,
        stream_tc,
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
        # padding inside kvl: the select and the bias form differ there under
        # the float32 interior (the bf16 one rounds lse so that both give 0)
        dict(name="packed_padding_inside_bf16_softmax_f32", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="float32", packed=True, padding_inside=True),
        # a video's id split into two runs by masked keys on segment -1: the
        # dense sweep spans every position of each id, the stream one (each
        # run) would miss pairs
        dict(name="packed_split_ids_bf16_softmax_bf16", shape=(6, 2048, 8, 64),
             dtype="bfloat16", sm="bfloat16", packed=True, split_ids=True),
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
        tc = stream_tc(q)
        tc_before = (flash_bwd_dq_tc.launches, flash_bwd_dkv_tc.launches)
        got = dict(dq=flash_bwd_dq(*args))
        got["dk"], got["dv"] = flash_bwd_dkv(*args)
        again = (flash_bwd_dq(*args), *flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        tc_launched = (flash_bwd_dq_tc.launches - tc_before[0],
                       flash_bwd_dkv_tc.launches - tc_before[1])
        check(tc_launched == ((2, 2) if tc else (0, 0)),
              f"{var['name']}: the tensor-core pair launched {tc_launched} times of "
              f"{(2, 2) if tc else (0, 0)}")
        check(all(torch.equal(got[n], x) for n, x in zip(("dq", "dk", "dv"), again)),
              f"{var['name']}: two launches of the backward kernels differ")
        del again
        want = dict(dq=flash_bwd_dq_reference(*args))
        want["dk"], want["dv"] = flash_bwd_dkv_reference(*args)
        rel = BWD_REL.get((var["dtype"], sm), BWD_REL_BF16)
        errs = _hold_backward(var["name"], got, want, rel, past)
        library_ms, library_note = _sdpa_bwd_ms(q, k, v, kv, seg, g, reps=5, chain=8)
        check(library_ms is not None, f"{var['name']}: SDPA's backward failed: {library_note}")
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"],
                   kernels="flash_bwd_{dq,dkv}_tc" if tc else "flash_bwd_{dq,dkv} (first design)",
                   tolerance=f"{rel} x max |plain|", deterministic=True, library_ms=library_ms)
        if var.get("padding_inside"):
            # the bias form on the same inputs: far from the kernels' gradients
            bias = dict(dq=flash_bwd_dq_stream_reference(*args))
            bias["dk"], bias["dv"] = flash_bwd_dkv_stream_reference(*args)
            row["bias_form_rel_diff"] = {
                n: float((bias[n].float() - got[n].float()).abs().max())
                / float(want[n].float().abs().max()) for n in got}
            check(max(row["bias_form_rel_diff"].values()) > BWD_REL_BF16,
                  f"{var['name']}: the bias form is as close as the select form "
                  f"{json.dumps(row['bias_form_rel_diff'])}: the row has no teeth")
            del bias
        del want
        kw = {}
        if tc:
            prep = flash_bwd_stream_prep(*args[:-1], dense=True)
            torch.cuda.synchronize()
            delta_err = _hold_prep(var["name"], prep,
                                   flash_bwd_stream_prep_reference(*args[:-1], dense=True))
            bound_ms, bound_by, flops, bytes_ = _prep_bound(q, seg)
            row["prep"] = dict(
                max_abs_err=delta_err,
                **spread_ms(lambda: flash_bwd_stream_prep(*args[:-1], dense=True), reps=10,
                            chain=8),
                plain_ms=median_ms(
                    lambda: flash_bwd_stream_prep_reference(*args[:-1], dense=True),
                    reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
            kw = dict(prep=prep)
        for kname, fn, ref_fn, products, outputs, keys in (
            ("dq", flash_bwd_dq, flash_bwd_dq_reference, 3, 1, ("dq",)),
            ("dkv", flash_bwd_dkv, flash_bwd_dkv_reference, 4, 2, ("dk", "dv")),
        ):
            bound_ms, bound_by, flops, bytes_ = _bwd_bound(q, kv, seg, products, outputs)
            row[kname] = dict(
                max_abs_err=max(errs[x] for x in keys),
                **spread_ms(lambda: fn(*args, **kw), reps=10 if tc else 5, chain=8),
                plain_ms=median_ms(lambda: ref_fn(*args), reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
        pair_ms = row["dq"]["ms"] + row["dkv"]["ms"] + row.get("prep", {}).get("ms", 0.0)
        row["pair_ms"] = pair_ms
        row["pair_ratio_to_library"] = pair_ms / library_ms
        for key in ("prep", "dq", "dkv"):
            if key in row:
                row[key]["ratio_to_library"] = row[key]["ms"] / library_ms
        if tc:
            row["split"] = _backward_device_split(args[:-1], sm)
        print(f"[backward] {json.dumps(row)}")
        summary = {key: [round(row[key][x], 4) for x in ("ms", "min_ms", "max_ms")]
                   for key in ("prep", "dq", "dkv") if key in row}
        print(f"[backward-time] {var['name']}: ms per call of 8 chained, [median, min, max] "
              f"{json.dumps(summary)}; SDPA backward {library_ms:.4f} ms; (prep + dq + dk/dv) "
              f"/ SDPA {row['pair_ratio_to_library']:.3f}"
              + (f"; one flash_backward: {json.dumps(row['split'])}" if tc else ""))
        rows.append(row)
        del q, k, v, kv, seg, o, lse, g, got, args, kw
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
    tc_launches = read_launches("flash_fwd_tc")["flash_fwd_tc"]
    check(forwards[0] > 0, "no forward ran")
    check(launches == tc_launches == cfg.self_num_layers * forwards[0],
          f"flash_fwd launched {launches} times, flash_fwd_tc {tc_launches}, for "
          f"{forwards[0]} forward batches (want {cfg.self_num_layers} per batch, every one "
          "the tensor-core kernel)")
    print(f"[serve] flash_fwd launches {launches} = {cfg.self_num_layers} x "
          f"{forwards[0]} forward batches, every one the tensor-core kernel (flash_fwd_tc)")

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
    return dict(launches=launches, tc_launches=tc_launches, forwards=forwards[0])


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
    every training step the prep and the two backward kernels 16 times each,
    every forward and backward launch the tensor-core kernels'."""
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
    launches = read_launches("flash_fwd", "flash_fwd_tc", "flash_bwd_stream_prep",
                             "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tc",
                             "flash_bwd_dkv_tc")
    layers = cfg.model.self_num_layers
    check(summary["step"] == steps == forwards["grad"] and steps > 0,
          f"{summary['step']} steps, {forwards['grad']} training forwards, plan {steps}")
    for name in ("flash_fwd", "flash_fwd_tc"):
        check(launches[name] == layers * forwards["all"],
              f"{name} launched {launches[name]} times for {forwards['all']} forwards")
    for name in ("flash_bwd_stream_prep", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tc",
                 "flash_bwd_dkv_tc"):
        check(launches[name] == layers * steps,
              f"{name} launched {launches[name]} times for {steps} steps")
    print(f"[train] {card}: {steps} steps of packed [6, 2048] batches, {forwards['all']} "
          f"forwards (val probe and eval included), launches {json.dumps(launches)} = "
          f"{layers} per forward / per step, every launch the tensor-core kernels'; "
          f"run {wall_s:.1f} s on the host clock")

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


SWEEP_LABEL = "flash_attention.attention_sweep"


def _profile_step(trainer, card: str, batch=None, label: str = "one training step") -> dict:
    """Where one training step's time goes (on ``batch``, by default the
    first of epoch 2): device time by kernel against the host clock
    (torch.profiler with CUDA activity), and the calls and host time of the
    attention sweep (``attention_sweep``: kvl and, packed, the key-tile
    bounds, small launches from the host), each wrapped in a labelled range
    on the host clock. The encoder makes it once a step for every layer's
    forward, remat recompute and backward: one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repurpose_tpu_torch.ops import flash_attention as fa

    if batch is None:
        batch = next(iter(trainer.train_loader.epoch(2)))
    batch = trainer._device_batch(batch)
    sweep = fa.attention_sweep
    sweep_s = []

    def timed_sweep(*args):
        t1 = time.perf_counter()
        with record_function(SWEEP_LABEL):
            out = sweep(*args)
        sweep_s.append(time.perf_counter() - t1)
        return out

    torch.cuda.synchronize()
    fa.attention_sweep = timed_sweep
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.train_step(trainer.state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        fa.attention_sweep = sweep
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.key != SWEEP_LABEL]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"[profile] {card}: {label}: {wall_ms:.1f} ms on the host clock, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.0f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms  {e.count:5d} x  "
              f"{e.key[:90]}")
    sweep_ms = sum(sweep_s) * 1e3
    print(f"[profile]   the attention sweep (attention_sweep, shared by every layer): "
          f"{len(sweep_s)} call(s) a step, {sweep_ms:.2f} ms on the host clock in all (under "
          f"the profiler)")
    check(len(sweep_s) == 1, f"{label}: the attention sweep was made {len(sweep_s)} times")
    return dict(profile_wall_ms=wall_ms, profile_busy_ms=busy_ms,
                profile_sweep_calls=len(sweep_s), profile_sweep_host_ms=sweep_ms)


def _step_grads(cfg, train_cfg, batch, impl: str, attn=None) -> dict:
    """Parameter gradients of one step (dropout 0) with ``impl`` attention
    or, given ``attn``, that callable in every layer."""
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.step import loss_fn

    model = build_model(dataclasses.replace(cfg, dropout=0.0, attention_impl=impl),
                        "cuda", seed=SEED).train()
    if attn is not None:
        for layer in model.multimodal_encoder.layers:
            layer.self_attn.attn = attn
    loss_fn(model, train_cfg, batch)[0].backward()
    return {n: p.grad for n, p in model.named_parameters()}


def _hold_grads(label: str, kernel: dict, plain: dict, bound: float, layers: int) -> dict:
    """Holds every parameter gradient of the kernel model against the plain
    one: relative L2 error within ``bound``; a parameter the plain model
    gives no gradient gets none; every in_proj_weight gradient non-zero.
    Returns the errors by parameter."""
    rels = {}
    for name, g_plain in plain.items():
        if g_plain is None:  # the reg head: no loss reaches it
            check(kernel[name] is None, f"{label} {name}: gradient where the plain model "
                                        "has none")
            continue
        check(kernel[name] is not None, f"{label} {name}: no gradient through the kernels")
        rels[name] = float((kernel[name] - g_plain).norm() / g_plain.norm())
    qkv = [f"multimodal_encoder.layers.{i}.self_attn.in_proj_weight" for i in range(layers)]
    worst = sorted(rels, key=rels.get)[-3:]
    print(f"[grad] {label}: {len(rels)} parameter gradients, relative L2 error median "
          f"{statistics.median(rels.values()):.4g}, worst "
          + ", ".join(f"{n} {rels[n]:.4g}" for n in worst)
          + f"; in_proj_weight {min(rels[n] for n in qkv):.4g}.."
          f"{max(rels[n] for n in qkv):.4g} over {layers} layers")
    check(all(float(kernel[n].abs().max()) > 0 for n in qkv),
          f"{label}: an in_proj_weight gradient is zero")
    bad = {n: r for n, r in rels.items() if not r <= bound}
    check(not bad, f"{label}: relative gradient errors past {bound}: {bad}")
    return rels


def phase_gradients(card: str) -> dict:
    """Every parameter gradient of one step of the kernel model (flash forward
    and backward kernels) against the same model with the plain attention
    (autograd through mha_torch), same weights, on a packed [6, 2048] batch:
    in the production setting (bf16, bf16 interior: the tensor-core backward
    pair), and in float32 on two of its rows (the kernels' float32 path, the
    first design, where only summation order differs). Returns the backward
    kernels' launches of each kernel step, by dtype."""
    from repurpose_tpu_torch.data.batching import Batch
    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.step import batch_to_device

    cfg = _training_config()
    train_ds, _, _ = cli.build_datasets(cfg, 16)
    batch = next(iter(BatchLoader(train_ds, cfg.train.batch_size, cfg.train.buckets,
                                  seed=cfg.train.seed, pack=True).epoch(0)))
    batch = batch_to_device(batch, "cuda")
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32",
                              attn_softmax_dtype="float32")
    two_rows = Batch(*[None if x is None else x[:2] for x in batch])
    names = ("flash_fwd", "flash_fwd_tc", "flash_bwd_dq", "flash_bwd_dkv", "flash_bwd_dq_tc",
             "flash_bwd_dkv_tc")
    launches = {}
    for dtype, model_cfg, b in (("bfloat16", cfg.model, batch), ("float32", f32, two_rows)):
        reset_launches()
        kernel = _step_grads(model_cfg, cfg.train, b, "auto")
        launches[dtype] = read_launches(*names)
        layers = cfg.model.self_num_layers
        tc = layers if dtype == "bfloat16" else 0
        check(launches[dtype] == {"flash_fwd": layers, "flash_fwd_tc": tc,
                                  "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                                  "flash_bwd_dq_tc": tc, "flash_bwd_dkv_tc": tc},
              f"{dtype} kernel step launched {launches[dtype]}")
        plain = _step_grads(model_cfg, cfg.train, b, "xla")
        _hold_grads(f"{card}: {dtype}, kernel vs plain-attention model, one packed "
                    f"[{b.visual.shape[0]}, {b.visual.shape[1]}] step", kernel, plain,
                    GRAD_REL_BOUND[dtype], cfg.model.self_num_layers)
        del kernel, plain
    print(f"[grad] {card}: launches of each kernel step {json.dumps(launches)}")
    return launches


# -- phase 7: long videos -------------------------------------------------------


LONG_REQUEST_A = (1900, 3000, 6000, 12000, 30000)  # seconds: one video per long bucket
# Packed rows of phases 7a and 8a: video lengths (steps) per bucket, drawn from
# a seed; the 12 of the 32768 row are also request B of phase 7b.
LONG_PACKED = {8192: (4, 1500, 2000), 16384: (8, 1000, 2000), 32768: (12, 1000, 2500)}


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
    shapes (bf16 rows: the tensor-core kernel, which each call must have
    launched; the float32 row: the first design), two launches equal bit
    for bit. At the packed 32768 row the dense forward (the tensor-core
    kernel on the dense sweep, ``segment_tile_bounds``) must give the stream
    kernel's bits on every live row: with each video one run of the row the
    two sweeps lay the same tiles there. The kernel (``ms``: with the stream
    sweep made once outside the chain, as the model makes it once a batch;
    ``wrapper_ms``: made inside each call, what a direct caller pays), SDPA
    on the same boolean mask (yardstick only) and that dense forward are
    each timed over >= 5 chains of back-to-back launches (median, min and
    max per launch), with each time's ratio to SDPA in this run; the plain
    version over single calls."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        attention_sweep,
        flash_forward_stream,
        flash_forward_stream_reference,
        flash_fwd_dense,
        flash_fwd_stream_tc,
        flash_fwd_tc,
        stream_tc,
    )

    variants = [
        dict(name="unpacked_T4096", shape=(1, 4096, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="unpacked_T32768", shape=(1, 32768, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="packed_T8192", shape=(1, 8192, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
        dict(name="packed_T16384", shape=(1, 16384, 8, 64), dtype="bfloat16",
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
        tc_before = flash_fwd_stream_tc.launches
        out, lse = flash_forward_stream(q, k, v, kv, seg, sm)
        again = flash_forward_stream(q, k, v, kv, seg, sm)
        torch.cuda.synchronize()
        tc = stream_tc(q)
        check(flash_fwd_stream_tc.launches - tc_before == (2 if tc else 0),
              f"long {var['name']}: the tensor-core kernel was launched "
              f"{flash_fwd_stream_tc.launches - tc_before} times of 2 (want {2 if tc else 0})")
        check(torch.equal(out, again[0]) and torch.equal(lse, again[1]),
              f"long {var['name']}: two launches of the streaming kernel differ")
        del again
        ref_out, ref_lse = flash_forward_stream_reference(q, k, v, kv, seg, sm)
        err, lse_err, atol, live = _hold_forward(f"long {var['name']}", out, lse, ref_out,
                                                 ref_lse, kv, seg, var["dtype"])
        del ref_out, ref_lse

        chain = 2 if q.shape[1] >= 16384 else 8  # back-to-back calls per timing
        # with the stream sweep made once outside the chain (what the model
        # pays: the encoder makes one a batch), and made inside every call
        sweep = attention_sweep(kv, seg, dense=False)
        kernel = spread_ms(lambda: flash_forward_stream(q, k, v, kv, seg, sm, sweep=sweep),
                           reps=5, chain=chain)
        wrapper = spread_ms(lambda: flash_forward_stream(q, k, v, kv, seg, sm), reps=5,
                            chain=chain)
        library = _sdpa_spread(q, k, v, kv, seg, reps=5, chain=chain)
        plain_ms = median_ms(lambda: flash_forward_stream_reference(q, k, v, kv, seg, sm),
                             reps=3, warmup=1)
        bound_ms, bound_by, flops, bytes_ = _bound(q, kv, seg)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"],
                   kernel="flash_fwd_stream_tc" if tc else "flash_fwd_stream",
                   max_abs_err=err, lse_max_abs_err=lse_err, out_atol=atol,
                   ms=kernel["ms"], min_ms=kernel["min_ms"], max_ms=kernel["max_ms"],
                   wrapper_ms=wrapper["ms"],
                   wrapper_min_max_ms=[wrapper["min_ms"], wrapper["max_ms"]],
                   wrapper_ratio_to_library=wrapper["ms"] / library["ms"],
                   chain=chain, plain_ms=plain_ms, library_ms=library["ms"],
                   library_min_ms=library["min_ms"], library_max_ms=library["max_ms"],
                   ratio_to_library=kernel["ms"] / library["ms"], bound_ms=bound_ms,
                   bound_by=bound_by, ratio_to_bound=kernel["ms"] / bound_ms, flops=flops,
                   bytes=bytes_, deterministic=True)
        if var["packed"] and q.shape[1] == 32768:
            # the dense forward on the same inputs: the same mainloop on the
            # dense sweep, which lays the same tiles here (each video one run)
            tc_before = flash_fwd_tc.launches
            dense_out, dense_lse = flash_fwd_dense(q, k, v, kv, seg, sm)
            torch.cuda.synchronize()
            check(flash_fwd_tc.launches - tc_before == 1,
                  "packed 32768: the dense forward did not take the tensor-core kernel")
            lse_live = live[:, None, :, None].expand_as(lse)
            check(torch.equal(dense_out[live], out[live])
                  and torch.equal(dense_lse[lse_live], lse[lse_live]),
                  "packed 32768: the dense forward's bits differ from the stream kernel's on "
                  "live rows")
            dense = spread_ms(lambda: flash_fwd_dense(q, k, v, kv, seg, sm), reps=5,
                              chain=chain)
            row["flash_fwd_packed_ms"] = dense["ms"]
            row["flash_fwd_packed_min_max_ms"] = [dense["min_ms"], dense["max_ms"]]
            row["flash_fwd_packed_bit_equal"] = True
            del dense_out, dense_lse
        print(f"[long-kernel] {json.dumps(row)}")
        print(f"[long-forward-time] {var['name']} ({row['kernel']}): ms per call of {chain} "
              f"chained, [median, min, max]: sweep made once outside {_triple(kernel)}, made "
              f"inside the wrapper {_triple(wrapper)}; SDPA {_triple(library)}; kernel / SDPA "
              f"{row['ratio_to_library']:.3f} ({row['wrapper_ratio_to_library']:.3f} with the "
              f"sweep inside); kernel / bound {row['ratio_to_bound']:.2f}")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, sweep
        torch.cuda.empty_cache()
    return rows


def _plain_stream_attention(softmax_dtype: str):
    """Attention callable of the plain-stream model: the streaming kernel's
    plain version (query and key chunks; the dense plain attention at
    T = 32768 would need ~34 GB of scores per layer), on its own sweep."""
    from repurpose_tpu_torch.ops.flash_attention import flash_forward_stream_reference

    def attn(q, k, v, key_valid, seg_ids=None, sweep=None):
        return flash_forward_stream_reference(q, k, v, key_valid, seg_ids, softmax_dtype)[0]

    return attn


def phase_long_video_serving(card: str) -> dict:
    """7b: the flagship serves long videos with ``configs/longvideo.yaml``'s
    buckets at batch 1. Request A (one video per bucket 2048..32768) unpacked
    and packed, bit-identical; request B (12 videos of 1000-2500 s) in one
    32768 bucket and in 8192 buckets, packed rows shared, held against
    unpacked; the 32768 forward against the plain-stream model. Every
    forward launches the streaming kernel 16 times past T = 2048 and the
    dense one 16 times at 2048, every one the tensor-core kernel."""
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

    # (T, dense launches, stream launches, tensor-core stream launches,
    # tensor-core dense launches) per forward
    forwards = []
    names = ("flash_fwd", "flash_fwd_stream", "flash_fwd_stream_tc", "flash_fwd_tc")

    def counts():
        return tuple(read_launches(*names).values())

    def before(module, args):
        forwards.append(counts())

    def after(module, args, output):
        was = forwards.pop()
        forwards.append((int(args[0].shape[1]),
                         *(now - then for now, then in zip(counts(), was))))

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
    launches = read_launches(*names)
    for t, *launched in forwards:
        # every launch takes the tensor-core kernel, streaming past STREAM_MAX_T
        want = [0, layers, layers, 0] if t > fa.STREAM_MAX_T else [layers, 0, 0, layers]
        check(launched == want, f"a forward at T = {t} launched flash_fwd / flash_fwd_stream / "
                                f"flash_fwd_stream_tc / flash_fwd_tc {launched} times (want "
                                f"{want})")
    n_served = len(forwards)
    by_t = {t: sum(1 for f in forwards if f[0] == t) for t in sorted({f[0] for f in forwards})}
    print(f"[long-serve] launches {json.dumps(launches)} over {len(forwards)} forwards "
          f"(by T: {json.dumps(by_t)}): {layers} per forward, flash_fwd_stream past "
          f"T = {fa.STREAM_MAX_T} and flash_fwd at 2048, every one the tensor-core kernel")
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
    check(all(f[1:] == (0, layers, layers, 0) for f in forwards[n_served:]),
          "a T = 32768 forward did not launch flash_fwd_stream_tc 16 times")
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
        launches[name] = read_launches("flash_fwd", "flash_fwd_tc", "flash_fwd_stream",
                                       "flash_fwd_stream_tc")
        check(launches[name]["flash_fwd_stream"] > 0, f"CLI {extra}: no streaming launch")
        check(launches[name]["flash_fwd_stream_tc"] == launches[name]["flash_fwd_stream"]
              and launches[name]["flash_fwd_tc"] == launches[name]["flash_fwd"],
              f"CLI {extra}: a launch took a first design: {launches[name]}")
        print(f"[long-cli] {card}: --synthetic 4 {' '.join(extra)}: {wall_s:.1f} s, launches "
              f"{json.dumps(launches[name])}; " + "; ".join(lines))
    return launches


# -- phase 8: long-video training -------------------------------------------------


# --synthetic videos of the unpacked run of phase 8b: the CLI draws their
# durations from the config's seed (1234); these 7 fall in the buckets 4096,
# 8192, 16384 and (four of them) 32768
LONG_TRAIN_VIDEOS = 7


def _grad_rows(kv, seg):
    """[B, T]: the rows the model gives a gradient (before kvl and, packed,
    inside a video)."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import _kv_len

    rows = torch.arange(kv.shape[1], device=kv.device)[None, :] < _kv_len(kv)
    return rows if seg is None else rows & (seg >= 0)


def _prep_bound(q, seg):
    """Least time for the prep's work: q, g and o read once, lse, key_valid
    and seg_ids read once; q_s, {lse, delta} and {flag, segment} written
    once; against a multiply and a multiply-add per element at the float32
    rate."""
    b, t, h, dh = q.shape
    tp = -(-t // 64) * 64
    elem = q.element_size()
    bytes_ = (4 * q.numel() * elem + b * h * t * 4 + b * t * (1 if seg is None else 5)
              + b * h * tp * 8 + b * tp * 8)
    flops = 3.0 * q.numel()
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS["float32"] * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops, bytes_


def _hold_prep(label: str, got, want) -> float:
    """The prep kernel against its plain version: q_s, lse and the flags
    exactly, delta within float32 summation order (1e-5 x max |delta|).
    Returns the max |delta| error."""
    import torch

    check(torch.equal(got[0], want[0]), f"{label}: prep q_s differs")
    check(torch.equal(got[1][..., 0], want[1][..., 0]), f"{label}: prep lse differs")
    check(torch.equal(got[2], want[2]), f"{label}: prep flags / segments differ")
    delta = want[1][..., 1]
    err = float((got[1][..., 1] - delta).abs().max())
    check(err <= 1e-5 * float(delta.abs().max()),
          f"{label}: prep delta max err {err:.3g} > 1e-5 x max {float(delta.abs().max()):.3g}")
    return err


def phase_long_backward_vs_plain() -> list[dict]:
    """8a: the streaming backward kernels against their plain versions at
    phase 7a's layouts (and [1, 16384] unpacked and packed), on o / lse from
    the streaming forward kernel and an upstream gradient that is 0 where
    the model's is. In bf16 at Dh 64 the prep kernel is held against its
    plain version too, and dq and dk/dv are timed on its outputs. Every
    kernel is timed over >= 5 chains of back-to-back launches (median, min
    and max of the time per launch: the card's time, not the host's), with
    the plain versions, SDPA's backward on the same boolean mask (yardstick
    only, timed the same way) and each time's ratio to SDPA in this run;
    ``ms`` with the stream sweep made once outside the chain (the model's
    case), ``wrapper_ms`` with each call making its own; two launches of
    each kernel must
    give equal bits. On the packed [1, 32768] row the dense backward pair
    (at bf16 Dh 64 the select-form instances of the same kernels, on its
    own sweep, which spans the same tiles where every video is one run)
    must give the same gradients bit for bit: no row
    inside kvl there lacks a valid key of its own video, so the two mask
    forms agree on every pair."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        attention_sweep,
        flash_bwd_dkv,
        flash_bwd_dkv_stream,
        flash_bwd_dkv_stream_reference,
        flash_bwd_dq,
        flash_bwd_dq_stream,
        flash_bwd_dq_stream_reference,
        flash_bwd_stream_prep,
        flash_bwd_stream_prep_reference,
        flash_forward_stream,
        stream_tc,
    )

    variants = [
        dict(name="unpacked_T4096", shape=(1, 4096, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="unpacked_f32_T4096", shape=(1, 4096, 8, 64), dtype="float32",
             sm="float32", packed=False),
        dict(name="packed_T8192", shape=(1, 8192, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
        dict(name="unpacked_T16384", shape=(1, 16384, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="packed_T16384", shape=(1, 16384, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
        dict(name="unpacked_T32768", shape=(1, 32768, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=False),
        dict(name="packed_T32768", shape=(1, 32768, 8, 64), dtype="bfloat16",
             sm="bfloat16", packed=True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for var in variants:
        q, k, v, kv, seg = _long_attention_inputs(var, gen)
        sm = var["sm"]
        o, lse = flash_forward_stream(q, k, v, kv, seg, sm)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        g = g.masked_fill(~_grad_rows(kv, seg)[:, :, None, None], 0.0)
        past = ~_grad_rows(kv, None)
        args = (q, k, v, kv, o, lse, g, seg, sm)
        got = dict(dq=flash_bwd_dq_stream(*args))
        got["dk"], got["dv"] = flash_bwd_dkv_stream(*args)
        again = (flash_bwd_dq_stream(*args), *flash_bwd_dkv_stream(*args))
        torch.cuda.synchronize()
        check(all(torch.equal(got[n], a) for n, a in zip(("dq", "dk", "dv"), again)),
              f"long {var['name']}: two launches of the stream kernels differ")
        del again
        want = dict(dq=flash_bwd_dq_stream_reference(*args))
        want["dk"], want["dv"] = flash_bwd_dkv_stream_reference(*args)
        rel = BWD_REL.get((var["dtype"], sm), BWD_REL_BF16)
        errs = _hold_backward(f"long {var['name']}", got, want, rel, past)
        del want
        big = q.shape[1] >= 16384
        chain = 2 if big else 8  # back-to-back calls per timing: the card's time
        library_ms, library_note = _sdpa_bwd_ms(q, k, v, kv, seg, g, reps=5, chain=chain)
        row = dict(name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
                   softmax_dtype=sm, packed=var["packed"], max_abs_err_by_grad=errs,
                   tolerance=f"{rel} x max |plain|", library_ms=library_ms,
                   library_note=library_note, deterministic=True)
        # each kernel timed with the stream sweep made once outside the chain
        # (``ms``: what the model pays, one sweep a batch) and, as before,
        # with the wrapper making its own (``wrapper_ms``)
        sweep = attention_sweep(kv, seg, dense=False)

        def both(fn, reps):
            outside = spread_ms(lambda: fn(sweep=sweep), reps=reps, chain=chain)
            inside = spread_ms(fn, reps=reps, chain=chain)
            return dict(**outside, wrapper_ms=inside["ms"],
                        wrapper_min_max_ms=[inside["min_ms"], inside["max_ms"]])

        kw = {}
        if stream_tc(q):
            prep = flash_bwd_stream_prep(*args[:-1], sweep=sweep)
            torch.cuda.synchronize()
            delta_err = _hold_prep(f"long {var['name']}", prep,
                                   flash_bwd_stream_prep_reference(*args[:-1]))
            bound_ms, bound_by, flops, bytes_ = _prep_bound(q, seg)
            row["prep"] = dict(
                max_abs_err=delta_err,
                **both(lambda **sw: flash_bwd_stream_prep(*args[:-1], **sw), reps=10),
                plain_ms=median_ms(lambda: flash_bwd_stream_prep_reference(*args[:-1]),
                                   reps=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
            kw = dict(prep=prep)
        for kname, fn, ref_fn, products, outputs, keys in (
            ("dq", flash_bwd_dq_stream, flash_bwd_dq_stream_reference, 3, 1, ("dq",)),
            ("dkv", flash_bwd_dkv_stream, flash_bwd_dkv_stream_reference, 4, 2, ("dk", "dv")),
        ):
            bound_ms, bound_by, flops, bytes_ = _bwd_bound(q, kv, seg, products, outputs)
            row[kname] = dict(
                max_abs_err=max(errs[x] for x in keys),
                **both(lambda **sw: fn(*args, **kw, **sw), reps=5 if big else 10),
                plain_ms=median_ms(lambda: ref_fn(*args), reps=1 if big else 3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
        pair_ms = row["dq"]["ms"] + row["dkv"]["ms"] + row.get("prep", {}).get("ms", 0.0)
        row["pair_ms"] = pair_ms
        if library_ms is not None:
            for key in ("prep", "dq", "dkv"):
                if key in row:
                    row[key]["ratio_to_library"] = row[key]["ms"] / library_ms
            row["pair_ratio_to_library"] = pair_ms / library_ms
        if var["packed"] and q.shape[1] == 32768:
            # the dense pair on the same inputs: one mainloop, the select form,
            # on its own prep (the dense sweep: the same tiles on this layout)
            dense_kw = dict(prep=flash_bwd_stream_prep(*args[:-1], dense=True))
            dense = dict(dq=flash_bwd_dq(*args, **dense_kw))
            dense["dk"], dense["dv"] = flash_bwd_dkv(*args, **dense_kw)
            torch.cuda.synchronize()
            check(all(torch.equal(dense[n], got[n]) for n in got),
                  f"packed 32768: the dense pair's gradients differ from the stream pair's")
            row["dense"] = dict(
                flash_bwd_dq_ms=median_ms(lambda: flash_bwd_dq(*args, **dense_kw), reps=3),
                flash_bwd_dkv_ms=median_ms(lambda: flash_bwd_dkv(*args, **dense_kw), reps=3),
                bit_equal=True)
            check(library_ms is not None and pair_ms < library_ms,
                  f"packed 32768: the stream backward ({pair_ms:.3f} ms) is not faster than "
                  f"SDPA's backward ({library_ms} ms)")
            del dense
        print(f"[long-backward] {json.dumps(row)}")
        summary = {key: [round(row[key][x], 4) for x in ("ms", "min_ms", "max_ms")]
                   for key in ("prep", "dq", "dkv") if key in row}
        inside = {key: [round(row[key]["wrapper_ms"], 4),
                        *(round(x, 4) for x in row[key]["wrapper_min_max_ms"])]
                  for key in ("prep", "dq", "dkv") if key in row}
        print(f"[long-backward-time] {var['name']}: ms per call of {chain} chained, "
              f"[median, min, max]: sweep made once outside {json.dumps(summary)}, made inside "
              f"the wrappers {json.dumps(inside)}; SDPA backward {library_ms} ms; pair / SDPA "
              f"{row.get('pair_ratio_to_library')}")
        rows.append(row)
        del q, k, v, kv, seg, o, lse, g, got, args, kw, sweep
        torch.cuda.empty_cache()
    return rows


def _long_training_config(buckets=None, pack: bool = False, epochs: int = 1,
                          steps: int | None = None):
    """``longvideo_config()`` (remat on, batch 1) for a smoke run of
    ``epochs`` epochs that each save, evaluate and run the val probe once (at
    the epoch's last step, given its ``steps``); ``buckets`` cuts the ladder;
    ``pack`` packs rows, with loss_norm batch_size (per video)."""
    cfg = longvideo_config()
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=epochs, save_epochs=1, eval_freq=1,
        intra_epoch_eval_freq=steps or cfg.train.intra_epoch_eval_freq,
        buckets=buckets or cfg.train.buckets, pack_sequences=pack,
        loss_norm="batch_size" if pack else cfg.train.loss_norm))


class _LaunchesPerStep:
    """Kernel launches of every training step (its MMCT forward, the remat
    recompute and the backward: from the forward to the optimizer step) and
    of every forward without gradients (val probe, evaluation), each with
    its T, from global module and optimizer hooks; a context manager."""

    def __enter__(self):
        import torch
        from torch.optim.optimizer import register_optimizer_step_pre_hook

        from repurpose_tpu_torch.models.mmct import MMCT

        self.steps, self.forwards = [], []
        self._step = self._forward = None
        names = list(_counted_wrappers())

        def start(module, args):
            if isinstance(module, MMCT):
                mark = (int(args[0].shape[1]), read_launches(*names))
                if torch.is_grad_enabled() and module.training:
                    self._step = mark
                else:
                    self._forward = mark

        def end_forward(module, args, output):
            if isinstance(module, MMCT) and not (torch.is_grad_enabled() and module.training):
                self.forwards.append(self._since(self._forward))

        def end_step(optimizer, args, kwargs):
            if self._step is not None:
                self.steps.append(self._since(self._step))
                self._step = None

        self._hooks = [torch.nn.modules.module.register_module_forward_pre_hook(start),
                       torch.nn.modules.module.register_module_forward_hook(end_forward),
                       register_optimizer_step_pre_hook(end_step)]
        return self

    def __exit__(self, *exc):
        for hook in self._hooks:
            hook.remove()

    @staticmethod
    def _since(mark):
        t, before = mark
        now = read_launches(*before)
        return t, {n: now[n] - before[n] for n in before if now[n] != before[n]}


def _hold_long_run(label: str, card: str, summary: dict, seen, workdir: str, steps: int,
                   layers: int, wall_s: float) -> dict:
    """Holds one long-video training run: ``steps`` steps, each past T = 2048
    launching exactly flash_fwd_stream 2 x ``layers`` (forward and remat
    recompute), every one the tensor-core kernel, and each streaming backward
    kernel (the prep, dq, dk/dv) ``layers`` times, nothing else; each forward
    without gradients ``layers`` launches of its forward kernel, the
    tensor-core one; finite losses, the val probe, the tIoU evaluation and
    a checkpoint. Returns the launches summed over the run."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    check(summary["step"] == steps == len(seen.steps) and steps > 0,
          f"{label}: {summary['step']} steps, {len(seen.steps)} seen, plan {steps}")
    step_want = {"flash_fwd_stream": 2 * layers, "flash_fwd_stream_tc": 2 * layers,
                 "flash_bwd_dq_stream": layers, "flash_bwd_dkv_stream": layers,
                 "flash_bwd_stream_prep": layers}
    for t, launched in seen.steps:
        check(t > fa.STREAM_MAX_T and launched == step_want,
              f"{label}: a step at T = {t} launched {launched} (want {step_want})")
    for t, launched in seen.forwards:
        want = ({"flash_fwd_stream": layers, "flash_fwd_stream_tc": layers}
                if t > fa.STREAM_MAX_T else {"flash_fwd": layers, "flash_fwd_tc": layers})
        check(launched == want, f"{label}: a forward at T = {t} launched {launched}")
    total = dict.fromkeys(_counted_wrappers(), 0)
    for _, launched in seen.steps + seen.forwards:
        for n, c in launched.items():
            total[n] += c
    lines = [json.loads(line) for line in open(os.path.join(workdir, "metrics.jsonl"))]
    losses = [m["batch/loss"] for m in lines if "batch/loss" in m]
    check(len(losses) > 0 and all(np.isfinite(x) for x in losses)
          and np.isfinite(summary["final_loss"]), f"{label}: non-finite losses {losses}")
    check(any("val/loss" in m and np.isfinite(m["val/loss"]) for m in lines),
          f"{label}: the val probe did not run")
    check({"tiou/mean", "tiou/0.5"} <= set(summary), f"{label}: evaluate returned "
                                                     f"{sorted(summary)}")
    blob = torch.load(os.path.join(workdir, "ckpt", f"{steps}.pt"), map_location="cpu",
                      weights_only=True)
    check(blob["nonfinite_count"] == 0 and blob["step"] == steps, f"{label}: bad checkpoint")
    by_t = {t: sum(1 for s in seen.steps if s[0] == t) for t in sorted({s[0] for s in seen.steps})}
    print(f"[long-train] {card}: {label}: {steps} steps (by T: {json.dumps(by_t)}), "
          f"{len(seen.forwards)} forwards without gradients (val probe, evaluation), "
          f"launches {json.dumps(total)}: per step {json.dumps(step_want)}; final loss "
          f"{summary['final_loss']:.4f}, tIoU mean {summary['tiou/mean']:.4f}, checkpoint "
          f"at step {steps}; run {wall_s:.1f} s on the host clock")
    return total


def _time_long_steps(trainer, batch, label: str, card: str, reps: int = 2) -> dict:
    """Step time of ``batch`` (staging, forward, recompute, backward, Adam;
    synchronised), median over ``reps`` steps after one warm-up step, with
    videos/s and the peak of allocated device memory."""
    import torch

    device_batch = trainer._device_batch(batch)
    trainer.train_step(trainer.state, device_batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t1 = time.perf_counter()
        m = trainer.train_step(trainer.state, trainer._device_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    row = dict(T=int(batch.visual.shape[1]), videos=int(m["n_real"]),
               step_ms=statistics.median(times) * 1e3,
               videos_per_s=int(m["n_real"]) / statistics.median(times),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[long-step] {card}: {label}: {json.dumps(row)}")
    return row


def phase_long_training(card: str, workdir: str) -> dict:
    """8b: the flagship trains on ``configs/longvideo.yaml`` (remat on, batch
    1) through the entry points: the training CLI's ``run`` on
    ``--synthetic 7`` unpacked (buckets 4096, 8192, 16384 and 32768), and
    ``Trainer`` on 12 videos of 1000-2500 s packed into rows of 32768 (the
    YAML's ladder, two epochs) and of 8192 (the ladder cut at 8192). Each run
    takes the val probe, a checkpoint and the tIoU evaluation, with exact
    launch counts per step. Then, per bucket, the step time, videos/s and
    peak memory; at 16384 the same step without remat, whose peak must be
    higher; and a profile of the 32768 step."""
    import torch

    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.loop import Trainer

    layers = longvideo_config().model.self_num_layers
    launches = dict.fromkeys(_counted_wrappers(), 0)

    def add(total):
        for n, c in total.items():
            launches[n] += c

    # unpacked, through the CLI
    cfg = _long_training_config()
    train_ds, _, _ = cli.build_datasets(cfg, LONG_TRAIN_VIDEOS)
    steps = BatchLoader(train_ds, 1, cfg.train.buckets,
                        seed=cfg.train.seed).batches_per_epoch(0)
    cfg = _long_training_config(steps=steps)
    run_dir = os.path.join(workdir, "unpacked")
    args = cli.parse_args(["--synthetic", str(LONG_TRAIN_VIDEOS), "--epochs", "1",
                           "--workdir", run_dir])
    reset_launches()
    with _LaunchesPerStep() as seen:
        t0 = time.perf_counter()
        summary = cli.run(cfg, args)
        wall_s = time.perf_counter() - t0
    add(_hold_long_run(f"unpacked, CLI run --synthetic {LONG_TRAIN_VIDEOS}", card, summary,
                       seen, run_dir, steps, layers, wall_s))

    trainer = Trainer(cfg, run_dir, train_ds, device="cuda")
    check(trainer.resume() and trainer.state.step == steps,
          "resume() did not restore the long-video checkpoint's step")
    by_t = {}
    for batch in trainer.train_loader.epoch(1):
        by_t.setdefault(int(batch.visual.shape[1]), batch)
    check(sorted(by_t) == [4096, 8192, 16384, 32768], f"unpacked buckets {sorted(by_t)}")
    timings = {}
    encoder = trainer.state.model.multimodal_encoder
    for t, batch in sorted(by_t.items()):
        timings[f"unpacked_T{t}"] = _time_long_steps(trainer, batch, f"unpacked [1, {t}]", card)
        if t == 16384:  # the same step without remat: its peak must be higher
            encoder.remat = False
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            trainer.train_step(trainer.state, trainer._device_batch(batch))
            torch.cuda.synchronize()
            no_remat = dict(step_ms=(time.perf_counter() - t1) * 1e3,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            encoder.remat = True
            check(no_remat["peak_gb"] > timings[f"unpacked_T{t}"]["peak_gb"],
                  f"[1, 16384]: peak without remat {no_remat} is not above the peak with "
                  f"remat {timings[f'unpacked_T{t}']}")
            timings[f"unpacked_T{t}"]["no_remat"] = no_remat
            print(f"[long-step] {card}: unpacked [1, 16384] without remat: "
                  f"{json.dumps(no_remat)}")
    profile = _profile_step(trainer, card, by_t[32768],
                            label="one unpacked [1, 32768] training step (remat)")
    trainer.close()

    # packed, through the Trainer: 12 videos in rows of 32768 and of 8192
    lens = _long_packed_lengths(32768)
    for rows_t, buckets, epochs in ((32768, None, 2), (8192, (2048, 4096, 8192), 1)):
        cfg = _long_training_config(buckets, pack=True, epochs=epochs)
        train_ds = SyntheticDataset(lens, cfg.model, seed=1)
        steps = BatchLoader(train_ds, 1, cfg.train.buckets, seed=cfg.train.seed,
                            pack=True).batches_per_epoch(0)
        cfg = _long_training_config(buckets, pack=True, epochs=epochs, steps=steps)
        run_dir = os.path.join(workdir, f"packed_{rows_t}")
        trainer = Trainer(cfg, run_dir, train_ds, SyntheticDataset(lens[:2], cfg.model, seed=2),
                          SyntheticDataset(lens[:3], cfg.model, seed=3), device="cuda")
        with _LaunchesPerStep() as seen:
            t0 = time.perf_counter()
            summary = trainer.fit()
            wall_s = time.perf_counter() - t0
        add(_hold_long_run(f"packed, Trainer, {len(lens)} videos of {min(lens)}-{max(lens)} s "
                           f"in rows of {rows_t}", card, summary, seen, run_dir,
                           steps * epochs, layers, wall_s))
        batch = next(iter(trainer.train_loader.epoch(epochs)))
        check(batch.visual.shape[1] == rows_t, f"packed rows of {batch.visual.shape[1]}")
        timings[f"packed_T{rows_t}"] = _time_long_steps(
            trainer, batch, f"packed [1, {rows_t}] of {int(batch.seg_ids.max()) + 1} videos",
            card)
        trainer.close()
    return dict(launches=launches, timings=timings, **profile)


def _plain_stream_trainable(softmax_dtype: str):
    """Attention callable of the plain-stream training model: an autograd
    Function whose forward is ``flash_forward_stream_reference`` and whose
    backward the two streaming plain versions (the dense plain attention at
    T = 8192 would hold 2 GB of scores per layer)."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        flash_bwd_dkv_stream_reference,
        flash_bwd_dq_stream_reference,
        flash_forward_stream_reference,
    )

    class PlainStream(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, key_valid, seg_ids):
            out, lse = flash_forward_stream_reference(q, k, v, key_valid, seg_ids,
                                                      softmax_dtype)
            ctx.save_for_backward(q, k, v, out, lse, key_valid, seg_ids)
            return out

        @staticmethod
        def backward(ctx, g):
            q, k, v, out, lse, key_valid, seg_ids = ctx.saved_tensors
            args = (q, k, v, key_valid, out, lse, g.contiguous(), seg_ids, softmax_dtype)
            dk, dv = flash_bwd_dkv_stream_reference(*args)
            return flash_bwd_dq_stream_reference(*args), dk, dv, None, None

    return lambda q, k, v, key_valid, seg_ids=None, sweep=None: PlainStream.apply(
        q, k, v, key_valid, seg_ids)


def phase_long_gradients(card: str) -> dict:
    """8c: every parameter gradient of one [1, 8192] step of the flagship on
    the long-video config (remat on) with the kernels against the same model
    whose attention is the plain-stream Function, unpacked and packed, in
    the production setting (bf16, bf16 interior) and in float32; then the
    kernel model with remat on against off, dropout 0.1 on: masks, loss and
    gradients bit-identical, and the dropout generator in the same state.
    The kernel steps' streaming forwards take the tensor-core kernel in bf16
    and the first design in float32; returns their launches by dtype."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.data.batching import collate, pack_batch, plan_packing
    from repurpose_tpu_torch.data.synthetic import synthetic_sample
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.step import batch_to_device, loss_fn

    cfg = longvideo_config()
    layers = cfg.model.self_num_layers
    train_cfg = dataclasses.replace(cfg.train, loss_norm="batch_size")
    rng = np.random.default_rng(SEED + 8)
    videos = [synthetic_sample(rng, n, cfg.model) for n in _long_packed_lengths(8192)]
    rows = plan_packing([v["duration"] for v in videos], 8192, 1)[0]
    check(sum(len(r) for r in rows) == len(videos), "the 8192 row does not hold its videos")
    batches = {
        "unpacked": collate([synthetic_sample(rng, 7000, cfg.model)], (8192,), batch_size=1),
        "packed": pack_batch(videos, rows, 8192, batch_size=1),
    }
    f32 = dataclasses.replace(cfg.model, compute_dtype="float32", attn_softmax_dtype="float32")
    launches = {}
    for dtype, model_cfg in (("bfloat16", cfg.model), ("float32", f32)):
        reset_launches()
        for name, batch in batches.items():
            b = batch_to_device(batch, "cuda")
            kernel = _step_grads(model_cfg, train_cfg, b, "auto")
            plain = _step_grads(model_cfg, train_cfg, b, "auto",
                                attn=_plain_stream_trainable(model_cfg.attn_softmax_dtype))
            _hold_grads(f"{card}: {dtype}, {name} [1, 8192], remat on, kernel vs plain-stream "
                        "model", kernel, plain, GRAD_REL_BOUND[dtype], layers)
            del kernel, plain
            torch.cuda.empty_cache()
        launches[dtype] = read_launches("flash_fwd_stream", "flash_fwd_stream_tc")
        # two steps of 2 x layers forwards (forward and remat recompute)
        want = 4 * layers
        check(launches[dtype] == {"flash_fwd_stream": want,
                                  "flash_fwd_stream_tc": want if dtype == "bfloat16" else 0},
              f"{dtype} [1, 8192] steps launched {launches[dtype]} (want {want} streaming "
              "forwards, all tensor-core in bf16, none in float32)")

    b = batch_to_device(batches["unpacked"], "cuda")
    runs = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(cfg.model, remat=remat), "cuda",
                            seed=SEED).train()
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        model.set_dropout_generator(gen)
        loss = loss_fn(model, train_cfg, b)[0]
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                     gen.get_state()))
        del model
    (loss_on, grads_on, gen_on), (loss_off, grads_off, gen_off) = runs
    same = [n for n, g in grads_off.items()
            if (g is None and grads_on[n] is None) or (g is not None and torch.equal(g, grads_on[n]))]
    check(torch.equal(loss_on, loss_off) and len(same) == len(grads_off)
          and torch.equal(gen_on, gen_off),
          f"remat on vs off, dropout {cfg.model.dropout}: loss {float(loss_on)} vs "
          f"{float(loss_off)}, {len(same)}/{len(grads_off)} gradients equal, generator "
          f"{'equal' if torch.equal(gen_on, gen_off) else 'differs'}")
    print(f"[grad] {card}: unpacked [1, 8192], dropout {cfg.model.dropout}: remat on vs off "
          f"bit-identical: loss {float(loss_on):.6f}, {len(same)}/{len(grads_off)} parameter "
          "gradients, the dropout generator's final state; streaming forward launches of "
          f"the kernel steps {json.dumps(launches)}")
    return launches


# -- phase 9: the bench tools ---------------------------------------------------


WIDE_DH = 256  # the widest kernel instance of the first designs
WIDE_PADDED_DH = 192  # a head the model route zero-pads to WIDE_DH


def phase_wide_heads() -> list[dict]:
    """Wide heads: the Dh 256 instances of the first designs (csrc/flash_fwd.cu,
    flash_fwd_stream.cu, flash_bwd.cu, flash_bwd_stream.cu) against their
    plain versions, forward and backward, bf16 and float32: the dense
    kernels at [2, 1024, 2, 256] unpacked and packed, the streaming ones at
    [1, 4096, 2, 256] unpacked and packed, each under ``TOL`` / ``BWD_REL``;
    each launch counted on the first design (never the tensor-core one).
    Times per launch of a chain with the sweep made outside (the forward,
    and the dq + dk/dv pair), SDPA forward and backward on the same mask,
    and the bounds. Then the model's route at Dh 192 (``flash_attention``,
    zero-padded to 256 with the head's own scale) on the card against the
    same call on CPU tensors (the plain versions at Dh 192), out and
    gradients."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    variants = []
    for dtype in ("bfloat16", "float32"):
        for packed in (False, True):
            variants.append(dict(name=f"dense_{'packed' if packed else 'unpacked'}_{dtype}",
                                 shape=(2, 1024, 2, WIDE_DH), dtype=dtype, sm=dtype,
                                 packed=packed, stream=False))
            variants.append(dict(name=f"stream_{'packed' if packed else 'unpacked'}_{dtype}",
                                 shape=(1, 4096, 2, WIDE_DH), dtype=dtype, sm=dtype,
                                 packed=packed, stream=True))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for var in variants:
        b, t, h, dh = var["shape"]
        dtype = getattr(torch, var["dtype"])
        qkv = torch.randn((b, t, 3 * h * dh), generator=gen, device="cuda").to(dtype)
        q, k, v = (z.view(b, t, h, dh) for z in qkv.split(h * dh, dim=-1))
        seg = None
        if var["packed"]:
            durs = [int(d) for d in np.random.default_rng(SEED + 12 + t).integers(
                t // 8, t // 2, size=4 * b)]
            mask, seg_np, _ = _packed_layout(b, t, durs)
            seg = torch.from_numpy(seg_np).cuda()
        else:
            mask = np.zeros((b, t), bool)
            for i in range(b):
                mask[i, : int((0.9 - 0.3 * i) * t)] = True
            mask[:, t // 3: t // 3 + 50] = False
        kv = torch.from_numpy(mask).cuda()
        sm = var["sm"]
        fwd, fwd_ref = ((fa.flash_forward_stream, fa.flash_forward_stream_reference)
                        if var["stream"] else (fa.flash_forward, fa.flash_forward_reference))
        dq_fn, dkv_fn, dq_ref, dkv_ref = (
            (fa.flash_bwd_dq_stream, fa.flash_bwd_dkv_stream, fa.flash_bwd_dq_stream_reference,
             fa.flash_bwd_dkv_stream_reference) if var["stream"] else
            (fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_bwd_dq_reference,
             fa.flash_bwd_dkv_reference))
        names = ("flash_fwd_stream", "flash_bwd_dq_stream", "flash_bwd_dkv_stream") \
            if var["stream"] else ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        tc_names = ("flash_fwd_stream_tc", "flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
        reset_launches()
        out, lse = fwd(q, k, v, kv, seg, sm)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        g = g.masked_fill(~_grad_rows(kv, seg)[:, :, None, None], 0.0)
        args = (q, k, v, kv, out, lse, g, seg, sm)
        got = dict(dq=dq_fn(*args))
        got["dk"], got["dv"] = dkv_fn(*args)
        torch.cuda.synchronize()
        launched = read_launches(*names, *tc_names)
        check([launched[n] for n in names] == [1, 1, 1] and not any(
            launched[n] for n in tc_names), f"wide {var['name']}: launches {launched}")
        ref_out, ref_lse = fwd_ref(q, k, v, kv, seg, sm)
        err, lse_err, atol, live = _hold_forward(f"wide {var['name']}", out, lse, ref_out,
                                                 ref_lse, kv, seg, var["dtype"])
        del ref_out, ref_lse
        want = dict(dq=dq_ref(*args))
        want["dk"], want["dv"] = dkv_ref(*args)
        rel = BWD_REL.get((var["dtype"], sm), BWD_REL_BF16)
        errs = _hold_backward(f"wide {var['name']}", got, want, rel, ~_grad_rows(kv, None))
        del want
        sweep = fa.attention_sweep(kv, seg, dense=not var["stream"])
        chain = 4
        f_ms = spread_ms(lambda: fwd(q, k, v, kv, seg, sm, sweep=sweep), reps=5, chain=chain)
        b_ms = spread_ms(lambda: (dq_fn(*args, sweep=sweep), dkv_fn(*args, sweep=sweep)),
                         reps=5, chain=chain)
        f_lib = _sdpa_spread(q, k, v, kv, seg, reps=5, chain=chain)
        b_lib, b_lib_note = _sdpa_bwd_ms(q, k, v, kv, seg, g, reps=5, chain=chain)
        f_bound = _bound(q, kv, seg)
        dq_bound, dkv_bound = _bwd_bound(q, kv, seg, 3, 1), _bwd_bound(q, kv, seg, 4, 2)
        row = dict(
            name=var["name"], shape=list(var["shape"]), dtype=var["dtype"], softmax_dtype=sm,
            packed=var["packed"], kernels=list(names), max_abs_err=err, lse_max_abs_err=lse_err,
            out_atol=atol, max_abs_err_by_grad=errs, grad_tolerance=f"{rel} x max |plain|",
            ms=f_ms["ms"], min_ms=f_ms["min_ms"], max_ms=f_ms["max_ms"],
            plain_ms=median_ms(lambda: fwd_ref(q, k, v, kv, seg, sm), reps=3, warmup=1),
            library_ms=f_lib["ms"], bound_ms=f_bound[0], bound_by=f_bound[1],
            bwd_ms=b_ms["ms"], bwd_min_ms=b_ms["min_ms"], bwd_max_ms=b_ms["max_ms"],
            bwd_plain_ms=median_ms(lambda: (dq_ref(*args), dkv_ref(*args)), reps=3, warmup=1),
            bwd_library_ms=b_lib, bwd_library_note=b_lib_note,
            bwd_bound_ms=dq_bound[0] + dkv_bound[0],
            bwd_bound_by=dq_bound[1] if dq_bound[0] >= dkv_bound[0] else dkv_bound[1],
            chain=chain)
        print(f"[wide-heads] {json.dumps(row)}")
        print(f"[wide-time] {var['name']}: forward {_triple(f_ms)} ms (SDPA "
              f"{f_lib['ms']:.4f}, bound {f_bound[0]:.4f}); dq + dk/dv {_triple(b_ms)} ms "
              f"(SDPA backward {b_lib}, bound {row['bwd_bound_ms']:.4f})")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, g, args, got, sweep, qkv
        torch.cuda.empty_cache()

    # the model's route at Dh 192: zero-padded to 256 with the head's own scale
    for dtype in (torch.bfloat16, torch.float32):
        b, t, h, dh = 2, 1024, 2, WIDE_PADDED_DH
        rng = np.random.default_rng(SEED + 13)
        q, k, v, w = (torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32))
                      .to(dtype) for _ in range(4))
        valid = torch.ones(b, t, dtype=torch.bool)
        valid[1, t // 2:] = False
        w = w * valid[:, :, None, None]
        runs = []
        for device in ("cuda", "cpu"):
            reset_launches()
            leaves = [x.to(device).requires_grad_() for x in (q, k, v)]
            out = fa.flash_attention(*leaves, valid.to(device), None, "float32")
            (out.float() * w.to(device).float()).sum().backward()
            if device == "cuda":
                torch.cuda.synchronize()
                launched = read_launches("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                check(launched == dict(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1),
                      f"wide Dh {dh} {dtype}: launches {launched}")
            runs.append([x.detach().float().cpu() for x in (out, *(z.grad for z in leaves))])
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        live = torch.arange(t)[None] < fa._kv_len(valid)
        errs = {}
        for name, got_x, want_x in zip(("out", "dq", "dk", "dv"), *runs):
            scale = float(want_x[live].abs().max())
            errs[name] = float((got_x[live] - want_x[live]).abs().max())
            check(errs[name] <= rel * scale and bool(torch.isfinite(got_x).all()),
                  f"wide Dh {dh} {dtype} {name}: max err {errs[name]:.3g} > {rel} x {scale:.3g}")
        row = dict(name=f"model_route_Dh{dh}_{str(dtype).split('.')[-1]}",
                   shape=[b, t, h, dh], padded_to=fa.kernel_head_dim("cuda", dh),
                   max_abs_err_by_output=errs, tolerance=f"{rel} x max |cpu|")
        print(f"[wide-heads] {json.dumps(row)}")
        rows.append(row)
    return rows


# the daemon and campaign phases' decode gate: with random weights the
# default 10 s duration gate would leave no candidate (as in phase 4)
DAEMON_DURATION_THRESH = 0.001
# Concurrent drains merge several clients' videos into other batches (other
# rows, other matrix shapes), so bf16 rounding differs from the sequential
# answer: each video's top score (the sigmoid of its largest kept logit,
# which Soft-NMS never decays) is held within 0.025 = BF16_LOGIT_MAX x 1/4,
# the sigmoid's largest slope; its clip count within 25 % of the larger
# count plus 2, since Soft-NMS keeps the candidates whose decayed score
# stays above min_score, and a score near it can flip either way.
DAEMON_TOP_SCORE_TOL = BF16_LOGIT_MAX / 4


def _daemon_config(workdir: str):
    """The production config with the daemon's decode gate, and a JSON copy
    of it for the subprocess (the card's machine has no PyYAML)."""
    cfg = production_config()
    cfg = dataclasses.replace(cfg, test_cfg=dataclasses.replace(
        cfg.test_cfg, duration_thresh=DAEMON_DURATION_THRESH))
    path = os.path.join(workdir, "production.json")
    with open(path, "w") as f:
        f.write(cfg.to_json())
    return cfg, path


def _feature_root(workdir: str, requests) -> str:
    """The requests' features as ``DIR/{visual,audio,text}/{id}.npy`` (the
    dataset's layout): clients then send video ids (``--feature_root``),
    not ~100 MB of JSON per 1800 s video."""
    import numpy as np

    root = os.path.join(workdir, "features")
    for m in ("visual", "audio", "text"):
        os.makedirs(os.path.join(root, m), exist_ok=True)
    for r, videos in enumerate(requests):
        for i, v in enumerate(videos):
            v["video_id"] = f"r{r}v{i}"
            for m in ("visual", "audio", "text"):
                np.save(os.path.join(root, m, f"{v['video_id']}.npy"), v[m])
    return root


def _http(url: str, payload: dict | None = None, timeout: float = 300.0):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _served(cfg, args):
    """The daemon of ``args`` in this process, serving on a thread:
    (base URL, server, scorer, thread)."""
    import threading

    from repurpose_tpu_torch import serve

    server, scorer, platform, name = serve.make_server(cfg, args)
    check(platform == "cuda" and name == _card_name(), f"daemon on {platform} {name}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", server, scorer, thread


def _card_name() -> str:
    import torch

    return torch.cuda.get_device_name(0)


def _shut(server, scorer, thread) -> None:
    server.shutdown()
    scorer.stop()
    scorer.join(timeout=60)
    server.server_close()
    thread.join(timeout=60)
    check(not scorer.is_alive() and not thread.is_alive(), "the daemon did not stop")


def phase_daemon(card: str, workdir: str) -> dict:
    """The serving daemon (``python -m repurpose_tpu_torch.serve``) at the
    production width (d_model 512, 16 layers, bf16, buckets 256-2048), on
    seeded weights written as a ``.pth``, features served by video id:
    (a) its classes in this process: requests of 4-8 videos of 200-1800 s,
    one client at a time, each answer equal bit for bit to in-process
    ``score_videos`` on the same videos, every attention launch the
    tensor-core forward; latency and videos/s per request; (b) 4 concurrent
    clients, unpacked and ``--pack``: every client answered in order,
    ``scored_total`` adding up, each video within ``DAEMON_TOP_SCORE_TOL`` of
    its sequential answer; (c) the module as a subprocess with ``--warmup``:
    its readiness line, one ``/score``, ``/healthz`` and exit code 0 on
    SIGTERM."""
    import threading

    import torch

    from repurpose_tpu_torch import serve
    from repurpose_tpu_torch.models import build_model

    cfg, cfg_json = _daemon_config(workdir)
    pth = os.path.join(workdir, "weights.pth")
    torch.save({"model": build_model(cfg.model, "cpu", seed=SEED).state_dict(), "epoch": 0,
                "loss": 0.0}, pth)
    requests = _requests(cfg.model, 8)
    features = _feature_root(workdir, requests)
    flags = ["--torch_ckpt", pth, "--port", "0", "--feature_root", features]
    ids = [[v["video_id"] for v in videos] for videos in requests]

    # (a) one client at a time, against score_videos in this process; warmed
    # up, so that the latencies are the steady state's
    base, server, scorer, thread = _served(cfg, serve.parse_args(flags + ["--warmup"]))
    sequential, latencies = {}, []
    try:
        reset_launches()
        for r, videos in enumerate(requests[:4]):
            t0 = time.perf_counter()
            status, body = _http(base + "/score", {"videos": [{"video_id": i} for i in ids[r]]})
            latencies.append((time.perf_counter() - t0, len(videos)))
            check(status == 200, f"daemon request {r}: {status}")
            want = [serve._json_result(x) for x in scorer.pipe.score_videos(
                [{m: v[m] for m in ("video_id", "visual", "audio", "text")} for v in videos],
                buckets=cfg.train.buckets, batch_size=8)]
            check(body["results"] == want,
                  f"daemon request {r}: answer differs from in-process score_videos")
            sequential.update({x["video_id"]: x for x in body["results"]})
        torch.cuda.synchronize()
        launches = read_launches("flash_fwd", "flash_fwd_tc")
        check(launches["flash_fwd_tc"] > 0 and launches["flash_fwd"] == launches["flash_fwd_tc"],
              f"daemon: launches {launches} (every forward the tensor-core kernel)")
        health = _http(base + "/healthz")[1]
        check(health["scored_total"] == sum(len(v) for v in requests[:4]),
              f"scored_total {health['scored_total']}")
        for r in range(4, 8):  # the other requests' sequential answers, for (b)
            body = _http(base + "/score", {"videos": [{"video_id": i} for i in ids[r]]})[1]
            sequential.update({x["video_id"]: x for x in body["results"]})
    finally:
        _shut(server, scorer, thread)
    ms = [t * 1e3 for t, _ in latencies]
    rate = sum(n for _, n in latencies) / sum(t for t, _ in latencies)
    print(f"[daemon] {card}: {len(ms)} requests of 4-8 videos, one client at a time, equal bit "
          f"for bit to in-process score_videos; latency ms median {statistics.median(ms):.1f} "
          f"[min {min(ms):.1f}, max {max(ms):.1f}], {rate:.2f} videos/s; launches "
          f"{json.dumps(launches)}")

    # (b) four concurrent clients, unpacked and packed
    concurrent = {}
    for pack in (False, True):
        base, server, scorer, thread = _served(
            cfg, serve.parse_args(flags + (["--pack"] if pack else [])))
        try:
            before = _http(base + "/healthz")[1]["scored_total"]
            out, t0 = {}, time.perf_counter()

            def client(r):
                out[r] = _http(base + "/score",
                               {"videos": [{"video_id": i} for i in ids[r]]})

            threads = [threading.Thread(target=client, args=(r,)) for r in range(4, 8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(600)
            wall = time.perf_counter() - t0
            check(sorted(out) == list(range(4, 8)), f"clients unanswered: {sorted(out)}")
            worst, counts = 0.0, []
            for r, (status, body) in out.items():
                check(status == 200 and [x["video_id"] for x in body["results"]] == ids[r],
                      f"concurrent client {r}: {status}, answers out of order")
                for x in body["results"]:
                    y = sequential[x["video_id"]]
                    check(x["duration"] == y["duration"], "durations differ")
                    top = abs(max(x["scores"], default=0.0) - max(y["scores"], default=0.0))
                    worst = max(worst, top)
                    n, m = len(x["scores"]), len(y["scores"])
                    counts.append((n, m))
                    check(top <= DAEMON_TOP_SCORE_TOL and abs(n - m) <= 0.25 * max(n, m) + 2,
                          f"{x['video_id']}: top score off by {top:.4g}, clips {n} vs {m}")
            total = _http(base + "/healthz")[1]["scored_total"] - before
            check(total == sum(len(ids[r]) for r in range(4, 8)), f"scored_total {total}")
        finally:
            _shut(server, scorer, thread)
        concurrent["packed" if pack else "unpacked"] = dict(
            wall_s=wall, videos=total, videos_per_s=total / wall, max_top_score_diff=worst,
            same_clip_counts=sum(n == m for n, m in counts), of=len(counts))
        print(f"[daemon] {card}: 4 concurrent clients {'--pack' if pack else 'unpacked'}: "
              f"{total} videos in {wall:.2f} s ({total / wall:.2f} videos/s), all answered "
              f"in order; max |top score - sequential| {worst:.4g} <= "
              f"{DAEMON_TOP_SCORE_TOL}; equal clip counts in "
              f"{sum(n == m for n, m in counts)}/{len(counts)} videos")

    # (c) the module as a subprocess, warmed up
    proc = subprocess.Popen(
        [sys.executable, "-m", "repurpose_tpu_torch.serve", "--config_path", cfg_json,
         "--warmup", "--pack", *flags], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        line = proc.stdout.readline()
        ready_s = time.perf_counter() - t0
        check("serving on http://" in line and f"platform=cuda {_card_name()}" in line,
              f"readiness line {line!r}: {proc.stderr.read()[-2000:] if not line else ''}")
        base = "http://127.0.0.1:" + line.split("http://")[1].split(" ")[0].rsplit(":", 1)[1]
        t1 = time.perf_counter()
        status, body = _http(base + "/score", {"videos": [{"video_id": i} for i in ids[0]]})
        first_ms = (time.perf_counter() - t1) * 1e3
        check(status == 200 and [x["video_id"] for x in body["results"]] == ids[0],
              "subprocess /score failed")
        status, health = _http(base + "/healthz")
        check(status == 200 and health["platform"] == "cuda" and health["pack"] is True
              and health["scored_total"] == len(ids[0]), f"/healthz {health}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 0, f"the daemon exited {rc} on SIGTERM: {proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    print(f"[daemon] {card}: python -m repurpose_tpu_torch.serve --warmup --pack: ready in "
          f"{ready_s:.1f} s ({line.strip()}); first /score after warm-up {first_ms:.1f} ms; "
          f"/healthz ok; SIGTERM exit 0")
    return dict(launches=launches, latency_ms=ms, videos_per_s=rate, concurrent=concurrent,
                ready_s=ready_s, first_score_ms=first_ms)


def phase_campaign(card: str, workdir: str) -> dict:
    """``python -m repurpose_tpu_torch.campaign --smoke 8`` on the card at the
    production width (random weights of the config's seed): the packed
    cross-check passes, the report is written, and the smoke split's
    temporary directory is gone afterwards."""
    _, cfg_json = _daemon_config(workdir)
    tmp = os.path.join(workdir, "tmp")
    os.makedirs(tmp, exist_ok=True)
    report = os.path.join(workdir, "campaign_report.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repurpose_tpu_torch.campaign", "--config_path", cfg_json,
         "--smoke", "8", "--report", report], cwd=ROOT, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, TMPDIR=tmp))
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"campaign exited {proc.returncode}: {proc.stderr[-3000:]}")
    with open(report) as f:
        rep = json.load(f)
    check(rep["eval_entries"] == 8 and rep["packed_crosscheck"]["passed"]
          and "error" not in rep, f"campaign report {rep}")
    check(rep["card"] == _card_name() and "nvidia_smi" in rep, "the report lacks the card")
    left = [n for n in os.listdir(tmp) if n.startswith("campaign_smoke_")]
    check(left == [], f"the smoke split was left behind: {left}")
    print(f"[campaign] {card}: --smoke 8 in {wall:.1f} s (one process: start, build reuse, "
          f"two scorings): mean precision@tIoU {rep['mean_precision_at_tiou']:.4f}, packed "
          f"cross-check deltas {json.dumps(rep['packed_crosscheck']['abs_delta_by_threshold'])} "
          f"within {rep['packed_crosscheck']['tolerance_per_threshold']}; report written; "
          "temporary directory removed")
    return dict(wall_s=wall, report=rep)


def phase_trainer_flags(card: str, workdir: str) -> dict:
    """``train --synthetic 12 --epochs 1 --profile --async-ckpt`` on the card
    at the production config (the CLI's ``run``): the trace exists and the
    step's host time is split by its largest CPU-side operations; the
    asynchronous checkpoint restores bit for bit against a synchronous save
    of the same state; ``load_batch`` takes the native route and equals
    ``collate`` bit for bit on an on-disk split of the production widths."""
    import numpy as np
    import torch

    from repurpose_tpu_torch import native
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.data.synthetic import write_synthetic_dataset
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.checkpoint import Checkpointer
    from repurpose_tpu_torch.train.loop import Trainer

    cfg = _training_config()
    run_dir = os.path.join(workdir, "run")
    reset_launches()
    t0 = time.perf_counter()
    summary = cli.run(cfg, cli.parse_args(["--synthetic", "12", "--epochs", "1", "--profile",
                                           "--async-ckpt", "--workdir", run_dir]))
    wall = time.perf_counter() - t0
    launches = read_launches("flash_fwd_tc", "flash_bwd_stream_prep", "flash_bwd_dq_tc",
                             "flash_bwd_dkv_tc")
    check(all(n > 0 for n in launches.values()), f"trainer flags: launches {launches}")
    steps = summary["step"]
    trace = os.path.join(run_dir, "profile", "trace.json")
    table = open(os.path.join(run_dir, "profile", "ops.txt")).read().splitlines()
    check(os.path.getsize(trace) > 0 and len(table) > 5, "no profile written")
    print(f"[trainer-flags] {card}: --profile --async-ckpt, {steps} packed [6, 2048] steps in "
          f"{wall:.1f} s; trace {os.path.getsize(trace)} bytes; launches {json.dumps(launches)}")
    # the host split: the operator table of the profiled epoch, by self CPU time
    for row in table[:24]:
        print(f"[train-host-split] {row}")
    step_row = next((r for r in table if r.strip().startswith("train_step")), "")
    print(f"[train-host-split] the annotated step: {step_row.strip()}")

    # the async checkpoint against a synchronous save of the same state
    trainer = Trainer(cfg, os.path.join(workdir, "restore"), cli.build_datasets(cfg, 12)[0],
                      device="cuda")
    trainer.checkpointer = Checkpointer(os.path.join(run_dir, "ckpt"))
    check(trainer.resume() and trainer.state.step == steps, "async checkpoint did not restore")
    sync_dir = os.path.join(workdir, "sync")
    Checkpointer(sync_dir).save(steps, trainer.state, {"epoch": 1})
    got = torch.load(os.path.join(run_dir, "ckpt", f"{steps}.pt"), map_location="cpu",
                     weights_only=True)
    want = torch.load(os.path.join(sync_dir, f"{steps}.pt"), map_location="cpu",
                      weights_only=True)
    for part in ("model", "optimizer"):
        a = torch.utils._pytree.tree_flatten(got[part])[0]
        b = torch.utils._pytree.tree_flatten(want[part])[0]
        check(len(a) == len(b) and all(
            torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b)),
            f"async checkpoint's {part} differs from the synchronous save")

    # the steady-state step's host split: warmed-up steps of the restored
    # state under the profiler, CPU-side operations by self time
    host = _host_split(trainer, card, os.path.join(workdir, "steady_profile"))
    trainer.close()

    # load_batch: the native route, equal to collate; each route timed on
    # files already in the page cache (one read of each first)
    check(native.available(), "the native feature loader did not build on the card's host")
    split = write_synthetic_dataset(os.path.join(workdir, "split"), [300, 1200, 700, 1800],
                                    cfg.model, seed=5)
    ds = RepurposeDataset(split, validate=False, use_cache=False)
    idx = [0, 1, 2, 3]
    ds.load_batch(idx, cfg.train.buckets, 6)
    collate([ds[i] for i in idx], cfg.train.buckets, 6)
    t1 = time.perf_counter()
    batch = ds.load_batch(idx, cfg.train.buckets, 6)
    native_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    want_batch = collate([ds[i] for i in idx], cfg.train.buckets, 6)
    numpy_ms = (time.perf_counter() - t1) * 1e3
    check(batch is not None and all(
        (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))
        for a, b in zip(batch, want_batch)), "load_batch differs from collate")
    print(f"[trainer-flags] {card}: async checkpoint at step {steps} equals a synchronous save "
          f"bit for bit; load_batch (native, csrc/npy_loader.cc) equals collate bit for bit "
          f"on a [6, 2048] batch of 4 videos: {native_ms:.1f} ms native, {numpy_ms:.1f} ms numpy "
          f"(host clock, files cached)")
    return dict(launches=launches, steps=steps, wall_s=wall, host_split=host)


def _host_split(trainer, card: str, logdir: str, warm: int = 3, steps: int = 4) -> dict:
    """The production step's host time split by CPU-side operation: ``warm``
    steps, then ``steps`` steps under ``utils.profiling.trace`` (each ending
    in a synchronise), the operators by self CPU time per step against the
    step's wall time and device busy time."""
    import itertools

    import torch

    from repurpose_tpu_torch.utils.profiling import trace

    batches = list(itertools.islice(trainer.train_loader.epoch(0), 2))
    for i in range(warm):
        trainer.train_step(trainer.state, trainer._device_batch(batches[i % len(batches)]))
    torch.cuda.synchronize()
    with trace(logdir) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            trainer.train_step(trainer.state, trainer._device_batch(batches[i % len(batches)]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type.name == "CUDA") / 1e3 / steps
    top = sorted((e for e in events if e.self_cpu_time_total > 0),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    rows = [dict(op=e.key, self_cpu_ms=e.self_cpu_time_total / 1e3 / steps,
                 calls=e.count / steps) for e in top]
    print(f"[host-split] {card}: packed [6, 2048] step, {steps} steps after {warm} warm-up, "
          f"under the profiler: wall {wall_ms:.2f} ms a step, device busy {busy:.2f} ms; "
          "CPU-side operations by self time per step:")
    for r in rows:
        print(f"[host-split]   {r['op']}: {r['self_cpu_ms']:.2f} ms, {r['calls']:.0f} calls")
    return dict(wall_ms=wall_ms, busy_ms=busy, top=rows)


def _nt_bound(q, kv):
    """Least time for the no-transpose forward on these inputs: the two
    products of every query row with the keys it needs (the valid keys; all
    T in a row with none), against q and out once, k/v rows up to kvl (all
    T in a row with no valid key) and key_valid read once."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import _kv_len

    b, t, d = q.shape
    n = kv.sum(dim=1)
    flops = 4.0 * t * float(torch.where(n > 0, n, t).double().sum()) * d
    kvl = _kv_len(kv)[:, 0]
    kvl = torch.where(kvl > 0, kvl, t)
    bytes_ = (2 * float(kvl.sum()) * d + 2 * q.numel()) * q.element_size() + kv.numel()
    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    t_ops = flops / PEAK_OPS[dtype] * 1e3
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops, bytes_)


def phase_nt_vs_plain() -> list[dict]:
    """9a: ``mha_nt`` against ``mha_nt_reference`` on every row under ``TOL``
    (rows past the last valid key and fully masked rows included; bf16 rows:
    the tensor-core kernel, which each call must have launched; the float32
    row: the first design), two launches equal bit for bit. The kernel, the
    port's ``flash_forward`` on [B, T, H, Dh] views of the same tensors and
    SDPA (yardstick only, on the same boolean mask) are each timed over >= 5
    chains of back-to-back launches (median, min and max per launch), with
    each time's ratio to SDPA in this run; the plain version over single
    calls."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import flash_forward
    from repurpose_tpu_torch.tools import bench_attention_fwd as baf

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    variants = [dict(name=f"tool_bf16_hpb{g}", shape=(baf.B, baf.T, baf.H, baf.DH),
                     dtype="bfloat16", hpb=g) for g in baf.NT_HEADS_PER_BLOCK]
    variants.append(dict(name="f32_T1000_holes_masked_row", shape=(2, 1000, 8, 64),
                         dtype="float32", hpb=2))
    rows = []
    for var in variants:
        b, t, h, dh = var["shape"]
        dtype = getattr(torch, var["dtype"])
        q, k, v = (torch.randn((b, t, h * dh), generator=gen, device="cuda").to(dtype)
                   for _ in range(3))
        kv = torch.ones((b, t), dtype=torch.bool, device="cuda")
        if var["dtype"] == "bfloat16":
            kv[:, baf.KEYS_VALID:] = False  # the tool's mask
        else:
            kv[0, 900:] = False  # a ragged row with interior holes,
            kv[0, torch.randint(0, 900, (100,), generator=gen, device="cuda")] = False
            kv[1] = False  # and a row with no valid key
        tc_before = baf.flash_fwd_nt_tc.launches
        out = baf.mha_nt(q, k, v, kv, heads=h, heads_per_block=var["hpb"])
        again = baf.mha_nt(q, k, v, kv, heads=h, heads_per_block=var["hpb"])
        torch.cuda.synchronize()
        tc = baf.nt_tc(q, h)
        check(baf.flash_fwd_nt_tc.launches - tc_before == (2 if tc else 0),
              f"mha_nt {var['name']}: the tensor-core kernel was launched "
              f"{baf.flash_fwd_nt_tc.launches - tc_before} times of 2")
        check(torch.equal(out, again), f"mha_nt {var['name']}: two launches differ")
        del again
        ref = baf.mha_nt_reference(q, k, v, kv, h)
        got, want = out.float(), ref.float()
        err = float((got - want).abs().max())
        tol = TOL[var["dtype"]]
        atol = tol.get("out_atol", 0.0) or tol["out_atol_rel_max"] * float(want.abs().max())
        bad = int(((got - want).abs() > atol + tol["out_rtol"] * want.abs()).sum())
        check(bad == 0, f"mha_nt {var['name']}: {bad} elements past atol {atol:.3g} "
                        f"rtol {tol['out_rtol']} (max err {err:.3g})")
        check(bool(torch.isfinite(got).all()), f"mha_nt {var['name']}: non-finite out")

        views = [z.view(b, t, h, dh) for z in (q, k, v)]
        bound_ms, bound_by, flops, bytes_ = _nt_bound(q, kv)
        chain = 20
        kernel = spread_ms(lambda: baf.mha_nt(q, k, v, kv, heads=h, heads_per_block=var["hpb"]),
                           reps=5, chain=chain)
        dense = spread_ms(lambda: flash_forward(*views, kv), reps=5, chain=chain)
        library = _sdpa_spread(*views, kv, None, reps=5, chain=chain)
        row = dict(
            name=var["name"], shape=list(var["shape"]), dtype=var["dtype"],
            heads_per_block=var["hpb"], kernel="flash_fwd_nt_tc" if tc else "flash_fwd_nt",
            max_abs_err=err, out_atol=atol, ms=kernel["ms"], min_ms=kernel["min_ms"],
            max_ms=kernel["max_ms"], chain=chain,
            plain_ms=median_ms(lambda: baf.mha_nt_reference(q, k, v, kv, h), reps=3, warmup=1),
            flash_forward_ms=dense["ms"],
            flash_forward_min_max_ms=[dense["min_ms"], dense["max_ms"]],
            library_ms=library["ms"], library_min_ms=library["min_ms"],
            library_max_ms=library["max_ms"], ratio_to_library=kernel["ms"] / library["ms"],
            bound_ms=bound_ms, bound_by=bound_by, ratio_to_bound=kernel["ms"] / bound_ms,
            flops=flops, bytes=bytes_, deterministic=True)
        print(f"[nt-kernel] {json.dumps(row)}")
        print(f"[nt-time] {var['name']} ({row['kernel']}): ms per call of {chain} chained, "
              f"[median, min, max] {_triple(kernel)}; flash_forward {_triple(dense)}; "
              f"SDPA {_triple(library)}; kernel / SDPA {row['ratio_to_library']:.3f}")
        rows.append(row)
        del q, k, v, kv, out, ref, got, want, views
        torch.cuda.empty_cache()
    return rows


def _int8_bounds(m: int, k: int, n: int, x_bytes: int) -> dict:
    """Least times of the two int8 kernels at (m, k, n): 2 m k n int8
    operations at the card's int8 peak against their bytes (the fused kernel:
    x, wq, ws read and out in x's dtype written once; the core kernel: xq
    and wq read and the int32 out written once)."""
    t_ops = 2.0 * m * k * n / PEAK_OPS["int8"] * 1e3
    out = {}
    for name, bytes_ in (("fused", m * k * x_bytes + k * n + 4 * n + m * n * x_bytes),
                         ("core", m * k + k * n + 4 * m * n)):
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         ops=2.0 * m * k * n, bytes=bytes_)
    return out


def _unaligned_copy(t):
    """A copy of ``t`` whose storage starts one element past a 16-byte
    boundary: a contiguous row-slice view of a larger flat buffer (as
    ``buf[1:]`` gives), which ``.contiguous()`` leaves where it is."""
    import torch

    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def phase_int8_vs_plain() -> list[dict]:
    """9b: ``int8_core`` and ``int8_matmul`` against their plain versions,
    bit for bit, at the tool's shapes, a ragged one, float32 x at the first
    tool shape and, at the same shape, x and xq unaligned (their rows reach
    the kernel through the plain-load route), bf16 or float32 x with an
    all-zero row; each launch's route checked against the rule (route 1
    where the A operand's rows are 16-byte aligned). The kernels,
    ``torch._int_mm`` (the core kernel's yardstick, never on the port's
    path) and the ``torch.matmul`` incumbent (bf16; float32 on the float32
    row) timed per launch of a chain (``spread_ms``), the plain versions over
    single calls; a ``[int8-time]`` line per row with each kernel's share of
    its bound and its ratio to the yardsticks."""
    import torch

    from repurpose_tpu_torch.tools import bench_int8_matmul as bim

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    variants = [dict(shape=shape, dtype="bfloat16", unaligned=False)
                for shape in [*bim.SHAPES, (1000, 520, 776)]]
    variants += [dict(shape=bim.SHAPES[0], dtype="float32", unaligned=False),
                 dict(shape=bim.SHAPES[0], dtype="bfloat16", unaligned=True)]
    rows = []
    for var in variants:
        m, k, n = var["shape"]
        x = torch.randn((m, k), generator=gen, device="cuda").to(getattr(torch, var["dtype"]))
        x[3] = 0  # the 1e-12 scale clamp
        w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(torch.bfloat16)
        wq, ws = bim.quantize_columns(w)
        xq, _ = bim.quantize_rows(x)
        if var["unaligned"]:
            x, xq = _unaligned_copy(x), _unaligned_copy(xq)
        fused, core = bim.int8_matmul(x, wq, ws), bim.int8_core(xq, wq)
        torch.cuda.synchronize()
        routes = dict(fused=bim.int8_matmul.last_launch, core=bim.int8_core.last_launch)
        for key, a in (("fused", x), ("core", xq)):
            want_route = int((k * a.element_size()) % 16 == 0 and a.data_ptr() % 16 == 0)
            check(routes[key]["route"] == want_route,
                  f"int8 {key} [{m}x{k}x{n}] {var}: route {routes[key]} taken, the rule gives "
                  f"{want_route}")
        for label, got, want in (
                ("int8_matmul", fused, bim.int8_matmul_reference(x, wq, ws)),
                ("int8_core", core, bim.int8_core_reference(xq, wq))):
            diff = int((got != want).sum())
            check(got.dtype == want.dtype and diff == 0,
                  f"{label} [{m}x{k}x{n}] {var}: {diff} elements differ from the plain version")
        bounds = _int8_bounds(m, k, n, x.element_size())
        chain = 20

        def timed(fn, plain, library, key):
            t = spread_ms(fn, reps=5, chain=chain)
            return dict(**t, plain_ms=median_ms(plain, reps=3, warmup=1),
                        library_ms=library, share_of_bound=bounds[key]["bound_ms"] / t["ms"],
                        **bounds[key])

        w_mm = w.to(x.dtype)
        # the yardsticks on aligned copies (cuBLAS may refuse an unaligned base)
        x_lib, xq_lib = (x.clone(), xq.clone()) if var["unaligned"] else (x, xq)
        bf16 = spread_ms(lambda: torch.matmul(x_lib, w_mm), reps=5, chain=chain)
        int_mm = spread_ms(lambda: torch._int_mm(xq_lib, wq), reps=5, chain=chain)
        row = dict(
            shape=[m, k, n], x_dtype=var["dtype"], unaligned=var["unaligned"], routes=routes,
            max_abs_err=0.0,
            fused=timed(lambda: bim.int8_matmul(x, wq, ws),
                        lambda: bim.int8_matmul_reference(x, wq, ws), None, "fused"),
            core=timed(lambda: bim.int8_core(xq, wq), lambda: bim.int8_core_reference(xq, wq),
                       int_mm["ms"], "core"),
            int_mm=int_mm, matmul=dict(**bf16, dtype=str(w_mm.dtype).split(".")[-1]),
            bf16_matmul_ms=bf16["ms"] if var["dtype"] == "bfloat16" else None)
        row["core"]["ratio_to_int_mm"] = row["core"]["ms"] / int_mm["ms"]
        for key in ("fused", "core"):
            row[key]["ratio_to_matmul"] = row[key]["ms"] / bf16["ms"]
        print(f"[int8-kernel] {json.dumps(row)}")
        print(f"[int8-time] {m}x{k}x{n} x {var['dtype']}"
              f"{' unaligned' if var['unaligned'] else ''} (routes fused "
              f"{routes['fused']['route']}, core {routes['core']['route']}): ms per call of "
              f"{chain} chained, [median, min, max]: int8_matmul {_triple(row['fused'])} "
              f"({row['fused']['share_of_bound']:.2f} of its bound "
              f"{row['fused']['bound_ms']:.4f}, {row['fused']['ratio_to_matmul']:.2f}x "
              f"{row['matmul']['dtype']} torch.matmul {_triple(bf16)}); int8_core "
              f"{_triple(row['core'])} ({row['core']['share_of_bound']:.2f} of its bound "
              f"{row['core']['bound_ms']:.4f}, {row['core']['ratio_to_int_mm']:.2f}x "
              f"torch._int_mm {_triple(int_mm)}, {row['core']['ratio_to_matmul']:.2f}x "
              f"torch.matmul)")
        rows.append(row)
        del x, w, w_mm, wq, ws, xq, fused, core, x_lib, xq_lib
        torch.cuda.empty_cache()
    return rows


def phase_bench_tools(card: str) -> dict:
    """9c: each tool's ``main([])`` on the card, its lines printed and its
    kernels' launches read (every ``mha_nt`` and ``flash_forward`` launch of
    the attention tool, bf16 at Dh 64, the tensor-core kernels); then the
    attention tool's
    ``mha_nt`` on float32 inputs of its shape, the path that still takes the
    first design."""
    import contextlib
    import io

    from repurpose_tpu_torch.tools import bench_attention_fwd, bench_int8_matmul

    launches = {}
    for tool, kernels, n_lines in ((bench_attention_fwd,
                                    ("flash_fwd_nt", "flash_fwd_nt_tc", "flash_fwd",
                                     "flash_fwd_tc"), 8),
                                   (bench_int8_matmul, ("int8_matmul", "int8_core"),
                                    1 + 2 * len(bench_int8_matmul.SHAPES))):
        name = tool.__name__.rsplit(".", 1)[-1]
        reset_launches()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tool.main([])
        wall_s = time.perf_counter() - t0
        launches[name] = read_launches(*kernels)
        lines = buf.getvalue().splitlines()
        check(rc == 0 and len(lines) == n_lines and card in lines[0],
              f"{name}: rc {rc}, printed {lines}")
        check(all(launches[name][kn] > 0 for kn in kernels),
              f"{name}: a kernel was not launched: {launches[name]}")
        for line in lines:
            print(f"[bench-tools] {name}: {line}")
        print(f"[bench-tools] {name}: main([]) {wall_s:.1f} s, launches "
              f"{json.dumps(launches[name])}")
    nt = launches["bench_attention_fwd"]
    check(nt["flash_fwd_nt_tc"] == nt["flash_fwd_nt"] and nt["flash_fwd_tc"] == nt["flash_fwd"],
          f"bench_attention_fwd: an mha_nt or flash_forward launch took the first design: {nt}")

    import torch

    baf = bench_attention_fwd
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q, k, v = (torch.randn((baf.B, baf.T, baf.H * baf.DH), generator=gen, device="cuda")
               for _ in range(3))
    kv = torch.ones((baf.B, baf.T), dtype=torch.bool, device="cuda")
    kv[:, baf.KEYS_VALID:] = False
    reset_launches()
    out = baf.mha_nt(q, k, v, kv, heads=baf.H)
    torch.cuda.synchronize()
    launches["mha_nt_float32"] = read_launches("flash_fwd_nt", "flash_fwd_nt_tc")
    check(out.shape == q.shape and bool(torch.isfinite(out).all())
          and launches["mha_nt_float32"] == {"flash_fwd_nt": 1, "flash_fwd_nt_tc": 0},
          f"mha_nt float32 at the tool's shape: launches {launches['mha_nt_float32']}")
    print(f"[bench-tools] mha_nt float32 at the tool's shape: launches "
          f"{json.dumps(launches['mha_nt_float32'])} (the first design), finite out")
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
    grad_launches = phase_gradients(card)
    long_variants = phase_long_kernel_vs_plain()
    long_served = phase_long_video_serving(card)
    long_cli = phase_long_cli(card)
    long_bwd_variants = phase_long_backward_vs_plain()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_long_", dir=os.path.join(ROOT, "runs"))
    try:
        long_trained = phase_long_training(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    long_grads = phase_long_gradients(card)
    wide = phase_wide_heads()
    nt_variants = phase_nt_vs_plain()
    int8_variants = phase_int8_vs_plain()
    bench = phase_bench_tools(card)
    extras = {}
    for name, phase in (("daemon", phase_daemon), ("campaign", phase_campaign),
                        ("trainer_flags", phase_trainer_flags)):
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{name}_", dir=os.path.join(ROOT, "runs"))
        try:
            extras[name] = phase(card, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    daemon, flags = extras["daemon"], extras["trainer_flags"]

    def timed(row):  # a row's kernel times and yardsticks, for a kernels entry
        return {x: row[x] for x in ("max_abs_err", "ms", "min_ms", "max_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")}

    bwd_head = next(r for r in bwd_variants if r["name"] == "packed_bf16_softmax_bf16")
    source = "repurpose_tpu_torch/csrc/"
    fa_line = "repurpose_tpu/ops/flash_attention.py:"
    long_train = long_trained["launches"]
    # the dense forward: the tensor-core kernel (bf16 at Dh 64, every path of
    # the model and the attention tool) and the first design (float32 and
    # the other Dh), whose launches on those paths are the difference: 0
    fwd_tc_rows = [r for r in variants if r["kernel"] == "flash_fwd_tc"]
    fwd_head = next(r for r in fwd_tc_rows if r["name"] == "packed_bf16_softmax_bf16")
    fwd_first = next(r for r in variants if r["kernel"] != "flash_fwd_tc")
    dense_fwd = dict(  # (all launches, tensor-core launches) by path
        serving=(served["launches"], served["tc_launches"]),
        training=(trained["launches"]["flash_fwd"], trained["launches"]["flash_fwd_tc"]),
        long_video_serving=(long_served["launches"]["flash_fwd"],
                            long_served["launches"]["flash_fwd_tc"]),
        long_video_cli=tuple(sum(v[n] for v in long_cli.values())
                             for n in ("flash_fwd", "flash_fwd_tc")),
        long_video_training=(long_train["flash_fwd"], long_train["flash_fwd_tc"]),
        gradients_bf16=(grad_launches["bfloat16"]["flash_fwd"],
                        grad_launches["bfloat16"]["flash_fwd_tc"]),
        bench_attention_fwd=(bench["bench_attention_fwd"]["flash_fwd"],
                             bench["bench_attention_fwd"]["flash_fwd_tc"]),
        daemon=(daemon["launches"]["flash_fwd"], daemon["launches"]["flash_fwd_tc"]))
    check(all(n == tc for n, tc in dense_fwd.values()),
          f"a dense forward on the model's paths took the first design: {dense_fwd}")
    kernels = [dict(
        name="flash_fwd_tc", route="cuda", source=source + "flash_fwd.cu",
        also_source=source + "flash_fwd_tc.cuh", replaces=f"{fa_line}227",
        launches=trained["launches"]["flash_fwd_tc"],
        launches_by_path={path: tc for path, (_, tc) in dense_fwd.items()},
        **timed(fwd_head), wrapper_ms=fwd_head["wrapper_ms"],
        variant=fwd_head["name"], variants=fwd_tc_rows,
    ), dict(
        name="flash_fwd", route="cuda", source=source + "flash_fwd.cu",
        replaces=f"{fa_line}227", design="first: float32, and bf16 at Dh 16, 32, 128 and 256",
        launches=grad_launches["float32"]["flash_fwd"],
        launches_by_path=dict(gradients_float32=grad_launches["float32"]["flash_fwd"],
                              **{path: n - tc for path, (n, tc) in dense_fwd.items()}),
        **timed(fwd_first), variant=fwd_first["name"], variants=[fwd_first],
        wide_heads=[r for r in wide if r["name"].startswith(("dense_", "model_route"))],
    )]
    # the dense backward: the tensor-core pair (bf16 at Dh 64, the training
    # path) and the first design (float32 and the other Dh)
    bwd_tc_rows = [r for r in bwd_variants if "prep" in r]
    bwd_first = next(r for r in bwd_variants if "prep" not in r)
    for name, key, line, also in (("flash_bwd_dq", "dq", 783, []),
                                  ("flash_bwd_dkv", "dkv", 1109, [1149])):
        r = bwd_head[key]
        tc_name = name + "_tc"
        check(long_train[tc_name] == long_train[name],  # every bf16 dense backward there
              f"long-video training: {name} launched {long_train[name]} times, "
              f"{tc_name} {long_train[tc_name]}")
        kernels.append(dict(
            name=tc_name, route="cuda", source=source + "flash_bwd.cu",
            also_source=source + "flash_bwd_tc.cuh", replaces=f"{fa_line}{line}",
            also_replaces=[f"{fa_line}{n}" for n in also],
            launches=trained["launches"][tc_name],
            launches_by_path=dict(training=trained["launches"][tc_name],
                                  gradients_bf16=grad_launches["bfloat16"][tc_name],
                                  long_video_training=long_train[tc_name],
                                  trainer_flags=flags["launches"][tc_name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=bwd_head["library_ms"],
            library_note="SDPA's whole backward (dq, dk and dv), against the pair",
            pair_ratio_to_library=bwd_head["pair_ratio_to_library"], variant=bwd_head["name"],
            variants=[dict(name=v["name"], **v[key], library_ms=v["library_ms"])
                      for v in bwd_tc_rows],
        ))
        r = bwd_first[key]
        first = grad_launches["float32"][name] - grad_launches["float32"][tc_name]
        kernels.append(dict(
            name=name, route="cuda", source=source + "flash_bwd.cu",
            replaces=f"{fa_line}{line}", also_replaces=[f"{fa_line}{n}" for n in also],
            design="first: float32, and bf16 at Dh 16, 32, 128 and 256",
            launches=first, launches_by_path=dict(gradients_float32=first),
            max_abs_err=r["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=bwd_first["library_ms"], variant=bwd_first["name"],
            wide_heads=[r for r in wide if r["name"].startswith("dense_")],
        ))

    # the streaming forward: the tensor-core kernel (bf16 at Dh 64, every
    # long-video path) and the first design (float32 and the other Dh)
    tc_rows = [r for r in long_variants if r["kernel"] == "flash_fwd_stream_tc"]
    first_rows = [r for r in long_variants if r["kernel"] == "flash_fwd_stream"]
    long_head = next(r for r in tc_rows if r["name"] == "unpacked_T32768")
    kernels.append(dict(
        # the dense forward's kernel of flash_fwd.cu, launched on the stream sweep
        name="flash_fwd_stream_tc", route="cuda", source=source + "flash_fwd.cu",
        also_source=source + "flash_fwd_tc.cuh", replaces=f"{fa_line}592",
        also_replaces=[f"{fa_line}512", f"{fa_line}657"],
        launches=long_served["launches"]["flash_fwd_stream_tc"],
        launches_by_path=dict(
            long_video_serving=long_served["launches"]["flash_fwd_stream_tc"],
            long_video_cli={k: v["flash_fwd_stream_tc"] for k, v in long_cli.items()},
            long_video_training=long_train["flash_fwd_stream_tc"],
            long_video_gradients_bf16=long_grads["bfloat16"]["flash_fwd_stream_tc"]),
        **timed(long_head), variant=long_head["name"], variants=tc_rows,
    ))
    first_head = first_rows[0]
    kernels.append(dict(
        name="flash_fwd_stream", route="cuda", source=source + "flash_fwd_stream.cu",
        replaces=f"{fa_line}592", also_replaces=[f"{fa_line}512", f"{fa_line}657"],
        design="first: float32, and bf16 at Dh 16, 32, 128 and 256",
        launches=long_grads["float32"]["flash_fwd_stream"],
        launches_by_path=dict(
            long_video_gradients_float32=long_grads["float32"]["flash_fwd_stream"]),
        **timed(first_head), variant=first_head["name"], variants=first_rows,
        wide_heads=[r for r in wide if r["name"].startswith("stream_")],
    ))
    long_bwd_head = next(r for r in long_bwd_variants if r["name"] == "unpacked_T32768")
    for name, key, replaces, also in (
        ("flash_bwd_dq_stream", "dq", 859, [914, 992]),
        ("flash_bwd_dkv_stream", "dkv", 1200, []),
    ):
        r = long_bwd_head[key]
        kernels.append(dict(  # bf16 Dh 64: the bias-form instances of the tensor-core pair
            name=name, route="cuda", source=source + "flash_bwd.cu",
            also_source=source + "flash_bwd_tc.cuh",
            first_design_source=source + "flash_bwd_stream.cu",
            replaces=f"{fa_line}{replaces}", also_replaces=[f"{fa_line}{n}" for n in also],
            launches=long_train[name],
            launches_by_path=dict(long_video_training=long_train[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=long_bwd_head["library_ms"], variant=long_bwd_head["name"],
            variants=[dict(name=v["name"], **v[key], library_ms=v["library_ms"],
                           library_note=v["library_note"]) for v in long_bwd_variants],
            wide_heads_first_design=[r for r in wide if r["name"].startswith("stream_")],
        ))
    r = long_bwd_head["prep"]
    kernels.append(dict(
        name="flash_bwd_stream_prep", route="cuda", source=source + "flash_bwd_stream.cu",
        replaces=f"{fa_line}1271", also_replaces=[f"{fa_line}1253"],
        launches=long_train["flash_bwd_stream_prep"] + trained["launches"]["flash_bwd_stream_prep"],
        launches_by_path=dict(training=trained["launches"]["flash_bwd_stream_prep"],
                              long_video_training=long_train["flash_bwd_stream_prep"],
                              trainer_flags=flags["launches"]["flash_bwd_stream_prep"]),
        max_abs_err=r["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
        library_ms=None,
        library_note="no single PyTorch call scales q and sums g * o per row",
        variant=long_bwd_head["name"],
        variants=[dict(name=v["name"], **v["prep"]) for v in long_bwd_variants
                  if "prep" in v],
    ))
    # the no-transpose forward: the tensor-core kernel (bf16 at Dh 64, the
    # tool's shape) and the first design (float32 and the other Dh)
    nt_tc_rows = [r for r in nt_variants if r["kernel"] == "flash_fwd_nt_tc"]
    nt_first_rows = [r for r in nt_variants if r["kernel"] == "flash_fwd_nt"]
    nt_head = next(r for r in nt_tc_rows if r["name"] == "tool_bf16_hpb2")
    kernels.append(dict(
        name="flash_fwd_nt_tc", route="cuda", source=source + "flash_fwd_nt.cu",
        also_source=source + "flash_fwd_tc.cuh", replaces="tools/bench_attention_fwd.py:73",
        launches=bench["bench_attention_fwd"]["flash_fwd_nt_tc"],
        launches_by_path=dict(bench_attention_fwd=bench["bench_attention_fwd"]["flash_fwd_nt_tc"]),
        **timed(nt_head), flash_forward_ms=nt_head["flash_forward_ms"], variant=nt_head["name"],
        variants=nt_tc_rows,
    ))
    nt_first = nt_first_rows[0]
    kernels.append(dict(
        name="flash_fwd_nt", route="cuda", source=source + "flash_fwd_nt.cu",
        replaces="tools/bench_attention_fwd.py:73",
        design="first: float32, and bf16 at Dh 16, 32, 128 and 256",
        launches=bench["mha_nt_float32"]["flash_fwd_nt"],
        launches_by_path=dict(
            bench_attention_fwd_float32=bench["mha_nt_float32"]["flash_fwd_nt"]),
        **timed(nt_first), variant=nt_first["name"], variants=nt_first_rows,
    ))
    int8_head = next(r for r in int8_variants if r["shape"] == [16384, 512, 512]
                     and r["x_dtype"] == "bfloat16" and not r["unaligned"])
    int8_tool = bench["bench_int8_matmul"]
    for name, key, device_kernel, replaces, library_note in (
            ("int8_matmul", "fused", "int8_mm_kernel", "tools/bench_int8_matmul.py:67",
             "no single PyTorch call quantises, multiplies in int8 and dequantises; "
             "bf16_matmul_ms is the bf16 torch.matmul incumbent"),
            ("int8_core", "core", "int8_core_kernel", "tools/bench_int8_matmul.py:102",
             "torch._int_mm")):
        r = int8_head[key]
        kernels.append(dict(
            name=name, route="cuda", source=source + "int8_matmul.cu",
            device_kernel=device_kernel, replaces=replaces,
            launches=int8_tool[name], launches_by_path=dict(bench_int8_matmul=int8_tool[name]),
            max_abs_err=int8_head["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"],
            max_ms=r["max_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], library_note=library_note,
            share_of_bound=r["share_of_bound"], bf16_matmul_ms=int8_head["bf16_matmul_ms"],
            variant=str(int8_head["shape"]),
            variants=[dict(shape=v["shape"], x_dtype=v["x_dtype"], unaligned=v["unaligned"],
                           route=v["routes"][key]["route"],
                           matmul_ms=v["matmul"]["ms"], **v[key]) for v in int8_variants],
        ))
    check(all(k["launches"] > 0 for k in kernels), "a kernel of the path was never launched: "
          + json.dumps({k["name"]: k["launches"] for k in kernels}))
    print(f"[time] chip_smoke.py ran {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
