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
   interiors: the tensor-core pair, select form, on one
   ``flash_bwd_stream_prep``, held against its plain version too; a packed
   bf16 row with padding inside kvl, where the select form and the plain
   versions of the stream kernels' bias form differ; [6, 1000, 8, 64]
   float32: the first design), two launches equal bit for bit; the prep, dq and dk/dv timed likewise, with SDPA's
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
   a. the streaming backward wrappers (dq, dk/dv) against their plain
      versions at [1, 4096] (bf16 and float32), [1, 16384] and [1, 32768]
      unpacked and packed rows of [1, 8192], [1, 16384] and [1, 32768]; in
      bf16 each wrapper is one launch of the fused backward
      (``flash_bwd_fused_tc``, ``flash_backward``'s route): two calls give
      dk and dv bit for bit and dq within its run-to-run spread; the prep
      and the fused kernel (alone and with its prep) held against their
      plain versions and timed, in float32 the first design's dq and dk/dv,
      each over >= 5 chains of back-to-back launches (median, min, max per
      launch; the stream sweep made once outside the chain and inside the
      wrapper) beside the bound and SDPA's backward; at packed 32768 the
      dense tensor-core pair on its own prep, held against the fused kernel
      and timed, and SDPA slower than the fused kernel with its prep; then
      the fused kernel at packed [6, 2048] (the training step's shape, where
      the route keeps the dense pair) beside the dense pair;
   b. the flagship trains through the CLI's ``run`` (``--synthetic 7``,
      unpacked: buckets 4096..32768) and ``Trainer`` (12 videos packed into
      rows of 32768 and of 8192), each with the val probe, a checkpoint and
      the tIoU evaluation, and exactly 32 / 16 / 16 launches of
      ``flash_fwd_stream`` / ``flash_bwd_fused_tc`` / ``flash_bwd_stream_prep``
      per step (forward and remat recompute, the forwards all tensor-core;
      backward) and no launch of the dense or the stream pair; then
      step time, videos/s and peak memory per bucket, the [1, 16384] step
      without remat (a higher peak) and a profile of the [1, 32768] step,
      which makes the attention sweep once;
   c. every parameter gradient of a [1, 8192] step, unpacked and packed, bf16
      and float32, against the plain-stream model (the streaming forward:
      the tensor-core kernel in bf16, the first design in float32); remat on
      vs off with dropout on: loss and masks bit-identical, the gradients
      within the run-to-run spread of the fused backward's dq sum;
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
   streaming forward and backward) and the head-chunked instances
   (csrc/flash_chunked.cu) at Dh 320, 512 and 1000 (zero-padded to 1024)
   against their plain versions at [2, 1024, 2, Dh] and [1, 4096, 2, Dh],
   unpacked and packed, bf16 and float32, each launch counted on its kernel,
   timed beside SDPA and the bound, and the model's route at Dh 192
   (zero-padded to 256) and Dh 1000 (T 1024 and 4096, the chunked kernels'
   launches) against the same call on the CPU;
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
14. the fusion variants (``fusion: cross`` and ``bottleneck``) at the
   flagship width, unpacked: ``score_videos`` in float32 on the card against
   the CPU, then 3 bf16 train steps at [2, 2048], with times and peak memory;
   then ``MMCTCross`` at [1, 32768] on the kernels, 3 bf16 steps against the
   float32 plain reference (``gpubench/reference/cross.py``), its kernel
   launches per step counted and listed;
15. the utilities and CLIs: ``python -m repurpose_tpu_torch.preflight
   --full`` (exit 0), the capacity model's estimate against the measured
   peak at the packed [6, 2048] step and the [1, 32768] remat step, and
   ``python -m repurpose_tpu_torch.analyze --synthetic 4``;
16. data and tensor parallelism, two ranks sharing the card over gloo
   (torchrun, ``--share_card``), at the production width with random weights
   and dropout 0: the same two processes re-grouped into (a) data=2 (each
   rank [3, 2048] of the packed global [6, 2048] batch), (b) model=2 (the
   tensor-parallel layers, the attention kernels launched at 4 of the 8
   heads), (c) data=2 with ZeRO-1 and (b32) model=2 in float32, each
   against one-process steps on the global batch (loss, grad norm, the
   update, within ``PARALLEL_RUNS``' bounds; (c) equal to (a) bit for bit
   with half its optimizer state per rank); (d) the
   multi-process ``evaluate`` (data=2, model=2) against the one-process one;
   (e) the train CLI and ``preflight`` under torchrun; each rank's step time
   and its time in collectives, labelled as shared-card times;
17. pipeline and sequence parallelism, two ranks sharing the card over gloo
   as in 16: (a) pipe=2 with GPipe and (b) with 1F1B (a stage of 8 layers
   each, 2 microbatches of [3, 2048] of the packed global batch) against
   the one-process steps, with exact launches per rank of the tensor-core
   forward, prep and dq / dk-dv pair and those kernels held against their
   plain versions on a stage's microbatch q/k/v; the peak memory per rank
   of the two schedules at 6 microbatches; (c) seq=2 ring attention on one
   8192 s video (each rank [1, 4096], remat), bf16 and float32, against one
   process on the whole row with the plain attention, and the ring op alone
   at [1, 8192, 8, 64] against ``mha_torch``; (d) the multi-process
   ``evaluate`` with the ring live and on pipe=2; (e) the train CLI on a
   ``pipe: 2`` config under torchrun and 16's ``preflight``'s pipeline check;
18. the feature extractors and preprocessing, at the published widths with
   seeded random checkpoints written in the HF / PANNs layouts: (a) CLIP
   ViT-B/32 (128 frames), CNN14 (512 one-second chunks), MiniLM-L6 (256
   sentences of 64 tokens) and the Whisper-base encoder (4 chunks of 30 s)
   on the card in float32 against the CPU, and in bf16 where the drivers
   run them so; Whisper float32 greedy tokens against the CPU's up to its
   first near tie; beam 5 with word timestamps; no kernel launch; (b)
   ``python -m repurpose_tpu_torch.preprocess --device cuda`` (visual and
   audio steps, then ``--verify``) on three videos of 120-600 s read
   through a fake ``ffmpeg`` / ``ffprobe``, the text step (Whisper ASR and
   MiniLM) in this process with a stub tokenizer; (c) those features
   through ``RepurposeDataset`` and the flagship's ``score_videos``, the
   tensor-core forward counted; (d) ``bench_extractors`` on the card;
19. a JSON line listing every ported kernel, then the verdict line
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --parallel-worker DIR`` and ``--pipeline-worker
DIR`` are phase 16's and 17's ranks, started by torchrun; run the script
with no arguments.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
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
import threading
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
# Two bf16 steps of one model on one batch past T = 2048 (remat on against
# off): the fused backward adds dq's float32 partials in an order that
# changes from run to run, which moves single bf16 roundings of dq by an ulp
# (2**-8 relative) and carries into every gradient below the layer; relative
# L2 error per parameter. The first run on the card read 0.00905 at worst
# (input_projection.weight, whose gradient nearly cancels over the 8192
# positions; 35 of 218 gradients bit-identical); 0.05 leaves five times that
# and stays far under the bf16 kernel-vs-plain bound (0.25). A dropped key
# tile or mask moves them by ~1.
REMAT_GRAD_REL = 0.05
# Two runs of the fused backward's dq (its float32 sum order): one bf16 ulp
# (2**-7 relative at most), and 1e-4 x max |dq| where a sum nearly cancels.
DQ_RUN_TOL = dict(rtol=2.0 ** -7, atol_rel_max=1e-4)

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
    difference; ``flash_bwd_fused_tc`` counts the fused long-T backward
    (``flash_backward`` past T = 2048 in bf16 at Dh 64, which then launches
    neither stream wrapper); the ``*_chunked`` names count the head-chunked
    kernels (past Dh 256), each also counted by its wrapper's own name."""
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
            "flash_bwd_fused_tc": fa.flash_bwd_fused_tc,
            "flash_fwd_chunked": fa.flash_fwd_chunked,
            "flash_fwd_stream_chunked": fa.flash_fwd_stream_chunked,
            "flash_bwd_dq_chunked": fa.flash_bwd_dq_chunked,
            "flash_bwd_dkv_chunked": fa.flash_bwd_dkv_chunked,
            "flash_bwd_dq_stream_chunked": fa.flash_bwd_dq_stream_chunked,
            "flash_bwd_dkv_stream_chunked": fa.flash_bwd_dkv_stream_chunked,
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


def _hold_dq_runs(label: str, got, want) -> None:
    """Two runs of the fused kernel's dq within ``DQ_RUN_TOL`` on every
    element."""
    got, want = got.float(), want.float()
    atol = DQ_RUN_TOL["atol_rel_max"] * float(want.abs().max())
    bad = int(((got - want).abs() > atol + DQ_RUN_TOL["rtol"] * want.abs()).sum())
    check(bad == 0, f"{label}: {bad} dq elements past the run-to-run tolerance")


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
    for e in _device_work(prof.key_averages()):
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


def _device_work(events) -> list:
    """The device's entries of a profile's ``key_averages()``: its kernels,
    copies and memsets. A ``record_function`` range (the port's spans, under
    a profiler) is mirrored onto the device's timeline under its own name;
    such a mirror is no work of its own and is dropped."""
    host = {e.key for e in events if e.device_type.name == "CPU"}
    return [e for e in events if e.device_type.name == "CUDA" and e.key not in host]


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
    kernels = _device_work(prof.key_averages())
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
    kernels = _device_work(prof.key_averages())
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
        dict(name="unpacked_T16384", shape=(1, 16384, 8, 64), dtype="bfloat16",
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
    """8a: the streaming backward wrappers (``flash_bwd_dq_stream``,
    ``flash_bwd_dkv_stream``) against their plain versions at phase 7a's
    layouts (and [1, 16384] unpacked and packed), on o / lse from the
    streaming forward kernel and an upstream gradient that is 0 where the
    model's is. In bf16 at Dh 64 each wrapper launches the fused kernel
    (``flash_bwd_fused_tc``) on the prep: two calls give dk and dv bit for
    bit and dq within ``DQ_RUN_TOL``; the prep is held against its plain
    version and timed, the fused kernel by ``_fused_row``. In float32 (the
    first design) two calls give equal bits and dq and dk/dv are timed.
    Every kernel is timed over >= 5 chains of back-to-back launches (median,
    min and max of the time per launch: the card's time, not the host's),
    with the plain versions, SDPA's backward on the same boolean mask
    (yardstick only, timed the same way) and each time's ratio to SDPA in
    this run; ``ms`` with the stream sweep made once outside the chain (the
    model's case), ``wrapper_ms`` with each call making its own. On the
    packed [1, 32768] row the dense tensor-core pair on a ``DensePrep`` (the
    dense sweep spans the same tiles where every video is one run) is held
    against the fused kernel and timed, and the fused kernel with its prep
    must beat SDPA's backward."""
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
        fused = stream_tc(q)
        got = dict(dq=flash_bwd_dq_stream(*args))
        got["dk"], got["dv"] = flash_bwd_dkv_stream(*args)
        again = dict(zip(("dq", "dk", "dv"),
                         (flash_bwd_dq_stream(*args), *flash_bwd_dkv_stream(*args))))
        torch.cuda.synchronize()
        if fused:
            _hold_dq_runs(f"long {var['name']}: two calls", again["dq"], got["dq"])
        check(all(torch.equal(got[n], again[n]) for n in (("dk", "dv") if fused else got)),
              f"long {var['name']}: two calls of the stream wrappers differ")
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
                   library_note=library_note)
        # each kernel timed with the stream sweep made once outside the chain
        # (``ms``: what the model pays, one sweep a batch) and, as before,
        # with the wrapper making its own (``wrapper_ms``)
        sweep = attention_sweep(kv, seg, dense=False)

        def both(fn, reps):
            outside = spread_ms(lambda: fn(sweep=sweep), reps=reps, chain=chain)
            inside = spread_ms(fn, reps=reps, chain=chain)
            return dict(**outside, wrapper_ms=inside["ms"],
                        wrapper_min_max_ms=[inside["min_ms"], inside["max_ms"]])

        if fused:
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
        else:  # the first design's two kernels
            for kname, fn, ref_fn, products, outputs, keys in (
                ("dq", flash_bwd_dq_stream, flash_bwd_dq_stream_reference, 3, 1, ("dq",)),
                ("dkv", flash_bwd_dkv_stream, flash_bwd_dkv_stream_reference, 4, 2,
                 ("dk", "dv")),
            ):
                bound_ms, bound_by, flops, bytes_ = _bwd_bound(q, kv, seg, products, outputs)
                row[kname] = dict(
                    max_abs_err=max(errs[x] for x in keys),
                    **both(lambda **sw: fn(*args, **sw), reps=5 if big else 10),
                    plain_ms=median_ms(lambda: ref_fn(*args), reps=1 if big else 3, warmup=1),
                    bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_)
        if library_ms is not None:
            for key in ("prep", "dq", "dkv"):
                if key in row:
                    row[key]["ratio_to_library"] = row[key]["ms"] / library_ms
        dense_got = None
        if fused and var["packed"] and q.shape[1] == 32768:
            # the dense pair on the same inputs, on its own prep (the dense
            # sweep: the same tiles on this layout), held against the fused
            # kernel's gradients in ``_fused_row``
            dense_kw = dict(prep=flash_bwd_stream_prep(*args[:-1], dense=True))
            dense_got = dict(dq=flash_bwd_dq(*args, **dense_kw))
            dense_got["dk"], dense_got["dv"] = flash_bwd_dkv(*args, **dense_kw)
            torch.cuda.synchronize()
            row["dense"] = dict(
                flash_bwd_dq_ms=median_ms(lambda: flash_bwd_dq(*args, **dense_kw), reps=3),
                flash_bwd_dkv_ms=median_ms(lambda: flash_bwd_dkv(*args, **dense_kw), reps=3))
            row["dense"]["pair_ms"] = (row["dense"]["flash_bwd_dq_ms"]
                                       + row["dense"]["flash_bwd_dkv_ms"] + row["prep"]["ms"])
        if fused:
            row["fused"] = _fused_row(f"long {var['name']}", args, sweep, prep, dense_got,
                                      library_ms, chain, big)
        if dense_got is not None:
            check(library_ms is not None and row["fused"]["with_prep_ms"] < library_ms,
                  f"packed 32768: the fused backward with its prep is not faster than SDPA's "
                  f"backward ({library_ms} ms)")
        print(f"[long-backward] {json.dumps(row)}")
        summary = {key: [round(row[key][x], 4) for x in ("ms", "min_ms", "max_ms")]
                   for key in ("prep", "dq", "dkv") if key in row}
        inside = {key: [round(row[key]["wrapper_ms"], 4),
                        *(round(x, 4) for x in row[key]["wrapper_min_max_ms"])]
                  for key in ("prep", "dq", "dkv") if key in row}
        print(f"[long-backward-time] {var['name']}: ms per call of {chain} chained, "
              f"[median, min, max]: sweep made once outside {json.dumps(summary)}, made inside "
              f"the wrappers {json.dumps(inside)}; SDPA backward {library_ms} ms")
        if fused:
            _print_fused(var["name"], row["fused"], row.get("dense", {}).get("pair_ms"))
        rows.append(row)
        del q, k, v, kv, seg, o, lse, g, got, args, sweep, dense_got
        torch.cuda.empty_cache()
    return rows


def _fused_row(label: str, args, sweep, prep, pair_got: dict | None, library_ms, chain: int,
               big: bool) -> dict:
    """The fused long-T backward (``flash_bwd_fused_tc``, what
    ``flash_backward`` launches past T = 2048 in bf16 at Dh 64) on these
    inputs: held against its plain version and, where given, the dense
    pair's gradients (``BWD_REL_BF16`` x max |plain|, rows past kvl 0), then
    timed over >= 5 chains of ``chain`` launches (``ms``: the kernel alone on
    ``prep``; ``with_prep_ms``: the prep and the kernel with dq written into
    q_s, what ``flash_backward`` launches), beside its bound (five products
    of 2 Dh operations a pair, three outputs), the plain version over single
    calls and SDPA's backward (``library_ms``)."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        flash_bwd_fused_stream_reference,
        flash_bwd_fused_tc,
        flash_bwd_stream_prep,
    )

    q, k, v, kv, o, lse, g, seg, sm = args
    outs = [torch.empty_like(q) for _ in range(3)]

    def alone():
        flash_bwd_fused_tc(q, k, v, g, sm, None, prep, *outs)

    def with_prep():
        p = flash_bwd_stream_prep(*args[:-1], sweep=sweep)
        flash_bwd_fused_tc(q, k, v, g, sm, None, p, p.qs, outs[1], outs[2])

    alone()
    torch.cuda.synchronize()
    got = dict(zip(("dq", "dk", "dv"), (x.clone() for x in outs)))
    want = dict(zip(("dq", "dk", "dv"), flash_bwd_fused_stream_reference(*args, sweep=sweep)))
    past = ~_grad_rows(kv, None)
    errs = _hold_backward(f"{label} fused vs plain", got, want, BWD_REL_BF16, past)
    del want
    pair_errs = (None if pair_got is None else
                 _hold_backward(f"{label} fused vs dense pair", got, pair_got, BWD_REL_BF16,
                                past))
    reps = 5 if big else 10
    timing = spread_ms(alone, reps=reps, chain=chain)
    whole = spread_ms(with_prep, reps=reps, chain=chain)
    bound_ms, bound_by, flops, bytes_ = _bwd_bound(q, kv, seg, 5, 3)
    row = dict(max_abs_err=max(errs.values()), max_abs_err_by_grad=errs,
               vs_pair_max_abs_err_by_grad=pair_errs, tolerance=f"{BWD_REL_BF16} x max |plain|",
               **timing, with_prep_ms=whole["ms"],
               with_prep_min_max_ms=[whole["min_ms"], whole["max_ms"]],
               plain_ms=median_ms(lambda: flash_bwd_fused_stream_reference(*args, sweep=sweep),
                                  reps=1 if big else 3, warmup=1),
               bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=bytes_,
               library_ms=library_ms)
    if library_ms is not None:
        row["with_prep_ratio_to_library"] = whole["ms"] / library_ms
    del got, outs
    return row


def _print_fused(name: str, r: dict, pair_ms: float | None) -> None:
    """The ``[long-backward-fused]`` line of one fused row."""
    print(f"[long-backward-fused] {name}: fused kernel {_triple(r)} ms, with the prep "
          f"{r['with_prep_ms']:.4f} ms; the dense pair with its prep {pair_ms} ms; bound "
          f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms'] * 100:.2f} % of "
          f"it; plain {r['plain_ms']:.2f} ms; SDPA backward {r['library_ms']} ms; max err "
          f"{json.dumps(r['max_abs_err_by_grad'])} vs plain, "
          f"{json.dumps(r['vs_pair_max_abs_err_by_grad'])} vs the dense pair")


def phase_fused_at_training_shape() -> dict:
    """8a': the fused long-T backward at the training step's shape, packed
    [6, 2048, 8, 64] bf16 (phase 3's layout), on the stream sweep, where
    ``flash_backward`` takes the dense tensor-core pair: held and timed as in
    8a beside the dense pair with its prep and SDPA's backward. The route
    does not take it there; the row is for deciding whether it should."""
    import torch

    from repurpose_tpu_torch.ops.flash_attention import (
        attention_sweep,
        flash_bwd_dkv,
        flash_bwd_dq,
        flash_bwd_stream_prep,
        flash_forward,
    )

    var = dict(name="packed_B6_T2048", shape=(6, 2048, 8, 64), dtype="bfloat16",
               sm="bfloat16", packed=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    q, k, v, kv, seg = _attention_inputs(var, gen)
    o, lse = flash_forward(q, k, v, kv, seg, "bfloat16")
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    g = g.masked_fill(~_grad_rows(kv, seg)[:, :, None, None], 0.0)
    args = (q, k, v, kv, o, lse, g, seg, "bfloat16")
    sweep = attention_sweep(kv, seg, dense=False)
    prep = flash_bwd_stream_prep(*args[:-1], sweep=sweep)
    library_ms, _ = _sdpa_bwd_ms(q, k, v, kv, seg, g, reps=5, chain=8)
    row = _fused_row("packed [6, 2048]", args, sweep, prep, None, library_ms, 8, False)
    dense_sweep = attention_sweep(kv, seg, dense=True)  # made once, as the model does

    def pair():
        dense = flash_bwd_stream_prep(*args[:-1], dense=True, sweep=dense_sweep)
        flash_bwd_dq(*args, prep=dense, sweep=dense_sweep)
        flash_bwd_dkv(*args, prep=dense, sweep=dense_sweep)

    pair_ms = spread_ms(pair, reps=10, chain=8)["ms"]
    out = dict(name=var["name"], shape=list(var["shape"]), dtype="bfloat16",
               softmax_dtype="bfloat16", packed=True, pair_ms=pair_ms,
               pair_note="the dense tensor-core pair with its prep, the route at T <= 2048",
               fused=row)
    _print_fused(var["name"], row, pair_ms)
    del q, k, v, kv, seg, o, lse, g, args, prep
    torch.cuda.empty_cache()
    return out


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
    recompute), every one the tensor-core kernel, and the prep and the fused
    backward kernel ``layers`` times each, nothing else; each forward
    without gradients ``layers`` launches of its forward kernel, the
    tensor-core one; finite losses, the val probe, the tIoU evaluation and
    a checkpoint. Returns the launches summed over the run."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    check(summary["step"] == steps == len(seen.steps) and steps > 0,
          f"{label}: {summary['step']} steps, {len(seen.steps)} seen, plan {steps}")
    step_want = {"flash_fwd_stream": 2 * layers, "flash_fwd_stream_tc": 2 * layers,
                 "flash_bwd_fused_tc": layers, "flash_bwd_stream_prep": layers}
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
    kernel model with remat on against off, dropout 0.1 on: masks and loss
    bit-identical, the dropout generator in the same state, and the
    gradients within ``REMAT_GRAD_REL`` (dq's sum order in the fused
    backward).
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
    # the fused backward adds dq in an order that changes from run to run, so
    # the gradients of two runs, remat or not, agree to REMAT_GRAD_REL
    rel = {n: float((g - grads_on[n]).float().norm() / g.float().norm().clamp_min(1e-30))
           for n, g in grads_off.items() if g is not None}
    worst = max(rel, key=rel.get)
    check(torch.equal(loss_on, loss_off) and rel[worst] <= REMAT_GRAD_REL
          and torch.equal(gen_on, gen_off),
          f"remat on vs off, dropout {cfg.model.dropout}: loss {float(loss_on)} vs "
          f"{float(loss_off)}, worst gradient {worst} {rel[worst]:.3g} (bound "
          f"{REMAT_GRAD_REL}), generator {'equal' if torch.equal(gen_on, gen_off) else 'differs'}")
    print(f"[grad] {card}: unpacked [1, 8192], dropout {cfg.model.dropout}: remat on vs off: "
          f"loss {float(loss_on):.6f} and the dropout generator's final state bit-identical, "
          f"{len(same)}/{len(grads_off)} parameter gradients bit-identical, the worst "
          f"{worst} at {rel[worst]:.3g} relative (bound {REMAT_GRAD_REL}, dq's sum order); "
          f"streaming forward launches of the kernel steps {json.dumps(launches)}")
    return launches


# -- phase 9: the bench tools ---------------------------------------------------


WIDE_DH = 256  # the widest fixed-width kernel instance of the first designs
WIDE_PADDED_DH = 192  # a head the model route zero-pads to WIDE_DH
CHUNKED_DHS = (320, 512, 1000)  # heads on the head-chunked kernels (1000 padded to 1024)
CHUNKED = {False: ("flash_fwd_chunked", "flash_bwd_dq_chunked", "flash_bwd_dkv_chunked"),
           True: ("flash_fwd_stream_chunked", "flash_bwd_dq_stream_chunked",
                  "flash_bwd_dkv_stream_chunked")}


def _wide_inputs(var: dict, gen):
    """q/k/v views of one [B, T, 3 * H * width] projection (width =
    ``kernel_head_dim`` of the variant's Dh, the columns past Dh zero, as
    ``FlashAttention`` pads), key_valid and seg_ids of the variant."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    b, t, h, dh = var["shape"]
    width = fa.kernel_head_dim("cuda", dh)
    dtype = getattr(torch, var["dtype"])
    qkv = torch.randn((b, t, 3, h, width), generator=gen, device="cuda")
    qkv[..., dh:] = 0.0
    qkv = qkv.view(b, t, 3 * h * width).to(dtype)
    q, k, v = (z.view(b, t, h, width) for z in qkv.split(h * width, dim=-1))
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
    return q, k, v, torch.from_numpy(mask).cuda(), seg


def phase_wide_heads() -> list[dict]:
    """Wide heads, forward and backward, bf16 and float32, against the plain
    versions under ``TOL`` / ``BWD_REL``: the Dh 256 instances of the first
    designs (csrc/flash_fwd.cu, flash_fwd_stream.cu, flash_bwd.cu,
    flash_bwd_stream.cu) and the head-chunked instances
    (csrc/flash_chunked.cu) at Dh 320, 512 and 1000 (zero-padded to 1024
    with the head's own scale), the dense kernels at [2, 1024, 2, Dh] and
    the streaming ones at [1, 4096, 2, Dh], unpacked and packed; each launch
    counted on its kernel (never the tensor-core one; past Dh 256 on the
    chunked one). Times per launch of a chain with the sweep made outside
    (the forward; the dq + dk/dv pair at Dh 256, dq and dk/dv each past
    it), SDPA forward and backward on the same mask, and the bounds. Then
    the model's route (``flash_attention``) at Dh 192 (zero-padded to 256)
    and at Dh 1000 (padded to 1024; T = 1024 and 4096) on the card against
    the same call on CPU tensors (the plain versions at the unpadded
    width), out and gradients, with its launches."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    variants = []
    for dh in (WIDE_DH, *CHUNKED_DHS):
        tag = "" if dh == WIDE_DH else f"_Dh{dh}"
        for dtype in ("bfloat16", "float32"):
            for packed in (False, True):
                kind = "packed" if packed else "unpacked"
                variants.append(dict(name=f"dense_{kind}_{dtype}{tag}", dh=dh,
                                     shape=(2, 1024, 2, dh), dtype=dtype, sm=dtype,
                                     packed=packed, stream=False))
                variants.append(dict(name=f"stream_{kind}_{dtype}{tag}", dh=dh,
                                     shape=(1, 4096, 2, dh), dtype=dtype, sm=dtype,
                                     packed=packed, stream=True))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    tc_names = ("flash_fwd_stream_tc", "flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
    all_chunked = CHUNKED[False] + CHUNKED[True]
    rows = []
    for var in variants:
        dh = var["dh"]
        chunked = dh > WIDE_DH
        q, k, v, kv, seg = _wide_inputs(var, gen)
        dtype = q.dtype
        scale = dh ** -0.5
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
        reset_launches()
        out, lse = fwd(q, k, v, kv, seg, sm, scale=scale)
        g = torch.randn(q.shape, generator=gen, device="cuda")
        g[..., dh:] = 0.0
        g = g.to(dtype).masked_fill(~_grad_rows(kv, seg)[:, :, None, None], 0.0)
        args = (q, k, v, kv, out, lse, g, seg, sm)
        got = dict(dq=dq_fn(*args, scale=scale))
        got["dk"], got["dv"] = dkv_fn(*args, scale=scale)
        torch.cuda.synchronize()
        launched = read_launches(*names, *tc_names, *all_chunked)
        want_chunked = CHUNKED[var["stream"]] if chunked else ()
        check([launched[n] for n in names] == [1, 1, 1] and not any(
            launched[n] for n in tc_names) and all(
            launched[n] == (n in want_chunked) for n in all_chunked),
            f"wide {var['name']}: launches {launched}")
        ref_out, ref_lse = fwd_ref(q, k, v, kv, seg, sm, scale=scale)
        err, lse_err, atol, live = _hold_forward(f"wide {var['name']}", out, lse, ref_out,
                                                 ref_lse, kv, seg, var["dtype"])
        del ref_out, ref_lse
        want = dict(dq=dq_ref(*args, scale=scale))
        want["dk"], want["dv"] = dkv_ref(*args, scale=scale)
        rel = BWD_REL.get((var["dtype"], sm), BWD_REL_BF16)
        errs = _hold_backward(f"wide {var['name']}", got, want, rel, ~_grad_rows(kv, None))
        del want
        sweep = fa.attention_sweep(kv, seg, dense=not var["stream"])
        chain = 2 if chunked else 4
        f_ms = spread_ms(lambda: fwd(q, k, v, kv, seg, sm, scale=scale, sweep=sweep), reps=5,
                         chain=chain)
        parts = {}
        if chunked:  # each backward kernel on its own; the pair is their sum
            for key, fn in (("dq", dq_fn), ("dkv", dkv_fn)):
                parts[key] = spread_ms(lambda: fn(*args, scale=scale, sweep=sweep), reps=5,
                                       chain=chain)
            b_ms = {x: parts["dq"][x] + parts["dkv"][x] for x in ("ms", "min_ms", "max_ms")}
        else:
            b_ms = spread_ms(lambda: (dq_fn(*args, scale=scale, sweep=sweep),
                                      dkv_fn(*args, scale=scale, sweep=sweep)), reps=5,
                             chain=chain)
        qd, kd, vd, gd = (x[..., :dh] for x in (q, k, v, g))  # the head's own width
        f_lib = _sdpa_spread(qd, kd, vd, kv, seg, reps=5, chain=chain)
        b_lib, b_lib_note = _sdpa_bwd_ms(qd, kd, vd, kv, seg, gd, reps=5, chain=chain)
        f_bound = _bound(qd, kv, seg)
        dq_bound, dkv_bound = _bwd_bound(qd, kv, seg, 3, 1), _bwd_bound(qd, kv, seg, 4, 2)
        row = dict(
            name=var["name"], dh=dh, width=q.shape[-1], shape=list(var["shape"]),
            dtype=var["dtype"], softmax_dtype=sm, packed=var["packed"],
            kernels=list(want_chunked or names), max_abs_err=err, lse_max_abs_err=lse_err,
            out_atol=atol, max_abs_err_by_grad=errs, grad_tolerance=f"{rel} x max |plain|",
            ms=f_ms["ms"], min_ms=f_ms["min_ms"], max_ms=f_ms["max_ms"],
            plain_ms=median_ms(lambda: fwd_ref(q, k, v, kv, seg, sm, scale=scale), reps=3,
                               warmup=1),
            library_ms=f_lib["ms"], bound_ms=f_bound[0], bound_by=f_bound[1],
            bwd_ms=b_ms["ms"], bwd_min_ms=b_ms["min_ms"], bwd_max_ms=b_ms["max_ms"],
            bwd_plain_ms=median_ms(lambda: (dq_ref(*args, scale=scale),
                                            dkv_ref(*args, scale=scale)), reps=3, warmup=1),
            bwd_library_ms=b_lib, bwd_library_note=b_lib_note,
            bwd_bound_ms=dq_bound[0] + dkv_bound[0],
            bwd_bound_by=dq_bound[1] if dq_bound[0] >= dkv_bound[0] else dkv_bound[1],
            chain=chain)
        if chunked:  # each backward kernel's own numbers, for its kernels entry
            for key, ref, bound, grads in (("dq", dq_ref, dq_bound, ("dq",)),
                                           ("dkv", dkv_ref, dkv_bound, ("dk", "dv"))):
                t_k = parts[key]
                row[key] = dict(max_abs_err=max(errs[n] for n in grads), ms=t_k["ms"],
                                min_ms=t_k["min_ms"], max_ms=t_k["max_ms"],
                                plain_ms=median_ms(lambda: ref(*args, scale=scale), reps=3,
                                                   warmup=1),
                                bound_ms=bound[0], bound_by=bound[1])
        print(f"[wide-heads] {json.dumps(row)}")
        print(f"[wide-time] {var['name']}: forward {_triple(f_ms)} ms (SDPA "
              f"{f_lib['ms']:.4f}, bound {f_bound[0]:.4f}); dq + dk/dv {_triple(b_ms)} ms "
              f"(SDPA backward {b_lib}, bound {row['bwd_bound_ms']:.4f})")
        rows.append(row)
        del q, k, v, kv, seg, out, lse, g, args, got, sweep
        torch.cuda.empty_cache()

    # the model's route: zero-padded to the kernel width with the head's own scale
    for dh, t in ((WIDE_PADDED_DH, 1024), (1000, 1024), (1000, 4096)):
        stream = t > fa.STREAM_MAX_T
        names = (CHUNKED[stream] if dh > WIDE_DH else
                 ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        for dtype in (torch.bfloat16, torch.float32):
            b, h = (2, 2) if t <= 1024 else (1, 2)
            rng = np.random.default_rng(SEED + 13)
            q, k, v, w = (torch.from_numpy(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32))
                          .to(dtype) for _ in range(4))
            valid = torch.ones(b, t, dtype=torch.bool)
            valid[-1, t // 2:] = False
            w = w * valid[:, :, None, None]
            runs = []
            for device in ("cuda", "cpu"):
                reset_launches()
                leaves = [x.to(device).requires_grad_() for x in (q, k, v)]
                out = fa.flash_attention(*leaves, valid.to(device), None, "float32")
                (out.float() * w.to(device).float()).sum().backward()
                if device == "cuda":
                    torch.cuda.synchronize()
                    launched = read_launches(*names)
                    check(launched == dict.fromkeys(names, 1),
                          f"wide route Dh {dh} T {t} {dtype}: launches {launched}")
                runs.append([x.detach().float().cpu() for x in (out, *(z.grad for z in leaves))])
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            live = torch.arange(t)[None] < fa._kv_len(valid)
            errs = {}
            for name, got_x, want_x in zip(("out", "dq", "dk", "dv"), *runs):
                scale = float(want_x[live].abs().max())
                errs[name] = float((got_x[live] - want_x[live]).abs().max())
                check(errs[name] <= rel * scale and bool(torch.isfinite(got_x).all()),
                      f"wide route Dh {dh} T {t} {dtype} {name}: max err {errs[name]:.3g} > "
                      f"{rel} x {scale:.3g}")
            row = dict(name=f"model_route_Dh{dh}_T{t}_{str(dtype).split('.')[-1]}",
                       shape=[b, t, h, dh], padded_to=fa.kernel_head_dim("cuda", dh),
                       launches=launched, max_abs_err_by_output=errs,
                       tolerance=f"{rel} x max |cpu|")
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


FUSION_VIDEOS = (400, 1100, 1900)  # seconds: buckets 512 and 2048 of the production config
FUSION_LOGIT_REL = 1e-3  # card vs CPU, float32: see phase_fusion_variants


def phase_fusion_variants(card: str) -> dict:
    """The fusion variants (``fusion: cross`` and ``bottleneck``) at the
    flagship width of configs/repurpose.yaml (d_model 512, 8 heads,
    ``text_num_layers`` 3, ``cross_num_layers`` 3), unpacked: for each,
    ``score_videos`` of three videos (buckets up to 2048) in float32 on the
    card against the same call on the CPU, on the same weights: the raw
    logits and offsets within ``FUSION_LOGIT_REL`` x max |CPU value| (float32
    sums in another order through 12 (cross) or 18 (bottleneck) attention
    layers; a wrong mask or a dropped modality moves them by O(1)), the same
    clips; the request's time and peak memory on the card. Then 3 train
    steps in bf16 with dropout 0.1 at [2, 2048]: finite losses, step time
    and peak memory. The cross variant's attention runs on the kernels (the
    first designs in float32, the tensor-core ones in bf16); the bottleneck
    variant's is ``mha_torch`` under every ``attention_impl``."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import synthetic_sample
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = production_config()
    buckets = cfg.train.buckets
    test_cfg = dataclasses.replace(cfg.test_cfg, duration_thresh=DAEMON_DURATION_THRESH)
    out = {}
    for fusion in ("cross", "bottleneck"):
        mc = dataclasses.replace(cfg.model, fusion=fusion, compute_dtype="float32")
        rng = np.random.default_rng(SEED + 21)
        videos = [dict(synthetic_sample(rng, d, mc), video_id=f"v{i}")
                  for i, d in enumerate(FUSION_VIDEOS)]
        sd = build_model(mc, "cpu", seed=SEED).state_dict()
        card_pipe = InferencePipeline(mc, sd, test_cfg, raw_outputs=True, device="cuda")
        card_pipe.score_videos(videos[:1], buckets, batch_size=2)  # first calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = card_pipe.score_videos(videos, buckets, batch_size=2)
        serve_ms = (time.perf_counter() - t0) * 1e3
        serve_peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        want = InferencePipeline(mc, sd, test_cfg, raw_outputs=True, device="cpu").score_videos(
            videos, buckets, batch_size=2)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        errs = {}
        for key in ("raw_logits", "raw_offsets"):
            a = np.concatenate([r[key].ravel() for r in got])
            w = np.concatenate([r[key].ravel() for r in want])
            errs[key] = float(np.abs(a - w).max())
            check(np.isfinite(a).all() and errs[key] <= FUSION_LOGIT_REL * float(np.abs(w).max()),
                  f"{fusion}: {key} card vs CPU max err {errs[key]:.3g}")
        check([r["video_id"] for r in got] == [r["video_id"] for r in want]
              and all(len(a["scores"]) > 0 for a in got), f"{fusion}: served clips differ")
        del card_pipe

        tc = dataclasses.replace(cfg.train, batch_size=2, buckets=(2048,), pack_sequences=False)
        mc16 = dataclasses.replace(cfg.model, fusion=fusion)
        model = build_model(mc16, "cuda", seed=SEED)
        gen = torch.Generator(device="cuda")
        model.set_dropout_generator(gen)
        optimizer, schedule = make_optimizer(model, tc, 3)
        state = TrainState(model, optimizer)
        step = make_train_step(mc16, tc, schedule)
        samples = [synthetic_sample(rng, d, mc16) for d in (1800, 2047)]  # 2048 s: d + 1
        batch = batch_to_device(collate(samples, tc.buckets, 2), "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, step_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            losses.append(float(step(state, batch)["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        train_peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)), f"{fusion}: train losses {losses}")
        out[fusion] = dict(max_abs_err_card_vs_cpu=errs, tolerance=f"{FUSION_LOGIT_REL} x max",
                           serve_ms=serve_ms, cpu_serve_ms=cpu_ms, serve_peak_bytes=serve_peak,
                           losses=losses, step_ms=step_ms, train_peak_bytes=train_peak,
                           params=sum(p.numel() for p in model.parameters()))
        print(f"[fusion] {card}: {fusion}: score_videos of {list(FUSION_VIDEOS)} s float32 "
              f"{serve_ms:.1f} ms on the card (CPU {cpu_ms:.1f} ms), peak "
              f"{serve_peak / 1e9:.2f} GB, raw logits / offsets vs CPU max err "
              f"{errs['raw_logits']:.3g} / {errs['raw_offsets']:.3g}; 3 bf16 train steps at "
              f"[2, 2048]: losses {[round(x, 4) for x in losses]}, step "
              f"{[round(x, 1) for x in step_ms]} ms, peak {train_peak / 1e9:.2f} GB")
        del model, optimizer, state, batch
        torch.cuda.empty_cache()
    return out


CROSS_LONG_T = 32768
CROSS_LONG_FILL = 0.9  # the recording fills 0.9 of the [1, 32768] row
CROSS_LONG_STEPS = 3
# MMCTCross in bf16 on the kernels against the float32 plain reference
# (gpubench/reference/cross.py), dropout 0, the same weights, features and
# Adam: the first step's logits (widest gap and root mean square, logit
# units), the first step's loss (relative; the next two are printed: Adam's
# first steps follow the gradient's sign, so later losses on the one batch
# part by more than rounding) and each leaf's first gradient
# (relative L2 error over the leaf's or the median leaf's norm, leaves under
# a thousandth of the median left out: the key biases, which the softmax
# does not see). bf16 rounds every activation and, with the bf16 softmax
# interior, every probability of 15 attention layers; the benchmark cell
# train-cross-long-32768 reads these gaps under its limits (PERF.md section
# 2), which are these bounds. A wrong mask, a dropped key block or a wrong
# merge moves the logits by O(1).
CROSS_LONG_BOUNDS = dict(logit_gap=0.2, logit_rms=0.04, loss_rel=0.02, grad_rel=0.5)


def phase_cross_long(card: str) -> dict:
    """``MMCTCross`` at the published widths (configs/cross_longvideo.yaml:
    d_model 512, 8 heads of Dh 64, 3 stream layers and 3 cross blocks) on
    the kernel route at [1, 32768] (one recording of 0.9 of the row), 3
    bf16 steps with Adam, against the float32 plain reference on the same
    weights and inputs (``CROSS_LONG_BOUNDS``). Each step's kernel launches
    are counted: 18 tensor-core stream forwards (12 self-attentions, 3
    cross-attentions of two key blocks each), 18 fused backwards and 15
    preps (one an attention: a cross-attention's blocks share theirs),
    nothing else; the first step's device kernels are listed
    from a ``torch.profiler`` trace, and its peak memory shows that no
    [1, 8, 32768, 32768] score tensor (32 GiB) was formed."""
    import collections

    import torch
    from torch.autograd import DeviceType

    from gpubench.reference import cross as ref_cross
    from gpubench.reference import model as ref_model
    from repurpose_tpu_torch.models import build_model

    mc = dataclasses.replace(production_config().model, fusion="cross", dropout=0.0)
    m = {k: getattr(mc, k) for k in ("vis_dim", "aud_dim", "text_dim", "d_model", "num_heads",
                                     "d_ff", "hidden_dim", "text_num_layers", "cross_num_layers",
                                     "dropout")}
    t, n = CROSS_LONG_T, int(CROSS_LONG_FILL * CROSS_LONG_T)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    feats = [torch.randn((1, t, m[k]), generator=gen, device="cuda")
             for k in ("vis_dim", "aud_dim", "text_dim")]
    mask = torch.zeros((1, t), dtype=torch.bool, device="cuda")
    mask[0, :n] = True
    labels = (torch.rand((1, t), generator=gen, device="cuda") < 0.2).float()
    w0 = ref_cross.weights(m, SEED, "cuda")

    model = build_model(mc, "cuda")
    model.load_state_dict(w0, strict=True)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    names = ("flash_fwd_stream_tc", "flash_fwd_stream", "flash_fwd_tc", "flash_fwd",
             "flash_bwd_fused_tc", "flash_bwd_stream_prep", "flash_bwd_dq_tc", "flash_bwd_dkv_tc",
             "flash_bwd_dq_stream", "flash_bwd_dkv_stream")
    launches, losses, step_ms, kernels = [], [], [], {}
    for s in range(CROSS_LONG_STEPS):
        reset_launches()
        opt.zero_grad(set_to_none=True)
        prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                   torch.profiler.ProfilerActivity.CUDA])
                if s == 0 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with prof:
            out = model(*feats, mask)
            loss = ref_model.focal_loss_sum(out.cls_logits[..., 0], labels, mask)
            loss.backward()
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_launches(*names))
        if s == 0:
            logits = out.cls_logits[..., 0][mask].float()
            grads = {k: p.grad.float().clone() for k, p in model.named_parameters()
                     if p.grad is not None}
            kernels = dict(collections.Counter(
                e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                and not e.name.startswith("repurpose:")).most_common())
        opt.step()
        losses.append(float(loss.detach()))
        del out, loss
    peak = torch.cuda.max_memory_allocated()
    del model, opt
    torch.cuda.empty_cache()
    expected = dict.fromkeys(names, 0) | {"flash_fwd_stream_tc": 18, "flash_fwd_stream": 18,
                                           "flash_bwd_fused_tc": 18,
                                           "flash_bwd_stream_prep": 15}
    check(all(x == expected for x in launches),
          f"cross-long: launches per step {launches}, expected {expected}")
    check(peak < 16 * 2**30, f"cross-long: peak {peak / 2**30:.2f} GiB: a score tensor?")

    leaves = {k: v.clone().requires_grad_() for k, v in w0.items()}
    ref_opt = torch.optim.Adam(list(leaves.values()), lr=1e-3)
    ref_losses = []
    t0 = time.perf_counter()
    for s in range(CROSS_LONG_STEPS):
        ref_opt.zero_grad(set_to_none=True)
        cls, _ = ref_cross.forward(leaves, m, *feats, mask)
        ref_loss = ref_model.focal_loss_sum(cls, labels, mask)
        ref_loss.backward()
        if s == 0:
            ref_logits = cls.detach()[mask]
            ref_grads = {k: v.grad.clone() for k, v in leaves.items() if v.grad is not None}
        ref_opt.step()
        ref_losses.append(float(ref_loss.detach()))
        del cls, ref_loss
    ref_s = time.perf_counter() - t0
    del leaves, ref_opt
    torch.cuda.empty_cache()

    d = (logits - ref_logits).abs()
    gaps = dict(logit_gap=float(d.max()), logit_rms=float(d.square().mean().sqrt()),
                loss_rel=abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]))
    norms = {k: float(v.norm()) for k, v in ref_grads.items()}
    med = statistics.median(norms.values())
    errs = {k: float((grads[k] - ref_grads[k]).norm()) / max(norms[k], med)
            for k in norms if norms[k] >= 1e-3 * med}
    worst = max(errs, key=errs.get)
    gaps["grad_rel"] = errs[worst]
    flash = {k: v for k, v in kernels.items() if "flash" in k}
    print(f"[cross-long] {card}: MMCTCross {sum(x.numel() for x in w0.values())} parameters at "
          f"[1, {t}] ({n} valid), 3 bf16 steps {[round(x, 1) for x in step_ms]} ms, peak "
          f"{peak / 2**30:.3f} GiB; launches per step {launches[0]}; flash kernels of step 1 "
          f"{flash}; against the float32 plain reference ({ref_s:.1f} s): {gaps} "
          f"(worst leaf {worst}), losses {losses} vs {ref_losses}")
    for k, bound in CROSS_LONG_BOUNDS.items():
        check(gaps[k] <= bound, f"cross-long: {k} {gaps[k]:.4g} over {bound}")
    return dict(step_ms=step_ms, peak_bytes=peak, launches=launches, kernels=kernels, gaps=gaps,
                worst_leaf=worst, losses=losses, ref_losses=ref_losses, ref_s=ref_s)


def phase_utils_and_clis(card: str, workdir: str) -> dict:
    """Item 12 on the card: ``python -m repurpose_tpu_torch.preflight --full``
    as a subprocess (exit 0; every check passes); the capacity model's
    estimate against the measured peak of a real step at the packed
    [6, 2048] production step and the [1, 32768] remat step of
    configs/longvideo.yaml (the estimate must not fall below the peak);
    ``python -m repurpose_tpu_torch.analyze --synthetic 4`` as a subprocess
    with this machine's installations (its JSON line names what it
    skipped)."""
    import torch

    from repurpose_tpu_torch.utils.capacity import estimate_train_bytes, measured_memory

    report = os.path.join(workdir, "preflight.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repurpose_tpu_torch.preflight", "--full", "--output-json",
         report], cwd=ROOT, capture_output=True, text=True, timeout=600)
    preflight_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"preflight --full exited {proc.returncode}: "
                                f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    with open(report) as f:
        checks = json.load(f)
    check(all(c["passed"] for c in checks) and len(checks) == 7, f"preflight: {checks}")
    summary = proc.stdout[proc.stdout.index("=== preflight summary ==="):].strip()
    print(f"[preflight] {card}: --full in {preflight_s:.1f} s, exit 0\n{summary}")

    memory = {}
    prod, longvideo = production_config(), longvideo_config()
    for name, mc, tc, bucket in (
            ("packed_6x2048", prod.model, prod.train, 2048),
            ("remat_1x32768", longvideo.model, longvideo.train, 32768)):
        torch.cuda.empty_cache()
        mem = measured_memory(mc, tc, bucket)
        est = estimate_train_bytes(mc, tc.batch_size, bucket)
        ratio = est["total_bytes"] / mem["peak_bytes"]
        check(est["total_bytes"] >= mem["peak_bytes"],
              f"capacity {name}: estimate {est['total_bytes']} below the peak {mem['peak_bytes']}")
        memory[name] = dict(measured=mem, estimate=est, ratio=ratio)
        print(f"[capacity] {card}: {name} (remat={mc.remat}, packed={tc.pack_sequences}): "
              f"measured peak {mem['peak_bytes'] / 1e9:.3f} GB, estimate "
              f"{est['total_bytes'] / 1e9:.3f} GB (ratio {ratio:.3f}; state "
              f"{est['state_bytes'] / 1e9:.3f}, activations {est['activation_bytes'] / 1e9:.3f}, "
              f"inputs {est['input_bytes'] / 1e9:.3f}, weight copies "
              f"{est['weight_copy_bytes'] / 1e9:.3f})")

    out_dir = os.path.join(workdir, "analysis")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repurpose_tpu_torch.analyze", "--synthetic", "4",
         "--output-dir", out_dir], cwd=ROOT, capture_output=True, text=True, timeout=600)
    analyze_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"analyze exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(line["videos"] == 4 and all(os.path.getsize(p) > 0 for p in line["artifacts"]),
          f"analyze: {line}")
    print(f"[analyze] {card}: --synthetic 4 in {analyze_s:.1f} s: separability "
          f"{line['separability_acc']}, peak at zero {json.dumps(line['peak_at_zero'])}, "
          f"artifacts {[os.path.basename(p) for p in line['artifacts']]}, skipped "
          f"{[os.path.basename(p) for p in line['skipped']]}")
    return dict(preflight=checks, preflight_s=preflight_s, memory=memory, analyze=line)


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
    busy = sum(e.self_device_time_total for e in _device_work(events)) / 1e3 / steps
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


# -- phase 16 -----------------------------------------------------------------

PARALLEL_STEPS = 3
PARALLEL_VIDEOS = 16  # synthetic videos: the first packed batch is the global [6, 2048]
PARALLEL_EVAL_VIDEOS = (300, 700, 1100, 1500, 1900, 450, 900, 1300)  # seconds
PARALLEL_TC = ("flash_fwd_tc", "flash_bwd_stream_prep", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")
PARALLEL_FIRST = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")  # all launches, both designs
# A mesh run against the one-process steps on the global [6, 2048] batch,
# same weights, dropout 0; per run (loss, grad norm) relative bounds for
# step 1 and for the later steps, and the bound on the update's relative L2
# (the parameters after the steps minus before, over the whole model; Adam's
# update ignores a uniform gradient scale, which the norm bound catches):
# - bf16 data parallelism, (a) and (c) (set before the first run): every
#   row's forward and backward is the one-process one but for cuBLAS's
#   choice of kernel for 3 x 2048 rows instead of 6 x 2048 (bf16 outputs an
#   ulp apart on single elements); the weight gradients are bf16 products
#   rounded on each rank before the float32 sum (2**-8 relative an
#   element). Loss 5e-3, norm 2e-2 at every step; update 0.05 (elements
#   whose gradient is rounding noise, as the key bias's, which softmax
#   cancels, move by +-lr either way; they are few).
# - bf16 tensor parallelism, (b): its partial products are rounded to bf16
#   before the float32 sum, so every activation of the residual stream is
#   rounded otherwise than in one process. Step 1 holds 5e-3 / 2e-2 (the
#   forward and the norm differ by that rounding only). Its gradients then
#   differ as two bf16 roundings' do, up to GRAD_REL_BOUND["bfloat16"] = 0.25
#   a parameter on the input side, where they sum random-sign terms over
#   every position, and with some of their signs flipped; Adam turns each
#   flipped sign into a 2 lr difference, and one step at PARALLEL_LR moves
#   this random-weight loss by a sixth: later steps 5e-2 / 0.15, update 0.5.
# - float32 tensor parallelism, (b32): the same sums in float32; it holds
#   the shards' arithmetic where rounding cannot hide a fault: loss 1e-4,
#   norm 1e-3 at every step, update 0.02 (noise gradients as above).
BF16_DP_TOL = dict(loss=(5e-3, 5e-3), norm=(2e-2, 2e-2), update=0.05)
PARALLEL_RUNS = {
    "a_data2": dict(axes=dict(data=2), rows=3, dtype="bfloat16", tol=BF16_DP_TOL,
                    hold_kernels=True),
    "b_model2": dict(axes=dict(data=1, model=2), rows=6, dtype="bfloat16",
                     tol=dict(loss=(5e-3, 5e-2), norm=(2e-2, 0.15), update=0.5),
                     hold_kernels=True),
    "c_data2_zero1": dict(axes=dict(data=2), rows=3, dtype="bfloat16", zero1=True,
                          tol=BF16_DP_TOL),
    "b32_model2_float32": dict(axes=dict(data=1, model=2), rows=6, dtype="float32", steps=2,
                               tol=dict(loss=(1e-4, 1e-4), norm=(1e-3, 1e-3), update=0.02)),
}


def _run_model(cfg, dtype: str):
    """``cfg.model`` with ``dtype`` activations and softmax interior."""
    return dataclasses.replace(cfg.model, compute_dtype=dtype, attn_softmax_dtype=dtype)


# (f) in phases 16 and 17: the fusion variants on a mesh, at phase 14's
# flagship widths (configs/repurpose.yaml: d_model 512, 8 heads,
# text_num_layers 3, cross_num_layers 3), unpacked [2, 2048] (videos of
# 1800 and 2047 s, one bucket-2048 row each), 3 steps at PARALLEL_LR. A
# variant is whole on every model rank (model = 2, phase 16) and every seq
# rank stages the whole rows (seq = 2 under the ring config, phase 17), so
# each rank runs the one-process forward and backward and nothing is summed
# over the axis: float32 at dropout 0 is held to the one-process steps on
# the same weights and batch within (b32)'s bounds (set before the first
# run), its noise parts (the key biases, NOISE_GRAD_REL) within 2 lr a step.
# bf16 at dropout 0.1 (phase 16): the model ranks seed one generator alike
# and draw the same masks, so their parameters after the steps should be
# equal bit for bit; they are held within 2 lr a step of each other, and
# the largest difference is printed. Attention launches per rank: phase 16's
# cross variant runs the kernels (``_fusion_launches``), its bottleneck
# variant none; phase 17's ring config resolves to ``mha_torch`` for both.
FUSIONS = ("cross", "bottleneck")
FUSION_MESH_DURS = (1800, 2047)  # seconds: 2047 s gives 2048 rows
FUSION_MESH_STEPS = 3
FUSION_MESH_DROPOUT = 0.1
FUSION_MESH_TOL = PARALLEL_RUNS["b32_model2_float32"]["tol"]
# phase 17 (f)'s served clips on seq = 2 against one process on the card:
# tests/test_torch_ring_attention.py's bounds (float32)
FUSION_SERVE_ATOL = dict(scores=1e-5, segments=1e-4)


def _fusion_model(cfg, fusion: str, dtype: str, **kw):
    """``cfg.model`` as the fusion variant ``fusion`` in ``dtype``."""
    return dataclasses.replace(_run_model(cfg, dtype), fusion=fusion, **kw)


def _fusion_train(cfg):
    return dataclasses.replace(cfg.train, batch_size=2, buckets=(2048,), pack_sequences=False)


def _fusion_launches(mc, fusion: str, bf16: bool) -> dict:
    """Phase 16 (f)'s attention launches per rank over its
    ``FUSION_MESH_STEPS`` steps at [2, 2048]: none for the bottleneck
    variant (``mha_torch`` under every ``attention_impl``); for the cross
    variant the dense kernels, one forward and one dq / dk-dv backward a
    self-attention (3 ``text_num_layers`` + ``cross_num_layers``) and a key
    block (two a cross-attention), the tensor-core pair with one prep an
    attention in bf16, the first designs in float32."""
    want = dict.fromkeys((*PARALLEL_TC, *PARALLEL_FIRST), 0)
    if fusion == "bottleneck":
        return want
    n_cross = max(mc.cross_num_layers, 1)
    n_self = 3 * max(mc.text_num_layers, 1) + n_cross
    want.update(dict.fromkeys(PARALLEL_FIRST, FUSION_MESH_STEPS * (n_self + 2 * n_cross)))
    if bf16:
        want.update(dict.fromkeys(PARALLEL_TC, FUSION_MESH_STEPS * (n_self + 2 * n_cross)))
        want["flash_bwd_stream_prep"] = FUSION_MESH_STEPS * (n_self + n_cross)
    return want


def _fusion_batch(mc):
    """(f)'s global batch [2, 2048], unpacked, made anew from its seed."""
    import numpy as np

    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(SEED + 16)
    return collate([synthetic_sample(rng, d, mc) for d in FUSION_MESH_DURS], (2048,), 2)


def _fusion_videos(mc) -> list[dict]:
    """Phase 14's three videos (``FUSION_VIDEOS``), made anew from its seed."""
    import numpy as np

    from repurpose_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(SEED + 21)
    return [dict(synthetic_sample(rng, d, mc), video_id=f"v{i}")
            for i, d in enumerate(FUSION_VIDEOS)]


def _serving_weights(sd: dict) -> dict:
    """``sd`` with the regression head's last bias at 15: random weights give
    zero-length clips, offsets of about 15 s give clips to compare."""
    import torch

    return dict(sd, **{"reg_head.7.bias": torch.full_like(sd["reg_head.7.bias"], 15.0)})


# (d): the multi-process evaluate scores the same videos with the same
# weights, and the tIoU sums are float64: one process and data=2 / model=2
# differ by the order of 8 float64 additions (~1e-17, measured). A bf16
# rounding that moved one clip boundary by one offset step (1/16 s at
# 15 s) would move a threshold's mean by ~1e-4; a dropped rank or a video
# scored twice by more. Measured equal to ~1e-17 on an H100 (PERF.md §6),
# so anything past 1e-6 is a fault to look at.
PARALLEL_EVAL_ATOL = 1e-6
PARALLEL_LR = 1e-5
# (d)'s decode: random weights score no clip past the production thresholds
PARALLEL_EVAL_TEST = dict(pre_nms_thresh=0.0, duration_thresh=0.001, max_seg_per_min=3.0,
                          min_score=0.0)


def _parallel_config():
    """The production config at dropout 0 and learning rate ``PARALLEL_LR``:
    at the production 1e-3 random weights diverge (the packed [6, 2048]
    loss went 147 -> 949 in one step on an H100 at 700 W), and the later
    steps then measure how that divergence amplifies bf16 rounding, not the
    parallel path; at 1e-5 the steps stay where rounding is all that
    differs. Its test config lets random weights' clips through the
    decode (``PARALLEL_EVAL_TEST``)."""
    cfg = production_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
        train=dataclasses.replace(cfg.train, lr=PARALLEL_LR),
        test_cfg=dataclasses.replace(cfg.test_cfg, **PARALLEL_EVAL_TEST))


def _run_group(cmd: list[str], timeout: float) -> tuple[int, str]:
    """Runs ``cmd`` (a launcher and the processes it starts) in a session of
    its own; on a time-out kills the whole group. (exit code, output)."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=30)
    return proc.returncode, out


def _torchrun(*args: str) -> list[str]:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", *args]


def _hold_attention_at(label: str, q, k, v, kv, seg, sm: str, scale, gen) -> dict:
    """The tensor-core forward, prep and dq / dk-dv pair against their plain
    versions on a rank's own attention inputs (the first layer's q/k/v of
    its run, column views of the fused projection as the model gives them,
    and its batch's mask and segments), under phases 2 and 3's tolerances
    (``TOL``, ``BWD_REL_BF16``, ``_hold_prep``); the upstream gradient is
    random before kvl and 0 past it, as in phase 3. Each kernel must have
    launched. Returns the shape and the max errors."""
    import torch

    from repurpose_tpu_torch.ops import flash_attention as fa

    counters = (fa.flash_fwd_tc, fa.flash_bwd_dq_tc, fa.flash_bwd_dkv_tc)
    before = [c.launches for c in counters]
    o, lse = fa.flash_forward(q, k, v, kv, seg_ids=seg, softmax_dtype=sm, scale=scale)
    ref_o, ref_lse = fa.flash_forward_reference(q, k, v, kv, seg, sm, scale=scale)
    err, lse_err, _, live = _hold_forward(f"{label} forward", o, lse, ref_o, ref_lse, kv, seg,
                                          "bfloat16")
    out_max = float(ref_o[live].float().abs().max())
    del ref_o, ref_lse
    past = torch.arange(q.shape[1], device=q.device)[None, :] >= fa._kv_len(kv)
    g = torch.randn(q.shape, generator=gen, device=q.device).to(q.dtype)
    g = g.masked_fill(past[:, :, None, None], 0.0)
    args = (q, k, v, kv, o, lse, g, seg, sm)
    prep = fa.flash_bwd_stream_prep(*args[:-1], scale=scale, dense=True)
    delta_err = _hold_prep(f"{label} prep", prep, fa.flash_bwd_stream_prep_reference(
        *args[:-1], scale=scale, dense=True))
    got = dict(dq=fa.flash_bwd_dq(*args, prep, scale=scale))
    got["dk"], got["dv"] = fa.flash_bwd_dkv(*args, prep, scale=scale)
    want = dict(dq=fa.flash_bwd_dq_reference(*args, scale=scale))
    want["dk"], want["dv"] = fa.flash_bwd_dkv_reference(*args, scale=scale)
    torch.cuda.synchronize()
    launched = [c.launches - b for c, b in zip(counters, before)]
    check(launched == [1, 1, 1], f"{label}: flash_fwd_tc / flash_bwd_dq_tc / flash_bwd_dkv_tc "
                                 f"launched {launched} times, want once each")
    errs = _hold_backward(f"{label} backward", got, want, BWD_REL_BF16, past)
    return dict(shape=list(q.shape), packed=seg is not None, out_max_abs_err=err,
                out_max_abs_plain=out_max, lse_max_abs_err=lse_err,
                prep_delta_max_abs_err=delta_err, grad_max_abs_err=errs,
                grad_max_abs_plain={n: float(w.float().abs().max()) for n, w in want.items()},
                grad_tolerance=f"{BWD_REL_BF16} x max |plain|")


def parallel_worker(workdir: str) -> int:
    """One of phase 16's two ranks (started by torchrun; both share the card
    over gloo): runs (a)-(c), (d) and (f) on the inputs the parent wrote to
    ``workdir`` (and (f)'s, made anew from their seeds) and writes each
    rank's results there."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from repurpose_tpu_torch.parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed("gloo", "cuda", share_card=True)  # before any CUDA work
    from repurpose_tpu_torch.config import MeshConfig
    from repurpose_tpu_torch.data.batching import Batch
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops import flash_attention as fa
    from repurpose_tpu_torch.parallel.mesh import create_mesh, mesh_self_check
    from repurpose_tpu_torch.parallel.sharding import local_rows, shard_state_dict
    from repurpose_tpu_torch.train.loop import Trainer
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer, optimizer_state_bytes
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    rank = dist.get_rank()
    cfg = _parallel_config()
    mc = cfg.model
    sd = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    z = np.load(os.path.join(workdir, "batch.npz"))
    global_batch = Batch(*[z[f] if f in z.files else None for f in Batch._fields])

    # observers only (the wrappers count the launches): the time in the
    # collectives, and the heads of each tensor-core attention launch
    spent = {"s": 0.0, "calls": 0}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent["s"] += time.perf_counter() - t0
                spent["calls"] += 1
        return call

    dist.all_reduce, dist.broadcast = timed(dist.all_reduce), timed(dist.broadcast)
    heads: dict[str, set] = {}
    fwd_launch, bwd_launch = fa._fwd_tc_launch, fa._tc_launch

    first_fwd: list = []  # the run's first tensor-core forward inputs, q to scale

    def fwd_seen(q, *args, **kwargs):
        heads.setdefault("flash_fwd_tc", set()).add(q.shape[2])
        if not first_fwd:
            first_fwd.append((q, *args))
        return fwd_launch(q, *args, **kwargs)

    def bwd_seen(name, q, *args, **kwargs):
        heads.setdefault(name, set()).add(q.shape[2])
        return bwd_launch(name, q, *args, **kwargs)

    fa._fwd_tc_launch, fa._tc_launch = fwd_seen, bwd_seen
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16 + rank)
    out: dict = {"rank": rank}
    for name, run in PARALLEL_RUNS.items():
        mesh = create_mesh(MeshConfig(**run["axes"]), "gloo", "cuda", share_card=True)
        check(mesh_self_check(mesh) == 2, "mesh self-check")
        tc = dataclasses.replace(cfg.train, batch_size=run["rows"],
                                 shard_opt_state=run.get("zero1", False))
        mc = _run_model(cfg, run["dtype"])
        model = build_model(mc, mesh.device, seed=SEED, mesh=mesh)
        model.load_state_dict(shard_state_dict(sd, mesh), strict=True)
        opt, schedule = make_optimizer(model, tc, 1, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = make_train_step(mc, tc, schedule, mesh)
        batch = batch_to_device(local_rows(global_batch, mesh), mesh.device)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        heads.clear()
        first_fwd.clear()
        hist, step_ms, coll_ms = [], [], []
        for _ in range(run.get("steps", PARALLEL_STEPS)):
            torch.cuda.synchronize()
            c0, t0 = spent["s"], time.perf_counter()
            m = step(state, batch)
            hist.append([float(m["loss"]), float(m["grad_norm"])])  # reads: synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            coll_ms.append((spent["s"] - c0) * 1e3)
        launches = read_launches(*PARALLEL_TC, *PARALLEL_FIRST)
        kernel_vs_plain = None
        if run.get("hold_kernels"):
            q, k, v, kv, seg, _, _, _, sm, scale = first_fwd[0]
            kernel_vs_plain = _hold_attention_at(f"{name} rank {rank}", q, k, v, kv, seg, sm,
                                                 scale, gen)
        first_fwd.clear()
        params, _ = state.gathered()
        if rank == 0:
            torch.save({k: v.cpu() for k, v in params.items()},
                       os.path.join(workdir, f"params_{name}.pt"))
        out[name] = dict(hist=hist, step_ms=step_ms, coll_ms=coll_ms, launches=launches,
                         heads={k: sorted(v) for k, v in heads.items()},
                         local_rows=int(batch.visual.shape[0]),
                         kernel_vs_plain=kernel_vs_plain,
                         opt_bytes=optimizer_state_bytes(opt), mesh=mesh.sizes)
        del model, opt, state, params
        torch.cuda.empty_cache()

    # (d) multi-process evaluate, each data rank its slice of the videos
    eval_sd = torch.load(os.path.join(workdir, "eval_init.pt"), weights_only=True)
    test_ds = SyntheticDataset(list(PARALLEL_EVAL_VIDEOS), mc, seed=7)
    for axes in (dict(data=2), dict(data=1, model=2)):
        trainer = Trainer(dataclasses.replace(cfg, mesh=MeshConfig(**axes)),
                          os.path.join(workdir, "eval"), test_ds, test_ds=test_ds,
                          init_params=eval_sd, device="cuda", dist_backend="gloo",
                          share_card=True)
        reset_launches()
        heads.clear()
        res = trainer.evaluate()
        out["d_eval_" + "_".join(f"{k}{v}" for k, v in axes.items())] = dict(
            tiou=res, launches=read_launches("flash_fwd_tc"),
            heads={k: sorted(v) for k, v in heads.items()})
        trainer.close()

    # (f) the fusion variants at model = 2, whole on every model rank
    mesh = create_mesh(MeshConfig(data=1, model=2), "gloo", "cuda", share_card=True)
    ftc = _fusion_train(cfg)
    for fusion in FUSIONS:
        for dtype, dropout in (("float32", 0.0), ("bfloat16", FUSION_MESH_DROPOUT)):
            fmc = _fusion_model(cfg, fusion, dtype, dropout=dropout)
            model = build_model(fmc, mesh.device, seed=SEED, mesh=mesh)
            model.set_dropout_generator(torch.Generator(device=mesh.device))
            opt, schedule = make_optimizer(model, ftc, 1, mesh)
            state = TrainState(model, opt, mesh=mesh)
            step = make_train_step(fmc, ftc, schedule, mesh)
            batch = batch_to_device(local_rows(_fusion_batch(fmc), mesh), mesh.device)
            torch.cuda.synchronize()
            dist.barrier()
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            hist, step_ms = [], []
            for _ in range(FUSION_MESH_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = step(state, batch)
                hist.append([float(m["loss"]), float(m["grad_norm"])])  # reads: synchronises
                step_ms.append((time.perf_counter() - t0) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            launches = read_launches(*PARALLEL_TC, *PARALLEL_FIRST)
            # the largest difference of this rank's parameters from model rank 0's
            mine = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
            theirs = mesh.broadcast(mine.clone(), "model", 0)
            key = f"f_{fusion}_{dtype}"
            if rank == 0 and dtype == "float32":
                torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                           os.path.join(workdir, f"params_{key}.pt"))
            out[key] = dict(hist=hist, step_ms=step_ms, peak=peak, launches=launches,
                            local=list(batch.visual.shape[:2]), mesh=mesh.sizes,
                            diff_from_rank0=float((mine - theirs).abs().max()),
                            params=mine.numel())
            del model, opt, state, batch, mine, theirs
            torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _update_rel(got: dict, want: dict, init: dict) -> float:
    """Relative L2 of (got - init) against (want - init) over every parameter."""
    num = den = 0.0
    for k, w in want.items():
        u_want = w.double() - init[k].double()
        num += float(((got[k].double() - init[k].double()) - u_want).pow(2).sum())
        den += float(u_want.pow(2).sum())
    return (num / den) ** 0.5


def _reference_steps(mc, tc, batch, steps: int, grad_parts: bool = False) -> dict:
    """One process's steps on the card: (loss, grad norm) a step, step ms,
    the peak allocated, the optimizer's bytes, the parameters before
    (``init``) and after them; with ``grad_parts`` the first step's gradient
    norm of each part (``_parts``) and the parts below ``NOISE_GRAD_REL`` of
    the largest."""
    import torch

    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer, optimizer_state_bytes
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    model = build_model(mc, "cuda", seed=SEED)
    init = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    opt, schedule = make_optimizer(model, tc, 1)
    state = TrainState(model, opt)
    step = make_train_step(mc, tc, schedule)
    dev = batch_to_device(batch, "cuda")
    torch.cuda.reset_peak_memory_stats()
    hist, ms = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, dev)
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        ms.append((time.perf_counter() - t0) * 1e3)
        if grad_parts and len(hist) == 1:  # the step leaves its gradients in .grad
            norms = {k: float(g.double().norm()) for k, g in _parts(
                (n, p.grad) for n, p in model.named_parameters() if p.grad is not None).items()}
    out = dict(hist=hist, step_ms=ms, peak=torch.cuda.max_memory_allocated(),
               opt_bytes=optimizer_state_bytes(opt), init=init,
               params={k: v.detach().cpu() for k, v in model.state_dict().items()})
    if grad_parts:
        top = max(norms.values())
        out.update(grad_norms=norms,
                   noise_parts=sorted(k for k, x in norms.items() if x < NOISE_GRAD_REL * top))
    del model, opt, state
    torch.cuda.empty_cache()
    return out




# A part of the parameters whose one-process gradient is below this share of
# the largest part's is rounding noise (the key biases: softmax cancels
# them, so their exact gradient is 0), and Adam moves it by about lr a step
# in a direction the summation order picks. Phase 17's ring runs hold such
# parts within 2 lr a step of one process and the update's relative L2
# over the rest. Set from the gradient norms that ``_reference_steps`` read on the
# card before it was first applied.
NOISE_GRAD_REL = 1e-6


def _parts(named) -> dict:
    """``named``'s tensors by name, each attention's ``in_proj_*`` cut into
    its q, k and v thirds (``name[q]``, ...)."""
    out = {}
    for k, v in named:
        if ".in_proj_" in k:
            d = v.shape[0] // 3
            for i, part in enumerate("qkv"):
                out[f"{k}[{part}]"] = v[i * d : (i + 1) * d]
        else:
            out[k] = v
    return out


def _noise_summary(ref: dict) -> str:
    """The first step's gradient norms of one process: the largest part, the
    smallest above ``NOISE_GRAD_REL`` of it, and the parts below it."""
    norms, noise = ref["grad_norms"], set(ref["noise_parts"])
    top = max(norms, key=norms.get)
    kept = min((k for k in norms if k not in noise), key=norms.get)
    below = sorted(norms[k] for k in noise)
    return (f"largest {norms[top]:.4g} ({top}), smallest kept {norms[kept]:.4g} ({kept}); "
            f"{len(noise)} parts below {NOISE_GRAD_REL:g} of the largest"
            + (f", {sum(k.endswith(('in_proj_bias[k]', '.k.bias')) for k in noise)} of them "
               f"key biases, "
               f"norms {below[0]:.4g}..{below[-1]:.4g}" if noise else ""))


def _hold_run(label: str, got: list, ref: dict, tol: dict, params, init,
              lr: float | None = None, steps: int = 0, tag: str = "pipeline") -> float:
    """Every rank's (loss, grad norm) within ``tol`` of the one-process steps
    (step 1, then the later steps), the ranks equal, the update's relative
    L2 within ``tol["update"]``; returns that L2. With ``lr`` the update is
    held over every part (``_parts``) but the one-process run's noise parts
    (``NOISE_GRAD_REL``), and those within 2 lr a step of the one-process
    ones."""
    for r, g in enumerate(got):
        for i, ((loss, norm), (rl, rn)) in enumerate(zip(g["hist"], ref["hist"])):
            j = min(i, 1)
            check(abs(loss - rl) <= tol["loss"][j] * abs(rl)
                  and abs(norm - rn) <= tol["norm"][j] * abs(rn),
                  f"{label} rank {r} step {i + 1}: loss/norm {g['hist']} against "
                  f"{ref['hist']} (bounds {tol})")
        check(g["hist"] == got[0]["hist"], f"{label}: the ranks logged {got[0]['hist']} and "
                                           f"{g['hist']}")
    if lr is None:
        rel = _update_rel(params, ref["params"], init)
    else:
        noise = set(ref["noise_parts"])
        got_p, want_p, init_p = ({k: v for k, v in _parts(x.items()).items() if k not in noise}
                                 for x in (params, ref["params"], init))
        rel = _update_rel(got_p, want_p, init_p)
        got_n, want_n = (_parts(x.items()) for x in (params, ref["params"]))
        off = max((float((got_n[k].double() - want_n[k].double()).abs().max())
                   for k in noise), default=0.0)
        check(off <= 2 * lr * steps * (1 + 1e-3),
              f"{label}: a noise part {off:.3g} off, past 2 lr a step")
        print(f"[{tag}] {label}: one process's first-step gradient norms: "
              f"{_noise_summary(ref)}; those parts within {off:.3g} of one process (2 lr a "
              f"step: {2 * lr * steps:.3g}); update rel L2 with them "
              f"{_update_rel(params, ref['params'], init):.4g}")
    check(rel <= tol["update"], f"{label}: update relative L2 {rel:.4g} > {tol['update']}")
    return rel


def phase_parallel(card: str, workdir: str) -> dict:
    """Item 9, parts 1-3, at the production width: two ranks sharing the card
    over gloo (torchrun), re-grouped into (a) data=2 (each rank [3, 2048] of
    the packed global [6, 2048] batch), (b) model=2 (tensor parallel: the
    attention kernels at 4 of the 8 heads), (c) data=2 with ZeRO-1 and (b32)
    model=2 in float32, each held to one-process steps on the global batch
    with the same weights (``PARALLEL_RUNS``' bounds), (a) and (b) also
    holding the tensor-core forward, prep and dq / dk-dv pair against their
    plain versions on each rank's first-layer q/k/v ([3, 2048, 8, 64] and
    [6, 2048, 4, 64], packed; ``_hold_attention_at``), (c) to (a) bit for
    bit with about half its optimizer state; (d) the multi-process ``evaluate`` (data=2 and
    model=2) against the one-process one; (e) ``python -m
    repurpose_tpu_torch.train`` and ``preflight`` under torchrun with
    ``--dist_backend gloo --share_card``; (f) the fusion variants at
    model=2, whole on each model rank, [2, 2048] unpacked: float32 held to
    one process, bf16 with dropout the model ranks' parameters held to each
    other. Times are of two ranks sharing one card: not data-parallel
    throughput. Returns (f)'s one-process references for phase 17."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    cfg = _parallel_config()
    mc = cfg.model
    init = {k: v.detach().cpu() for k, v in build_model(mc, "cpu", seed=SEED).state_dict().items()}
    torch.save(init, os.path.join(workdir, "init.pt"))
    eval_sd = dict(init)
    # random weights give zero-length clips; offsets of ~15 s give clips tIoU can score
    eval_sd["reg_head.7.bias"] = torch.full_like(init["reg_head.7.bias"], 15.0)
    torch.save(eval_sd, os.path.join(workdir, "eval_init.pt"))
    train_ds, _, _ = cli.build_datasets(cfg, PARALLEL_VIDEOS)
    batch = next(iter(BatchLoader(train_ds, 6, cfg.train.buckets, seed=cfg.train.seed,
                                  pack=True).epoch(0)))
    check(batch.visual.shape[:2] == (6, 2048) and (batch.seg_ids.max(axis=1) >= 0).all(),
          f"the global batch is not 6 full packed rows: {batch.visual.shape}")
    np.savez(os.path.join(workdir, "batch.npz"),
             **{f: x for f, x in zip(batch._fields, batch) if x is not None})

    # the one-process references on the global batch, one per dtype
    tc = dataclasses.replace(cfg.train, batch_size=6)
    refs = {}
    for dtype, steps in (("bfloat16", PARALLEL_STEPS), ("float32", 2)):
        refs[dtype] = _reference_steps(_run_model(cfg, dtype), tc, batch, steps)
        print(f"[parallel] {card}: one process, {dtype}, packed [6, 2048], {steps} steps: "
              f"loss/grad norm {json.dumps(refs[dtype]['hist'])}, step ms "
              f"{json.dumps([round(x, 2) for x in refs[dtype]['step_ms']])}, Adam state "
              f"{refs[dtype]['opt_bytes'] / 1e6:.1f} MB")
    # (f)'s: each fusion variant in float32 at dropout 0 on its [2, 2048] batch
    fusion_refs = {}
    for fusion in FUSIONS:
        fmc = _fusion_model(cfg, fusion, "float32")
        fusion_refs[fusion] = r = _reference_steps(fmc, _fusion_train(cfg), _fusion_batch(fmc),
                                                   FUSION_MESH_STEPS, grad_parts=True)
        print(f"[parallel] {card}: one process, {fusion}, float32, unpacked [2, 2048], "
              f"{FUSION_MESH_STEPS} steps: loss/grad norm {json.dumps(r['hist'])}, step ms "
              f"{json.dumps([round(x, 2) for x in r['step_ms']])}, peak "
              f"{r['peak'] / 2**30:.2f} GiB")
    one = Trainer(cfg, os.path.join(workdir, "eval_one"),
                  SyntheticDataset(list(PARALLEL_EVAL_VIDEOS), mc, seed=7),
                  test_ds=SyntheticDataset(list(PARALLEL_EVAL_VIDEOS), mc, seed=7),
                  init_params=eval_sd, device="cuda")
    ref_eval = one.evaluate()
    one.close()
    del one
    torch.cuda.empty_cache()
    print(f"[parallel] {card}: one process, evaluate {json.dumps(ref_eval)}")

    # (a)-(d): one torchrun launch of two ranks
    t0 = time.perf_counter()
    rc, log = _run_group(_torchrun(os.path.join(ROOT, "chip_smoke.py"), "--parallel-worker",
                                   workdir), timeout=420)
    launch_s = time.perf_counter() - t0
    check(rc == 0, f"phase 16 ranks exited {rc}:\n{log[-6000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    results: dict = {}
    for name, run in PARALLEL_RUNS.items():
        got = [x[name] for x in ranks]
        params = torch.load(os.path.join(workdir, f"params_{name}.pt"), weights_only=True)
        ref = refs[run["dtype"]]
        tol = run["tol"]
        tc_kernels = run["dtype"] == "bfloat16"
        want_heads = mc.num_heads // run["axes"].get("model", 1)
        steps = run.get("steps", PARALLEL_STEPS)
        rel = _hold_run(name, got, ref, tol, params, init)
        for r, g in enumerate(got):
            check(g["local_rows"] == run["rows"], f"{name} rank {r}: {g['local_rows']} rows")
            layers = mc.self_num_layers * steps
            want = {k: layers if tc_kernels else 0 for k in PARALLEL_TC}
            want.update({k: layers for k in PARALLEL_FIRST})
            check(g["launches"] == want, f"{name} rank {r}: launches {g['launches']}, "
                                         f"want {want}")
            if tc_kernels:
                check(all(g["heads"].get(k) == [want_heads]
                          for k in ("flash_fwd_tc", "flash_bwd_dq_tc", "flash_bwd_dkv_tc")),
                      f"{name} rank {r}: heads {g['heads']}, want {want_heads}")
            if run.get("hold_kernels"):
                held = g["kernel_vs_plain"]
                want_shape = [run["rows"], 2048, want_heads, mc.d_model // mc.num_heads]
                check(held is not None and held["shape"] == want_shape and held["packed"],
                      f"{name} rank {r}: kernels held at {held}, want packed {want_shape}")
                print(f"[parallel] {card}: ({name.split('_')[0]}) rank {r}: the tensor-core "
                      f"forward, prep and dq / dk-dv pair against their plain versions on "
                      f"this rank's first-layer q/k/v: {json.dumps(held)}")
        results[name] = dict(ranks=got, update_rel=rel, params=params)
        print(f"[parallel] {card}: ({name.split('_')[0]}) {run['dtype']}, mesh {got[0]['mesh']}, "
              f"each rank [{run['rows']}, 2048]: loss/grad norm {json.dumps(got[0]['hist'])} "
              f"(one process {json.dumps(ref['hist'])}; bounds {json.dumps(tol)}), update rel "
              f"L2 {rel:.3e}; launches per rank {json.dumps(got[0]['launches'])} at H = "
              f"{want_heads}; optimizer state per rank "
              f"{[round(g['opt_bytes'] / 1e6, 1) for g in got]} MB (one process "
              f"{ref['opt_bytes'] / 1e6:.1f})")
        print(f"[parallel] {card}: ({name.split('_')[0]}) shared-card times (two ranks on one "
              f"card, not data-parallel throughput): step ms per rank "
              f"{[[round(x, 1) for x in g['step_ms']] for g in got]}, of it in collectives "
              f"(gloo, staged through the host) "
              f"{[[round(x, 1) for x in g['coll_ms']] for g in got]}")
    a, c = results["a_data2"], results["c_data2_zero1"]
    check(all(torch.equal(v, c["params"][k]) for k, v in a["params"].items())
          and [g["hist"] for g in a["ranks"]] == [g["hist"] for g in c["ranks"]],
          "ZeRO-1 (c) differs from the replicated optimizer (a)")
    shares = [g["opt_bytes"] / h["opt_bytes"] for g, h in zip(c["ranks"], a["ranks"])]
    check(all(0.5 <= s <= 0.51 for s in shares), f"ZeRO-1 optimizer state shares {shares}")
    print(f"[parallel] {card}: (c) ZeRO-1 equals (a) bit for bit (parameters and every "
          f"step's loss and norm); optimizer state per rank {shares} of (a)'s")
    check(ref_eval["tiou/0.5"] > 0, f"the one-process evaluate scores nothing: {ref_eval}")
    evals = {}
    for key in ("d_eval_data2", "d_eval_data1_model2"):
        for r, x in enumerate(ranks):
            got = x[key]["tiou"]
            check(got == ranks[0][key]["tiou"], f"{key}: the ranks returned different tIoU")
            check(all(abs(got[k] - v) <= PARALLEL_EVAL_ATOL for k, v in ref_eval.items()),
                  f"{key} rank {r}: {got} against one process {ref_eval} (bound "
                  f"{PARALLEL_EVAL_ATOL})")
        evals[key] = ranks[0][key]
        print(f"[parallel] {card}: (d) evaluate on {key[7:]}: {json.dumps(ranks[0][key]['tiou'])}"
              f" (one process {json.dumps(ref_eval)}); forward launches per rank "
              f"{[x[key]['launches']['flash_fwd_tc'] for x in ranks]} at H "
              f"{ranks[0][key]['heads'].get('flash_fwd_tc')}")
    check(evals["d_eval_data1_model2"]["heads"].get("flash_fwd_tc") == [mc.num_heads // 2],
          "the model=2 evaluation did not launch the forward at H = 4")
    fusion_runs = {}
    for fusion in FUSIONS:
        ref = fusion_refs[fusion]
        f32, b16 = ([x[f"f_{fusion}_{dtype}"] for x in ranks] for dtype in ("float32", "bfloat16"))
        params = torch.load(os.path.join(workdir, f"params_f_{fusion}_float32.pt"),
                            weights_only=True)
        rel = _hold_run(f"(f) {fusion} model=2 float32", f32, ref, FUSION_MESH_TOL, params,
                        ref["init"], lr=PARALLEL_LR, steps=FUSION_MESH_STEPS, tag="parallel")
        for r, g in enumerate(f32 + b16):
            check(g["local"] == [2, 2048], f"(f) {fusion}: a rank staged {g['local']}")
            want = _fusion_launches(mc, fusion, bf16=r >= len(f32))
            check(g["launches"] == want,
                  f"(f) {fusion}: a rank's attention launches {g['launches']}, want {want}")
        diff = max(g["diff_from_rank0"] for g in b16)
        check(all(np.isfinite(g["hist"]).all() for g in b16)
              and diff <= 2 * PARALLEL_LR * FUSION_MESH_STEPS,
              f"(f) {fusion} bf16 dropout {FUSION_MESH_DROPOUT}: losses "
              f"{[g['hist'] for g in b16]}, the model ranks' parameters {diff:.3g} apart")
        fusion_runs[fusion] = dict(float32=f32, bfloat16=b16, update_rel=rel,
                                   bf16_rank_diff=diff, reference={
                                       x: ref[x] for x in ("hist", "step_ms", "peak")})
        gib = lambda runs: [round(g["peak"] / 2**30, 2) for g in runs]  # noqa: E731
        ms = lambda runs: [[round(x, 1) for x in g["step_ms"]] for g in runs]  # noqa: E731
        print(f"[parallel] {card}: (f) {fusion} at model=2, whole on each model rank "
              f"({f32[0]['params'] / 1e6:.1f} M parameters), each rank [2, 2048] unpacked, "
              f"attention launches per rank float32 {json.dumps(f32[0]['launches'])}, bf16 "
              f"{json.dumps(b16[0]['launches'])}; float32 dropout 0 loss/grad norm "
              f"{json.dumps(f32[0]['hist'])}"
              f" (one process {json.dumps(ref['hist'])}; bounds {json.dumps(FUSION_MESH_TOL)}), "
              f"update rel L2 {rel:.3e}; bf16 dropout {FUSION_MESH_DROPOUT} losses per rank "
              f"{[[round(h[0], 5) for h in g['hist']] for g in b16]}, the model ranks' "
              f"parameters after {FUSION_MESH_STEPS} steps "
              + ("equal bit for bit" if diff == 0 else f"at most {diff:.3g} apart")
              + f"; shared-card step ms per rank float32 {ms(f32)}, bf16 {ms(b16)} (one process "
              f"float32 {[round(x, 1) for x in ref['step_ms']]}); peak allocated per rank "
              f"float32 {gib(f32)} GiB, bf16 {gib(b16)} GiB (one process float32 "
              f"{ref['peak'] / 2**30:.2f} GiB)")

    # (e) the train CLI and preflight under torchrun
    cfg_json = os.path.join(workdir, "config.json")
    with open(cfg_json, "w") as f:
        f.write(production_config().to_json())
    run_dir = os.path.join(workdir, "cli")
    t0 = time.perf_counter()
    rc, log = _run_group(_torchrun("-m", "repurpose_tpu_torch.train", "--config_path", cfg_json,
                                   "--synthetic", "8", "--epochs", "1", "--dist_backend", "gloo",
                                   "--share_card", "--workdir", run_dir), timeout=420)
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"train under torchrun exited {rc}:\n{log[-6000:]}")
    done = re.findall(r"rank (\d)/2 training done: .*'final_loss': ([-+0-9.eE]+|nan)", log)
    check(sorted(r for r, _ in done) == ["0", "1"] and len({x for _, x in done}) == 1
          and np.isfinite(float(done[0][1])), f"the ranks' summaries: {done}\n{log[-3000:]}")
    check(os.path.isfile(os.path.join(run_dir, "metrics.jsonl")), "rank 0 wrote no metrics")
    print(f"[parallel] {card}: (e) torchrun --nproc_per_node 2 -m repurpose_tpu_torch.train "
          f"--synthetic 8 --epochs 1 --dist_backend gloo --share_card: exit 0 in {cli_s:.1f} s, "
          f"both ranks final loss {done[0][1]}")
    t0 = time.perf_counter()
    rc, log = _run_group(_torchrun("-m", "repurpose_tpu_torch.preflight", "--dist_backend",
                                   "gloo", "--share_card"), timeout=420)
    pre_s = time.perf_counter() - t0
    check(rc == 0 and log.count("[PASS] dp x tp train step") == 2
          and log.count("[PASS] collective self-check: gloo all_reduce=2") == 2,
          f"preflight under torchrun exited {rc}:\n{log[-6000:]}")
    print(f"[parallel] {card}: (e) torchrun --nproc_per_node 2 -m repurpose_tpu_torch.preflight "
          f"--dist_backend gloo --share_card: exit 0 in {pre_s:.1f} s, every check passed on "
          f"both ranks: " + "; ".join(sorted({line.strip() for line in log.splitlines()
                                              if "dp x tp" in line and "PASS" in line})))
    print(f"[parallel] {card}: phase 16 {time.perf_counter() - t_phase:.1f} s (the ranks' "
          f"launch {launch_s:.1f} s)")
    return dict(runs={k: dict(ranks=v["ranks"], update_rel=v["update_rel"])
                      for k, v in results.items()},
                reference={k: {x: v[x] for x in ("hist", "step_ms", "opt_bytes")}
                           for k, v in refs.items()},
                evaluate=evals, fusion=fusion_runs, fusion_refs=fusion_refs, cli_s=cli_s,
                preflight_s=pre_s, preflight_log=log)


# -- phase 17: pipeline and sequence parallelism --------------------------------

# (a) and (b): the pipe = 2 runs on the packed global [6, 2048] batch, each
# rank a stage of 8 layers, M microbatches of 3 rows, against the one-process
# steps (phase 16's references). Every microbatch's forward and backward is
# the one-process one but for cuBLAS's choice of kernel for 3 x 2048 rows
# instead of 6 x 2048, and the stage's weight gradients are the two
# microbatches' bf16 products summed in float32: phase 16 (a)'s kind of
# difference, so (a)'s bounds (BF16_DP_TOL, set before the first run).
PIPE_STEPS = 3
PIPE_M = 2
PIPE_MEMORY_M = 6  # (b)'s memory comparison: one row a microbatch
# (c): seq = 2, ring attention, one video of 8192 s unpacked ([1, 8192]) in
# configs/longvideo.yaml's model settings (remat), each rank [1, 4096],
# against one process on the whole row with attention_impl="xla". In bf16
# the ring keeps the probabilities in float32 for P V where mha_torch
# rounds them to bf16 first, so every layer's attention output is rounded
# otherwise: phase 16 (b)'s kind of difference and (b)'s bounds. In float32
# the two differ by summation order only: (b32)'s bounds. Set before the
# first run. That run held every bound but (c32)'s update, 0.02098 over all
# parameters: parts whose gradient is float32 noise (``NOISE_GRAD_REL``)
# flip sign at random, each a 2 lr Adam difference. So the update is held
# without them, at the same bounds, and they within 2 lr a step.
RING_T = 8192
RING_RUNS = {
    "c_ring_bf16": dict(dtype="bfloat16", steps=3,
                        tol=dict(loss=(5e-3, 5e-2), norm=(2e-2, 0.15), update=0.5)),
    "c32_ring_float32": dict(dtype="float32", steps=2,
                             tol=dict(loss=(1e-4, 1e-4), norm=(1e-3, 1e-3), update=0.02)),
}
# The ring op alone at [1, 8192, 8, 64] against mha_torch on the whole
# sequence, forward and gradients of sum(out ** 2) (the tail 10 % of keys
# masked): float32 within 1e-5 of each tensor's largest element (sums in
# another order), bf16 inputs within BWD_REL_BF16 of it (the output is
# rounded to bf16 once, mha_torch rounds its probabilities too).
RING_OP_REL = {"float32": 1e-5, "bfloat16": BWD_REL_BF16}


def _ring_op_inputs(dtype: str):
    """q, k, v [1, RING_T, 8, 64] (``dtype``) and the key mask, on the card,
    the same on every rank."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 17)
    q, k, v = (torch.randn((1, RING_T, 8, 64), generator=gen).to("cuda", getattr(torch, dtype))
               for _ in range(3))
    mask = torch.ones((1, RING_T), dtype=torch.bool, device="cuda")
    mask[:, int(0.9 * RING_T):] = False
    return q, k, v, mask


def _long_ring_batch(mc):
    from repurpose_tpu_torch.data.batching import collate
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset

    ds = SyntheticDataset([RING_T], mc, seed=SEED + 17)
    return collate([ds[0]], (RING_T,), 1)


def _ring_config(dtype: str):
    """``configs/longvideo.yaml``'s model (remat) with ``dtype`` activations
    and interior, dropout 0, lr ``PARALLEL_LR``."""
    cfg = longvideo_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=0.0, compute_dtype=dtype,
                                       attn_softmax_dtype=dtype),
        train=dataclasses.replace(cfg.train, lr=PARALLEL_LR))


def pipeline_worker(workdir: str) -> int:
    """One of phase 17's two ranks (started by torchrun; both share the card
    over gloo): runs (a)-(d) and (f) on the inputs the parent wrote to
    ``workdir`` (and (f)'s, made anew from their seeds) and writes each
    rank's results there."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from repurpose_tpu_torch.parallel.mesh import maybe_initialize_distributed

    maybe_initialize_distributed("gloo", "cuda", share_card=True)  # before any CUDA work
    from repurpose_tpu_torch.config import MeshConfig
    from repurpose_tpu_torch.data.batching import Batch
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops import flash_attention as fa
    from repurpose_tpu_torch.ops.ring_attention import ring_attention
    from repurpose_tpu_torch.parallel.mesh import Mesh, create_mesh, mesh_self_check
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.parallel.pipeline_1f1b import make_1f1b_train_step
    from repurpose_tpu_torch.parallel.sharding import local_rows, seq_split
    from repurpose_tpu_torch.train.loop import Trainer
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    rank = dist.get_rank()
    cfg = _parallel_config()
    mc = cfg.model
    sd = torch.load(os.path.join(workdir, "init.pt"), weights_only=True)
    z = np.load(os.path.join(workdir, "batch.npz"))
    global_batch = Batch(*[z[f] if f in z.files else None for f in Batch._fields])

    # observers only (the wrappers count the launches): the time in the hops
    # and collectives, and the first tensor-core forward's inputs
    spent = {"s": 0.0}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                spent["s"] += time.perf_counter() - t0
        return call

    Mesh.hop = timed(Mesh.hop)
    dist.all_reduce, dist.broadcast = timed(dist.all_reduce), timed(dist.broadcast)
    fwd_launch, first_fwd = fa._fwd_tc_launch, []

    def fwd_seen(q, *args, **kwargs):
        if not first_fwd:
            first_fwd.append((q, *args))
        return fwd_launch(q, *args, **kwargs)

    fa._fwd_tc_launch = fwd_seen
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17 + rank)
    out: dict = {"rank": rank}

    def steps(step, state, batch, n):
        hist, ms, hop_ms = [], [], []
        for _ in range(n):
            torch.cuda.synchronize()
            c0, t0 = spent["s"], time.perf_counter()
            m = step(state, batch)
            hist.append([float(m["loss"]), float(m["grad_norm"])])  # reads: synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
            hop_ms.append((spent["s"] - c0) * 1e3)
        return hist, ms, hop_ms

    # (a) GPipe and (b) 1F1B on pipe = 2
    mesh = create_mesh(MeshConfig(data=1, pipe=2), "gloo", "cuda", share_card=True)
    check(mesh_self_check(mesh) == 2, "mesh self-check")
    batch = batch_to_device(local_rows(global_batch, mesh), mesh.device)
    for name, schedule in (("a_gpipe", "gpipe"), ("b_1f1b", "1f1b")):
        tc = dataclasses.replace(cfg.train, batch_size=6, pipeline_schedule=schedule,
                                 pipeline_microbatches=PIPE_M)
        model = build_model(mc, mesh.device, seed=SEED, mesh=mesh)
        model.load_state_dict(sd, strict=True)
        opt, sched = make_optimizer(model, tc, 1, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = (make_1f1b_train_step(mc, tc, sched, mesh, PIPE_M) if schedule == "1f1b"
                else make_train_step(mc, tc, sched, mesh))
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        first_fwd.clear()
        hist, ms, hop_ms = steps(step, state, batch, PIPE_STEPS)
        launches = read_launches(*PARALLEL_TC, *PARALLEL_FIRST)
        q, k, v, kv, seg, _, _, _, sm, scale = first_fwd[0]
        held = _hold_attention_at(f"{name} rank {rank}", q, k, v, kv, seg, sm, scale, gen)
        first_fwd.clear()
        params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if rank == 0:
            torch.save(params, os.path.join(workdir, f"params_{name}.pt"))
        out[name] = dict(hist=hist, step_ms=ms, hop_ms=hop_ms, launches=launches,
                         kernel_vs_plain=held, local_rows=int(batch.visual.shape[0]))
        del model, opt, state, params
        torch.cuda.empty_cache()
    # (b) memory: one step of each schedule at M = 6, the peak allocated per rank
    peaks = {}
    for schedule in ("gpipe", "1f1b"):
        tc = dataclasses.replace(cfg.train, batch_size=6, pipeline_schedule=schedule,
                                 pipeline_microbatches=PIPE_MEMORY_M)
        model = build_model(mc, mesh.device, seed=SEED, mesh=mesh)
        opt, sched = make_optimizer(model, tc, 1, mesh)
        step = (make_1f1b_train_step(mc, tc, sched, mesh, PIPE_MEMORY_M) if schedule == "1f1b"
                else make_train_step(mc, tc, sched, mesh))
        state = TrainState(model, opt, mesh=mesh)
        step(state, batch)  # Adam's moments exist from here on
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state, batch)
        torch.cuda.synchronize()
        peaks[schedule] = dict(peak=torch.cuda.max_memory_allocated(), before=base)
        del model, opt, state
        torch.cuda.empty_cache()
    out["b_memory_m6"] = peaks

    # (c) seq = 2 ring attention on [1, 8192], each rank [1, 4096]
    mesh = create_mesh(MeshConfig(data=1, seq=2), "gloo", "cuda", share_card=True)
    check(mesh_self_check(mesh) == 2, "mesh self-check")
    for name, run in RING_RUNS.items():
        rcfg = _ring_config(run["dtype"])
        rmc = dataclasses.replace(rcfg.model, attention_impl="ring")
        model = build_model(rmc, mesh.device, seed=SEED, mesh=mesh)
        model.load_state_dict(sd, strict=True)
        opt, sched = make_optimizer(model, rcfg.train, 1, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = make_train_step(rmc, rcfg.train, sched, mesh)
        b = batch_to_device(local_rows(_long_ring_batch(rmc), mesh, seq=True), mesh.device)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        hist, ms, hop_ms = steps(step, state, b, run["steps"])
        launches = read_launches(*PARALLEL_TC, *PARALLEL_FIRST)
        peak = torch.cuda.max_memory_allocated()
        params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        if rank == 0:
            torch.save(params, os.path.join(workdir, f"params_{name}.pt"))
        out[name] = dict(hist=hist, step_ms=ms, hop_ms=hop_ms, launches=launches,
                         local=list(b.visual.shape[:2]), peak=peak)
        del model, opt, state, params
        torch.cuda.empty_cache()
    # (c) the ring op alone: this rank's shard of the output and gradients
    w = RING_T // 2
    cols = slice(rank * w, (rank + 1) * w)
    for dtype in RING_OP_REL:
        q, k, v, mask = _ring_op_inputs(dtype)
        q, k, v = (x[:, cols].detach().requires_grad_() for x in (q, k, v))
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        o = ring_attention(q, k, v, mask[:, cols], mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        (o.float() ** 2).sum().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        torch.save({n: x.detach().cpu() for n, x in (("out", o), ("dq", q.grad), ("dk", k.grad),
                                                      ("dv", v.grad))},
                   os.path.join(workdir, f"ring_op_{dtype}_rank{rank}.pt"))
        out[f"ring_op_{dtype}_ms"] = [(t1 - t0) * 1e3, (t2 - t1) * 1e3]
        del q, k, v, o

    # (d) multi-process evaluate: ring live on seq = 2 (float32), and pipe = 2
    eval_sd = torch.load(os.path.join(workdir, "eval_init.pt"), weights_only=True)
    for key, axes, model_kw in (
            ("d_eval_seq2_ring", dict(data=1, seq=2), dict(attention_impl="ring",
                                                           compute_dtype="float32",
                                                           attn_softmax_dtype="float32")),
            ("d_eval_pipe2", dict(data=1, pipe=2), {})):
        ecfg = _eval_config(cfg, model_kw, MeshConfig(**axes))
        test_ds = SyntheticDataset(list(PARALLEL_EVAL_VIDEOS), ecfg.model, seed=7)
        trainer = Trainer(ecfg, os.path.join(workdir, "eval"), test_ds, test_ds=test_ds,
                          init_params=eval_sd, device="cuda", dist_backend="gloo",
                          share_card=True)
        reset_launches()
        res = trainer.evaluate()
        out[key] = dict(tiou=res, ring=trainer.pipeline.ring,
                        launches=read_launches("flash_fwd_tc"))
        trainer.close()

    # (f) the fusion variants on seq = 2 under the ring config: whole rows
    mesh = create_mesh(MeshConfig(data=1, seq=2), "gloo", "cuda", share_card=True)
    ftc = _fusion_train(cfg)
    for fusion in FUSIONS:
        fmc = _fusion_model(cfg, fusion, "float32", attention_impl="ring")
        model = build_model(fmc, mesh.device, seed=SEED, mesh=mesh)
        serve_sd = _serving_weights({k: v.clone() for k, v in model.state_dict().items()})
        opt, sched = make_optimizer(model, ftc, 1, mesh)
        state = TrainState(model, opt, mesh=mesh)
        step = make_train_step(fmc, ftc, sched, mesh)
        # the port's own staging: the rows, and only the ring's columns of them
        b = batch_to_device(local_rows(_fusion_batch(fmc), mesh, seq=seq_split(fmc, mesh)),
                            mesh.device)
        torch.cuda.synchronize()
        dist.barrier()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        hist, ms, hop_ms = steps(step, state, b, FUSION_MESH_STEPS)
        peak = torch.cuda.max_memory_allocated()
        launches = read_launches(*PARALLEL_TC, *PARALLEL_FIRST)
        if rank == 0:
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                       os.path.join(workdir, f"params_f_{fusion}.pt"))
        local = list(b.visual.shape[:2])
        del model, opt, state, b
        torch.cuda.empty_cache()
        pipe = InferencePipeline(fmc, serve_sd, cfg.test_cfg, device=mesh.device, mesh=mesh)
        del serve_sd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scored = pipe.score_videos(_fusion_videos(fmc), cfg.train.buckets, batch_size=2)
        serve_ms = (time.perf_counter() - t0) * 1e3
        out[f"f_{fusion}"] = dict(
            hist=hist, step_ms=ms, hop_ms=hop_ms, peak=peak, launches=launches, local=local,
            ring=pipe.ring, serve_ms=serve_ms,
            scored=[{k: np.asarray(v).tolist() if k in ("segments", "scores", "labels") else v
                     for k, v in r.items()} for r in scored])
        del pipe
        torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _eval_config(cfg, model_kw: dict, mesh):
    """(d)'s config: ``model_kw`` over the model, on ``mesh``; unpacked where
    the model rings (packing composes with no ring) or is its reference."""
    ring = model_kw.get("attention_impl") in ("ring", "xla")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **model_kw), mesh=mesh,
        train=dataclasses.replace(cfg.train, pack_sequences=cfg.train.pack_sequences and not ring))


def phase_pipeline_and_ring(card: str, workdir: str, preflight_log: str,
                            fusion_refs: dict) -> dict:
    """Item 9, parts 4-5, at the production width: two ranks sharing the
    card over gloo (torchrun), re-grouped into (a) pipe = 2 with GPipe and
    (b) pipe = 2 with 1F1B (each rank a stage of 8 layers, M = 2
    microbatches of [3, 2048] of the packed global [6, 2048] batch), held to
    the one-process steps with exact launches per rank of the tensor-core
    forward, prep and dq / dk-dv pair, and those kernels held against their
    plain versions on a stage's microbatch q/k/v ([3, 2048, 8, 64]); (b)
    also prints the peak memory per rank of one step of each schedule at
    M = 6; (c) seq = 2 ring attention on one 8192 s video ([1, 8192], each
    rank [1, 4096], remat), bf16 and float32, held to one process on the
    whole row with the plain attention, and the ring op alone at
    [1, 8192, 8, 64] against ``mha_torch`` on the whole sequence; (d) the
    multi-process ``evaluate`` with the ring live on seq = 2 (float32) and
    on pipe = 2, against one process; (e) the train CLI with a ``pipe: 2``
    config under torchrun, and phase 16's ``preflight`` run's pipeline
    check on both ranks; (f) the fusion variants on seq = 2 under the ring
    config, float32, [2, 2048] unpacked: each rank stages the whole rows,
    its steps held to phase 16's one-process references (``fusion_refs``)
    and its ``score_videos`` on the mesh to one process's clips. Times are
    of two ranks sharing one card: gloo's transport, not pipeline
    throughput."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.data.loader import BatchLoader
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.data.synthetic import SyntheticDataset
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.ops.attention import mha_torch
    from repurpose_tpu_torch.train import __main__ as cli
    from repurpose_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    cfg = _parallel_config()
    mc = cfg.model
    init = {k: v.detach().cpu() for k, v in build_model(mc, "cpu", seed=SEED).state_dict().items()}
    torch.save(init, os.path.join(workdir, "init.pt"))
    eval_sd = dict(init)
    eval_sd["reg_head.7.bias"] = torch.full_like(init["reg_head.7.bias"], 15.0)
    torch.save(eval_sd, os.path.join(workdir, "eval_init.pt"))
    train_ds, _, _ = cli.build_datasets(cfg, PARALLEL_VIDEOS)
    batch = next(iter(BatchLoader(train_ds, 6, cfg.train.buckets, seed=cfg.train.seed,
                                  pack=True).epoch(0)))
    check(batch.visual.shape[:2] == (6, 2048), f"the global batch is {batch.visual.shape}")
    np.savez(os.path.join(workdir, "batch.npz"),
             **{f: x for f, x in zip(batch._fields, batch) if x is not None})

    # the one-process references
    ref = _reference_steps(_run_model(cfg, "bfloat16"),
                           dataclasses.replace(cfg.train, batch_size=6), batch, PIPE_STEPS)
    ring_refs = {}
    for name, run in RING_RUNS.items():
        rcfg = _ring_config(run["dtype"])
        rmc = dataclasses.replace(rcfg.model, attention_impl="xla")
        ring_refs[name] = _reference_steps(rmc, rcfg.train, _long_ring_batch(rmc), run["steps"],
                                           grad_parts=True)
        print(f"[pipeline] {card}: one process, {run['dtype']}, [1, {RING_T}] remat, "
              f"attention_impl=xla: loss/grad norm {json.dumps(ring_refs[name]['hist'])}, step "
              f"ms {json.dumps([round(x, 1) for x in ring_refs[name]['step_ms']])}, peak "
              f"{ring_refs[name]['peak'] / 2**30:.2f} GiB")
    evals = {}
    for key, model_kw in (("d_eval_seq2_ring", dict(attention_impl="xla", compute_dtype="float32",
                                                    attn_softmax_dtype="float32")),
                          ("d_eval_pipe2", {})):
        ecfg = _eval_config(cfg, model_kw, cfg.mesh)
        test_ds = SyntheticDataset(list(PARALLEL_EVAL_VIDEOS), ecfg.model, seed=7)
        one = Trainer(ecfg, os.path.join(workdir, "eval_one"), test_ds, test_ds=test_ds,
                      init_params=eval_sd, device="cuda")
        evals[key] = one.evaluate()
        one.close()
        check(evals[key]["tiou/0.5"] > 0, f"the one-process evaluate scores nothing: {evals}")
    torch.cuda.empty_cache()

    # (a)-(d): one torchrun launch of two ranks
    t0 = time.perf_counter()
    rc, log = _run_group(_torchrun(os.path.join(ROOT, "chip_smoke.py"), "--pipeline-worker",
                                   workdir), timeout=600)
    launch_s = time.perf_counter() - t0
    check(rc == 0, f"phase 17 ranks exited {rc}:\n{log[-6000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    results: dict = {}
    layers = mc.self_num_layers // 2 * PIPE_M * PIPE_STEPS  # a stage's launches of each kernel
    for name in ("a_gpipe", "b_1f1b"):
        got = [x[name] for x in ranks]
        params = torch.load(os.path.join(workdir, f"params_{name}.pt"), weights_only=True)
        rel = _hold_run(name, got, ref, BF16_DP_TOL, params, init)
        fwd = layers * (2 if name == "b_1f1b" else 1)  # 1F1B recomputes the forward
        want = dict(flash_fwd_tc=fwd, flash_bwd_stream_prep=layers, flash_bwd_dq_tc=layers,
                    flash_bwd_dkv_tc=layers, flash_fwd=fwd, flash_bwd_dq=layers,
                    flash_bwd_dkv=layers)
        for r, g in enumerate(got):
            check(g["launches"] == want, f"{name} rank {r}: launches {g['launches']}, "
                                         f"want {want}")
            held = g["kernel_vs_plain"]
            check(held["shape"] == [3, 2048, 8, 64] and held["packed"],
                  f"{name} rank {r}: kernels held at {held}")
            print(f"[pipeline] {card}: ({name.split('_')[0]}) rank {r}: the tensor-core "
                  f"forward, prep and dq / dk-dv pair against their plain versions on this "
                  f"stage's first microbatch q/k/v: {json.dumps(held)}")
        results[name] = dict(ranks=got, update_rel=rel)
        print(f"[pipeline] {card}: ({name.split('_')[0]}) {name[2:]} pipe=2, M={PIPE_M}, "
              f"stages of 8 layers, bf16, packed [6, 2048]: loss/grad norm "
              f"{json.dumps(got[0]['hist'])} (one process {json.dumps(ref['hist'])}; bounds "
              f"{json.dumps(BF16_DP_TOL)}), update rel L2 {rel:.3e}; launches per rank "
              f"{json.dumps(got[0]['launches'])}")
        print(f"[pipeline] {card}: ({name.split('_')[0]}) shared-card times (two ranks on one "
              f"card: gloo's transport, not pipeline throughput): step ms per rank "
              f"{[[round(x, 1) for x in g['step_ms']] for g in got]}, of it in hops and "
              f"collectives {[[round(x, 1) for x in g['hop_ms']] for g in got]}")
    mem = [x["b_memory_m6"] for x in ranks]
    for r, m in enumerate(mem):
        check(m["1f1b"]["peak"] < m["gpipe"]["peak"],
              f"rank {r}: 1F1B's peak {m['1f1b']} not below GPipe's {m['gpipe']} at M = 6")
    print(f"[pipeline] {card}: (b) peak allocated per rank in one step at M = "
          f"{PIPE_MEMORY_M} (rows of 1): " + "; ".join(
              f"rank {r} GPipe {m['gpipe']['peak'] / 2**30:.3f} GiB (before the step "
              f"{m['gpipe']['before'] / 2**30:.3f}), 1F1B {m['1f1b']['peak'] / 2**30:.3f} GiB "
              f"(before {m['1f1b']['before'] / 2**30:.3f})" for r, m in enumerate(mem)))
    for name, run in RING_RUNS.items():
        got = [x[name] for x in ranks]
        params = torch.load(os.path.join(workdir, f"params_{name}.pt"), weights_only=True)
        rel = _hold_run(name, got, ring_refs[name], run["tol"], params, init,
                        lr=PARALLEL_LR, steps=run["steps"])
        zero = dict.fromkeys((*PARALLEL_TC, *PARALLEL_FIRST), 0)
        for r, g in enumerate(got):
            check(g["local"] == [1, RING_T // 2], f"{name} rank {r}: local {g['local']}")
            check(g["launches"] == zero, f"{name} rank {r}: the ring launched {g['launches']}")
        results[name] = dict(ranks=got, update_rel=rel)
        print(f"[pipeline] {card}: ({name.split('_')[0]}) seq=2 ring, {run['dtype']}, [1, "
              f"{RING_T}] remat, each rank [1, {RING_T // 2}]: loss/grad norm "
              f"{json.dumps(got[0]['hist'])} (one process, xla: "
              f"{json.dumps(ring_refs[name]['hist'])}; bounds {json.dumps(run['tol'])}), update "
              f"rel L2 {rel:.3e}; peak per rank {[round(g['peak'] / 2**30, 2) for g in got]} "
              f"GiB; shared-card step ms {[[round(x, 1) for x in g['step_ms']] for g in got]}, "
              f"of it in hops and all_reduces {[[round(x, 1) for x in g['hop_ms']] for g in got]}")
    ring_op = {}
    for dtype, rel_bound in RING_OP_REL.items():
        q, k, v, mask = (x.requires_grad_() if x.is_floating_point() else x
                         for x in _ring_op_inputs(dtype))
        o = mha_torch(q, k, v, mask)
        (o.float() ** 2).sum().backward()
        shards = [torch.load(os.path.join(workdir, f"ring_op_{dtype}_rank{r}.pt"),
                             weights_only=True) for r in range(2)]
        live = mask[0].cpu()
        errs = {}
        for n, want in (("out", o), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            whole = torch.cat([s[n] for s in shards], dim=1)[0].float()
            w = want.detach().cpu()[0].float()
            errs[n] = float((whole[live] - w[live]).abs().max()) / float(w.abs().max())
            check(bool(torch.isfinite(whole).all()), f"ring op {dtype} {n}: not finite")
        check(all(e <= rel_bound for e in errs.values()),
              f"ring op {dtype}: errors {errs} (of each tensor's max) past {rel_bound}")
        ring_op[dtype] = dict(rel_err=errs, ms=[x[f"ring_op_{dtype}_ms"] for x in ranks])
        print(f"[pipeline] {card}: (c) the ring op at [1, {RING_T}, 8, 64] {dtype} (keys past "
              f"0.9 T masked) against mha_torch on the whole sequence: max error of each "
              f"tensor's max {json.dumps(errs)} (bound {rel_bound}); shared-card forward / "
              f"backward ms per rank {json.dumps(ring_op[dtype]['ms'])}")
        del q, k, v, o
        torch.cuda.empty_cache()
    for key, want in evals.items():
        for r, x in enumerate(ranks):
            got = x[key]["tiou"]
            check(got == ranks[0][key]["tiou"], f"{key}: the ranks returned different tIoU")
            check(all(abs(got[k] - v) <= PARALLEL_EVAL_ATOL for k, v in want.items()),
                  f"{key} rank {r}: {got} against one process {want} (bound "
                  f"{PARALLEL_EVAL_ATOL})")
        check(ranks[0][key]["ring"] == (key == "d_eval_seq2_ring"),
              f"{key}: the ring live at eval: {ranks[0][key]['ring']}")
        print(f"[pipeline] {card}: (d) evaluate on {key[7:]}: {json.dumps(ranks[0][key]['tiou'])}"
              f" (one process {json.dumps(want)}; ring live {ranks[0][key]['ring']}); forward "
              f"launches per rank {[x[key]['launches']['flash_fwd_tc'] for x in ranks]}")

    fusion_runs = {}
    for fusion in FUSIONS:
        ref = fusion_refs[fusion]
        got = [x[f"f_{fusion}"] for x in ranks]
        params = torch.load(os.path.join(workdir, f"params_f_{fusion}.pt"), weights_only=True)
        rel = _hold_run(f"(f) {fusion} seq=2 ring config", got, ref, FUSION_MESH_TOL, params,
                        ref["init"], lr=PARALLEL_LR, steps=FUSION_MESH_STEPS)
        # one process on the attention the ranks' ring config resolves to for a
        # variant (mha_torch, "xla"), so that the clips differ by the mesh alone
        fmc = _fusion_model(cfg, fusion, "float32", attention_impl="xla")
        one = InferencePipeline(fmc, _serving_weights(ref["init"]), cfg.test_cfg, device="cuda")
        want = one.score_videos(_fusion_videos(fmc), cfg.train.buckets, batch_size=2)
        del one
        torch.cuda.empty_cache()
        check(sum(len(w["scores"]) for w in want) > 0, f"(f) {fusion}: one process serves no clip")
        errs = dict.fromkeys(FUSION_SERVE_ATOL, 0.0)
        for r, g in enumerate(got):
            check(g["local"] == [2, 2048] and not g["ring"],
                  f"(f) {fusion} rank {r}: staged {g['local']}, ring {g['ring']}")
            check(not any(g["launches"].values()),
                  f"(f) {fusion} rank {r}: an attention kernel launched {g['launches']}")
            check([x["video_id"] for x in g["scored"]] == [w["video_id"] for w in want]
                  and all(x["labels"] == w["labels"].tolist() for x, w in zip(g["scored"], want)),
                  f"(f) {fusion} rank {r}: the served clips differ from one process's")
            for key in errs:
                errs[key] = max([errs[key]] + [
                    float(np.abs(np.asarray(x[key]) - w[key]).max()) for x, w in
                    zip(g["scored"], want) if len(w[key])])
        check(all(errs[k] <= v for k, v in FUSION_SERVE_ATOL.items()),
              f"(f) {fusion}: served clips {errs} from one process's (bounds {FUSION_SERVE_ATOL})")
        fusion_runs[fusion] = dict(ranks=got, update_rel=rel, serve_max_abs_err=errs)
        print(f"[pipeline] {card}: (f) {fusion} on seq=2 under the ring config, float32: each "
              f"rank staged {got[0]['local']} (the whole rows; no ring, no attention kernel); "
              f"loss/grad norm {json.dumps(got[0]['hist'])} (one process "
              f"{json.dumps(ref['hist'])}; bounds {json.dumps(FUSION_MESH_TOL)}), update rel L2 "
              f"{rel:.3e}; shared-card step ms per rank "
              f"{[[round(x, 1) for x in g['step_ms']] for g in got]}, of it in all_reduces "
              f"{[[round(x, 1) for x in g['hop_ms']] for g in got]}, peak allocated per rank "
              f"{[round(g['peak'] / 2**30, 2) for g in got]} GiB; score_videos of "
              f"{list(FUSION_VIDEOS)} s on the mesh: {sum(len(w['scores']) for w in want)} clips,"
              f" one process's, max abs err {json.dumps(errs)} (bounds "
              f"{json.dumps(FUSION_SERVE_ATOL)}), {[round(g['serve_ms'], 1) for g in got]} ms "
              f"per rank")

    # (e) the train CLI on pipe = 2 under torchrun; phase 16's preflight run
    raw = production_config().to_dict()
    raw["tpu"] = {"mesh": dict(data=1, model=1, seq=1, pipe=2)}  # the schema's mesh section
    cfg_json = os.path.join(workdir, "config_pipe2.json")
    with open(cfg_json, "w") as f:
        json.dump(raw, f)
    run_dir = os.path.join(workdir, "cli")
    t0 = time.perf_counter()
    rc, log = _run_group(_torchrun("-m", "repurpose_tpu_torch.train", "--config_path", cfg_json,
                                   "--synthetic", "8", "--epochs", "1", "--dist_backend", "gloo",
                                   "--share_card", "--workdir", run_dir), timeout=420)
    cli_s = time.perf_counter() - t0
    check(rc == 0, f"train on pipe=2 under torchrun exited {rc}:\n{log[-6000:]}")
    done = re.findall(r"rank (\d)/2 training done: .*'final_loss': ([-+0-9.eE]+|nan)", log)
    check(sorted(r for r, _ in done) == ["0", "1"] and len({x for _, x in done}) == 1
          and np.isfinite(float(done[0][1])), f"the ranks' summaries: {done}\n{log[-3000:]}")
    check("pipeline parallelism: 2 stages x 2 microbatches (1f1b)" in log,
          f"the CLI did not run the 1F1B pipeline:\n{log[-3000:]}")
    check(preflight_log.count("[PASS] pipeline-parallel step (dp x pp)") == 2,
          "phase 16's preflight did not pass its pipeline check on both ranks")
    print(f"[pipeline] {card}: (e) torchrun --nproc_per_node 2 -m repurpose_tpu_torch.train "
          f"(tpu: mesh pipe 2, 1f1b) --synthetic 8 --epochs 1 --dist_backend gloo --share_card: "
          f"exit 0 in {cli_s:.1f} s, both ranks final loss {done[0][1]}; phase 16's preflight "
          f"under torchrun: " + "; ".join(sorted({line.strip() for line in
                                                 preflight_log.splitlines()
                                                 if "dp x pp" in line and "PASS" in line})))
    print(f"[pipeline] {card}: phase 17 {time.perf_counter() - t_phase:.1f} s (the ranks' "
          f"launch {launch_s:.1f} s)")
    return dict(runs=results, ring_op=ring_op, memory_m6=mem, cli_s=cli_s,
                fusion=fusion_runs,
                evaluate={k: dict(tiou=ranks[0][k]["tiou"],
                                  launches=ranks[0][k]["launches"]) for k in evals})


# -- phase 18 -----------------------------------------------------------------

# Phase 18's sizes: (a) the extractors at the published widths on these
# inputs; (b) three videos of these seconds through the preprocessing CLI.
EXTRACT_CLIP_FRAMES = 128
EXTRACT_CNN14_CHUNKS = 512  # one-second chunks at 22 050 samples
EXTRACT_MINILM = (256, 64)  # sentences, tokens
EXTRACT_WHISPER_CHUNKS = 4  # 30 s chunks
EXTRACT_VIDEOS = {"xvid_a": 120, "xvid_b": 347, "xvid_c": 600}
# (a)'s bounds, set before the first run. Float32 on the card (TF32 off)
# against the CPU: the same arithmetic summed in another order, ~1e-6
# relative; 1e-4 absolute on embeddings of unit scale. bf16 against the CPU
# in float32: the bf16 products round every activation to 2**-8 relative,
# through up to 12 layers; each row's cosine at least 0.99.
EXTRACT_F32_ATOL = 1e-4
EXTRACT_BF16_COS = 0.99
# Whisper float32 greedy tokens: equal to the CPU's up to the first position
# where the CPU's ruled logits have a top-2 gap under this (a near tie the
# card may break the other way).
NEAR_TIE_GAP = 1e-3

FAKE_FFMPEG = '''#!{python}
"""Stand-in for {kind} over "videos" that are JSON files
{{"duration": seconds, "seed": n}}: ffprobe prints the duration; ffmpeg
writes one seeded RGB frame a second (rawvideo, the -vf crop's geometry)
or a seeded mono wave (f32le at -ar)."""
import json, sys
import numpy as np
args = sys.argv
path = args[args.index("-i") + 1] if "-i" in args else args[-1]
with open(path) as f:
    spec = json.load(f)
dur = float(spec["duration"])
if {kind!r} == "ffprobe":
    sys.stdout.write(json.dumps({{"format": {{"duration": str(dur)}}}}))
    sys.exit(0)
fmt = args[args.index("-f") + 1]
out = sys.stdout.buffer
rng = np.random.default_rng(spec["seed"])
if fmt == "rawvideo":
    crop = [p for p in args[args.index("-vf") + 1].split(",") if p.startswith("crop=")][0]
    w, h = (int(x) for x in crop[len("crop="):].split(":"))
    for _ in range(int(dur)):
        out.write(rng.integers(0, 256, (h, w, 3), dtype=np.uint8).tobytes())
elif fmt == "f32le":
    sr = int(args[args.index("-ar") + 1])
    t = np.arange(int(dur * sr)) / sr
    wave = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.normal(size=t.size)
    out.write(wave.astype("<f4").tobytes())
else:
    sys.exit(64)
out.flush()
'''


def install_fake_ffmpeg(bin_dir: str) -> str:
    """Writes ``FAKE_FFMPEG`` as ``ffmpeg`` and ``ffprobe`` into ``bin_dir``;
    returns a PATH with ``bin_dir`` first."""
    os.makedirs(bin_dir, exist_ok=True)
    for kind in ("ffmpeg", "ffprobe"):
        path = os.path.join(bin_dir, kind)
        with open(path, "w") as f:
            f.write(FAKE_FFMPEG.format(python=sys.executable, kind=kind))
        os.chmod(path, 0o755)
    return bin_dir + os.pathsep + os.environ.get("PATH", "")


def write_fake_video(path: str, duration: float, seed: int) -> None:
    with open(path, "w") as f:
        json.dump({"duration": duration, "seed": seed}, f)


def hf_clip_vision_shapes(cfg) -> dict:
    """Names and shapes of an HF ``CLIPVisionModelWithProjection`` state dict
    that ``convert_hf_clip_vision`` reads."""
    w, p = cfg.width, "vision_model."
    shapes = {f"{p}embeddings.patch_embedding.weight": (w, 3, cfg.patch_size, cfg.patch_size),
              f"{p}embeddings.class_embedding": (w,),
              f"{p}embeddings.position_embedding.weight": (cfg.num_patches + 1, w),
              "visual_projection.weight": (cfg.projection_dim, w)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        shapes.update({f"{p}{ln}.weight": (w,), f"{p}{ln}.bias": (w,)})
    for i in range(cfg.layers):
        e = f"{p}encoder.layers.{i}."
        for n, (o, k) in {"self_attn.q_proj": (w, w), "self_attn.k_proj": (w, w),
                          "self_attn.v_proj": (w, w), "self_attn.out_proj": (w, w),
                          "mlp.fc1": (cfg.mlp_ratio * w, w), "mlp.fc2": (w, cfg.mlp_ratio * w),
                          "layer_norm1": (w, None), "layer_norm2": (w, None)}.items():
            shapes[f"{e}{n}.weight"] = (o, k) if k else (o,)
            shapes[f"{e}{n}.bias"] = (o,)
    return shapes


def hf_bert_shapes(cfg) -> dict:
    """Names and shapes of an HF ``BertModel`` state dict that
    ``convert_hf_bert`` reads."""
    d, f = cfg.width, cfg.intermediate
    shapes = {"embeddings.word_embeddings.weight": (cfg.vocab_size, d),
              "embeddings.position_embeddings.weight": (cfg.max_position, d),
              "embeddings.token_type_embeddings.weight": (cfg.type_vocab, d),
              "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,)}
    for i in range(cfg.layers):
        e = f"encoder.layer.{i}."
        for n, (o, k) in {"attention.self.query": (d, d), "attention.self.key": (d, d),
                          "attention.self.value": (d, d), "attention.output.dense": (d, d),
                          "attention.output.LayerNorm": (d, None), "intermediate.dense": (f, d),
                          "output.dense": (d, f), "output.LayerNorm": (d, None)}.items():
            shapes[f"{e}{n}.weight"] = (o, k) if k else (o,)
            shapes[f"{e}{n}.bias"] = (o,)
    return shapes


def panns_cnn14_shapes(cfg) -> dict:
    """Names and shapes of a PANNs ``Cnn14`` checkpoint's ``model`` state dict
    that ``convert_panns_cnn14`` reads."""
    def bn(name, c):
        return {f"{name}.{k}": (c,) for k in ("weight", "bias", "running_mean", "running_var")}

    shapes = bn("bn0", cfg.n_mels)
    in_ch = 1
    for i, ch in enumerate(cfg.channels, 1):
        shapes[f"conv_block{i}.conv1.weight"] = (ch, in_ch, 3, 3)
        shapes[f"conv_block{i}.conv2.weight"] = (ch, ch, 3, 3)
        shapes.update(bn(f"conv_block{i}.bn1", ch))
        shapes.update(bn(f"conv_block{i}.bn2", ch))
        in_ch = ch
    shapes.update({"fc1.weight": (cfg.embed_dim, in_ch), "fc1.bias": (cfg.embed_dim,)})
    return shapes


def hf_whisper_shapes(cfg) -> dict:
    """Names and shapes of an HF ``WhisperForConditionalGeneration`` state
    dict that ``convert_hf_whisper`` reads (``proj_out`` is tied)."""
    d, f = cfg.d_model, cfg.d_ff
    attn = {"q_proj": True, "k_proj": False, "v_proj": True, "out_proj": True}
    shapes = {"model.encoder.conv1.weight": (d, cfg.n_mels, 3), "model.encoder.conv1.bias": (d,),
              "model.encoder.conv2.weight": (d, d, 3), "model.encoder.conv2.bias": (d,),
              "model.encoder.embed_positions.weight": (cfg.max_source_positions, d),
              "model.decoder.embed_tokens.weight": (cfg.vocab_size, d),
              "model.decoder.embed_positions.weight": (cfg.max_target_positions, d)}
    for side, n, blocks in (("encoder", cfg.enc_layers, ("self_attn",)),
                            ("decoder", cfg.dec_layers, ("self_attn", "encoder_attn"))):
        shapes[f"model.{side}.layer_norm.weight"] = (d,)
        shapes[f"model.{side}.layer_norm.bias"] = (d,)
        for i in range(n):
            e = f"model.{side}.layers.{i}."
            for blk in blocks:
                for proj, bias in attn.items():
                    shapes[f"{e}{blk}.{proj}.weight"] = (d, d)
                    if bias:
                        shapes[f"{e}{blk}.{proj}.bias"] = (d,)
                shapes[f"{e}{blk}_layer_norm.weight"] = (d,)
                shapes[f"{e}{blk}_layer_norm.bias"] = (d,)
            for n2, shape in (("fc1", (f, d)), ("fc2", (d, f))):
                shapes[f"{e}{n2}.weight"] = shape
                shapes[f"{e}{n2}.bias"] = (shape[0],)
            shapes[f"{e}final_layer_norm.weight"] = (d,)
            shapes[f"{e}final_layer_norm.bias"] = (d,)
    return shapes


def random_checkpoint(shapes: dict, seed: int) -> dict:
    """Seeded random weights for the names and shapes given, as CPU float32
    tensors: matrices, convolutions and tables normal with std
    1/sqrt(fan_in); LayerNorm / BatchNorm scales 1 + N(0, 0.02); biases,
    running means and the class embedding N(0, 0.02); running variances
    uniform in [0.5, 2]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if len(shape) >= 2:
            x = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[1:])), shape)
        elif name.endswith("running_var"):
            x = rng.uniform(0.5, 2.0, shape)
        elif name.endswith(".weight"):
            x = 1.0 + rng.normal(0.0, 0.02, shape)
        else:
            x = rng.normal(0.0, 0.02, shape)
        out[name] = torch.from_numpy(x.astype(np.float32))
    return out


def hf_whisper_config(cfg) -> dict:
    """The fields of an HF Whisper ``config.json`` that ``config_from_hf``
    reads, for ``cfg``."""
    return dict(model_type="whisper", vocab_size=cfg.vocab_size, num_mel_bins=cfg.n_mels,
                d_model=cfg.d_model, encoder_layers=cfg.enc_layers,
                decoder_layers=cfg.dec_layers, encoder_attention_heads=cfg.heads,
                decoder_attention_heads=cfg.heads, encoder_ffn_dim=cfg.d_ff,
                decoder_ffn_dim=cfg.d_ff, max_source_positions=cfg.max_source_positions,
                max_target_positions=cfg.max_target_positions)


class StubTokenizer:
    """Stands in for the HF tokenizers the card's machine lacks: ``__call__``
    has the BERT tokenizer's signature (words hashed onto ids above 999,
    [CLS] 101 ... [SEP] 102, padding 0) and ``decode`` renders Whisper's
    text tokens as " w<id>" pieces (byte-level BPE's concatenation)."""

    def __call__(self, texts, padding="max_length", truncation=True, max_length=64,
                 return_tensors="np"):
        import zlib

        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for r, text in enumerate(texts):
            words = [1000 + zlib.crc32(w.encode()) % 29000 for w in text.split()]
            row = [101, *words[: max_length - 2], 102]
            ids[r, : len(row)] = row
            mask[r, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, ids):
        return "".join(f" w{i}" for i in ids)


def write_extractor_checkpoints(root: str) -> dict:
    """Seeded random checkpoints at the published widths, in the published
    layouts and names, written with ``torch.save``: CLIP ViT-B/32 and
    MiniLM-L6 as HF directories (``pytorch_model.bin``), PANNs CNN14 as a
    ``{"model": ...}`` ``.pth``, Whisper-base as an HF directory with
    ``config.json``. Returns their paths and state dicts."""
    import torch

    from repurpose_tpu_torch.extractors.clip_vit import CLIPVisionConfig
    from repurpose_tpu_torch.extractors.cnn14 import CNN14Config
    from repurpose_tpu_torch.extractors.minilm import MiniLMConfig
    from repurpose_tpu_torch.extractors.whisper_torch import WhisperConfig

    out = {}
    for name, shapes, seed in (("clip", hf_clip_vision_shapes(CLIPVisionConfig()), 11),
                               ("panns", panns_cnn14_shapes(CNN14Config()), 12),
                               ("minilm", hf_bert_shapes(MiniLMConfig()), 13),
                               ("whisper", hf_whisper_shapes(WhisperConfig()), 14)):
        sd = random_checkpoint(shapes, seed)
        if name == "panns":
            path = os.path.join(root, "Cnn14.pth")
            torch.save({"model": sd}, path)
        else:
            path = os.path.join(root, name)
            os.makedirs(path, exist_ok=True)
            torch.save(sd, os.path.join(path, "pytorch_model.bin"))
            if name == "whisper":
                with open(os.path.join(path, "config.json"), "w") as f:
                    json.dump(hf_whisper_config(WhisperConfig()), f)
        out[name] = (path, sd)
    return out


def _hold_extractor(name: str, run, device: str, bf16: bool, width: int) -> dict:
    """``run(device, dtype)`` -> float32 CPU outputs: the card in float32
    within ``EXTRACT_F32_ATOL`` of the CPU, and, where the driver runs it
    in bf16, the card in bf16 with each row (of ``width`` values) at a
    cosine of at least ``EXTRACT_BF16_COS`` to the CPU's."""
    import torch

    t0 = time.perf_counter()
    cpu = run("cpu", "float32")
    t_cpu = time.perf_counter() - t0
    card = run(device, "float32")
    check(bool(torch.isfinite(card).all()) and float(cpu.abs().max()) > 0,
          f"{name}: non-finite or all-zero outputs")
    err = float((card - cpu).abs().max())
    row = dict(name=name, shape=list(cpu.shape), max_abs_err_f32=err,
               max_abs=float(cpu.abs().max()), cpu_s=round(t_cpu, 2))
    check(err <= EXTRACT_F32_ATOL, f"{name}: card float32 {err:.3g} off the CPU")
    if bf16:
        a, b = run(device, "bfloat16").reshape(-1, width), cpu.reshape(-1, width)
        cos = float(torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1).min())
        row["min_row_cos_bf16"] = cos
        check(cos >= EXTRACT_BF16_COS, f"{name}: a bf16 row's cosine {cos:.5f} to the CPU")
    return row


def phase_extractors(card: str, workdir: str, device: str = "cuda") -> dict:
    """Phase 18, the extractors and preprocessing: (a) each extractor on the
    card against the same module on the CPU, (b) the preprocessing CLI on
    three videos, (c) their features scored into clips, (d) the extractor
    bench."""
    import numpy as np
    import torch

    from repurpose_tpu_torch.config import DatasetConfig, ModelConfig, TestConfig
    from repurpose_tpu_torch.data.dataset import RepurposeDataset
    from repurpose_tpu_torch.data.synthetic import synthetic_entry
    from repurpose_tpu_torch.extractors import whisper_torch as wt
    from repurpose_tpu_torch.extractors.clip_vit import (
        CLIP_IMAGE_MEAN,
        CLIP_IMAGE_STD,
        CLIPVisionConfig,
        CLIPVisionEncoder,
        convert_hf_clip_vision,
    )
    from repurpose_tpu_torch.extractors.cnn14 import (
        CNN14,
        convert_panns_cnn14,
        embed_waveform_chunks,
    )
    from repurpose_tpu_torch.extractors.minilm import MiniLMConfig, MiniLMEncoder, convert_hf_bert
    from repurpose_tpu_torch.infer import InferencePipeline
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.preprocessing.pipeline import PreprocessConfig, PreprocessingPipeline

    rng = np.random.default_rng(SEED + 18)
    t_phase = time.perf_counter()
    ckpt = write_extractor_checkpoints(workdir)
    reset_launches()

    # (a) each extractor on the card against the same module on the CPU
    held = {}
    clip_sd = convert_hf_clip_vision(ckpt["clip"][1], CLIPVisionConfig())
    frames = rng.integers(0, 256, (EXTRACT_CLIP_FRAMES, 224, 224, 3), dtype=np.uint8)
    images = torch.from_numpy((frames.astype(np.float32) / 255.0 - CLIP_IMAGE_MEAN)
                              / CLIP_IMAGE_STD)

    @torch.inference_mode()
    def clip_run(dev, dtype):
        m = CLIPVisionEncoder(compute_dtype=dtype, device=dev)
        m.load_state_dict(clip_sd)
        return m(images.to(dev)).float().cpu()

    panns_sd = convert_panns_cnn14(ckpt["panns"][1])
    waves = torch.from_numpy(rng.normal(0, 0.1, (EXTRACT_CNN14_CHUNKS, 22050)).astype(np.float32))

    @torch.inference_mode()
    def cnn14_run(dev, dtype):
        m = CNN14(compute_dtype=dtype, device=dev)
        m.load_state_dict(panns_sd)
        return embed_waveform_chunks(m, waves.to(dev)).float().cpu()

    minilm_sd = convert_hf_bert(ckpt["minilm"][1], MiniLMConfig())
    n_sent, n_tok = EXTRACT_MINILM
    ids = torch.from_numpy(rng.integers(1000, MiniLMConfig().vocab_size, (n_sent, n_tok)))
    lengths = rng.integers(4, n_tok + 1, n_sent)
    mask = torch.from_numpy((np.arange(n_tok)[None] < lengths[:, None]).astype(np.int64))

    @torch.inference_mode()
    def minilm_run(dev, dtype):
        m = MiniLMEncoder(compute_dtype=dtype, device=dev)
        m.load_state_dict(minilm_sd)
        return m(ids.to(dev), mask.to(dev)).float().cpu()

    whisper_dir = ckpt["whisper"][0]
    chunks = (0.1 * rng.normal(size=(EXTRACT_WHISPER_CHUNKS, wt.N_SAMPLES))).astype(np.float32)
    asrs = {}

    def asr(dev, dtype):
        if (dev, dtype) not in asrs:
            asrs[dev, dtype] = wt.WhisperASR.from_hf_dir(
                whisper_dir, tokenizer=StubTokenizer(), compute_dtype=dtype, device=dev)
        return asrs[dev, dtype]

    def whisper_run(dev, dtype):
        return asr(dev, dtype).encode_waves(chunks).float().cpu()

    for name, run, bf16, width in (
            ("clip", clip_run, True, 512), ("cnn14", cnn14_run, True, 2048),
            ("minilm", minilm_run, False, 384), ("whisper_encoder", whisper_run, True, 512)):
        held[name] = _hold_extractor(name, run, device, bf16, width)
        print(f"[extract] {card}: {json.dumps(held[name])}")

    # Whisper float32 greedy: the card's tokens equal the CPU's up to the
    # token the CPU chose at its first near tie (its ruled logits' top-2 gap,
    # read from a teacher-forced pass over its own tokens), or through EOT
    cpu_asr, card_asr = asr("cpu", "float32"), asr(device, "float32")
    prompt = cpu_asr.prompt
    with torch.inference_mode():
        enc_cpu = cpu_asr.encode_waves(chunks)
        tok_cpu = wt.greedy_decode(cpu_asr.decoder, enc_cpu, prompt)
        tok_card = wt.greedy_decode(card_asr.decoder, card_asr.encode_waves(chunks), prompt).cpu()
        logits = cpu_asr.decoder(tok_cpu, enc_cpu)
        suppress = torch.from_numpy(wt._suppress_mask(cpu_asr.cfg))
        p = len(prompt)
        compared = []
        for r in range(tok_cpu.shape[0]):
            upto = tok_cpu.shape[1]
            for pos in range(p - 1, tok_cpu.shape[1] - 1):
                ruled = wt._rules_for_position(logits[r : r + 1, pos], tok_cpu[r : r + 1], pos, p,
                                               cpu_asr.cfg, suppress)[0]
                top2 = torch.topk(ruled, 2).values
                if float(top2[0] - top2[1]) < NEAR_TIE_GAP:
                    upto = pos + 1  # the token chosen at a near tie may differ
                    break
                if int(tok_cpu[r, pos + 1]) == cpu_asr.cfg.eot:
                    upto = pos + 2  # through the row's EOT
                    break
            same = bool((tok_cpu[r, :upto] == tok_card[r, :upto]).all())
            check(same, f"whisper greedy row {r}: the card's tokens leave the CPU's before "
                  f"position {upto} with no near tie")
            compared.append(upto - p)
    n_tokens = [int((row != cpu_asr.cfg.eot).sum()) - p for row in tok_cpu]
    print(f"[extract] {card}: whisper float32 greedy: tokens equal to the CPU's on "
          f"{compared} sampled positions of {n_tokens} per row")
    # beam 5 with word timestamps, through WhisperASR on the card (bf16)
    beam_asr = wt.WhisperASR.from_hf_dir(whisper_dir, tokenizer=StubTokenizer(), beam_size=5,
                                         device=device)
    t0 = time.perf_counter()
    segs = beam_asr.transcribe_wave(chunks.reshape(-1), word_timestamps=True)
    t_beam = time.perf_counter() - t0
    words = [len(s.get("words", [])) for s in segs]
    check(all(np.isfinite([s["start"], s["end"]]).all() for s in segs), "beam: bad segment times")
    print(f"[extract] {card}: whisper bf16 beam 5 + word timestamps on "
          f"{EXTRACT_WHISPER_CHUNKS} x 30 s: {len(segs)} segments, {sum(words)} words "
          f"(per segment {words[:12]}{' ...' if len(words) > 12 else ''}), {t_beam:.2f} s")
    launches = read_launches(*_counted_wrappers())
    check(not any(launches.values()), f"a kernel launched during extraction: {launches}")
    print(f"[extract] kernel launches during (a): {json.dumps(launches)}")

    # (b) the preprocessing CLI on three videos (fake ffmpeg / ffprobe)
    path_env = install_fake_ffmpeg(os.path.join(workdir, "bin"))
    env = dict(os.environ, PATH=path_env)
    video_dir = os.path.join(workdir, "videos")
    os.makedirs(video_dir)
    entries = []
    for i, (vid, dur) in enumerate(EXTRACT_VIDEOS.items()):
        write_fake_video(os.path.join(video_dir, f"{vid}.mp4"), dur, seed=100 + i)
        entries.append(dict(synthetic_entry(rng, dur), youtube_id=vid))
    dataset = os.path.join(workdir, "dataset.json")
    with open(dataset, "w") as f:
        json.dump(entries, f)
    pcfg = PreprocessConfig(
        video_dir=video_dir, visual_dir=os.path.join(workdir, "visual"),
        audio_dir=os.path.join(workdir, "audio"), text_dir=os.path.join(workdir, "text"),
        transcript_dir=os.path.join(workdir, "transcripts"), clip_checkpoint=ckpt["clip"][0],
        panns_checkpoint=ckpt["panns"][0], minilm_checkpoint=ckpt["minilm"][0],
        whisper_checkpoint=whisper_dir)
    config = os.path.join(workdir, "preprocess.json")
    with open(config, "w") as f:
        json.dump(dataclasses.asdict(pcfg), f)

    def cli(*args) -> tuple[dict, float, dict]:
        """Runs the CLI; returns its JSON, its wall time and the time from
        each ``step: <name>`` log line (the pipeline's, at a step's start) to
        the next line of that kind or the exit, read as the lines arrive."""
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "repurpose_tpu_torch.preprocess",
                                 "--dataset", dataset, "--config", config, "--device", device,
                                 *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        out = []
        reader = threading.Thread(target=lambda: out.append(proc.stdout.read()))
        reader.start()
        starts, err = [], []
        for line in proc.stderr:
            err.append(line)
            if "step: " in line:
                starts.append((line.split("step: ", 1)[1].strip(), time.perf_counter()))
        reader.join(timeout=900)
        rc = proc.wait(timeout=900)
        end = time.perf_counter()
        check(rc == 0, f"preprocess {' '.join(args)} exited {rc}:\n{''.join(err)[-3000:]}")
        bounds = [t for _, t in starts[1:]] + [end]
        per_step = {name: b - t for (name, t), b in zip(starts, bounds)}
        return json.loads(out[0][out[0].index("{"):]), end - t0, per_step

    result, seconds, per_step = cli("--steps", "visual", "audio")
    steps = {"process": dict(seconds=round(seconds, 2))}
    for step in ("visual", "audio"):
        done = result[step]["completed"]
        check(done == len(EXTRACT_VIDEOS) and result[step]["failed"] == 0,
              f"preprocess --steps {step}: {result[step]}")
        steps[step] = dict(seconds=round(per_step[step], 2), videos=done)

    class StubTokenizerPipeline(PreprocessingPipeline):
        """The text step in this process, the stub tokenizer handed in where
        ``run_text`` reaches for ``transformers``."""

        def _minilm(self):
            return convert_hf_bert(self._load_state_dict(self.cfg.minilm_checkpoint),
                                   MiniLMConfig()), StubTokenizer()

        def _asr(self):
            return wt.WhisperASR.from_hf_dir(self.cfg.whisper_checkpoint,
                                             tokenizer=StubTokenizer(), device=self.device)

    os.environ["PATH"], saved_path = path_env, os.environ.get("PATH", "")
    try:
        t0 = time.perf_counter()
        result = StubTokenizerPipeline(pcfg, device=device).run_text(list(EXTRACT_VIDEOS))
        steps["text"] = dict(seconds=round(time.perf_counter() - t0, 2),
                             videos=result["completed"])
    finally:
        os.environ["PATH"] = saved_path
    check(result["completed"] == len(EXTRACT_VIDEOS) and result["failed"] == 0,
          f"run_text: {result}")
    report, seconds, _ = cli("--verify")
    steps["verify"] = dict(seconds=round(seconds, 2),
                           complete=report["complete_all_modalities"])
    check(report["complete_all_modalities"] == len(EXTRACT_VIDEOS), f"--verify: {report}")
    print(f"[preprocess] {card}: {sum(EXTRACT_VIDEOS.values())} video-seconds in "
          f"{len(EXTRACT_VIDEOS)} videos: {json.dumps(steps)}")

    # (c) the features of (b) through the dataset into clips with the flagship
    ds = RepurposeDataset(DatasetConfig(label_path=dataset, video_path=pcfg.visual_dir,
                                        audio_path=pcfg.audio_dir, text_path=pcfg.text_dir),
                          use_cache=False)
    check(len(ds) == len(EXTRACT_VIDEOS), f"the dataset kept {len(ds)} of the videos")
    videos = [ds[i] for i in range(len(ds))]
    cfg = ModelConfig()
    # phase 16's decode thresholds: random weights leave no candidate at the
    # default ones
    pipe = InferencePipeline(cfg, build_model(cfg, "cpu", seed=SEED).state_dict(),
                             TestConfig(**PARALLEL_EVAL_TEST), device=device)
    reset_launches()
    t0 = time.perf_counter()
    scored = pipe.score_videos(videos)
    t_score = time.perf_counter() - t0
    clips = read_launches("flash_fwd", "flash_fwd_tc")
    on_card = torch.device(device).type == "cuda"  # CPU tensors take the plain version
    check(clips["flash_fwd_tc"] == clips["flash_fwd"] and (clips["flash_fwd"] > 0) == on_card,
          f"scoring the extracted features: launches {clips}")
    for v, r in zip(videos, scored):
        check(len(r["segments"]) > 0 and np.isfinite(np.asarray(r["scores"])).all(),
              f"{v['video_id']}: no clip or a non-finite score")
        print(f"[preprocess] {card}: {v['video_id']} ({v['duration']} s) -> "
              f"{len(r['segments'])} clips, top "
              f"{np.round(np.asarray(r['segments'][:3]), 1).tolist()}")
    print(f"[preprocess] video -> clips: {len(videos)} videos scored in {t_score * 1e3:.1f} ms, "
          f"launches {json.dumps(clips)}")

    # (d) the extractor bench on the card
    from repurpose_tpu_torch.tools import bench_extractors

    line = bench_extractors.main([] if device == "cuda" else ["--device", device])
    print(f"[extract-bench] {card}: {json.dumps(line)}")
    seconds = time.perf_counter() - t_phase
    print(f"[extract] phase 18 took {seconds:.1f} s")
    return dict(held=held, steps=steps, clip_launches=clips, bench=line, seconds=seconds)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "repurpose_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2])
    if sys.argv[1:2] == ["--pipeline-worker"]:
        return pipeline_worker(sys.argv[2])
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
    reset_launches()
    long_bwd_variants = phase_long_backward_vs_plain()
    long_bwd_launches = read_launches("flash_bwd_dq_stream", "flash_bwd_dkv_stream")
    fused_b6 = phase_fused_at_training_shape()
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
    phase_fusion_variants(card)
    phase_cross_long(card)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_utils_", dir=os.path.join(ROOT, "runs"))
    try:
        utils = phase_utils_and_clis(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_", dir=os.path.join(ROOT, "runs"))
    try:
        parallel = phase_parallel(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_pipeline_", dir=os.path.join(ROOT, "runs"))
    try:
        pipeline = phase_pipeline_and_ring(card, workdir, parallel["preflight_log"],
                                           parallel.pop("fusion_refs"))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_extract_", dir=os.path.join(ROOT, "runs"))
    try:
        extracted = phase_extractors(card, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

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
        daemon=(daemon["launches"]["flash_fwd"], daemon["launches"]["flash_fwd_tc"]),
        video_to_clips=(extracted["clip_launches"]["flash_fwd"],
                        extracted["clip_launches"]["flash_fwd_tc"]))
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
        wide_heads=[r for r in wide if r.get("dh") == WIDE_DH and r["name"].startswith("dense_")
                    or r["name"].startswith(f"model_route_Dh{WIDE_PADDED_DH}_")],
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
            wide_heads=[r for r in wide if r.get("dh") == WIDE_DH
                        and r["name"].startswith("dense_")],
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
        wide_heads=[r for r in wide if r.get("dh") == WIDE_DH
                    and r["name"].startswith("stream_")],
    ))
    long_bwd_head = next(r for r in long_bwd_variants if r["name"] == "unpacked_T32768")
    # the fused long-T backward: flash_backward's route past T = 2048 in bf16
    # at Dh 64, every long-video training step's backward (and the stream
    # wrappers' kernel there)
    r = long_bwd_head["fused"]
    kernels.append(dict(
        name="flash_bwd_fused_tc", route="cuda", source=source + "flash_bwd.cu",
        also_source=source + "flash_bwd_fused.cuh", replaces=f"{fa_line}859",
        also_replaces=[f"{fa_line}{n}" for n in (914, 992, 1200)],
        launches=long_train["flash_bwd_fused_tc"],
        launches_by_path=dict(long_video_training=long_train["flash_bwd_fused_tc"]),
        **{x: r[x] for x in ("max_abs_err", "ms", "min_ms", "max_ms", "with_prep_ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")},
        variant=long_bwd_head["name"], library_note="SDPA's whole backward (dq, dk and dv)",
        variants=[dict(name=v["name"], **v["fused"],
                       dense_pair_ms=v["dense"]["pair_ms"] if "dense" in v else v.get("pair_ms"))
                  for v in long_bwd_variants + [fused_b6] if "fused" in v],
    ))
    # the stream wrappers: in bf16 at Dh 64 the fused kernel above, each
    # keeping its own gradients; the first design's kernels timed in float32
    first_bwd = next(r for r in long_bwd_variants if "dq" in r)
    for name, key, grads, replaces, also in (
        ("flash_bwd_dq_stream", "dq", ("dq",), 859, [914, 992]),
        ("flash_bwd_dkv_stream", "dkv", ("dk", "dv"), 1200, []),
    ):
        r = first_bwd[key]
        kernels.append(dict(
            name=name, route="cuda", source=source + "flash_bwd_stream.cu",
            design="first: float32, and bf16 at Dh 16, 32, 128 and 256; bf16 at Dh 64 the "
                   "fused kernel (flash_bwd_fused_tc)",
            replaces=f"{fa_line}{replaces}", also_replaces=[f"{fa_line}{n}" for n in also],
            launches=long_bwd_launches[name],  # the wrappers called directly (8a)
            launches_by_path=dict(long_video_training=long_train[name],
                                  long_backward_wrappers=long_bwd_launches[name]),
            max_abs_err=r["max_abs_err"], ms=r["ms"], min_ms=r["min_ms"], max_ms=r["max_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=first_bwd["library_ms"], variant=first_bwd["name"],
            fused_max_abs_err={v["name"]: max(v["max_abs_err_by_grad"][x] for x in grads)
                               for v in long_bwd_variants if "fused" in v},
            wide_heads_first_design=[r for r in wide if r.get("dh") == WIDE_DH
                                     and r["name"].startswith("stream_")],
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
    # the head-chunked instances: launched by the model's route at Dh 1000
    # (phase 10), held and timed on every chunked row; the head row is Dh 512
    routes = [r for r in wide if r["name"].startswith("model_route_Dh1000_")]
    timed_keys = ("max_abs_err", "ms", "min_ms", "max_ms", "plain_ms", "bound_ms", "bound_by")

    def chunked_timing(row, part):  # the forward's numbers, or one backward kernel's
        if part is None:
            return {**{x: row[x] for x in timed_keys}, "library_ms": row["library_ms"]}
        return {**{x: row[part][x] for x in timed_keys}, "library_ms": row["bwd_library_ms"]}

    for stream, names in CHUNKED.items():
        prefix = "stream_" if stream else "dense_"
        rows = [r for r in wide if r.get("dh", 0) > WIDE_DH and r["name"].startswith(prefix)]
        head = next(r for r in rows if r["name"] == f"{prefix}unpacked_bfloat16_Dh512")
        fa_lines = ((592, [512, 657]), (859, [914, 992]), (1200, [])) if stream else (
            (227, []), (783, []), (1109, [1149]))
        for name, (line, also), part in zip(names, fa_lines, (None, "dq", "dkv")):
            kernels.append(dict(
                name=name, route="cuda", source=source + "flash_chunked.cu",
                replaces=f"{fa_line}{line}", also_replaces=[f"{fa_line}{n}" for n in also],
                design="head-chunked first design: every Dh past 256",
                launches=sum(x["launches"].get(name, 0) for x in routes),
                launches_by_path=dict(wide_head_model_route={
                    x["name"]: x["launches"].get(name, 0) for x in routes}),
                **chunked_timing(head, part),
                library_note=None if part is None else
                "SDPA's whole backward (dq, dk and dv), against this kernel alone",
                variant=head["name"],
                variants=[dict(name=x["name"], **chunked_timing(x, part)) for x in rows],
            ))
    # phase 16's paths, per rank: the bf16 train steps (tensor-core kernels at
    # H = 8, 4, 8), the float32 tensor-parallel steps (the first designs at
    # H = 4) and the evaluations' forwards
    for k in kernels:
        for name, run in parallel["runs"].items():
            n = run["ranks"][0]["launches"]
            if k["name"] in PARALLEL_TC and PARALLEL_RUNS[name]["dtype"] == "bfloat16":
                k["launches_by_path"][f"parallel_{name}_per_rank"] = n[k["name"]]
            elif (k["name"] in PARALLEL_FIRST and k.get("design", "").startswith("first")
                  and PARALLEL_RUNS[name]["dtype"] == "float32"):
                k["launches_by_path"][f"parallel_{name}_per_rank"] = n[k["name"]]
        if k["name"] == "flash_fwd_tc":
            k["launches_by_path"].update({
                f"parallel_{key}_per_rank": x["launches"]["flash_fwd_tc"]
                for key, x in parallel["evaluate"].items()})
            k["launches_by_path"].update({
                f"pipeline_{key}_per_rank": x["launches"]["flash_fwd_tc"]
                for key, x in pipeline["evaluate"].items()})
        # phase 17's pipe = 2 steps, per rank (a stage of 8 layers, M = 2)
        if k["name"] in PARALLEL_TC:
            for name in ("a_gpipe", "b_1f1b"):
                k["launches_by_path"][f"pipeline_{name}_per_rank"] = (
                    pipeline["runs"][name]["ranks"][0]["launches"][k["name"]])
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
