"""The port's bench tools: the counterparts of the repository's root
``tools/`` scripts whose Pallas kernels have Hopper kernels here, and of
root ``bench_extractors.py``:

    python -m repurpose_tpu_torch.tools.bench_attention_fwd [--device cuda|cpu]
    python -m repurpose_tpu_torch.tools.bench_int8_matmul [--device cuda|cpu]
    python -m repurpose_tpu_torch.tools.bench_extractors [JSON_PATH] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card. The kernel
tools' times on the card come from CUDA events around ``n_chain``
back-to-back calls (one stream runs them in order, so no scan is needed);
``bench_extractors`` times whole synchronised runs on the host clock. With
``--device cpu`` they are host-clock times of the CPU path and say nothing
of the card.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def device_line(device: torch.device) -> str:
    """``device: <name>, <power limit>`` as ``nvidia-smi`` prints them, or
    ``device: cpu`` (host clock) for a CPU run."""
    if device.type != "cuda":
        return "device: cpu (host-clock times of the plain versions)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    return f"device: {smi}"


def per_call_ms(fn, device: torch.device, n_chain: int, reps: int = 3) -> float:
    """Median over ``reps`` of the time of ``n_chain`` back-to-back calls of
    ``fn``, divided by ``n_chain``, after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n_chain):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n_chain)
        else:
            t0 = time.perf_counter()
            for _ in range(n_chain):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / n_chain)
    return statistics.median(times)
