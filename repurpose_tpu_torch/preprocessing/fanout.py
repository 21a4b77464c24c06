"""Host-parallel chunk fan-out runner for preprocessing: the port of
``repurpose_tpu/preprocessing/fanout.py``, whose workers run
``python -m repurpose_tpu_torch.preprocess`` (root ``preprocess.py`` is the
JAX package's CLI).

Capability parity with the reference's SLURM fan-out layer, host-local
instead of sbatch:

- ``preprocessing/submit_parallel_jobs.sh`` — chunk discovery
  (``{type}_chunk_*.json``, or ``*_chunk_*.json`` for "all"), ``--num-jobs``
  limit, ``--dry-run`` preview of the exact commands, submission summary.
- ``preprocessing/slurm_preprocessing_job.sh:108-133`` — per-chunk worker
  invoking the pipeline CLI and dropping ``{chunk}_SUCCESS`` /
  ``{chunk}_FAILED`` marker files next to the outputs.

The reference fans out one SLURM GPU job per chunk; here it is one host
worker process per chunk (bounded by ``workers``): the extractor batches of
the workers share the card, so the win is in the host stages (download,
ffmpeg decode, I/O), as in the reference's per-chunk jobs. Markers make
reruns resumable: chunks with a ``_SUCCESS`` marker are skipped, ``_FAILED``
chunks rerun only with ``retry_failed``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shlex
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

# A command template that replaces the real per-chunk worker (the tests'
# seam, as a fake ffmpeg on PATH is the media tests'). "{chunk}" is
# substituted.
WORKER_ENV = "REPURPOSE_FANOUT_WORKER"
# the directory that holds the repurpose_tpu_torch package
_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def find_chunks(splits_dir: str, dataset_type: str = "all") -> list[str]:
    """Chunk discovery (submit_parallel_jobs.sh:106-111): ``*_chunk_*.json``
    for "all", else ``{type}_chunk_*.json``."""
    pat = "*_chunk_*.json" if dataset_type == "all" else f"{dataset_type}_chunk_*.json"
    return sorted(glob.glob(os.path.join(splits_dir, pat)))


@dataclasses.dataclass
class ChunkResult:
    chunk: str
    status: str  # success | failed | skipped_success | skipped_failed | would_run
    rc: int | None = None
    log: str | None = None
    duration_s: float = 0.0


def _marker(markers_dir: str, chunk: str, kind: str) -> str:
    name = os.path.splitext(os.path.basename(chunk))[0]
    return os.path.join(markers_dir, f"{name}_{kind}")


def _worker_cmd(chunk: str, steps: Sequence[str], config: str | None,
                device: str = "cuda") -> list[str]:
    override = os.environ.get(WORKER_ENV)
    if override:
        tpl = shlex.split(override)
        return [a.replace("{chunk}", chunk) for a in tpl]
    cmd = [
        sys.executable, "-m", "repurpose_tpu_torch.preprocess",
        "--dataset", chunk, "--steps", *steps, "--device", device,
    ]
    if config:
        cmd += ["--config", config]
    return cmd


def _worker_env() -> dict:
    """The environment of a worker: this one, with the directory holding
    ``repurpose_tpu_torch`` first on PYTHONPATH (``-m`` imports from there
    whatever the working directory)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [_PACKAGE_ROOT, env.get("PYTHONPATH")]))
    return env


def run_fanout(
    chunks: Sequence[str],
    steps: Sequence[str] = ("download", "visual", "audio", "text"),
    *,
    workers: int = 2,
    limit: int | None = None,
    dry_run: bool = False,
    retry_failed: bool = False,
    markers_dir: str | None = None,
    config: str | None = None,
    device: str = "cuda",
) -> dict:
    """Run each chunk through a worker subprocess (``--device`` passed
    through); write per-chunk markers.

    Returns a summary dict ``{requested, run, succeeded, failed, skipped,
    results: [ChunkResult...]}`` — the host-local counterpart of the
    reference's sbatch submission report (submit_parallel_jobs.sh:124-139).
    """
    chunks = list(chunks)
    requested = len(chunks)
    if limit is not None and limit < len(chunks):
        # "Limiting to first N chunks" (submit_parallel_jobs.sh:124-128)
        chunks = chunks[:limit]
    if markers_dir is None:
        markers_dir = os.path.dirname(chunks[0]) if chunks else "."
    os.makedirs(markers_dir, exist_ok=True)

    results: list[ChunkResult] = []
    to_run: list[str] = []
    for c in chunks:
        if os.path.exists(_marker(markers_dir, c, "SUCCESS")):
            results.append(ChunkResult(c, "skipped_success"))
        elif os.path.exists(_marker(markers_dir, c, "FAILED")) and not retry_failed:
            results.append(ChunkResult(c, "skipped_failed"))
        else:
            to_run.append(c)

    if dry_run:
        for c in to_run:
            cmd = _worker_cmd(c, steps, config, device)
            print(f"DRY RUN: would run: {shlex.join(cmd)}")
            results.append(ChunkResult(c, "would_run"))
        return _summarize(requested, results)

    def run_one(c: str) -> ChunkResult:
        cmd = _worker_cmd(c, steps, config, device)
        log_path = _marker(markers_dir, c, "log.txt")
        t0 = time.time()
        # a stale FAILED marker from a previous attempt must not survive a
        # successful retry (the reference leaves both; one marker is truthier)
        for kind in ("SUCCESS", "FAILED"):
            try:
                os.remove(_marker(markers_dir, c, kind))
            except OSError:
                pass
        with open(log_path, "w") as log:
            log.write(f"+ {shlex.join(cmd)}\n")
            log.flush()
            try:
                rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                    env=_worker_env()).returncode
            except OSError as e:  # worker binary missing/unspawnable
                log.write(f"spawn failed: {e}\n")
                rc = 127
        dur = time.time() - t0
        kind = "SUCCESS" if rc == 0 else "FAILED"
        with open(_marker(markers_dir, c, kind), "w") as f:
            f.write(json.dumps({"rc": rc, "duration_s": round(dur, 2),
                                "steps": list(steps)}) + "\n")
        return ChunkResult(c, "success" if rc == 0 else "failed", rc, log_path, round(dur, 2))

    if to_run:
        with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            results.extend(ex.map(run_one, to_run))
    return _summarize(requested, results)


def _summarize(requested: int, results: list[ChunkResult]) -> dict:
    by = lambda s: sum(1 for r in results if r.status == s)  # noqa: E731
    return {
        "requested": requested,
        "run": by("success") + by("failed"),
        "succeeded": by("success"),
        "failed": by("failed"),
        "skipped": by("skipped_success") + by("skipped_failed"),
        "would_run": by("would_run"),
        "results": [dataclasses.asdict(r) for r in results],
    }
