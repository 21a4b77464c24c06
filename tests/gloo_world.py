"""Worlds of gloo (or NCCL) worker processes for the port's parallel tests.

A worker is a script run as ``python -c SCRIPT rank world root``; it starts
its process group over a ``file://`` store under ``root`` (so no port is
shared between test workers) with a collective timeout, runs its cases and
writes ``root/out{world}_rank{rank}.pt``. ``start`` launches every world at
once; ``results`` waits for them (killing all on a failure or a time-out,
so a deadlock fails instead of hanging) and loads what they wrote.
"""

import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent

# the head of every worker script: its rank, world and directory, one torch
# thread, and the process group with a timeout on every collective
PREAMBLE = r'''
import sys
from datetime import timedelta
import torch
import torch.distributed as dist
rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
if BACKEND == "nccl":
    torch.cuda.set_device(rank)
dist.init_process_group(BACKEND, init_method=f"file://{root}/store{world}", rank=rank,
                        world_size=world, timeout=timedelta(seconds=120))
'''


def start(script: str, root, worlds, backend: str = "gloo") -> list:
    """Starts every rank of every world in ``worlds`` running ``script``
    (``backend`` "nccl": rank r on card r)."""
    # the repository and its tests directory (a worker may import a test
    # module by name: ``tests`` is no package, and another may be installed)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    head = PREAMBLE.replace("BACKEND", repr(backend))
    return [(w, subprocess.Popen([sys.executable, "-c", head + script, str(r), str(w),
                                  str(root)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True, env=env, cwd=str(ROOT)))
            for w in worlds for r in range(w)]


def results(procs, root, timeout: float = 300) -> dict:
    """{world: [each rank's results]} once every rank has exited 0."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for _, p in procs]
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
    for (_, p), log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    worlds = sorted({w for w, _ in procs})
    return {w: [torch.load(Path(root) / f"out{w}_rank{r}.pt", weights_only=False)
                for r in range(w)] for w in worlds}
