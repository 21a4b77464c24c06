"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries land in ``build/`` beside this
file (git-ignored), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # nvcc's output (ptxas register/spill report) per source

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# C signatures of the entry points, by source name
SIGNATURES = {
    "flash_fwd": {
        "flash_fwd": (
            [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
             _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
    },
    "flash_fwd_stream": {
        "flash_fwd_stream": (
            [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
             _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
    },
    "flash_bwd": {
        "flash_bwd_dq": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
        "flash_bwd_dkv": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{key}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(name: str, job) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file


def build_all() -> list[str]:
    """Compile every ``csrc/*.cu`` whose library is missing, one ``nvcc``
    process per source, all started together. Returns the source names."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    return names


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if needed,
    with the argument and result types of its entry points declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib
