"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Libraries land in ``build/`` beside this
file (git-ignored), named by a hash of the source, the ``csrc/*.cuh`` headers
it includes (directly or through another header) and the flags, so an edited
source or header rebuilds and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.

Two host libraries are built here too, from the repository's root
``csrc/`` (read in place) with the host's C++ compiler (``g++`` or ``c++``;
``nvcc``'s host compiler is one) into the same ``build/``, bound with
``ctypes``: the whole-batch feature loader ``npy_loader.cc`` (``probe_npy``,
``batch_load_npy``) and the word aligner's monotonic DTW ``dtw.cc``
(``dtw_path``). Where no compiler or no build is possible, ``available()``
is False and the dataset reads features with numpy, and ``dtw_path`` takes
``_dtw_numpy``, as the JAX package does: this is host work, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
# the repository's host sources, shared with the JAX package: the .npy
# feature loader and the word aligner's DTW
HOST_SOURCES = {name: Path(__file__).resolve().parent.parent / "csrc" / f"{name}.cc"
                for name in ("npy_loader", "dtw")}
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

logger = logging.getLogger(__name__)
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
        "flash_fwd_tc": ([_P] * 11 + [_I] * 4 + [ctypes.c_float, _P], _I),
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
        "flash_bwd_dq_tc": ([_P] * 11 + [_I] * 4 + [ctypes.c_float, _P], _I),
        "flash_bwd_dkv_tc": ([_P] * 12 + [_I] * 4 + [ctypes.c_float, _P], _I),
        "flash_bwd_fused_tc": ([_P] * 14 + [_I] * 4 + [ctypes.c_float, _P], _I),
    },
    "flash_bwd_stream": {
        "flash_bwd_dq_stream": (
            [_P] * 13 + [_I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
        "flash_bwd_dkv_stream": (
            [_P] * 14 + [_I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
        "flash_bwd_stream_prep": ([_P] * 10 + [_I] * 4 + [ctypes.c_float, _P], _I),
    },
    "flash_chunked": {
        "flash_fwd_chunked": ([_P] * 12 + [_I] * 7 + [ctypes.c_float, _P], _I),
        "flash_bwd_dq_chunked": ([_P] * 14 + [_I] * 7 + [ctypes.c_float, _P], _I),
        "flash_bwd_dkv_chunked": ([_P] * 16 + [_I] * 7 + [ctypes.c_float, _P], _I),
    },
    "flash_fwd_nt": {
        "flash_fwd_nt": (
            [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P,
             _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
        "flash_fwd_nt_tc": (
            [_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, _P,
             _I, _I, _I, _I, ctypes.c_float, _P],
            _I,
        ),
    },
    "int8_matmul": {
        "int8_core": ([_P] * 6, _I),
        "int8_matmul": ([_P] * 7, _I),
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


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes with
    ``#include "..."``, directly or through another header, in the order
    first met."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append(path.parent / inc.decode())
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


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


# -- the host libraries (root csrc/npy_loader.cc and csrc/dtw.cc) -----------------

_host: dict[str, ctypes.CDLL | None] = {}
_I64 = ctypes.c_int64
# C signatures of the host libraries' entry points, by source name
HOST_SIGNATURES = {
    "npy_loader": {
        "npy_probe": ([ctypes.c_char_p, ctypes.POINTER(_I64), ctypes.POINTER(_I64)], _I),
        "npy_batch_load_f32": ([ctypes.POINTER(ctypes.c_char_p), _I64, _P, _I64, _I64,
                                ctypes.POINTER(_I64), _I], _I),
    },
    "dtw": {"repurpose_dtw": ([_P, _I, _I, _P, _P], _I)},
}


def _cxx() -> str | None:
    return shutil.which("g++") or shutil.which("c++")


def host_library(name: str = "npy_loader") -> ctypes.CDLL | None:
    """The host library of root ``csrc/<name>.cc``, built at first use (named
    by a hash of the source and the flags); None where it cannot be built or
    loaded."""
    with _lock:
        if name not in _host:
            _host[name] = _build_host(name)
        return _host[name]


def _build_host(name: str) -> ctypes.CDLL | None:
    source = HOST_SOURCES[name]
    cxx = _cxx()
    if cxx is None or not source.exists():
        logger.info("no C++ compiler or no %s: the numpy path runs", source.name)
        return None
    h = hashlib.sha256(source.read_bytes() + " ".join(HOST_FLAGS).encode())
    out = BUILD / f"{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *HOST_FLAGS, str(source), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            logger.warning("building %s failed: the numpy path runs\n%s",
                           source.name, proc.stderr[-500:])
            return None
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        logger.warning("%s unloadable (%s): the numpy path runs", out.name, e)
        return None
    for fn, (argtypes, restype) in HOST_SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def available() -> bool:
    """Whether the host feature loader is built and loaded."""
    return host_library() is not None


def probe_npy(path: str) -> tuple[int, int] | None:
    """(rows, cols) of a float32 C-order 2-D .npy, or None on any mismatch."""
    lib = host_library()
    if lib is None:
        return None
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    if lib.npy_probe(path.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    return int(rows.value), int(cols.value)


def batch_load_npy(paths: list[str], t: int, d: int, n_threads: int = 4, out=None):
    """Loads the files into a zero-padded [len(paths), t, d] float32 batch
    with threaded preads: (batch, rows per file), or None where the loader
    refuses a file (the caller then reads with numpy). ``out``, a C-contiguous
    float32 array of that shape (a reused staging buffer, which holds an
    earlier batch), is loaded into instead of a new one, and its rows past
    each file's length are zeroed here: the library writes only the rows it
    reads."""
    import numpy as np

    lib = host_library()
    if lib is None:
        return None
    n = len(paths)
    reused = out is not None
    if not reused:
        out = np.zeros((n, t, d), np.float32)
    elif (out.shape != (n, t, d) or out.dtype != np.float32
          or not out.flags.c_contiguous or not out.flags.writeable):
        raise ValueError(f"out: a writeable C-contiguous float32 {(n, t, d)} array, got "
                         f"{out.dtype} {out.shape}")
    rows = np.zeros(n, np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.npy_batch_load_f32(arr, n, out.ctypes.data_as(ctypes.c_void_p), t, d,
                                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                                n_threads)
    if rc != 0:
        return None
    if reused:
        for i, r in enumerate(rows):
            out[i, r:] = 0.0
    return out, rows


def dtw_path(cost):
    """Minimum-cost monotonic path through a [n_tokens, n_frames] cost matrix
    (down / right / diagonal steps), ordered start to end, as two int32
    arrays: the word aligner's DTW (extractors/whisper_align.py). Root
    ``csrc/dtw.cc`` where its host library builds, else ``_dtw_numpy``; both
    give the same path."""
    import numpy as np

    cost = np.ascontiguousarray(cost, np.float32)
    n, m = cost.shape
    if n == 0 or m == 0:
        # no cells to traverse; the numpy backtrace would loop forever
        # chasing an unreachable (0, 0) exit
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    lib = host_library("dtw")
    if lib is not None:
        ti = np.zeros(n + m, np.int32)
        tj = np.zeros(n + m, np.int32)
        length = lib.repurpose_dtw(cost.ctypes.data_as(ctypes.c_void_p), n, m,
                                   ti.ctypes.data_as(ctypes.c_void_p),
                                   tj.ctypes.data_as(ctypes.c_void_p))
        if length > 0:
            return ti[:length].copy(), tj[:length].copy()
    return _dtw_numpy(cost)


def _dtw_numpy(cost):
    """Anti-diagonal wavefront DP (the JAX package's host fallback,
    ``repurpose_tpu/native.py``): cells on diagonal d = i + j depend only on
    diagonals d-1 (up / left) and d-2 (the diagonal step), so each wavefront
    is one vectorised min. Ties break as in ``csrc/dtw.cc``."""
    import numpy as np

    n, m = cost.shape
    inf = np.float32(np.inf)
    acc = np.full((n, m), inf, np.float32)
    trace = np.zeros((n, m), np.int8)  # 0 = diag, 1 = up, 2 = left
    for d in range(n + m - 1):
        lo = max(0, d - m + 1)
        hi = min(n - 1, d)
        i = np.arange(lo, hi + 1)
        j = d - i
        c_diag = np.where(
            (i > 0) & (j > 0), acc[np.maximum(i - 1, 0), np.maximum(j - 1, 0)], inf
        )
        c_diag = np.where((i == 0) & (j == 0), 0.0, c_diag)
        c_up = np.where(i > 0, acc[np.maximum(i - 1, 0), j], inf)
        c_left = np.where(j > 0, acc[i, np.maximum(j - 1, 0)], inf)
        # diag < up < left strictly, else left unless up strictly beats both
        best = np.where(
            (c_diag < c_up) & (c_diag < c_left), 0,
            np.where((c_up < c_diag) & (c_up < c_left), 1, 2),
        ).astype(np.int8)
        vals = np.stack([c_diag, c_up, c_left])[best, np.arange(len(i))]
        acc[i, j] = cost[i, j] + vals
        trace[i, j] = best
    ti, tj = [], []
    i, j = n - 1, m - 1
    while True:
        ti.append(i)
        tj.append(j)
        if i == 0 and j == 0:
            break
        if i == 0:
            t = 2
        elif j == 0:
            t = 1
        else:
            t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1], np.int32), np.asarray(tj[::-1], np.int32)
