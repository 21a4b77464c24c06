"""Spans that a traced run records around the program's layers, from the
benchmark's own code: while the stretch is profiled, each function named
here runs inside a ``record_function("gpubench:<layer>")`` span, so that
the idle gaps of ``breakdown`` name the layer the host was in. Nothing is
wrapped in an untraced run. Spans inside the program are a later change.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

# (module, attribute path, span name) by kind of cell
TARGETS = {
    "serve": [
        ("repurpose_tpu_torch.infer", "InferencePipeline.score_videos", "daemon drain"),
        ("repurpose_tpu_torch.data.batching", "pack_batch", "host batch build"),
        ("repurpose_tpu_torch.infer", "InferencePipeline._to_device", "host to device"),
        ("repurpose_tpu_torch.infer", "InferencePipeline._forward", "forward"),
        ("repurpose_tpu_torch.ops.decode", "soft_nms_batch", "soft-nms"),
        ("repurpose_tpu_torch.infer", "_unpack", "device to host and unpack"),
        ("numpy", "load", "npy read"),
    ],
    "train": [
        ("repurpose_tpu_torch.data.loader", "pack_batch", "host batch build"),
        ("repurpose_tpu_torch.train.loop", "batch_to_device", "host to device"),
        ("numpy", "load", "npy read"),
    ],
}


def _wrap(fn, name):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*a, **k):
        with record_function(f"gpubench:{name}"):
            return fn(*a, **k)

    return inner


@contextlib.contextmanager
def recorded(kind: str):
    """The ``kind``'s targets wrapped in spans for the body's length."""
    undo = []
    try:
        for mod, path, name in TARGETS[kind]:
            owner = importlib.import_module(mod)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = owner.__dict__[attr] if attr in vars(owner) else getattr(owner, attr)
            setattr(owner, attr, _wrap(fn, name))
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)
