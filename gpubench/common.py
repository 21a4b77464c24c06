"""Pieces the drivers share: the configuration as the program takes it and
as the reference reads it, the warm cards' memory, and the percentile."""

from __future__ import annotations

import dataclasses
import gc
import math

import torch

SECTIONS = ("train_dataset", "val_dataset", "test_dataset", "model", "train", "test_cfg", "tpu")


def program_config(raw: dict, seed: int):
    """The port's ``Config`` of a configuration file (the reference schema
    as JSON), with the run's seed as the training seed."""
    from repurpose_tpu_torch.config import load_config

    cfg = load_config({k: v for k, v in raw.items() if k in SECTIONS})
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=seed))


def train_settings(raw: dict) -> dict:
    """The training settings the reference reads: the ``train`` section
    with the ``tpu`` section's buckets, packing and loss normalisation."""
    tpu = raw.get("tpu", {})
    out = {"pack_sequences": False, "loss_norm": "config_batch_size", **raw["train"]}
    out.update({k: tpu[k] for k in ("buckets", "pack_sequences", "loss_norm") if k in tpu})
    return out


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def percentile(values: list[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    the values at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100 * len(s)) - 1)]


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
