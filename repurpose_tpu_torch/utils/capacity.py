"""Device-memory capacity model of the port's train step: does (bucket,
batch) fit on the card, and what is the largest bucket that does?

The counterpart of ``repurpose_tpu/utils/capacity.py`` (the reference's
memory-requirement model of detect_gpu_setup.py), rewritten for what the
port keeps on an H100 in one eager PyTorch step (``train/step.py``):

- ``param_count`` is exact for the concat MMCT;
- ``estimate_train_bytes`` adds, term by term, the float32 weights, their
  gradients and Adam's two moments; the activations autograd saves for the
  backward (bf16 tensors, float32 LayerNorm inputs, dropout masks, the
  attention's LSE and no score matrix with the flash kernels); the bf16
  copies of the weights the Dense layers save; one layer's backward
  transients (with ``remat`` the recomputed layer as well); and the device
  batch. The step's peak is the larger of the backward's and the optimizer
  step's (foreach Adam's two gradient-sized temporaries);
- ``device_memory_bytes`` reads the card's memory from
  ``torch.cuda.get_device_properties``; there is no default figure;
- ``measured_memory`` runs a real train step on the card and returns the
  allocator's peak, the ground truth the estimate is held to.

The estimate carries no fudge factor: it is held at or above the measured
peak at the production step and the long-video remat step on the card
(``chip_smoke.py``, PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from repurpose_tpu_torch.config import ModelConfig, TrainConfig


def param_count(cfg: ModelConfig) -> int:
    """Parameter count of the concat-fusion MMCT, exact."""
    d, dff, h = cfg.d_model, cfg.d_ff, cfg.hidden_dim
    per_layer = (
        (d * 3 * d + 3 * d)  # qkv
        + (d * d + d)  # out
        + (d * dff + dff) + (dff * d + d)  # ffn
        + 4 * d  # 2 LayerNorms
    )
    head = 2 * d + d * h + h + h * h + h  # norm + dense_0 + dense_1
    heads = (head + h * 1 + 1) + (head + h * 2 + 2)  # cls(->1) + reg(->2)
    stem = (cfg.concat_dim * d + d) + 2 * d + (d * d + d) + 2 * d  # proj+norms+fmap
    return cfg.self_num_layers * per_layer + stem + heads + 2 * d  # encoder_norm


def _layer_bytes_per_token(cfg: ModelConfig, act: int) -> int:
    """Bytes one encoder layer saves for its backward, per token: the two
    LayerNorms' float32 inputs, the qkv projection's input and output, the
    attention's output and float32 LSE (one per head; the flash kernels keep
    no score matrix), the FFN's input, ReLU output and second input, in the
    compute dtype, and the three dropout masks (one byte an element)."""
    d, dff = cfg.d_model, cfg.d_ff
    masks = (2 * d + dff) if cfg.dropout > 0 else 0
    return 2 * 4 * d + act * (6 * d + 2 * dff) + 4 * cfg.num_heads + masks


def _stem_bytes_per_token(cfg: ModelConfig, act: int) -> int:
    """Bytes the layers around the encoder save, per token: the concat
    (input projection), the float32 inputs of the input, encoder and feature
    norms, the feature map's input and ReLU output and its dropout mask, and
    in each head the norm's float32 input, the Dense inputs and ReLU
    outputs, the masks and the float32 input of the last Dense."""
    d, h = cfg.d_model, cfg.hidden_dim
    mask = 1 if cfg.dropout > 0 else 0
    head = 4 * d + act * d + 3 * act * h + 4 * h + mask * 2 * h
    return act * cfg.concat_dim + 3 * 4 * d + 2 * act * d + mask * d + 2 * head


def estimate_train_bytes(
    cfg: ModelConfig,
    batch: int,
    bucket: int,
    grad_accum_steps: int = 1,
    grad_accum_dtype: str = "float32",
    zero1_dp: int = 1,
) -> dict:
    """Byte estimate of one train step's peak on one card.

    Terms:
    - state: float32 weights and their float32 gradients, Adam's m and v
      (float32, /``zero1_dp``), and with ``grad_accum_steps`` > 1 the
      summed gradients in ``grad_accum_dtype`` beside each chunk's own;
    - weight copies: under bf16 compute each Dense layer casts its weight
      to bf16 and saves the copy for the backward (~2 bytes a parameter);
    - activations: every encoder layer's saved tensors
      (``_layer_bytes_per_token``) over the rows one chunk holds, or with
      ``remat`` only each layer's bf16 input plus the recomputed layer; the
      layers around the encoder (``_stem_bytes_per_token``); one layer's
      backward transients (its gradients, the size of what it saved);
      ``attention_impl="xla"`` adds the plain attention's three float32
      [B, H, T, T] tensors per layer (one layer with remat);
    - the device batch: the float32 features and the per-token targets,
      mask, segments and positions (25 bytes a token);
    - the optimizer step: foreach Adam's weight-decayed gradient copy and
      sqrt(v), two float32 tensors of the parameters' size, once the
      activations are freed.
    The peak is the state plus the larger of the backward's and the
    optimizer step's transients.
    """
    n = param_count(cfg)
    act = 2 if cfg.compute_dtype == "bfloat16" else 4
    accum = max(int(grad_accum_steps), 1)
    b, t, d = batch, bucket, cfg.d_model
    grad_bytes = 4 * n
    if accum > 1:
        grad_bytes += n * (2 if grad_accum_dtype == "bfloat16" else 4)
    state_bytes = 4 * n + 2 * 4 * n // max(int(zero1_dp), 1) + grad_bytes
    weight_copies = 2 * n if act == 2 else 0
    bc = -(-b // accum)  # the rows one accumulation chunk holds
    layer = bc * t * _layer_bytes_per_token(cfg, act)
    if cfg.remat:
        acts = cfg.self_num_layers * bc * t * d * act + 2 * layer
    else:
        acts = cfg.self_num_layers * layer + layer
    acts += bc * t * _stem_bytes_per_token(cfg, act)
    if cfg.attention_impl == "xla":
        quad = 3 * 4 * bc * cfg.num_heads * t * t
        acts += quad if cfg.remat else quad * cfg.self_num_layers
    inputs = b * t * (4 * cfg.concat_dim + 25)
    optimizer_bytes = 2 * 4 * n
    total = state_bytes + inputs + max(weight_copies + acts, optimizer_bytes)
    return {
        "params": n,
        "state_bytes": state_bytes,
        "weight_copy_bytes": weight_copies,
        "activation_bytes": acts,
        "input_bytes": inputs,
        "optimizer_bytes": optimizer_bytes,
        "total_bytes": total,
    }


def device_memory_bytes(device="cuda", memory_bytes: float | None = None) -> float:
    """The memory of ``device``: ``memory_bytes`` when given, else the CUDA
    card's total memory. Raises for any other device without
    ``memory_bytes``: there is no default figure."""
    import torch

    if memory_bytes is not None:
        return float(memory_bytes)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no memory figure for {dev}: pass memory_bytes")
    from repurpose_tpu_torch import resolve_device

    return float(torch.cuda.get_device_properties(resolve_device(dev)).total_memory)


def capacity_table(
    cfg: ModelConfig,
    batch: int,
    buckets: Iterable[int],
    memory_bytes: float | None = None,
    device="cuda",
    **train_knobs,
) -> list[dict]:
    """One row per bucket: the estimate and whether it fits the device's
    memory (``device_memory_bytes``). ``train_knobs`` pass through to
    ``estimate_train_bytes``."""
    mem = device_memory_bytes(device, memory_bytes)
    rows = []
    for t in buckets:
        est = estimate_train_bytes(cfg, batch, t, **train_knobs)
        rows.append(
            {
                "bucket": int(t),
                "batch": batch,
                "est_gb": round(est["total_bytes"] / 1e9, 2),
                "memory_gb": round(mem / 1e9, 1),
                "fits": bool(est["total_bytes"] < mem),
            }
        )
    return rows


def max_safe_bucket(
    cfg: ModelConfig, batch: int, memory_bytes: float | None = None, cap: int = 1 << 17,
    device="cuda", **train_knobs,
) -> int:
    """Largest power-of-two bucket (from 256) whose train step fits the
    estimate; 0 when none does."""
    mem = device_memory_bytes(device, memory_bytes)
    best = 0
    t = 256
    while t <= cap:
        if estimate_train_bytes(cfg, batch, t, **train_knobs)["total_bytes"] < mem:
            best = t
        t *= 2
    return best


def _full_batch(cfg: ModelConfig, train_cfg: TrainConfig, bucket: int, seed: int):
    """A host batch of ``train_cfg.batch_size`` rows of ``bucket`` with every
    position valid (the most a step can hold): packed, two synthetic videos
    a row, head to tail; unpacked, one video of ``bucket`` seconds a row."""
    import numpy as np

    from repurpose_tpu_torch.data.batching import collate, pack_batch
    from repurpose_tpu_torch.data.synthetic import synthetic_sample

    rng = np.random.default_rng(seed)
    b = train_cfg.batch_size
    packed = train_cfg.pack_sequences
    durs = [bucket // 2, bucket - bucket // 2] * b if packed else [bucket] * b
    # a sample of duration d holds d + 1 seconds (both ends of the range)
    samples = [synthetic_sample(rng, d - 1, cfg) for d in durs]
    if [s["duration"] for s in samples] != durs:
        raise RuntimeError("synthetic samples of unexpected length")
    if packed:
        return pack_batch(samples, [[2 * i, 2 * i + 1] for i in range(b)], bucket, b)
    return collate(samples, (bucket,), b)


def measured_memory(cfg: ModelConfig, train_cfg: TrainConfig, bucket: int,
                    device="cuda", seed: int = 0) -> dict:
    """The ground truth: the allocator's peak over one real train step on
    the card (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``) at ``train_cfg.batch_size`` full rows of
    ``bucket`` (packed when ``train_cfg.pack_sequences``), less what the
    process held before the call (0 in a fresh process). A first step runs
    before the measured one, so Adam's moments exist, as in every later
    step."""
    import torch

    from repurpose_tpu_torch import resolve_device
    from repurpose_tpu_torch.models import build_model
    from repurpose_tpu_torch.train.state import TrainState, make_optimizer
    from repurpose_tpu_torch.train.step import batch_to_device, make_train_step

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measured_memory reads the CUDA allocator, not {dev}")
    train_cfg = dataclasses.replace(train_cfg, buckets=(bucket,))
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    model = build_model(cfg, dev, seed)
    optimizer, schedule = make_optimizer(model, train_cfg, 1)
    state = TrainState(model, optimizer)
    step = make_train_step(cfg, train_cfg, schedule)
    batch = batch_to_device(_full_batch(cfg, train_cfg, bucket, seed), dev)
    step(state, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    metrics = step(state, batch)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    loss = float(metrics["loss"])
    del state, optimizer, model, batch, metrics
    torch.cuda.empty_cache()
    return {"peak_bytes": int(peak - before), "batch": train_cfg.batch_size, "bucket": bucket,
            "packed": bool(train_cfg.pack_sequences), "remat": bool(cfg.remat),
            "loss": loss}
