"""Typed configuration, copied from ``repurpose_tpu/config.py``.

Loads the reference's YAML schema into the same frozen dataclasses the JAX
package uses, so one config file drives both. ``yaml`` is imported inside
``load_config`` only: the machine with the card has no PyYAML, and nothing
on the serving path reads a file.

Knobs that only mean something on the TPU are kept for config compatibility
and read as follows here:

- ``attention_impl``: "xla" is the plain PyTorch attention (``mha_torch``);
  "auto" and "pallas_full" take the CUDA flash forward and backward kernels
  for every T, "pallas" the flash forward with the plain recompute backward;
  "ring" is not ported yet (ROADMAP).
- ``matmul_precision``: ignored. TF32 is off (package docstring), so every
  float32 product already runs at the reference's "highest" precision.
- ``attn_softmax_dtype``: the element type of the kernel's softmax interior,
  as on the TPU.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


@dataclass(frozen=True)
class DatasetConfig:
    """Paths for one split (reference: configs/Repurpose.yaml:1-21)."""

    label_path: str = ""
    video_path: str = ""
    audio_path: str = ""
    text_path: str = ""


@dataclass(frozen=True)
class ModelConfig:
    """MMCT architecture (reference: models/MMCTransformer.py:26-96)."""

    vis_dim: int = 512
    aud_dim: int = 2048
    text_dim: int = 384
    d_model: int = 512
    self_num_layers: int = 16
    text_num_layers: int = 3
    cross_num_layers: int = 3
    num_heads: int = 8
    d_ff: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    max_len: int = 5000
    compute_dtype: str = "bfloat16"  # activations; params stay float32
    attention_impl: str = "auto"  # "auto" | "xla" | "pallas" | "pallas_full" | "ring"
    remat: bool = False
    matmul_precision: str = "default"
    attn_softmax_dtype: str = "bfloat16"
    modalities: tuple[str, ...] = ("visual", "audio", "text")
    reg_activation: str = "relu"
    fusion: str = "concat"

    @property
    def concat_dim(self) -> int:
        dims = {"visual": self.vis_dim, "audio": self.aud_dim, "text": self.text_dim}
        return sum(dims[m] for m in self.modalities)

    def __post_init__(self) -> None:
        if self.d_model % self.num_heads != 0:
            raise ValueError(
                f"d_model={self.d_model} not divisible by num_heads={self.num_heads}"
            )
        bad = set(self.modalities) - {"visual", "audio", "text"}
        if bad or not self.modalities:
            raise ValueError(f"bad modalities: {self.modalities}")
        object.__setattr__(self, "modalities", tuple(self.modalities))
        if self.reg_activation not in ("relu", "softplus"):
            raise ValueError(f"bad reg_activation: {self.reg_activation}")
        if self.fusion not in ("concat", "cross", "bottleneck"):
            raise ValueError(f"bad fusion: {self.fusion}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype: {self.compute_dtype}")
        if self.attention_impl not in ("auto", "xla", "pallas", "pallas_full", "ring"):
            raise ValueError(f"bad attention_impl: {self.attention_impl}")
        if self.matmul_precision not in ("default", "float32", "highest"):
            raise ValueError(f"bad matmul_precision: {self.matmul_precision}")
        if self.attn_softmax_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad attn_softmax_dtype: {self.attn_softmax_dtype}")


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: configs/Repurpose.yaml:33-44).
    ``pipeline_*``, ``shard_opt_state`` and ``rng_impl`` are carried so
    reference-schema files load; the port trains on one card and ignores
    them."""

    seed: int = 1234
    lr: float = 1e-3
    epochs: int = 50
    weight_decay: float = 1e-4
    warmup_epochs: int = 0
    save_epochs: int = 5
    batch_size: int = 6
    eval_freq: int = 1
    intra_epoch_eval_freq: int = 50
    buckets: tuple[int, ...] = (256, 512, 1024, 2048)
    loss_norm: str = "config_batch_size"
    reg_loss_weight: float = 0.0
    pack_sequences: bool = False
    pipeline_microbatches: int = 2
    pipeline_schedule: str = "1f1b"
    grad_accum_steps: int = 1
    shard_opt_state: bool = False
    grad_accum_dtype: str = "float32"
    rng_impl: str = "rbg"

    def __post_init__(self) -> None:
        if not self.buckets or list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be sorted unique, got {self.buckets}")
        if self.loss_norm not in ("config_batch_size", "batch_size"):
            raise ValueError(f"bad loss_norm: {self.loss_norm}")
        if self.rng_impl not in ("rbg", "threefry"):
            raise ValueError(f"bad rng_impl: {self.rng_impl}")
        if self.pipeline_microbatches < 1:
            raise ValueError(
                f"pipeline_microbatches must be >= 1, got {self.pipeline_microbatches}"
            )
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"bad pipeline_schedule: {self.pipeline_schedule}")
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        if self.grad_accum_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad grad_accum_dtype: {self.grad_accum_dtype}")
        if self.grad_accum_steps > 1 and self.batch_size % self.grad_accum_steps:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"grad_accum_steps {self.grad_accum_steps}"
            )


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout of the reference schema's ``tpu:`` section. Carried
    so reference-schema files load; the port runs on one card so far."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1


@dataclass(frozen=True)
class TestConfig:
    """Inference/decode settings (reference: configs/Repurpose.yaml:52-61)."""

    # Not a pytest test class despite the Test* name.
    __test__ = False

    pre_nms_topk: int = 1000
    pre_nms_thresh: float = 0.5
    duration_thresh: float = 10.0
    duration_thresh_max: float = 90.0
    max_seg_per_min: float = 0.3
    nms_sigma: float = 0.5
    min_score: float = 0.01


@dataclass(frozen=True)
class Config:
    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    val_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    test_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    test_cfg: TestConfig = field(default_factory=TestConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)


def _build(cls, raw: Mapping[str, Any], *, extra_keys: Sequence[str] = ()):
    """Construct a dataclass from a raw mapping, erroring on unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(raw) - names - set(extra_keys)
    if unknown:
        raise ValueError(f"unknown keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {k: v for k, v in raw.items() if k in names}
    if "buckets" in kwargs and kwargs["buckets"] is not None:
        kwargs["buckets"] = tuple(kwargs["buckets"])
    return cls(**kwargs)


def load_config(path_or_dict: str | Mapping[str, Any]) -> Config:
    """Load a reference-schema YAML file (or an already-parsed dict, or the
    same schema as a ``.json`` file, which needs no PyYAML).

    The reference's ``distributed:`` section is accepted and ignored. An
    optional ``tpu:`` section may set mesh axes and override model/train
    knobs, exactly as in the JAX package."""
    if isinstance(path_or_dict, Mapping):
        raw = dict(path_or_dict)
    elif str(path_or_dict).endswith(".json"):
        import json

        with open(path_or_dict) as f:
            raw = json.load(f)
    else:
        import yaml  # only file loading needs PyYAML

        with open(path_or_dict) as f:
            raw = yaml.safe_load(f) or {}

    tpu = dict(raw.get("tpu") or {})
    model_raw = dict(raw.get("model") or {})
    model_raw.update(
        {
            k: tpu[k]
            for k in (
                "compute_dtype", "attention_impl", "remat",
                "matmul_precision", "modalities", "fusion", "reg_activation",
            )
            if k in tpu
        }
    )
    if "modalities" in model_raw and model_raw["modalities"] is not None:
        model_raw["modalities"] = tuple(model_raw["modalities"])
    train_raw = dict(raw.get("train") or {})
    train_raw.update(
        {k: tpu[k] for k in
         ("buckets", "loss_norm", "reg_loss_weight", "pack_sequences",
          "pipeline_microbatches", "pipeline_schedule", "grad_accum_steps",
          "grad_accum_dtype", "shard_opt_state") if k in tpu}
    )
    mesh_raw = {k: tpu[k] for k in ("data", "model", "seq", "pipe") if k in tpu}
    if "mesh" in tpu:
        mesh_raw = dict(tpu["mesh"])

    return Config(
        train_dataset=_build(DatasetConfig, raw.get("train_dataset") or {}),
        val_dataset=_build(DatasetConfig, raw.get("val_dataset") or {}),
        test_dataset=_build(DatasetConfig, raw.get("test_dataset") or {}),
        model=_build(ModelConfig, model_raw),
        train=_build(TrainConfig, train_raw),
        mesh=_build(MeshConfig, mesh_raw),
        test_cfg=_build(TestConfig, raw.get("test_cfg") or {}),
    )
