"""Typed configuration dataclasses.

A copy of the JAX package's ``config`` module (``DataConfig``,
``ModelConfig``, ``OptimConfig``, ``MeshConfig``, ``TrainConfig``) with the
same field names and defaults, so that a ``train_config.json`` written by
either package loads in the other. Some fields name options of the JAX
package that the port does not run yet; the code that reads a config
rejects those values where it meets them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset ingest and input-pipeline configuration."""

    root_dir: str = "./tone"
    image_size: int = 224          # model input H = W
    canonical_size: int = 256      # decoded arena frame side
    batch_size: int = 16
    split_ratio: float = 0.7
    balance: bool = True
    decode_workers: int = 8
    prefetch_depth: int = 2
    augment: bool = False          # flip / crop / colour jitter (train)
    normalize_imagenet: bool = False
    input_affine: tuple | None = None  # per-channel (scale, offset) on the
                                   # [0, 1] floats; exclusive with
                                   # normalize_imagenet
    seed: int = 0
    cache_decoded: bool = True
    device_cache: bool = True
    device_cache_max_bytes: int = 8 << 30
    early_commit_min_bytes: int = 1 << 30
    streaming: bool = False
    chunk_size: int = 2048
    stream_cache: bool = False
    drop_remainder: bool = True
    pallas_preprocess: str = "auto"  # the train path's preprocess
                                   # kernel: "auto" (when it augments),
                                   # "on" (every call), "off" (none)
    steps_per_dispatch: int = 8    # train steps per multi-step call

    @property
    def num_classes(self) -> int:
        return 2


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """SkinCancerListModel-family architecture description."""

    name: str = "skin_cancer_list"
    conv_features: tuple[int, ...] = (32, 64, 128)
    first_kernel: int = 7
    kernel: int = 3
    linear_features: tuple[int, ...] = (512, 256)
    dropout: tuple[float, ...] = (0.5, 0.5)
    num_classes: int = 2
    image_size: int = 224
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = False
    fused_pool: bool = True
    pool_mode: str = "auto"        # auto|phase|selector|stock
    stem: str = "auto"             # auto|phase|s2d
    in_channels: int = 3
    freeze_backbone: bool = False

    def __post_init__(self) -> None:
        if len(self.dropout) not in (1, len(self.linear_features)):
            raise ValueError(
                "dropout must have one rate or one per linear layer: "
                f"{self.dropout} vs {self.linear_features}"
            )


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "adam"        # adam | rmsprop | sgd | adamw
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    momentum: float = 0.0
    moment_dtype: str | None = None  # "bfloat16": store adam's mu in bf16
    nu_dtype: str | None = None      # "bfloat16": also nu, lr folded in
    class_weights: tuple[float, ...] | None = None
    auto_class_weights: bool = False
    lr_schedule: str = ""          # "" | "step" | "exponential" | "cosine"
    lr_step_size: int = 0
    lr_gamma: float = 0.1
    lr_decay_steps: int = 0
    lr_warmup_steps: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh description. data axis = DP, model axis = TP."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class HpoConfig:
    """HPO sweep configuration (the reference's constants,
    tone_bias_optuna.py:26-39)."""

    trials: int = 100
    time_limit_hours: float = 16.0
    sample_size: int = 300
    batch_size: int = 32
    epochs: int = 10
    n_train_examples: int = 32 * 12
    n_valid_examples: int = 32 * 4
    population: int = 8            # vmap-stacked trials per wave
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 20
    eval_every: int = 1
    checkpoint_every: int = 0
    results_dir: str = "results"
    experiment_dir: str | None = None
    init_from: str | None = None
    log_every_batches: int = 8
    checkpoint_best: bool = False
    best_metric: str = "loss"
    early_stop_patience: int = 0
    seed: int = 0
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True)


def replace(cfg: Any, **kw: Any) -> Any:
    return dataclasses.replace(cfg, **kw)


def _deep_tuple(value: list) -> tuple:
    """JSON arrays -> hashable nested tuples."""
    return tuple(
        _deep_tuple(v) if isinstance(v, list) else v for v in value
    )


def _build(cls: type, payload: Mapping[str, Any]) -> Any:
    """Build a config dataclass from a mapping; unknown keys are ignored."""
    kwargs: dict[str, Any] = {}
    for field in dataclasses.fields(cls):
        if field.name not in payload:
            continue
        value = payload[field.name]
        if isinstance(value, list):
            value = _deep_tuple(value)
        kwargs[field.name] = value
    return cls(**kwargs)


def train_config_from_dict(payload: Mapping[str, Any]) -> TrainConfig:
    payload = dict(payload)
    for key, sub in (("data", DataConfig), ("model", ModelConfig),
                     ("optim", OptimConfig), ("mesh", MeshConfig)):
        if key in payload and isinstance(payload[key], Mapping):
            payload[key] = _build(sub, payload[key])
    return _build(TrainConfig, payload)
