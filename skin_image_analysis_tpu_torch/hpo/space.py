"""The ISIC model search space + winning configurations (a copy of the
JAX package's ``hpo.space``).

Mirrors the reference's search space (tone_bias_optuna.py:123-173): a
fixed first conv block (out 16–256, kernel 7), 1–6 further k=3 conv
blocks (out 16–256 each, + ReLU + 2x2 pool), then 2–5 linear blocks
(out 16–256, dropout 0.2–0.5), log-softmax head; optimizer in
{Adam, RMSprop, SGD} with log-uniform lr in [1e-5, 1e-1]
(tone_bias_optuna.py:239-241). Instead of building a torch Module the
space materializes (ModelConfig, OptimConfig) pairs for the port's
flagship model family — same architecture grammar.
"""

from __future__ import annotations

from typing import Any

from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig

MAX_EXTRA_CONV_LAYERS = 6


def define_isic_model(
    trial: Any, classes: int = 2, image_size: int = 224,
    compute_dtype: str = "bfloat16",
) -> tuple[ModelConfig, OptimConfig]:
    """Sample one architecture + optimizer from the search space.

    Total pool count is capped so the spatial map never vanishes — the
    generalization of the reference's tracked ``image_size //= 2``
    flatten-size bookkeeping (tone_bias_optuna.py:138-161), which at 224
    permits the full 7 pools.
    """
    max_pools = max(1, image_size.bit_length() - 1)  # floor(log2(size))
    max_extra = max(1, min(MAX_EXTRA_CONV_LAYERS, max_pools - 1))
    first_out = trial.suggest_int("first_conv_out", 16, 256)
    n_conv = trial.suggest_int("n_conv_layers", 1, max_extra)
    conv_features = [first_out] + [
        trial.suggest_int(f"conv_out_{i}", 16, 256) for i in range(n_conv)
    ]
    n_linear = trial.suggest_int("n_linear_layers", 2, 5)
    linear_features = [
        trial.suggest_int(f"linear_out_{i}", 16, 256) for i in range(n_linear)
    ]
    dropouts = [
        trial.suggest_float(f"dropout_{i}", 0.2, 0.5) for i in range(n_linear)
    ]
    optimizer = trial.suggest_categorical(
        "optimizer", ["adam", "rmsprop", "sgd"]
    )
    lr = trial.suggest_float("lr", 1e-5, 1e-1, log=True)

    model_cfg = ModelConfig(
        conv_features=tuple(conv_features),
        first_kernel=7,
        kernel=3,
        linear_features=tuple(linear_features),
        dropout=tuple(dropouts),
        num_classes=classes,
        image_size=image_size,
        compute_dtype=compute_dtype,
    )
    optim_cfg = OptimConfig(optimizer=optimizer, learning_rate=lr)
    return model_cfg, optim_cfg


def best_hyperparameters() -> dict[str, Any]:
    """The winning parameter set from the reference's TRIALS=100 sweep
    (tone_bias_optuna.py:96-110), expressed in this search space's
    parameter names for TrialReplay."""
    return {
        "first_conv_out": 192,
        "n_conv_layers": 3,
        "conv_out_0": 172,
        "conv_out_1": 22,
        "conv_out_2": 86,
        "n_linear_layers": 3,
        "linear_out_0": 227,
        "linear_out_1": 80,
        "linear_out_2": 86,
        "dropout_0": 0.4750108276372097,
        "dropout_1": 0.33605861431570366,
        "dropout_2": 0.26780264501531464,
        "optimizer": "adam",
        "lr": 0.03627331743927454,
    }


def create_best_model_config(
    image_size: int = 224, compute_dtype: str = "bfloat16"
) -> tuple[ModelConfig, OptimConfig]:
    """Replay the winning parameters (reference create_best_model,
    tone_bias_optuna.py:116-121)."""
    from skin_image_analysis_tpu_torch.hpo.study import TrialReplay

    return define_isic_model(
        TrialReplay(best_hyperparameters()),
        image_size=image_size,
        compute_dtype=compute_dtype,
    )
