"""Hyper-parameter search (port of the JAX package's ``hpo``): the ask/tell
engine, TPE, the ISIC search space, artifact replay, the proxy-training
objective and stacked trial waves."""

from skin_image_analysis_tpu_torch.hpo.study import (  # noqa: F401
    MedianPruner,
    RandomSampler,
    Study,
    Trial,
    TrialPruned,
    TrialReplay,
    create_study,
)
from skin_image_analysis_tpu_torch.hpo.tpe import TPESampler  # noqa: F401
from skin_image_analysis_tpu_torch.hpo.space import (  # noqa: F401
    best_hyperparameters,
    create_best_model_config,
    define_isic_model,
)
