from skin_image_analysis_tpu_torch.metrics.fairness import (  # noqa: F401
    analyse_predictions,
    confusion_matrix,
    di_from_counts,
    disparate_impact_analysis,
    filter_instances,
    values_counts,
)
from skin_image_analysis_tpu_torch.metrics.auc import roc_auc  # noqa: F401
