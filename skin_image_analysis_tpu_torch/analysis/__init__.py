from skin_image_analysis_tpu_torch.analysis.experiments import (  # noqa: F401
    compute_ci,
    flatten_record,
    read_experiment,
    read_experiments,
    transpose_dict,
)
