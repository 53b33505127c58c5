from skin_image_analysis_tpu_torch.data.ingest import (  # noqa: F401
    balance_dataset,
    print_counts,
    read_isic_metadata,
    sample_dataframe,
    shuffle_split,
)
from skin_image_analysis_tpu_torch.data.dataset import LesionTable  # noqa: F401
