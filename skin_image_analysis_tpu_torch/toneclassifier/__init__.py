from skin_image_analysis_tpu_torch.toneclassifier.class_weight import (  # noqa: F401
    balanced_class_weights,
    count_small_images,
)
from skin_image_analysis_tpu_torch.toneclassifier.classical import ModalItaClassifier  # noqa: F401
from skin_image_analysis_tpu_torch.toneclassifier.split import split_metadata_csv  # noqa: F401
