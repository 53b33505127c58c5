"""The model families. Importing the package registers every family's
constructors (``registry.get_model``), as the JAX package's does."""

from skin_image_analysis_tpu_torch.models.cnn import (  # noqa: F401
    SkinCancerListModel,
    SkinCancerModel,
    build_model,
)
from skin_image_analysis_tpu_torch.models.registry import get_model, register_model  # noqa: F401
from skin_image_analysis_tpu_torch.models import resnet as resnet  # noqa: F401  (registers resnet18/34/50)
from skin_image_analysis_tpu_torch.models import xception as xception  # noqa: F401  (registers xception, xception_small)
from skin_image_analysis_tpu_torch.models import efficientnet as efficientnet  # noqa: F401  (registers efficientnet_b0-b7)
from skin_image_analysis_tpu_torch.models import efficientnet_v2 as efficientnet_v2  # noqa: F401  (registers efficientnet_v2_b0-b3/s/m/l)
from skin_image_analysis_tpu_torch.models import mobilenet as mobilenet  # noqa: F401  (registers mobilenet_v2)
from skin_image_analysis_tpu_torch.models import resnet_v2 as resnet_v2  # noqa: F401  (registers resnet50/101/152_v2)
from skin_image_analysis_tpu_torch.models import vgg as vgg  # noqa: F401  (registers vgg16/vgg19)
