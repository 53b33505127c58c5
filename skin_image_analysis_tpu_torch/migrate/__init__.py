"""Migration from the reference framework (port of the JAX package's
``migrate``).

- :mod:`.torch_pickle`: a safe reader of torch ``.pth`` zipfile
  checkpoints (a stub unpickler: nothing from the pickle is imported or
  run);
- :mod:`.reference`: the reference's whole-module ``session_model.pth``
  pickles and whole experiment folders into the port's artifacts;
- :mod:`.keras_model`: the reference TF pipeline's saved ``.keras``
  transfer model into the same artifacts (needs keras).
"""

from skin_image_analysis_tpu_torch.migrate.keras_model import (
    KerasImportError,
    import_keras_experiment,
    import_keras_model,
)
from skin_image_analysis_tpu_torch.migrate.reference import (
    import_reference_experiment,
    import_reference_model,
)
from skin_image_analysis_tpu_torch.migrate.torch_pickle import (
    TorchPickleError,
    load_pth,
    named_modules,
    named_tensors,
)

__all__ = [
    "KerasImportError",
    "TorchPickleError",
    "import_keras_experiment",
    "import_keras_model",
    "import_reference_experiment",
    "import_reference_model",
    "load_pth",
    "named_modules",
    "named_tensors",
]
