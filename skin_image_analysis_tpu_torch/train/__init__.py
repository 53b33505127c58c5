from skin_image_analysis_tpu_torch.train.state import TrainState, create_train_state  # noqa: F401
from skin_image_analysis_tpu_torch.train.step import make_eval_step, make_train_step  # noqa: F401
