from skin_image_analysis_tpu_torch.utils import jsonl as jsonl  # noqa: F401
