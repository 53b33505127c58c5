"""The port's FLOP count against the JAX package's, on the CPU."""

import pytest
import torch

from skin_image_analysis_tpu.config import ModelConfig as JModelConfig
from skin_image_analysis_tpu.utils import flops as jflops
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.utils import flops as tflops


@pytest.mark.parametrize("stem", ["phase", "s2d"])
def test_forward_flops_per_img_matches_jax(stem):
    """The flagship at 224: the phase-packed 8x8/s2 stem or the 5x5 s2d
    stem, both packages counting the lowering they run, to 1e-9."""
    got = tflops.forward_flops_per_img(ModelConfig(stem=stem,
                                                   image_size=224))
    want = jflops.forward_flops_per_img(
        JModelConfig(stem=stem, image_size=224, compute_dtype="bfloat16"))
    assert got == pytest.approx(want, rel=1e-9)


def test_contraction_flops_counts_convs_and_matmuls_only():
    x = torch.empty(2, 3, 8, 8, device="meta")
    w = torch.empty(4, 3, 3, 3, device="meta")
    a = torch.empty(5, 6, device="meta")
    b = torch.empty(6, 7, device="meta")

    def fn():
        y = torch.relu(torch.nn.functional.conv2d(x, w, padding=1))
        return torch.softmax(a @ b, dim=-1), y.sum()

    assert tflops.contraction_flops(fn) == 2 * 2 * 4 * 8 * 8 * 27 + 2 * 5 * 7 * 6
