"""Attribution methods (port of the JAX package's ``explain.attribution``):
Integrated Gradients, saliency, SmoothGrad, GradientShap and Grad-CAM.

Each takes a model of the port in eval mode (``model(x)`` returns float32
log-probs), NHWC input ``x`` ``[B, H, W, C]`` and the target classes
``[B]``, and returns NHWC attributions (Grad-CAM: ``[B, h, w]`` maps).
Gradients are taken with respect to the input only. The many-pass
methods run their passes (interpolation steps, noise samples) as rows of
one batch, at most :data:`ROWS_PER_PASS` rows a forward and backward: an
eval-mode model treats rows independently, so a pass of k steps of B
images gives each image's gradients as k separate passes would. The
gradients are summed in float32. Randomness comes from an explicit
``torch.Generator`` on the input's device.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from skin_image_analysis_tpu_torch.models.cnn import SkinCancerListModel

# Rows a forward and backward holds: the flagship's train batch, which the
# card holds at 224².
ROWS_PER_PASS = 256


def _target_sum(log_probs: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    return log_probs.gather(1, target[:, None]).sum()


def _input_grad(model: nn.Module, x: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """d (sum over rows of the target log-prob) / d x: each row's own
    gradient, since the rows are independent."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(_target_sum(model(x), target), x)[0]


def _chunks(n: int, rows: int):
    """Slices of ``range(n)`` of at most ``ROWS_PER_PASS // rows`` (at
    least 1) items: the passes of n variants of a ``rows``-row batch."""
    per = max(1, ROWS_PER_PASS // rows)
    return (slice(i, i + per) for i in range(0, n, per))


def _pass_grads(model: nn.Module, inputs: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """``inputs`` ``[k, B, ...]``: their float32 input gradients, from one
    forward and backward of k * B rows."""
    k = inputs.shape[0]
    g = _input_grad(model, inputs.flatten(0, 1), target.repeat(k))
    return g.float().reshape(inputs.shape)


def integrated_gradients(model: nn.Module, x: torch.Tensor,
                         target: torch.Tensor,
                         baseline: torch.Tensor | None = None,
                         n_steps: int = 200) -> torch.Tensor:
    """IG attribution ``[B, H, W, C]``: (x - x0) times the mean gradient
    along the straight path from ``baseline`` (default zeros) to x, by the
    Riemann-right rule: alpha = (i + 1) / n_steps."""
    if baseline is None:
        baseline = torch.zeros_like(x)
    diff = x - baseline
    alphas = torch.arange(n_steps, dtype=torch.float32,
                          device=x.device) + 1.0
    alphas = (alphas / n_steps).reshape(-1, *([1] * x.dim()))
    total = torch.zeros_like(x, dtype=torch.float32)
    for steps in _chunks(n_steps, x.shape[0]):
        total += _pass_grads(model, baseline + alphas[steps] * diff,
                             target).sum(0)
    return diff * total / n_steps


def saliency(model: nn.Module, x: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """|d target log-prob / d x| (Captum's Saliency)."""
    return _input_grad(model, x, target).abs()


def smoothgrad(model: nn.Module, x: torch.Tensor, target: torch.Tensor,
               generator: torch.Generator, n_samples: int = 25,
               sigma: float = 0.1) -> torch.Tensor:
    """NoiseTunnel-style smoothed saliency: the mean over ``n_samples``
    draws of Gaussian input noise (std ``sigma``) of |d score / d x|."""
    noise = torch.randn((n_samples, *x.shape), generator=generator,
                        device=x.device, dtype=x.dtype)
    total = torch.zeros_like(x, dtype=torch.float32)
    for samples in _chunks(n_samples, x.shape[0]):
        total += _pass_grads(model, x + sigma * noise[samples],
                             target).abs().sum(0)
    return total / n_samples


def gradient_shap(model: nn.Module, x: torch.Tensor, target: torch.Tensor,
                  generator: torch.Generator,
                  baselines: torch.Tensor | None = None,
                  n_baselines: int = 8, n_steps: int = 32,
                  sigma: float = 0.09) -> torch.Tensor:
    """GradientShap: the mean over baselines of IG from that baseline
    (broadcast over the batch) to x plus one draw of Gaussian noise (std
    ``sigma``). ``baselines`` ``[n, H, W, C]``; by default ``n_baselines``
    uniform draws."""
    if baselines is None:
        baselines = torch.rand((n_baselines, *x.shape[1:]),
                               generator=generator, device=x.device,
                               dtype=x.dtype)
    noise = torch.randn((baselines.shape[0], *x.shape), generator=generator,
                        device=x.device, dtype=x.dtype)
    total = torch.zeros_like(x, dtype=torch.float32)
    for baseline, eps in zip(baselines, noise):
        total += integrated_gradients(model, x + sigma * eps, target,
                                      baseline.expand_as(x), n_steps)
    return total / baselines.shape[0]


def _normalized_cam(activation: torch.Tensor,
                    grads: torch.Tensor) -> torch.Tensor:
    """relu(sum_c mean_hw(grads) * A) of NCHW maps, each image divided by
    its max (floored at 1e-12): ``[B, h, w]`` in [0, 1]."""
    weights = grads.float().mean(dim=(2, 3), keepdim=True)
    cam = torch.relu((weights * activation.float()).sum(dim=1))
    mx = cam.flatten(1).amax(dim=1).clamp_min(1e-12)
    return cam / mx[:, None, None]


def grad_cam(model: nn.Module, x: torch.Tensor, target: torch.Tensor,
             conv_layer: str | None = None) -> torch.Tensor:
    """Grad-CAM ``[B, h, w]`` of the flagship models
    (``SkinCancerListModel`` and ``SkinCancerModel``) on the post-pool
    output A of a conv block: ``conv_layer`` is the JAX package's key
    ``"ConvBlock_{i}/__call__"``, by default the last block. The rest of
    the model (the later blocks, the MLP and the head, the model's own
    modules) is a function of A; the CAM is relu(sum_c mean_hw(d score /
    d A) * A), normalized per image by its max."""
    n = len(model.conv_blocks)
    i = n - 1
    if conv_layer is not None:
        m = re.fullmatch(r"ConvBlock_(\d+)/__call__", conv_layer)
        if not m or int(m.group(1)) >= n:
            raise ValueError(f"no conv block {conv_layer!r}; the model has "
                             f"ConvBlock_0 ... ConvBlock_{n - 1}")
        i = int(m.group(1))
    with torch.no_grad():
        act = model.features(x, stop=i + 1)
    with torch.enable_grad():
        act = act.detach().requires_grad_(True)
        score = _target_sum(model.classify(act, i + 1), target)
        grads = torch.autograd.grad(score, act)[0]
    return _normalized_cam(act.detach(), grads)


def gap_head_log_probs(model: nn.Module,
                       features: torch.Tensor) -> torch.Tensor:
    """The closed-form head of a GAP-head model on its NCHW feature map
    (dropout is the identity in eval): a float32 GAP, the ``head`` Dense
    in float32 and a log-softmax; ``[B, num_classes]``."""
    pooled = features.float().mean(dim=(2, 3))
    logits = F.linear(pooled, model.head.weight.float(),
                      model.head.bias.float())
    return F.log_softmax(logits, dim=-1)


def grad_cam_gap_head(model: nn.Module, x: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Grad-CAM ``[B, h, w]`` of a model whose head is GAP -> Dropout ->
    Dense -> log-softmax: the ResNets and every Keras-compatible family.

    A is the feature map the GAP reads, which ``model.features`` returns
    (a ResNet's last block output; Xception's relu(block14_sepconv2_bn),
    VGG's last pool, ResNet-V2's relu(post_bn), MobileNetV2's
    relu6(Conv_1_bn), the EfficientNets' silu(top_bn)). Given A the head
    is the closed form of :func:`gap_head_log_probs`, so d score / d A is
    exact without a backward through the backbone. The JAX package finds
    A by a name rule over captured module outputs (the last 4-D output of
    a top-level ``\\w+_\\d+`` module), which picks the right map for the
    ResNets only; each port model names its map itself, so there is no
    discovery rule and no ``activation_key``. The CAM is computed in
    float32."""
    if isinstance(model, SkinCancerListModel):
        raise TypeError("the flagship models have no GAP head; use grad_cam")
    with torch.no_grad():
        act = model.features(x)
    with torch.enable_grad():
        act = act.detach().float().requires_grad_(True)
        score = _target_sum(gap_head_log_probs(model, act), target)
        grads = torch.autograd.grad(score, act)[0]
    return _normalized_cam(act.detach(), grads)
