"""The flagship classifier, plainly: the reference repository's
``SkinCancerListModel`` (jpope8/skin-image-analysis,
``src/tone_bias_model.py``).

Conv blocks ``conv_features`` (first kernel ``first_kernel``, then
``kernel``; stride 1, SAME padding, bias), each followed by ReLU and a 2x2
max-pool; the NCHW flatten; Dense ``linear_features`` each with ReLU and
inverted dropout; a Dense head; a float32 log-softmax. Parameters are
held by name in a dict, under the names of the program's ``state_dict``
(``conv_blocks.i.*``, ``mlp_blocks.j.*``, ``head.*``): the weight layouts
are PyTorch's (``[out, in, k, k]`` and ``[out, in]``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.precision import EXACT, Precision


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's name and shape, in the order of the model."""
    out: dict[str, tuple[int, ...]] = {}
    cin, side = cfg["in_channels"], cfg["image_size"]
    for i, feats in enumerate(cfg["conv_features"]):
        k = cfg["first_kernel"] if i == 0 else cfg["kernel"]
        out[f"conv_blocks.{i}.weight"] = (feats, cin, k, k)
        out[f"conv_blocks.{i}.bias"] = (feats,)
        cin, side = feats, side // 2
    width = cin * side * side
    for j, feats in enumerate(cfg["linear_features"]):
        out[f"mlp_blocks.{j}.weight"] = (feats, width)
        out[f"mlp_blocks.{j}.bias"] = (feats,)
        width = feats
    out["head.weight"] = (cfg["num_classes"], width)
    out["head.bias"] = (cfg["num_classes"],)
    return out


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    """The benchmark's weights, drawn in one call: He-normal weights
    (std sqrt(2 / fan_in)), biases 0.01 * N(0, 1)."""
    named = shapes(cfg)
    total = sum(math.prod(s) for s in named.values())
    flat = torch.randn(total, generator=generator, device=device)
    params, at = {}, 0
    for name, shape in named.items():
        n = math.prod(shape)
        chunk = flat[at:at + n].view(shape)
        at += n
        if name.endswith(".weight"):
            fan_in = math.prod(shape[1:])
            params[name] = chunk * math.sqrt(2.0 / fan_in)
        else:
            params[name] = chunk * 0.01
    return params


def dropout_widths(cfg: dict) -> list[int]:
    """The widths whose dropout draws noise, in the order of the draws."""
    return [w for w, r in zip(cfg["linear_features"], _rates(cfg))
            if 0.0 < r < 1.0]


def _rates(cfg: dict) -> list[float]:
    rates = list(cfg["dropout"])
    return rates * len(cfg["linear_features"]) if len(rates) == 1 else rates


def forward(cfg: dict, params: dict, x: torch.Tensor,
            noise: list[torch.Tensor] | None = None,
            prec: Precision = EXACT, train: bool | None = None):
    """NHWC float input -> (``[B, num_classes]`` float32 log-probs, {}:
    the model keeps no statistics). With ``noise`` (one uniform ``[B,
    width]`` per dropping layer) the forward trains: a unit is kept where
    its draw is below ``1 - rate``."""
    q = prec.operand
    x = x.permute(0, 3, 1, 2).float()
    for i in range(len(cfg["conv_features"])):
        w = params[f"conv_blocks.{i}.weight"]
        x = q(F.conv2d(q(x), q(w), params[f"conv_blocks.{i}.bias"],
                       padding=w.shape[-1] // 2))
        x = F.max_pool2d(F.relu(x), 2, 2)
    x = x.reshape(x.shape[0], -1)
    draws = iter(noise or [])
    for j, rate in enumerate(_rates(cfg)):
        x = F.relu(q(F.linear(q(x), q(params[f"mlp_blocks.{j}.weight"]),
                              params[f"mlp_blocks.{j}.bias"])))
        if noise is not None and 0.0 < rate < 1.0:
            keep = 1.0 - rate
            x = torch.where(next(draws) < keep, x / keep,
                            torch.zeros((), device=x.device))
    x = q(F.linear(q(x), q(params["head.weight"]), params["head.bias"]))
    return F.log_softmax(x.float(), dim=-1), {}


def forward_flops_per_image(cfg: dict) -> int:
    """The contraction FLOPs of one image's forward, by the arithmetic of
    the repository's ``bench.py`` (``_train_flops_per_img`` / 3): 2 per
    multiply-accumulate of each SAME stride-1 conv and each Dense."""
    s = cfg["image_size"]
    c_in = cfg["in_channels"]
    fwd = 0
    for i, c_out in enumerate(cfg["conv_features"]):
        k = cfg["first_kernel"] if i == 0 else cfg["kernel"]
        fwd += 2 * s * s * c_out * k * k * c_in
        s //= 2
        c_in = c_out
    feats = s * s * c_in
    for width in cfg["linear_features"]:
        fwd += 2 * feats * width
        feats = width
    fwd += 2 * feats * cfg["num_classes"]
    return fwd
