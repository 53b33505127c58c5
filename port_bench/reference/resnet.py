"""ResNet-50 with a transfer head, plainly (He et al. 2015,
arXiv:1512.03385, Table 1; the stride of each stage's first block on its
3x3 conv, the "v1.5" layout of NVIDIA's and torchvision's ResNet-50).

Stem: 7x7/2 conv (pad 3), BatchNorm, ReLU, 3x3/2 max-pool (pad 1).
Bottleneck blocks ``stage_sizes`` of widths 64, 128, 256, 512 (x4 out):
1x1, 3x3 (stride 2 in a stage's first block after the first stage, pad
1), 1x1, each conv without bias and followed by BatchNorm, ReLU between
them and after the residual sum; a 1x1 projection with BatchNorm where
the shape changes. Head: global average pool, inverted dropout, Dense,
float32 log-softmax. With ``freeze_backbone`` the pooled features carry
no gradient (the statistics still move).

BatchNorm is Flax's: in training it normalizes with the batch's mean and
biased variance (over N, H, W) and moves the running averages as
``r = momentum * r + (1 - momentum) * batch``; in evaluation it uses the
running averages; epsilon 1e-5. Parameters and buffers are held by name
under the names of the program's ``state_dict``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.precision import EXACT, Precision

EPS = 1e-5


def _blocks(cfg: dict):
    """(index, in channels, width, stride, projects) of every block."""
    cin, n = 64, 0
    for stage, count in enumerate(cfg["stage_sizes"]):
        width = 64 * 2 ** stage
        for b in range(count):
            stride = 2 if stage > 0 and b == 0 else 1
            projects = cin != width * 4 or stride != 1
            yield n, cin, width, stride, projects
            cin, n = width * 4, n + 1


def _bn(out: dict, name: str, c: int) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{leaf}"] = (c,)


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's and statistic's name and shape."""
    out: dict[str, tuple[int, ...]] = {
        "stem_conv.weight": (64, cfg["in_channels"], 7, 7)}
    _bn(out, "stem_bn", 64)
    cout = 64
    for n, cin, width, stride, projects in _blocks(cfg):
        convs = [(width, cin, 1), (width, width, 3), (width * 4, width, 1)]
        for j, (o, i, k) in enumerate(convs):
            out[f"blocks.{n}.conv{j}.weight"] = (o, i, k, k)
            _bn(out, f"blocks.{n}.bn{j}", o)
        if projects:
            out[f"blocks.{n}.downsample_conv.weight"] = (width * 4, cin, 1, 1)
            _bn(out, f"blocks.{n}.downsample_bn", width * 4)
        cout = width * 4
    out["head.weight"] = (cfg["num_classes"], cout)
    out["head.bias"] = (cfg["num_classes"],)
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    """The benchmark's weights from two draws: He-normal convs and head
    (std sqrt(2 / fan_in)), BatchNorm scales uniform in [0.5, 1] but the
    last of each block's in [0.1, 0.2], biases 0.01 * N(0, 1); running
    means 0 and variances 1.

    The small last scales keep each residual branch small, as in a trained
    ResNet (and as the zero scales of a fresh one do): with them the
    train-mode forward is not chaotic in its batch, and the first steps
    can be followed across precisions."""
    named = shapes(cfg)
    learn = [k for k in named if not is_statistic(k)]
    total = sum(math.prod(named[k]) for k in learn)
    normal = torch.randn(total, generator=generator, device=device)
    uniform = torch.rand(total, generator=generator, device=device)
    params, at = {}, 0
    for name in named:
        shape = named[name]
        if name.endswith("running_mean"):
            params[name] = torch.zeros(shape, device=device)
            continue
        if name.endswith("running_var"):
            params[name] = torch.ones(shape, device=device)
            continue
        n = math.prod(shape)
        z, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if len(shape) > 1:
            params[name] = z * math.sqrt(2.0 / math.prod(shape[1:]))
        elif name.endswith("bn2.weight"):
            params[name] = 0.1 + 0.1 * u
        elif name.endswith(".weight"):
            params[name] = 0.5 + 0.5 * u
        else:
            params[name] = 0.01 * z
    return params


def dropout_widths(cfg: dict) -> list[int]:
    """The head's input width, where its dropout draws noise."""
    width = 64 * 2 ** (len(cfg["stage_sizes"]) - 1) * 4
    return [width] if 0.0 < cfg["head_dropout"] < 1.0 else []


class _Run:
    """One forward: the parameters, whether it trains, the precision, and
    the batch statistics it measured (name -> (mean, variance))."""

    def __init__(self, params: dict, train: bool, prec: Precision):
        self.p, self.train, self.prec = params, train, prec
        self.stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def conv(self, x, name: str, stride: int, pad: int):
        q = self.prec.operand
        return q(F.conv2d(q(x), q(self.p[f"{name}.weight"]), stride=stride,
                          padding=pad))

    def bn(self, x, name: str):
        p = self.p
        if self.train:
            mean = self.prec.stat(x.mean(dim=(0, 2, 3)))
            var = self.prec.stat(x.var(dim=(0, 2, 3), unbiased=False))
            self.stats[name] = (mean.detach(), var.detach())
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        mul = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
        return self.prec.operand((x - mean[:, None, None])
                                 * mul[:, None, None]
                                 + p[f"{name}.bias"][:, None, None])


def features(cfg: dict, run: _Run, x: torch.Tensor) -> torch.Tensor:
    """NHWC input -> the pooled ``[B, 2048]`` features."""
    x = x.permute(0, 3, 1, 2).float()
    x = F.relu(run.bn(run.conv(x, "stem_conv", 2, 3), "stem_bn"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for n, _cin, _width, stride, projects in _blocks(cfg):
        y = x
        for j, (s, pad) in enumerate(((1, 0), (stride, 1), (1, 0))):
            y = run.bn(run.conv(y, f"blocks.{n}.conv{j}", s, pad),
                       f"blocks.{n}.bn{j}")
            if j < 2:
                y = F.relu(y)
        if projects:
            x = run.bn(run.conv(x, f"blocks.{n}.downsample_conv", stride, 0),
                       f"blocks.{n}.downsample_bn")
        x = run.prec.operand(F.relu(y + x))
    return run.prec.operand(x.mean(dim=(2, 3)))


def forward(cfg: dict, params: dict, x: torch.Tensor,
            noise: list[torch.Tensor] | None = None,
            prec: Precision = EXACT, train: bool | None = None):
    """NHWC float input -> (``[B, num_classes]`` float32 log-probs, the
    batch statistics by BatchNorm name). It trains (batch statistics and,
    with ``noise``, the head's dropout: kept where the draw is below
    ``1 - rate``) when ``train`` or ``noise`` is given."""
    train = noise is not None if train is None else train
    run = _Run(params, train, prec)
    h = features(cfg, run, x)
    if cfg["freeze_backbone"]:
        h = h.detach()
    if noise:
        keep = 1.0 - cfg["head_dropout"]
        h = torch.where(noise[0] < keep, h / keep,
                        torch.zeros((), device=h.device))
    q = prec.operand
    logits = q(F.linear(q(h), q(params["head.weight"]), params["head.bias"]))
    return F.log_softmax(logits.float(), dim=-1), run.stats


def moved_statistics(params: dict, stats: dict, momentum: float) -> dict:
    """The running averages after one training forward's ``stats``."""
    out = {}
    for name, (mean, var) in stats.items():
        for leaf, batch in (("running_mean", mean), ("running_var", var)):
            r = params[f"{name}.{leaf}"]
            out[f"{name}.{leaf}"] = momentum * r + (1.0 - momentum) * batch
    return out
