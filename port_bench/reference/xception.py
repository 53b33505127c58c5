"""Xception with a transfer head, plainly (Chollet 2017, "Xception: Deep
Learning with Depthwise Separable Convolutions", arXiv:1610.02357, Fig. 5,
as ``keras.applications.Xception`` builds it).

Stem: a 3x3/2 VALID conv to 32 and a 3x3 VALID conv to 64, each followed
by BatchNorm and ReLU. Entry blocks 2-4 (128, 256, 728): the residual
branch a 1x1/2 VALID conv with BatchNorm; the main branch [ReLU] ->
separable conv -> BatchNorm -> ReLU -> separable conv -> BatchNorm -> a
3x3/2 max pool with TF's SAME padding of -inf (on an even side 0 rows
before and 1 after, on an odd side 1 and 1); block 2 has no ReLU before
its first separable conv. Middle flow: ``middle_blocks`` blocks of three
ReLU -> separable conv 728 -> BatchNorm, each block added to its input.
Exit block: separable convs of 728 and 1024 in the entry blocks' pattern,
with a 1x1/2 conv and BatchNorm as the residual; then separable convs of
1536 and 2048, each followed by BatchNorm and ReLU. Head: global average
pool, inverted dropout, Dense, float32 log-softmax. With
``freeze_backbone`` the pooled features carry no gradient.

A separable conv is a 3x3 depthwise conv (stride 1, SAME, depth
multiplier 1) followed by a 1x1 pointwise conv; no conv has a bias.
BatchNorm is the ResNet reference's (``reference.resnet``): in training
the batch's mean and two-pass biased variance over N, H, W, the running
averages moved as ``r = momentum * r + (1 - momentum) * batch``; in
evaluation the running averages; epsilon 1e-3, Keras's. Parameters and
buffers are held by name under the names of the program's
``state_dict``.

Departures from the published network: a ``num_classes`` Dense head in
place of the 1000-class classifier, and the inverted dropout before it
(the transfer recipe's). A training forward on a real device (not on
``meta`` tensors, where ``port_bench.flops`` counts the published
operations) recomputes each block's activations in its backward
(``torch.utils.checkpoint``), so that float32 steps at B=256 and 299² fit
on one card beside the arenas: the arithmetic is the same, and each
BatchNorm's statistics are still those of the whole batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.precision import EXACT, Precision

EPS = 1e-3
MIDDLE = 728
ENTRY = ((2, 128), (3, 256), (4, 728))


def _exit(cfg: dict) -> int:
    """The number of the exit block (13 at the published depth)."""
    return 5 + cfg["middle_blocks"]


def _bn(out: dict, name: str, c: int) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{leaf}"] = (c,)


def _sep(out: dict, name: str, cin: int, cout: int) -> None:
    out[f"{name}.depthwise.weight"] = (cin, 1, 3, 3)
    out[f"{name}.pointwise.weight"] = (cout, cin, 1, 1)
    _bn(out, f"{name}_bn", cout)


def shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's and statistic's name and shape."""
    out: dict[str, tuple[int, ...]] = {}
    out["block1_conv1.weight"] = (32, cfg["in_channels"], 3, 3)
    _bn(out, "block1_conv1_bn", 32)
    out["block1_conv2.weight"] = (64, 32, 3, 3)
    _bn(out, "block1_conv2_bn", 64)
    cin = 64
    for bi, feats in ENTRY:
        out[f"block{bi}_res_conv.weight"] = (feats, cin, 1, 1)
        _bn(out, f"block{bi}_res_bn", feats)
        _sep(out, f"block{bi}_sepconv1", cin, feats)
        _sep(out, f"block{bi}_sepconv2", feats, feats)
        cin = feats
    for bi in range(5, _exit(cfg)):
        for si in (1, 2, 3):
            _sep(out, f"block{bi}_sepconv{si}", MIDDLE, MIDDLE)
    bi = _exit(cfg)
    out[f"block{bi}_res_conv.weight"] = (1024, MIDDLE, 1, 1)
    _bn(out, f"block{bi}_res_bn", 1024)
    _sep(out, f"block{bi}_sepconv1", MIDDLE, MIDDLE)
    _sep(out, f"block{bi}_sepconv2", MIDDLE, 1024)
    _sep(out, f"block{bi + 1}_sepconv1", 1024, 1536)
    _sep(out, f"block{bi + 1}_sepconv2", 1536, 2048)
    out["head.weight"] = (cfg["num_classes"], 2048)
    out["head.bias"] = (cfg["num_classes"],)
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def _branch_ends(cfg: dict) -> set[str]:
    """The scales of the last BatchNorm of each residual branch."""
    ends = {f"block{bi}_sepconv2_bn.weight"
            for bi in (2, 3, 4, _exit(cfg))}
    return ends | {f"block{bi}_sepconv3_bn.weight"
                   for bi in range(5, _exit(cfg))}


def init(cfg: dict, generator: torch.Generator, device) -> dict:
    """The benchmark's weights from two draws: He-normal convs and head
    (std sqrt(2 / fan_in)), BatchNorm scales uniform in [0.5, 1] but the
    last of each residual branch's in [0.1, 0.2], biases 0.01 * N(0, 1);
    running means 0 and variances 1.

    The small last scales keep each residual branch small, as in a trained
    network: with them the train-mode forward is not chaotic in its batch,
    and the first steps can be followed across precisions (the ResNet
    reference's reason)."""
    named = shapes(cfg)
    ends = _branch_ends(cfg)
    learn = [k for k in named if not is_statistic(k)]
    total = sum(math.prod(named[k]) for k in learn)
    normal = torch.randn(total, generator=generator, device=device)
    uniform = torch.rand(total, generator=generator, device=device)
    params, at = {}, 0
    for name, shape in named.items():
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
        elif name in ends:
            params[name] = 0.1 + 0.1 * u
        elif name.endswith(".weight"):
            params[name] = 0.5 + 0.5 * u
        else:
            params[name] = 0.01 * z
    return params


def dropout_widths(cfg: dict) -> list[int]:
    """The head's input width, where its dropout draws noise."""
    return [2048] if 0.0 < cfg["head_dropout"] < 1.0 else []


def _same_pad(n: int) -> tuple[int, int]:
    """TF's SAME padding (before, after) of a 3x3/2 window over ``n``."""
    total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


class _Run:
    """One forward: the parameters, whether it trains, the precision, and
    the batch statistics it measured (name -> (mean, variance))."""

    def __init__(self, params: dict, train: bool, prec: Precision):
        self.p, self.train, self.prec = params, train, prec
        self.stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}

    def conv(self, x, name: str, stride: int = 1, pad: int = 0,
             groups: int = 1):
        q = self.prec.operand
        return q(F.conv2d(q(x), q(self.p[f"{name}.weight"]), stride=stride,
                          padding=pad, groups=groups))

    def sep(self, x, name: str):
        """The separable conv ``name`` and its BatchNorm."""
        x = self.conv(x, f"{name}.depthwise", pad=1, groups=x.shape[1])
        return self.bn(self.conv(x, f"{name}.pointwise"), f"{name}_bn")

    def bn(self, x, name: str):
        p = self.p
        if self.train:
            mean = self.prec.stat(x.mean(dim=(0, 2, 3)))
            var = self.prec.stat(x.var(dim=(0, 2, 3), unbiased=False))
            # a recomputed segment measures the same statistics again
            self.stats.setdefault(name, (mean.detach(), var.detach()))
        else:
            mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        mul = torch.rsqrt(var + EPS) * p[f"{name}.weight"]
        return self.prec.operand((x - mean[:, None, None])
                                 * mul[:, None, None]
                                 + p[f"{name}.bias"][:, None, None])

    def pool(self, x):
        """3x3/2 max pool with SAME padding of -inf."""
        top, bottom = _same_pad(x.shape[2])
        left, right = _same_pad(x.shape[3])
        x = F.pad(x, (left, right, top, bottom), value=-math.inf)
        return F.max_pool2d(x, 3, 2)

    def segment(self, fn, x):
        """``fn(x)``, its activations recomputed in the backward where a
        training forward on a real device records a graph."""
        if (self.train and torch.is_grad_enabled()
                and x.device.type != "meta"):
            return checkpoint(fn, x, use_reentrant=False)
        return fn(x)


def _segments(cfg: dict, run: _Run) -> list:
    """The forward as functions of one activation each: the stem, each
    block of the entry, middle and exit flows, and the last block."""
    q = run.prec.operand

    def stem(x):
        x = F.relu(run.bn(run.conv(x, "block1_conv1", stride=2),
                          "block1_conv1_bn"))
        return F.relu(run.bn(run.conv(x, "block1_conv2"),
                             "block1_conv2_bn"))

    def reduction(bi, first_relu):
        def block(x):
            residual = run.bn(run.conv(x, f"block{bi}_res_conv", stride=2),
                              f"block{bi}_res_bn")
            y = F.relu(x) if first_relu else x
            y = run.sep(y, f"block{bi}_sepconv1")
            y = run.sep(F.relu(y), f"block{bi}_sepconv2")
            return q(run.pool(y) + residual)
        return block

    def middle(bi):
        def block(x):
            y = x
            for si in (1, 2, 3):
                y = run.sep(F.relu(y), f"block{bi}_sepconv{si}")
            return q(x + y)
        return block

    def last(x):
        bi = _exit(cfg) + 1
        x = F.relu(run.sep(x, f"block{bi}_sepconv1"))
        return F.relu(run.sep(x, f"block{bi}_sepconv2"))

    return ([stem] + [reduction(bi, bi != 2) for bi, _ in ENTRY]
            + [middle(bi) for bi in range(5, _exit(cfg))]
            + [reduction(_exit(cfg), True), last])


def features(cfg: dict, run: _Run, x: torch.Tensor) -> torch.Tensor:
    """NHWC input -> the pooled ``[B, 2048]`` features."""
    x = x.permute(0, 3, 1, 2).float()
    for fn in _segments(cfg, run):
        x = run.segment(fn, x)
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
