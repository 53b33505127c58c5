"""The precisions the reference computes in.

``exact`` is the reference proper: float32 everywhere, TF32 off. The
``control`` lowers each precision a configuration states by one step, as
a later change might: what the configurations compute in bf16 (the
operands and outputs of the convolutions and matmuls, the BatchNorm
outputs, the residual sums and the pooled features) to fp8 e4m3 with a
per-tensor scale, the preprocess
output to the dtype below the one the configuration states (bf16 -> fp8,
float32 -> bf16), and the float32 BatchNorm statistics and optimizer
moments to bf16. The comparison that decides ``correct`` has to fail the
control (``port_bench.checks``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, NamedTuple

import torch

E4M3_MAX = 448.0


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through fp8 e4m3 with a per-tensor scale that maps
    its largest magnitude to 448; the gradient passes straight through."""
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (q.to(x.dtype) - x).detach()


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through bfloat16; the gradient passes straight
    through."""
    q = x.detach().to(torch.bfloat16).to(x.dtype)
    return x + (q - x).detach()


#: the rounding one step below each dtype a configuration states
ONE_STEP_BELOW = {"float32": bf16, "bfloat16": fp8_e4m3}


class Precision(NamedTuple):
    """Where the reference rounds: ``operand`` every tensor the model
    computes in its compute dtype (the operands and outputs of its
    convolutions and matmuls, its BatchNorm outputs, residual sums and
    pooled features), ``output`` the preprocess output, ``stat`` the
    BatchNorm statistics, ``moment`` the optimizer moments."""

    name: str
    operand: Callable[[torch.Tensor], torch.Tensor]
    output: Callable[[torch.Tensor], torch.Tensor]
    stat: Callable[[torch.Tensor], torch.Tensor]
    moment: Callable[[torch.Tensor], torch.Tensor]


EXACT = Precision("exact", _same, _same, _same, _same)


def control(preprocess_dtype: str) -> Precision:
    """The control of a configuration whose train preprocess writes
    ``preprocess_dtype`` and whose contractions run in bf16."""
    return Precision("control", fp8_e4m3, ONE_STEP_BELOW[preprocess_dtype],
                     bf16, bf16)


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """TF32 off for matmuls and convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
