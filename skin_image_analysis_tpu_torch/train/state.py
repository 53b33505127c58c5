"""Train state: model + optimizer + step count + generator.

Port of the JAX package's ``train.state``. The optimizers are the
port's own: adamw, rmsprop and sgd with optax's rules, and adam in the
JAX package's two forms:

- ``optax.adam`` semantics: moments updated in the gradient's dtype,
  ``mu`` optionally stored in ``moment_dtype``; update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)``;
- the low-precision form (``_scale_by_adam_lowp``, chosen by
  ``nu_dtype``): both moments stored narrow, the math in float32, the
  learning rate folded into the same update.

``torch.optim`` is not used: its state layout and its bf16 rules differ
from optax's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from skin_image_analysis_tpu_torch.config import ModelConfig, OptimConfig
from skin_image_analysis_tpu_torch.models.cnn import build_model

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_lr(cfg: OptimConfig) -> float | Callable[[int], float]:
    """Learning rate: a float, or a function of the optimizer step count
    (the schedules of optax: staircased or smooth exponential decay,
    cosine decay, and a linear warmup prefix)."""
    base = cfg.learning_rate
    sched = None
    if cfg.lr_schedule in ("step", "exponential"):
        if cfg.lr_step_size < 1:
            raise ValueError(
                f"lr_schedule={cfg.lr_schedule!r} needs lr_step_size >= 1 "
                f"(got {cfg.lr_step_size}); pass --lr-step-size"
            )
        step_size, gamma = cfg.lr_step_size, cfg.lr_gamma
        staircase = cfg.lr_schedule == "step"

        def sched(count: int) -> float:
            p = count / step_size
            if staircase:
                p = math.floor(p)
            return base * gamma ** p
    elif cfg.lr_schedule == "cosine":
        if cfg.lr_decay_steps < 1:
            raise ValueError(
                "lr_schedule='cosine' needs lr_decay_steps >= 1 "
                f"(got {cfg.lr_decay_steps}); pass --lr-decay-steps"
            )
        decay_steps = cfg.lr_decay_steps

        def sched(count: int) -> float:
            frac = min(count, decay_steps) / decay_steps
            return base * 0.5 * (1 + math.cos(math.pi * frac))
    elif cfg.lr_schedule:
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    if cfg.lr_warmup_steps:
        warmup = cfg.lr_warmup_steps
        tail = sched if sched is not None else (lambda count: base)

        def warmed(count: int) -> float:
            if count < warmup:
                return base * count / warmup
            return tail(count - warmup)

        return warmed
    return sched if sched is not None else base


class Optimizer:
    """The interface the train step and the checkpoint take: ``params``,
    ``step(grads)`` updating them in place, ``count`` (updates applied),
    ``name`` and :meth:`state`. The learning rate (a float, or a function
    of the count before the update, as optax's schedules see it) is
    computed on the host, so a step needs no device sync."""

    name = ""

    def __init__(self, params, lr):
        self.params = list(params)
        self.lr = lr
        self.count = 0

    def _lr(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else self.lr

    def state(self) -> dict[str, list[torch.Tensor]]:
        """The optimizer's tensors by name, one list entry per parameter:
        what a snapshot saves and restores in place."""
        return {}

    def step(self, grads) -> None:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam over a list of parameters, updating them in place.

    ``lowp=False``: ``optax.adam(lr, mu_dtype=mu_dtype)``. ``lowp=True``:
    the JAX package's ``_scale_by_adam_lowp`` (moments stored in
    ``mu_dtype``/``nu_dtype``, float32 math, lr folded in). Bias
    corrections come from ``count`` on the host."""

    name = "adam"

    def __init__(self, params, lr, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype: torch.dtype | None = None,
                 nu_dtype: torch.dtype | None = None, lowp: bool = False):
        super().__init__(params, lr)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.lowp = lowp
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=(nu_dtype if lowp else None)
                                    or p.dtype) for p in self.params]

    def state(self) -> dict[str, list[torch.Tensor]]:
        return {"mu": self.mu, "nu": self.nu}

    def _decay(self, upd: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        """The update before the learning rate: adam's own."""
        return upd

    @torch.no_grad()
    def step(self, grads) -> None:
        """Apply one update from ``grads`` (one per parameter, in order)."""
        b1, b2, eps = self.b1, self.b2, self.eps
        lr = self._lr(self.count)
        self.count += 1
        # bias corrections in float32, as optax computes them
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.lowp:
                gf = g.float()
                mf = self.mu[i].float().mul_(b1).add_(gf, alpha=1.0 - b1)
                vf = self.nu[i].float().mul_(b2).addcmul_(
                    gf, gf, value=1.0 - b2)
                upd = (mf / bc1).mul_(-lr).div_(
                    (vf / bc2).sqrt_().add_(eps))
                p.add_(upd.to(p.dtype))
                self.mu[i].copy_(mf)
                self.nu[i].copy_(vf)
            else:
                # optax computes b1 * mu in mu's storage dtype, with b1
                # itself rounded to it (0.8984375 for a bf16 mu)
                mu = self.mu[i]
                m = g.mul(1.0 - b1).add_(
                    (mu * torch.tensor(b1, dtype=mu.dtype)).to(g.dtype))
                v = g.mul(g).mul_(1.0 - b2).add_(self.nu[i], alpha=b2)
                upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
                p.add_(self._decay(upd, p).mul_(-lr).to(p.dtype))
                self.mu[i].copy_(m)
                self.nu[i].copy_(v)


class AdamW(Adam):
    """``optax.adamw(lr, weight_decay=wd, mu_dtype=mu_dtype)``: adam's
    update plus the decoupled ``wd * p`` on every parameter, both scaled
    by the learning rate."""

    name = "adamw"

    def __init__(self, params, lr, weight_decay: float,
                 mu_dtype: torch.dtype | None = None):
        super().__init__(params, lr, mu_dtype=mu_dtype)
        self.weight_decay = weight_decay

    def _decay(self, upd: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return upd.add_(p * self.weight_decay)


class RMSProp(Optimizer):
    """``optax.rmsprop(lr, decay, eps, eps_in_sqrt=False)``, which is
    ``torch.optim.RMSprop``'s rule: ``v = (1 - decay) g^2 + decay v``
    from ``v = 0``, update ``-lr * g / (sqrt(v) + eps)``."""

    name = "rmsprop"

    def __init__(self, params, lr, decay: float = 0.99, eps: float = 1e-8):
        super().__init__(params, lr)
        self.decay, self.eps = decay, eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state(self) -> dict[str, list[torch.Tensor]]:
        return {"nu": self.nu}

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self._lr(self.count)
        self.count += 1
        for p, g, nu in zip(self.params, grads, self.nu):
            v = g.mul(g).mul_(1.0 - self.decay).add_(nu.mul(self.decay))
            scaling = torch.reciprocal(v.sqrt().add_(self.eps))
            p.add_(scaling.mul_(g).mul_(-lr).to(p.dtype))
            nu.copy_(v)


class SGD(Optimizer):
    """``optax.sgd(lr)`` or, with ``momentum``, ``optax.sgd(lr,
    momentum)``: the trace ``t = g + momentum * t`` (no dampening) and
    the update ``-lr * t``."""

    name = "sgd"

    def __init__(self, params, lr, momentum: float = 0.0):
        super().__init__(params, lr)
        self.momentum = momentum
        self.trace = ([torch.zeros_like(p) for p in self.params]
                      if momentum else [])

    def state(self) -> dict[str, list[torch.Tensor]]:
        return {"trace": self.trace} if self.momentum else {}

    @torch.no_grad()
    def step(self, grads) -> None:
        lr = self._lr(self.count)
        self.count += 1
        for i, (p, g) in enumerate(zip(self.params, grads)):
            if self.momentum:
                t = g.add(self.trace[i].mul(self.momentum))
                self.trace[i].copy_(t)
            else:
                t = g
            p.add_(t.mul(-lr).to(p.dtype))


def make_optimizer(cfg: OptimConfig, params) -> Optimizer:
    """The optimizer an :class:`OptimConfig` describes: adam (optax's, or
    the low-precision form when ``nu_dtype`` is narrow), adamw, rmsprop
    or sgd, each over the learning rate of :func:`make_lr`."""
    name = cfg.optimizer.lower()
    mu_dtype = _DTYPES[cfg.moment_dtype] if cfg.moment_dtype else None
    nu_dtype = _DTYPES[cfg.nu_dtype] if cfg.nu_dtype else None
    lr = make_lr(cfg)
    if name != "adam" and nu_dtype is not None \
            and nu_dtype != torch.float32:
        # both moments narrow is adam's low-precision form only
        raise ValueError(
            f"nu_dtype={cfg.nu_dtype!r} is only supported with "
            f"optimizer='adam' (got {cfg.optimizer!r}); use moment_dtype "
            "to narrow adamw's first moment")
    if name == "adam":
        if nu_dtype is not None and nu_dtype != torch.float32:
            return Adam(params, lr, mu_dtype=mu_dtype or nu_dtype,
                        nu_dtype=nu_dtype, lowp=True)
        return Adam(params, lr, mu_dtype=mu_dtype)
    if name == "adamw":
        return AdamW(params, lr, cfg.weight_decay, mu_dtype=mu_dtype)
    if name == "rmsprop":
        return RMSProp(params, lr, decay=0.99, eps=1e-8)
    if name == "sgd":
        return SGD(params, lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    """What the JAX package's ``TrainState`` pytree carries: the model
    (params), the optimizer (its state), the count of applied steps and
    the generator that dropout and augmentation draw from."""

    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def head_parameters(model: nn.Module) -> list[nn.Parameter]:
    """The parameters a frozen-backbone run trains: the model's top-level
    Dense head (GAP -> Dropout -> Dense), as the JAX package labels
    ``Dense_*`` trainable and everything else frozen. A model without such
    a head raises ValueError."""
    head = getattr(model, "head", None)
    if not isinstance(head, nn.Module) or not list(head.parameters()):
        top = sorted({k.split(".")[0] for k, _ in model.named_parameters()})
        raise ValueError(
            "freeze_backbone needs a model with a top-level Dense head "
            f"(the transfer families); got top-level params {top}")
    return list(head.parameters())


def create_train_state(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                       seed: int, device="cuda") -> TrainState:
    """Init a model (on ``device``) and its optimizer from ``seed``. With
    ``freeze_backbone`` the optimizer covers the head only, so the
    backbone gets no update, no weight decay and no moments (optax's
    ``multi_transform`` with ``set_to_zero`` in the JAX package)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    model = build_model(model_cfg, device=device, generator=generator)
    params = list(model.parameters())
    if model_cfg.freeze_backbone:
        if not getattr(model, "freeze_backbone", False):
            raise ValueError(
                f"model {model_cfg.name!r} does not support "
                "freeze_backbone (the transfer families only)")
        params = head_parameters(model)
    optimizer = make_optimizer(optim_cfg, params)
    return TrainState(model=model, optimizer=optimizer, generator=generator)
