"""Full-search-space parallel HPO: padded super-network populations (port
of the JAX package's ``hpo.population``).

A *wave* fixes the architecture skeleton, (n_conv, n_linear, optimizer
kind), and runs K trials that vary every other dimension: per-layer
widths, per-layer dropout rates and lr.

- Every layer is padded to the search-space max width (256). A trial of
  width w occupies the first w channels; padded channels start at zero
  and their gradients are masked every step, so the padded network is
  exactly the unpadded one (zero weights in, zero activations through
  ReLU/pool/dropout, zero gradients out).
- Init is Xavier-normal at the *active* fans, times the activity mask.
- lr and the dropout rates are per-trial tensors; the optimizer kind is
  static per wave (adam | rmsprop | sgd, lr-free, the lr applied
  outside), with optax's update formulas.

The stacking is the JAX package's ``vmap``: ``torch.func.vmap`` of
``torch.func.grad`` over a ``functional_call`` of one padded model, on
parameters and optimizer states stacked on a leading K axis; a step sums
exact microbatch gradients (mean-NLL decomposes linearly) so one
microbatch's padded activations are live at a time. The stacked forward
runs the padded model with ``pool_mode="stock"`` (ReLU then
``max_pool2d``): ``torch.func.vmap`` does not pass through the custom
``autograd.Function`` of the selector pool (``ops.pooling``), and the
stock pool is the same function. Dropout masks come from uniform draws
made outside the vmapped function (``dropout_noise``: one ``[K, mb,
width]`` draw per MLP block and microbatch from the wave's generator), so
a lone run of trial k given slice k of the draws is the same trial.

The input: the JAX package's wave gathers each step's ``[K, B]`` uint8
rows from the device pool and converts them with ``/ 255`` inside the
stacked program, once for the whole stack (not once per trial). The port
does that gather and conversion in the fused preprocess kernel
(``ops.kernels.preprocess_kernel``, eval form: no crop offset, no flip,
scale 1/255), ONE launch per stacked train step over all K * B rows, and
one launch per validation batch over K * mb rows; on CPU tensors the
kernel's plain twin runs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.func import functional_call, grad_and_value, vmap

from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.ops.kernels.preprocess_kernel import (
    fused_preprocess_planar,
)

PAD_WIDTH = 256  # the search-space max width (tone_bias_optuna.py:133-169)


@dataclass(frozen=True)
class WaveSkeleton:
    """The static shape of one wave: everything that changes tensor
    shapes or control flow. ``pad_width`` is the width every layer pads
    to (the search-space max; smaller for narrowed spaces)."""

    n_conv: int          # extra k=3 conv blocks (reference n_conv_layers)
    n_linear: int        # linear blocks
    optimizer: str       # adam | rmsprop | sgd (static per wave)
    image_size: int = 224
    compute_dtype: str = "bfloat16"
    pad_width: int = PAD_WIDTH

    @property
    def conv_count(self) -> int:
        return 1 + self.n_conv

    def padded_model_config(self) -> ModelConfig:
        return ModelConfig(
            conv_features=(self.pad_width,) * self.conv_count,
            first_kernel=7,
            kernel=3,
            linear_features=(self.pad_width,) * self.n_linear,
            dropout=(0.5,) * self.n_linear,
            image_size=self.image_size,
            compute_dtype=self.compute_dtype,
            fused_pool=False,
            pool_mode="stock",
        )

    def flatten_spatial(self) -> int:
        side = self.image_size
        for _ in range(self.conv_count):
            side //= 2
        return side * side

    def padded_param_bytes(self) -> int:
        """float32 parameter footprint of the padded network."""
        pad = self.pad_width
        total = 7 * 7 * 3 * pad + pad
        for _ in range(self.n_conv):
            total += 3 * 3 * pad * pad + pad
        fan_in = self.flatten_spatial() * pad
        for _ in range(self.n_linear):
            total += fan_in * pad + pad
            fan_in = pad
        total += fan_in * 2 + 2
        return total * 4


def activation_bytes(skel: WaveSkeleton, microbatch: int) -> int:
    """Peak transient activation footprint of ONE trial's forward and
    backward at the padded width: the first conv's full-resolution output
    (microbatch x image^2 x pad x 2 bytes) with 3x headroom."""
    first_conv = microbatch * skel.image_size ** 2 * skel.pad_width * 2
    return 3 * first_conv


def default_microbatch(skel: WaveSkeleton, batch_size: int) -> int:
    """Exact-gradient microbatches when the padded activations at full
    batch would dwarf device memory."""
    if skel.image_size >= 128:
        return max(4, batch_size // 8)
    return batch_size


def max_population(skel: WaveSkeleton, batch_size: int = 32,
                   microbatch: int | None = None,
                   budget_bytes: int = 8 << 30) -> int:
    """Largest power-of-two K fitting the budget: params, grads and two
    moments (~4x the parameter bytes) plus the microbatch transient;
    at most 32."""
    if microbatch is None:
        microbatch = default_microbatch(skel, batch_size)
    per_trial = 4 * skel.padded_param_bytes() + activation_bytes(
        skel, microbatch)
    k = max(1, budget_bytes // max(per_trial, 1))
    return 1 << min(int(math.log2(k)), 5)


def _layer_specs(skel: WaveSkeleton):
    """(parameter prefix, kind, index) of every parameter-owning layer in
    call order; kind in {conv, dense, head}."""
    for i in range(skel.conv_count):
        yield f"conv_blocks.{i}", "conv", i
    for j in range(skel.n_linear):
        yield f"mlp_blocks.{j}", "dense", j
    yield "head", "head", 0


def _feature_mask(width: torch.Tensor, pad: int) -> torch.Tensor:
    """[pad] 0/1 mask of the first ``width`` channels."""
    return (torch.arange(pad, device=width.device) < width).float()


def _active_fans(skel: WaveSkeleton, kind: str, idx: int,
                 conv_w: torch.Tensor, lin_w: torch.Tensor):
    if kind == "conv":
        cin = torch.tensor(3, device=conv_w.device) if idx == 0 \
            else conv_w[idx - 1]
        return cin, conv_w[idx]
    if kind == "dense":
        if idx == 0:
            return (skel.flatten_spatial() * conv_w[skel.conv_count - 1],
                    lin_w[0])
        return lin_w[idx - 1], lin_w[idx]
    return lin_w[skel.n_linear - 1], torch.tensor(2, device=lin_w.device)


def trial_param_masks(skel: WaveSkeleton, conv_w: torch.Tensor,
                      lin_w: torch.Tensor) -> dict[str, torch.Tensor]:
    """0/1 masks shaped like the padded parameters of ONE trial with
    active widths ``conv_w`` [conv_count] and ``lin_w`` [n_linear]. The
    first dense layer reads the NCHW flatten (c, h, w), so its channel
    mask repeats over the spatial positions."""
    pad = skel.pad_width
    out: dict[str, torch.Tensor] = {}
    for prefix, kind, idx in _layer_specs(skel):
        if kind == "conv":
            cin, cout = _active_fans(skel, kind, idx, conv_w, lin_w)
            in_m = _feature_mask(cin, 3 if idx == 0 else pad)
            out_m = _feature_mask(cout, pad)
            kmask = out_m[:, None, None, None] * in_m[None, :, None, None]
            bmask = out_m
        elif kind == "dense":
            if idx == 0:
                in_m = torch.repeat_interleave(
                    _feature_mask(conv_w[skel.conv_count - 1], pad),
                    skel.flatten_spatial())
            else:
                in_m = _feature_mask(lin_w[idx - 1], pad)
            out_m = _feature_mask(lin_w[idx], pad)
            kmask = out_m[:, None] * in_m[None, :]
            bmask = out_m
        else:
            in_m = _feature_mask(lin_w[skel.n_linear - 1], pad)
            kmask = torch.ones((2, 1), device=in_m.device) * in_m[None, :]
            bmask = torch.ones((2,), device=in_m.device)
        out[f"{prefix}.weight"] = kmask
        out[f"{prefix}.bias"] = bmask
    return out


def wave_masks(skel: WaveSkeleton, conv_w: torch.Tensor,
               lin_w: torch.Tensor) -> dict[str, torch.Tensor]:
    """:func:`trial_param_masks` of every lane, stacked: ``conv_w`` [K,
    conv_count], ``lin_w`` [K, n_linear]."""
    per = [trial_param_masks(skel, conv_w[k], lin_w[k])
           for k in range(conv_w.shape[0])]
    return {name: torch.stack([m[name] for m in per]) for name in per[0]}


def init_trial_params(skel: WaveSkeleton, generator: torch.Generator,
                      conv_w: torch.Tensor, lin_w: torch.Tensor
                      ) -> dict[str, torch.Tensor]:
    """Padded float32 parameters of one trial: Xavier-normal at the
    ACTIVE fans (the reference's init) times the activity mask; biases
    zero."""
    dev = conv_w.device
    pad = skel.pad_width
    out: dict[str, torch.Tensor] = {}
    for prefix, kind, idx in _layer_specs(skel):
        fin, fout = _active_fans(skel, kind, idx, conv_w, lin_w)
        if kind == "conv":
            k = 7 if idx == 0 else 3
            shape = (pad, 3 if idx == 0 else pad, k, k)
            fan_in, fan_out = k * k * fin, k * k * fout
        elif kind == "dense":
            shape = (pad, skel.flatten_spatial() * pad if idx == 0
                     else pad)
            fan_in, fan_out = fin, fout
        else:
            shape = (2, pad)
            fan_in, fan_out = fin, fout
        std = torch.sqrt(2.0 / (fan_in + fan_out).float())
        out[f"{prefix}.weight"] = torch.randn(
            shape, generator=generator, device=dev) * std
        out[f"{prefix}.bias"] = torch.zeros(shape[0], device=dev)
    masks = trial_param_masks(skel, conv_w, lin_w)
    return {k: v * masks[k] for k, v in out.items()}


# -- the lr-free optimizer cores (optax's formulas) --------------------------


def init_opt_state(optimizer: str, params: dict) -> dict:
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    k = next(iter(params.values())).shape[0]
    dev = next(iter(params.values())).device
    if optimizer == "adam":
        return {"mu": zeros, "nu": {n: v.clone() for n, v in zeros.items()},
                "count": torch.zeros(k, dtype=torch.int32, device=dev)}
    if optimizer == "rmsprop":
        return {"nu": zeros}
    if optimizer == "sgd":
        return {}
    raise ValueError(f"unknown optimizer {optimizer!r}")


def _lane(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-lane ``[K]`` value shaped to broadcast against ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def scale_updates(optimizer: str, grads: dict, opt: dict):
    """``(updates, new state)``: ``optax.scale_by_adam()``,
    ``scale_by_rms(decay=0.99, eps=1e-8, eps_in_sqrt=False)`` (torch
    RMSprop's defaults) or the identity, per lane."""
    if optimizer == "sgd":
        return grads, opt
    if optimizer == "rmsprop":
        nu = {k: 0.01 * g * g + 0.99 * opt["nu"][k]
              for k, g in grads.items()}
        upd = {k: g / (torch.sqrt(nu[k]) + 1e-8) for k, g in grads.items()}
        return upd, {"nu": nu}
    b1, b2, eps = 0.9, 0.999, 1e-8
    mu = {k: (1 - b1) * g + b1 * opt["mu"][k] for k, g in grads.items()}
    nu = {k: (1 - b2) * (g * g) + b2 * opt["nu"][k]
          for k, g in grads.items()}
    count = opt["count"] + 1
    c = count.float()
    upd = {}
    for k, g in grads.items():
        m_hat = mu[k] / _lane(1 - b1 ** c, g)
        v_hat = nu[k] / _lane(1 - b2 ** c, g)
        upd[k] = m_hat / (torch.sqrt(v_hat) + eps)
    return upd, {"mu": mu, "nu": nu, "count": count}


# -- the stacked programs ----------------------------------------------------


def stacked_input(pool: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``pool`` [N, 3, S, S] uint8 rows ``rows`` (any shape) -> float32
    ``[*rows.shape, S, S, 3]`` in [0, 1]: one launch of the preprocess
    kernel over all the rows (its plain twin on the CPU)."""
    flat = rows.reshape(-1).to(torch.int32).contiguous()
    b, s = flat.shape[0], pool.shape[-1]
    dev = pool.device
    x = fused_preprocess_planar(
        pool, torch.zeros((b, 2), dtype=torch.int32, device=dev),
        torch.zeros(b, dtype=torch.int32, device=dev),
        torch.full((b, 3), 1.0 / 255.0, device=dev),
        torch.zeros((b, 3), device=dev), flat, image_size=s)
    return x.permute(0, 2, 3, 1).reshape(*rows.shape, s, s, 3)


class WavePrograms:
    """The per-trial math of one skeleton, stacked over K lanes: init,
    one stacked train step, validation accuracy and the lane merge. The
    padded model is built once on ``device``; its own parameters are
    never used (every call passes the stacked ones)."""

    def __init__(self, skel: WaveSkeleton, microbatch: int, n_micro: int,
                 device):
        from skin_image_analysis_tpu_torch.models.cnn import build_model

        self.skel = skel
        self.microbatch = microbatch
        self.n_micro = n_micro
        self.device = torch.device(device)
        self.model = build_model(skel.padded_model_config(),
                                 device=self.device)
        for p in self.model.parameters():
            p.requires_grad_(False)
        model = self.model

        def loss_fn(p, dr, x, labels, noise):
            log_probs = functional_call(
                model, p, (x,), {"train": True, "dropout_rates": dr,
                                 "dropout_noise": noise})
            picked = log_probs.gather(1, labels[:, None])[:, 0]
            return -picked.mean()

        self._vgrad = vmap(grad_and_value(loss_fn))

        def eval_one(p, x, labels):
            log_probs = functional_call(model, p, (x,), {"train": False})
            return (log_probs.argmax(-1) == labels).sum()

        self._veval = vmap(eval_one)

    def init_wave(self, seeds, conv_w: torch.Tensor, lin_w: torch.Tensor):
        """Stacked params and optimizer state; lane k draws its init from
        a generator seeded with ``seeds[k]``."""
        lanes = []
        for k, seed in enumerate(seeds):
            g = torch.Generator(device=self.device).manual_seed(int(seed))
            lanes.append(init_trial_params(self.skel, g, conv_w[k],
                                           lin_w[k]))
        params = {n: torch.stack([p[n] for p in lanes]) for n in lanes[0]}
        return params, init_opt_state(self.skel.optimizer, params)

    def draw_noise(self, k: int, generator: torch.Generator
                   ) -> list[list[torch.Tensor]]:
        """One step's dropout draws: per microbatch, one uniform ``[K,
        mb, pad]`` per MLP block."""
        return [[torch.rand((k, self.microbatch, self.skel.pad_width),
                            generator=generator, device=self.device)
                 for _ in range(self.skel.n_linear)]
                for _ in range(self.n_micro)]

    def train_step(self, params: dict, opt: dict, pool: torch.Tensor,
                   pool_lb: torch.Tensor, rows: torch.Tensor,
                   masks: dict, drops: torch.Tensor, lrs: torch.Tensor,
                   noise: list) -> tuple[dict, dict, torch.Tensor]:
        """One stacked step on ``rows`` [K, B] of the pool: returns the
        new params and optimizer state and each lane's mean NLL [K]."""
        k, b = rows.shape
        x = stacked_input(pool, rows)                  # [K, B, S, S, 3]
        labels = pool_lb[rows.long()]
        mb = self.microbatch
        grads, loss = None, None
        for m in range(self.n_micro):
            sl = slice(m * mb, (m + 1) * mb)
            g, l = self._vgrad(params, drops, x[:, sl], labels[:, sl],
                               tuple(noise[m]))
            if grads is None:
                grads, loss = g, l
            else:
                grads = {n: grads[n] + g[n] for n in grads}
                loss = loss + l
        grads = {n: v / self.n_micro * masks[n] for n, v in grads.items()}
        upd, opt = scale_updates(self.skel.optimizer, grads, opt)
        params = {n: w - _lane(lrs, w) * upd[n] * masks[n]
                  for n, w in params.items()}
        return params, opt, loss / self.n_micro

    @torch.no_grad()
    def valid_accuracy(self, params: dict, pool: torch.Tensor,
                       pool_lb: torch.Tensor, vb_idx: torch.Tensor
                       ) -> torch.Tensor:
        """Each lane's accuracy over its ``vb_idx`` [K, n_vb, mb] rows."""
        k, n_vb, mb = vb_idx.shape
        total = torch.zeros(k, dtype=torch.int64, device=self.device)
        for i in range(n_vb):
            rows = vb_idx[:, i]
            total += self._veval(params, stacked_input(pool, rows),
                                 pool_lb[rows.long()])
        return total.double() / (n_vb * mb)

    @staticmethod
    def merge_lanes(state, fresh, mask: torch.Tensor):
        """Replace the lanes where ``mask`` [K] with ``fresh``'s (the slot
        refill); every leaf has a leading K axis."""
        if isinstance(state, dict):
            return {n: WavePrograms.merge_lanes(v, fresh[n], mask)
                    for n, v in state.items()}
        return torch.where(_lane(mask, state), fresh, state)


def _microbatching(skel: WaveSkeleton, batch_size: int,
                   microbatch: int | None) -> tuple[int, int]:
    if microbatch is None:
        microbatch = default_microbatch(skel, batch_size)
    microbatch = min(microbatch, batch_size)
    while batch_size % microbatch:
        microbatch -= 1
    return microbatch, batch_size // microbatch


def planar_pool(pixels: np.ndarray, device) -> torch.Tensor:
    """uint8 NHWC host pixels -> the planar ``[N, 3, S, S]`` device pool
    the preprocess kernel gathers from."""
    planar = np.ascontiguousarray(np.asarray(pixels, np.uint8).transpose(
        0, 3, 1, 2))
    return torch.from_numpy(planar).to(device)


def train_wave(
    skel: WaveSkeleton,
    conv_widths: np.ndarray,    # [K, conv_count] int
    linear_widths: np.ndarray,  # [K, n_linear] int
    dropouts: np.ndarray,       # [K, n_linear] float
    lrs: np.ndarray,            # [K] float
    train_pixels: np.ndarray,
    train_labels: np.ndarray,
    valid_pixels: np.ndarray,
    valid_labels: np.ndarray,
    epochs: int = 10,
    batch_size: int = 32,
    train_limit: int | None = None,
    valid_limit: int | None = None,
    seed: int = 0,
    microbatch: int | None = None,
    epoch_callback=None,
    device="cuda",
) -> dict[str, Any]:
    """Train one wave of K padded trials in lockstep on ``device``;
    returns per-epoch validation accuracy ``[epochs, K]`` and the per-step
    losses ``[steps, K]``. Each lane walks the wave's batches in its own
    order; ``epoch_callback(epoch, accuracies)`` returning False stops the
    wave (every trial pruned)."""
    from skin_image_analysis_tpu_torch.train.loop import resolve_device

    dev = resolve_device(device)
    k = len(lrs)
    conv_w = torch.as_tensor(np.asarray(conv_widths), dtype=torch.int64,
                             device=dev)
    lin_w = torch.as_tensor(np.asarray(linear_widths), dtype=torch.int64,
                            device=dev)
    drops = torch.as_tensor(np.asarray(dropouts, np.float32), device=dev)
    lr_t = torch.as_tensor(np.asarray(lrs, np.float32), device=dev)
    rng = np.random.default_rng(seed)

    def stack(labels, limit, bsz):
        order = rng.permutation(len(labels))
        n_batches = len(labels) // bsz
        if limit is not None:
            n_batches = min(n_batches, max(limit // bsz, 1))
        return order[: n_batches * bsz].reshape(n_batches, bsz)

    microbatch, n_micro = _microbatching(skel, batch_size, microbatch)
    tb = stack(train_labels, train_limit, batch_size)
    vb = stack(valid_labels, valid_limit, microbatch)
    n_tr = len(train_labels)
    pool = planar_pool(np.concatenate([train_pixels, valid_pixels]), dev)
    pool_lb = torch.as_tensor(np.concatenate(
        [train_labels, valid_labels]).astype(np.int64), device=dev)
    vb_idx = torch.as_tensor(np.broadcast_to(vb + n_tr, (k,) + vb.shape)
                             .copy(), device=dev)

    progs = WavePrograms(skel, microbatch, n_micro, dev)
    masks = wave_masks(skel, conv_w, lin_w)
    params, opt = progs.init_wave([seed * 1000 + i for i in range(k)],
                                  conv_w, lin_w)
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    history, losses = [], []
    for epoch in range(epochs):
        perms = np.stack([rng.permutation(len(tb)) for _ in range(k)])
        tb_idx = torch.as_tensor(tb[perms], device=dev)  # [K, n_b, B]
        for i in range(tb_idx.shape[1]):
            params, opt, loss = progs.train_step(
                params, opt, pool, pool_lb, tb_idx[:, i], masks, drops,
                lr_t, progs.draw_noise(k, gen))
            losses.append(loss.detach())
        history.append(progs.valid_accuracy(params, pool, pool_lb, vb_idx)
                       .cpu().numpy())
        if epoch_callback is not None and not epoch_callback(
                epoch, history[-1]):
            break
    return {
        "accuracy_history": np.stack(history),
        "final_accuracy": history[-1],
        "losses": torch.stack(losses).float().cpu().numpy(),
        "params": params,
    }
