"""Train and eval steps (port of the JAX package's ``train.step``).

A train step is forward + masked NLL + backward + the optimizer update.
It runs the model with ``train=True``, so a model with BatchNorm
normalizes with the batch's statistics (over all B rows, invalid ones
too) and moves its running averages once; eval runs on the running
averages.
The multi-step forms take ``[k, B]`` arena row indices and run a Python
loop over the k steps; with the fused preprocess kernel the kernel
gathers each batch from the device arena itself. A step whose rows are
all invalid (the padding of an epoch's last call) is inert: it computes
nothing, updates nothing (BatchNorm statistics included), draws no
random numbers and does not advance the step count. Metrics stay on the
device; the caller fetches them once.
The five-crop eval step averages the log-probs of four corner crops and
the centre crop.

Inside :func:`debug_nans` every train step and eval batch is checked for
non-finite values (the port's ``--debug-nans``).

The steps mark their layers as spans (``utils.profiling.annotate``), which
a profiler session records: ``train.call`` (a multi-step call, its index
uploads included), ``train.step`` (a live step) and inside it
``train.preprocess``, ``train.forward`` (the model and the loss),
``train.backward``, ``train.reduce`` (the gradients' all-reduce under a
mesh) and ``train.optimizer``; ``eval.call`` (a multi-batch call, or an
eval step called alone).

Every step and maker takes a process ``mesh`` (``parallel.create_mesh``
under a ``torch.distributed`` group), where the JAX package's steps take a
device mesh: each rank runs its rows of the global batch, the loss over
the global batch's weight, the gradients and metrics summed over the
data axis, the flatten Dense split over the model axis
(``parallel.tensor``). A model's train-mode BatchNorm then normalizes
with the global batch's statistics (``models.resnet.global_batch_stats``),
and its dropout takes each rank's rows of the whole batch's draws, so
that every family's step equals the single-process one on the global
batch, as GSPMD makes the JAX package's.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import inspect
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from skin_image_analysis_tpu_torch.models.resnet import global_batch_stats
from skin_image_analysis_tpu_torch.ops.losses import nll_loss
from skin_image_analysis_tpu_torch.ops.preprocess import (
    AugmentDraws,
    draw_augment,
    five_crop_batch,
    preprocess_batch,
)
from skin_image_analysis_tpu_torch.parallel.distributed import gather_rows
from skin_image_analysis_tpu_torch.train.state import TrainState
from skin_image_analysis_tpu_torch.utils.profiling import annotate


_CHECK_FINITE = contextvars.ContextVar("debug_nans", default=False)


@contextlib.contextmanager
def debug_nans() -> Iterator[None]:
    """The nearest torch comes to ``jax_debug_nans``, for the ``with``
    block: autograd's anomaly mode over every backward, and a check of
    each train step (the model input, the log-probs, the loss, then every
    gradient, in that order) and of each eval batch's log-probs. The first
    non-finite value raises :class:`FloatingPointError` naming the step
    and the tensor; anomaly mode's ``RuntimeError`` for a backward
    function that returned NaN is raised as one. Every step of a
    multi-step call is checked on its own. The checks read each value
    back to the host, so a step waits for the card.

    What it cannot catch, where ``jax_debug_nans`` would: a NaN that
    appears and vanishes inside one operation or one CUDA kernel (the
    fused preprocess kernel, a cuDNN convolution), and a NaN in a masked
    branch that a ``where`` or a mask drops. A forward NaN is named by
    the first checked tensor that carries it, not by the operation that
    made it."""
    token = _CHECK_FINITE.set(True)
    anomaly = torch.is_anomaly_enabled()
    check_nan = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(anomaly, check_nan)
        _CHECK_FINITE.reset(token)


def _raise_non_finite(where: str,
                      named: Sequence[tuple[str, torch.Tensor]]) -> None:
    """FloatingPointError naming the first of ``named`` that holds a
    non-finite value."""
    finite = torch.stack([t.isfinite().all() for _, t in named]).tolist()
    for (name, _), ok in zip(named, finite):
        if not ok:
            raise FloatingPointError(f"debug_nans: non-finite {name} in "
                                     f"{where}")


def masked_loss_and_metrics(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor | None = None,
    class_weights=None,
    reduce: Callable | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(loss, correct, count)``. With ``valid``, padded rows count
    nowhere: the loss is ``-sum(w * log_p[label]) / max(sum(w), 1)`` with
    ``w`` the validity times the label's class weight.

    ``reduce`` (a sum over the ranks of a data axis) makes ``sum(w)`` the
    global batch's: each rank's loss is then its share, and the shares
    sum to the whole batch's loss however the invalid rows fall."""
    labels = labels.long()
    preds = log_probs.argmax(dim=-1)
    if valid is None and reduce is None:
        loss = nll_loss(log_probs, labels, class_weights)
        correct = (preds == labels).sum()
        count = torch.tensor(labels.shape[0], device=labels.device)
        return loss, correct, count
    picked = log_probs.gather(1, labels[:, None])[:, 0]
    w = (valid.float() if valid is not None
         else torch.ones_like(picked, dtype=torch.float32))
    if class_weights is not None:
        w = w * torch.as_tensor(class_weights, dtype=torch.float32,
                                device=w.device)[labels]
    denom = w.sum() if reduce is None else reduce(w.sum().detach())
    if valid is not None:
        denom = torch.clamp_min(denom, 1.0)
    loss = -(w * picked).sum() / denom
    if valid is None:
        return loss, (preds == labels).sum(), torch.tensor(
            labels.shape[0], device=labels.device)
    return loss, ((preds == labels) & valid).sum(), valid.sum()


def _shard(mesh, data_axis: str, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's rows of an ``n``-row global batch."""
    dp = mesh.shape[data_axis]
    if n % dp:
        raise ValueError(f"batch of {n} rows not divisible by data-"
                         f"parallel degree {dp}")
    w = n // dp
    lo = mesh.axis_index(data_axis) * w
    return lo, lo + w


def _sum_over(mesh, data_axis: str, t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` summed over this rank's ``data_axis`` group."""
    return mesh.all_reduce(t.clone(), data_axis)


def _rank_draws(state: TrainState, preprocess_fn, n: int, side: int,
                lo: int, hi: int):
    """(augment draws, dropout noise) of this rank's rows ``[lo, hi)``,
    drawn for the whole ``n``-row batch from the state's generator, as
    one process draws them."""
    model, gen = state.model, state.generator
    missing = [what for what, ok in (
        ("a draw_dropout_noise method",
         hasattr(model, "draw_dropout_noise")),
        ("a forward that takes dropout_noise",
         "dropout_noise" in inspect.signature(model.forward).parameters),
    ) if not ok]
    if missing:
        raise NotImplementedError(
            "data-parallel training draws the whole batch's dropout ahead "
            "and hands each rank its rows, which needs "
            f"{' and '.join(missing)}; {type(model).__name__} lacks it "
            "(every family of the model registry has both)")
    draws = None
    augment = getattr(preprocess_fn, "augment", None)
    if augment is not None:
        whole = draw_augment(n, side, preprocess_fn.image_size, augment,
                             gen)
        draws = AugmentDraws(*(None if t is None else t[lo:hi]
                               for t in whole))
    device = next(model.parameters()).device
    noise = [None if u is None else u[lo:hi]
             for u in model.draw_dropout_noise(n, gen, device)]
    return draws, noise


def train_step(
    state: TrainState,
    pixels: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor | None = None,
    class_weights=None,
    preprocess_fn: Callable | None = None,
    rows: torch.Tensor | None = None,
    mesh=None,
    data_axis: str = "data",
) -> dict[str, torch.Tensor]:
    """One step on a batch; updates ``state`` in place. ``pixels`` is the
    model input, or the raw batch when ``preprocess_fn`` is given, or the
    whole arena when ``rows`` selects the batch for a ``preprocess_fn``
    that gathers (``supports_rows``).

    Under a process ``mesh`` the step is data (and tensor) parallel: the
    arguments are the global batch and this rank trains its rows of it.
    Every rank draws the whole batch's augmentation and dropout from its
    generator (kept in step on every rank) and keeps its rows, the loss
    is normalised over the global batch, and the gradients and metrics
    are summed over the data axis, so the step equals the
    single-process one on the global batch."""
    with annotate("train.step"):
        model, opt, gen = state.model, state.optimizer, state.generator
        reduce, kw, fwd = None, {}, {}
        if mesh is not None:
            reduce = functools.partial(_sum_over, mesh, data_axis)
            n = labels.shape[0]
            lo, hi = _shard(mesh, data_axis, n)
            labels = labels[lo:hi]
            valid = None if valid is None else valid[lo:hi]
            if rows is not None:
                rows = rows[lo:hi]
            else:
                pixels = pixels[lo:hi]
            kw["draws"], fwd["dropout_noise"] = _rank_draws(
                state, preprocess_fn, n, pixels.shape[2], lo, hi)
        if preprocess_fn is not None:
            if rows is not None:
                kw["rows"] = rows
            with annotate("train.preprocess"):
                pixels = preprocess_fn(pixels, gen, **kw)
        model.train()
        params = opt.params
        for p in params:
            p.grad = None
        with annotate("train.forward"):
            with (contextlib.nullcontext() if mesh is None
                  else global_batch_stats(mesh, data_axis)):
                log_probs = model(pixels, train=True, generator=gen, **fwd)
            loss, correct, count = masked_loss_and_metrics(
                log_probs, labels, valid, class_weights, reduce)
        with annotate("train.backward"):
            if _CHECK_FINITE.get():
                grads = _checked_grads(state, pixels, log_probs, loss)
            else:
                grads = torch.autograd.grad(loss, params)
        if reduce is not None:
            with annotate("train.reduce"):
                for g in grads:
                    mesh.all_reduce(g, data_axis)
        with annotate("train.optimizer"):
            opt.step(grads)
        state.step += 1
        loss = loss.detach()
        if reduce is not None:
            loss, correct, count = (reduce(t) for t in (
                loss, correct.long(), count.long()))
        return {"loss": loss, "correct": correct, "count": count}


def _checked_grads(state: TrainState, pixels: torch.Tensor,
                   log_probs: torch.Tensor, loss: torch.Tensor) -> tuple:
    """The train step's gradients under :func:`debug_nans`."""
    where = f"train step {state.step + 1}"
    _raise_non_finite(where, [("model input", pixels),
                              ("log-probs", log_probs), ("loss", loss)])
    params = state.optimizer.params
    try:
        grads = torch.autograd.grad(loss, params)
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"debug_nans: {where}: {e}") from e
    names = {id(p): n for n, p in state.model.named_parameters()}
    _raise_non_finite(where, [(f"gradient of {names[id(p)]}", g)
                              for p, g in zip(params, grads)])
    return grads


def multi_train_step(
    state: TrainState,
    arena: torch.Tensor,
    idx: np.ndarray,
    labels: np.ndarray,
    valid: np.ndarray,
    class_weights=None,
    preprocess_fn: Callable | None = None,
    skip_empty: bool = True,
    mesh=None,
    data_axis: str = "data",
) -> dict[str, torch.Tensor]:
    """k train steps over batches gathered from the device ``arena`` by
    the host arrays ``idx``, ``labels``, ``valid`` (each ``[k, B]``).
    Returns ``{"loss", "correct", "count"}``, each ``[k]`` on the device;
    inert steps report 0 for all three. With ``skip_empty=False`` a step
    whose rows are all invalid runs as any other (loss 0, an optimizer
    update from zero gradients), as the JAX package's one-step-a-call
    path runs it. Under a process ``mesh`` the ``[k, B]`` arrays are the
    global batches, every rank holds the whole arena, and each step
    gathers this rank's rows (:func:`train_step`)."""
    with annotate("train.call"):
        dev = arena.device
        k = idx.shape[0]
        idx_d = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
        lab_d = torch.from_numpy(
            np.ascontiguousarray(labels, np.int64)).to(dev)
        val_d = torch.from_numpy(np.ascontiguousarray(valid, bool)).to(dev)
        gathers = getattr(preprocess_fn, "supports_rows", False)
        par = {} if mesh is None else {"mesh": mesh, "data_axis": data_axis}
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        losses, corrects, counts = [], [], []
        for i in range(k):
            if skip_empty and not valid[i].any():
                losses.append(zero)
                corrects.append(izero)
                counts.append(izero)
                continue
            if gathers:
                m = train_step(state, arena, lab_d[i], val_d[i],
                               class_weights, preprocess_fn, rows=idx_d[i],
                               **par)
            else:
                m = train_step(state, arena[idx_d[i].long()], lab_d[i],
                               val_d[i], class_weights, preprocess_fn, **par)
            losses.append(m["loss"].float())
            corrects.append(m["correct"].long())
            counts.append(m["count"].long())
        return {"loss": torch.stack(losses), "correct": torch.stack(corrects),
                "count": torch.stack(counts)}


@torch.no_grad()
def eval_step(
    model: torch.nn.Module,
    pixels: torch.Tensor,
    row_id: torch.Tensor,
    valid: torch.Tensor | None = None,
    preprocess_fn: Callable | None = None,
    mesh=None,
    data_axis: str = "data",
) -> dict[str, torch.Tensor]:
    """Forward without dropout + argmax: ``{"pred", "log_probs",
    "row_id"}`` (+ ``"valid"``). Under a process ``mesh`` each rank scores
    its rows of the batch and every rank gets the whole batch's
    log-probs (the argmax is taken over them)."""
    with annotate("eval.call"):
        return _eval_batch(model, pixels, row_id, valid, preprocess_fn,
                           mesh, data_axis)


def _eval_batch(model, pixels, row_id, valid, preprocess_fn, mesh,
                data_axis):
    """:func:`eval_step` outside its span, for callers inside their own."""
    if mesh is not None:
        n = pixels.shape[0]
        lo, hi = _shard(mesh, data_axis, n)
        pixels = pixels[lo:hi]
    if preprocess_fn is not None:
        pixels = preprocess_fn(pixels, None)
    model.eval()
    log_probs = model(pixels, train=False)
    if _CHECK_FINITE.get():
        _raise_non_finite("an eval batch", [("log-probs", log_probs)])
    if mesh is not None:
        log_probs = gather_rows(mesh, data_axis, log_probs, n, lo)
    out = {"pred": log_probs.argmax(dim=-1), "log_probs": log_probs,
           "row_id": row_id}
    if valid is not None:
        out["valid"] = valid
    return out


@torch.no_grad()
def multi_eval_step(
    model: torch.nn.Module,
    arena: torch.Tensor,
    idx: np.ndarray,
    row_id: np.ndarray,
    valid: np.ndarray,
    preprocess_fn: Callable | None = None,
    mesh=None,
    data_axis: str = "data",
) -> dict[str, torch.Tensor]:
    """k eval batches gathered from the device ``arena`` by the host
    arrays ``idx``, ``row_id``, ``valid`` (each ``[k, B]``). Returns
    ``{"pred" [k,B], "log_probs" [k,B,C], "row_id" [k,B], "valid"
    [k,B]}`` on the device; padded rows carry ``valid=False``. Under a
    process ``mesh`` each rank scores its rows of each batch, and every
    rank returns the whole batches."""
    with annotate("eval.call"):
        dev = arena.device
        k, b = idx.shape
        idx_d = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
        lo, hi = (0, b) if mesh is None else _shard(mesh, data_axis, b)
        gathers = getattr(preprocess_fn, "supports_rows", False)
        preds, log_probs = [], []
        for i in range(k):
            if not valid[i].any() and log_probs:
                # a padding batch: its rows are dropped by every consumer
                preds.append(torch.zeros_like(preds[-1]))
                log_probs.append(torch.zeros_like(log_probs[-1]))
                continue
            rows = idx_d[i, lo:hi]
            if gathers:
                pixels = preprocess_fn(arena, None, rows=rows)
            else:
                pixels = arena[rows.long()]
                if preprocess_fn is not None:
                    pixels = preprocess_fn(pixels, None)
            out = _eval_batch(model, pixels, None, None, None, None, data_axis)
            lp = out["log_probs"]
            if mesh is not None:
                lp = gather_rows(mesh, data_axis, lp, b, lo)
            preds.append(lp.argmax(dim=-1))
            log_probs.append(lp)
        return {
            "pred": torch.stack(preds),
            "log_probs": torch.stack(log_probs),
            "row_id": torch.from_numpy(np.asarray(row_id, np.int32)).to(dev),
            "valid": torch.from_numpy(np.asarray(valid, bool)).to(dev),
        }


def _check_mesh(mesh) -> None:
    if mesh is not None and not getattr(mesh, "is_process_mesh", False):
        raise TypeError(
            "the train and eval steps take a process mesh "
            "(parallel.create_mesh under torch.distributed), got "
            f"{mesh!r}")


def make_train_step(
    class_weights=None,
    mesh=None,
    data_axis: str = "data",
    preprocess_fn: Callable | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The JAX package's maker over :func:`train_step`: ``step(state,
    batch) -> (state, metrics)`` for a batch ``{"pixels", "label"}`` with
    an optional ``"valid"`` mask. The state is updated in place and
    returned. Under a process ``mesh`` the batch is the global batch (as
    ``parallel.distributed.global_batch`` assembles it from each rank's
    rows); ``data_axis`` names the mesh axis of the batch."""
    _check_mesh(mesh)

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        metrics = train_step(state, batch["pixels"], batch["label"],
                             batch.get("valid"), class_weights,
                             preprocess_fn, mesh=mesh, data_axis=data_axis)
        return state, metrics

    return step


def make_eval_step(
    mesh=None,
    data_axis: str = "data",
    preprocess_fn: Callable | None = None,
) -> Callable[[torch.nn.Module, dict], dict]:
    """The JAX package's maker over :func:`eval_step`: ``step(model,
    batch)`` for a batch ``{"pixels", "row_id"}`` with an optional
    ``"valid"``, returning ``{"pred", "log_probs", "row_id"}`` (+
    ``"valid"``). The model carries its weights and BatchNorm statistics,
    where the JAX step takes them apart. Under a process ``mesh`` the
    batch is the global batch; each rank scores its rows."""
    _check_mesh(mesh)

    def step(model: torch.nn.Module, batch: dict) -> dict:
        return eval_step(model, batch["pixels"], batch["row_id"],
                         batch.get("valid"), preprocess_fn, mesh=mesh,
                         data_axis=data_axis)

    return step


def make_multi_train_step(
    k: int,
    class_weights=None,
    mesh=None,
    data_axis: str = "data",
    preprocess_fn: Callable | None = None,
) -> Callable:
    """The JAX package's maker over :func:`multi_train_step`:
    ``multi(state, arena, idx [k, B], label [k, B], valid [k, B]) ->
    (state, {"loss" [k], "correct" [k], "count" [k]})``, the host arrays
    numpy and ``arena`` on the device. Steps whose rows are all invalid
    are inert. The state is updated in place and returned; ``k`` is
    checked against each call's arrays, as the JAX program asserts it."""
    _check_mesh(mesh)

    def multi(state: TrainState, arena: torch.Tensor, idx, label,
              valid) -> tuple[TrainState, dict]:
        if np.shape(idx)[0] != k:
            raise ValueError(f"make_multi_train_step built for k={k} but "
                             f"got {np.shape(idx)[0]}-step index arrays")
        metrics = multi_train_step(
            state, arena, np.asarray(idx), np.asarray(label),
            np.asarray(valid), class_weights, preprocess_fn, mesh=mesh,
            data_axis=data_axis)
        return state, metrics

    return multi


def make_multi_eval_step(
    k: int,
    mesh=None,
    data_axis: str = "data",
    preprocess_fn: Callable | None = None,
) -> Callable:
    """The JAX package's maker over :func:`multi_eval_step`:
    ``multi(model, arena, idx [k, B], row_id [k, B], valid [k, B]) ->
    {"pred" [k, B], "log_probs" [k, B, C], "row_id" [k, B], "valid"
    [k, B]}``. The model carries its weights and BatchNorm statistics,
    where the JAX program takes ``params, apply_fn`` and
    ``batch_stats``."""
    _check_mesh(mesh)

    def multi(model: torch.nn.Module, arena: torch.Tensor, idx, row_id,
              valid) -> dict:
        if np.shape(idx)[0] != k:
            raise ValueError(f"make_multi_eval_step built for k={k} but "
                             f"got {np.shape(idx)[0]}-batch index arrays")
        return multi_eval_step(model, arena, np.asarray(idx),
                               np.asarray(row_id), np.asarray(valid),
                               preprocess_fn, mesh=mesh,
                               data_axis=data_axis)

    return multi


def make_five_crop_eval_step(
    crop_size: int,
    normalize_imagenet: bool = False,
    channels_fn: Callable | None = None,
    input_affine: tuple | None = None,
) -> Callable:
    """Five-crop test-time augmentation: ``step(model, pixels, row_id,
    valid=None)`` on NHWC ``pixels`` at the canonical (pre-crop) size.
    The five crops ride one batched forward; their log-probs are averaged
    before the argmax. ``channels_fn`` maps the cropped float RGB batch
    to the model input (in place of the normalisation)."""

    @torch.no_grad()
    def step(model, pixels, row_id, valid=None):
        with annotate("eval.call"):
            x = five_crop_batch(pixels, crop_size)
            x = preprocess_batch(
                x, None, image_size=crop_size, train=False,
                normalize_imagenet=normalize_imagenet and channels_fn is None,
                input_affine=input_affine if channels_fn is None else None)
            if channels_fn is not None:
                x = channels_fn(x)
            model.eval()
            log_probs = model(x, train=False)
            log_probs = log_probs.reshape(5, -1, log_probs.shape[-1]).mean(0)
            out = {"pred": log_probs.argmax(dim=-1), "log_probs": log_probs,
                   "row_id": row_id}
            if valid is not None:
                out["valid"] = valid
            return out

    return step
