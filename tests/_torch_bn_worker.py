"""Worker of tests/test_torch_bn_parallel.py: one rank of a 2-rank gloo
CPU cluster training the BatchNorm families data-parallel.

Usage: python tests/_torch_bn_worker.py <rank> <world> <port> <dir>

``<dir>`` holds ``cases.json`` (the cohort root and the resnet init file)
written by the test; each rank writes ``rank<r>.pt``: per case its
outputs, gradients, losses, parameters and running statistics, and the
folder of the ``run_training`` case.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from skin_image_analysis_tpu_torch import config as C

SIDE, GLOBAL_B = 32, 8
# the layer cases: (global rows, rows of rank 0, compute dtype)
BN_CASES = {"even": (8, 4, "float32"), "uneven": (8, 3, "float32"),
            "bf16": (8, 4, "bfloat16")}
NODROP = "resnet18_nodrop"


def register_nodrop() -> None:
    """``resnet18_nodrop``: resnet18 with the head's dropout off, so a
    step draws nothing random (``tests.test_torch_resnet.nodrop_models``'
    port half)."""
    from skin_image_analysis_tpu_torch.models import registry, resnet

    if NODROP in registry._REGISTRY:
        return

    @registry.register_model(NODROP)
    def build(cfg, device=None):
        return resnet.ResNet((2, 2, 2, 2), "basic", cfg.num_classes,
                             head_dropout=0.0,
                             compute_dtype=cfg.compute_dtype,
                             freeze_backbone=cfg.freeze_backbone,
                             in_channels=cfg.in_channels, device=device)


def bn_data(rows: int, channels: int = 6, seed: int = 0):
    """(x [rows, C, 5, 5], cotangent, weight, bias, running mean, running
    var), float32, channel means away from 0."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, channels, 5, 5)) * 2
         + rng.standard_normal((1, channels, 1, 1)) * 3)
    g = rng.standard_normal((rows, channels, 5, 5))
    params = (1 + 0.2 * rng.standard_normal(channels),
              0.1 * rng.standard_normal(channels),
              0.1 * rng.standard_normal(channels),
              rng.uniform(0.5, 1.5, channels))
    return [np.asarray(a, np.float32) for a in (x, g, *params)]


def bn_case(name: str, lo: int, hi: int, mesh=None) -> dict:
    """The port's BatchNorm in train mode on rows [lo, hi) of the case's
    batch (all rows without a mesh): its output, the gradients of
    ``sum(y * g)`` to the rows, scale and bias, and the running stats."""
    from skin_image_analysis_tpu_torch.models.resnet import (
        BatchNorm,
        global_batch_stats,
    )

    rows, _, dtype = BN_CASES[name]
    x, g, w, b, rm, rv = (torch.from_numpy(a) for a in bn_data(rows))
    bn = BatchNorm(x.shape[1], dtype)
    with torch.no_grad():
        for t, v in ((bn.weight, w), (bn.bias, b), (bn.running_mean, rm),
                     (bn.running_var, rv)):
            t.copy_(v)
    xr = x[lo:hi].to(bn.compute_dtype).requires_grad_(True)
    if mesh is None:
        y = bn(xr, train=True)
    else:
        with global_batch_stats(mesh):
            y = bn(xr, train=True)
    (y.float() * g[lo:hi]).sum().backward()
    return {"y": y.detach().float(), "dx": xr.grad.float(),
            "dw": bn.weight.grad.clone(), "db": bn.bias.grad.clone(),
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def resnet_batch(seed: int = 1) -> dict:
    """Float NHWC pixels of the ImageNet-normalized scale, labels, and
    one invalid row (it still counts in the batch statistics)."""
    rng = np.random.default_rng(seed)
    return {"pixels": rng.standard_normal((GLOBAL_B, SIDE, SIDE, 3))
            .astype(np.float32),
            "label": (np.arange(GLOBAL_B) % 2).astype(np.int32),
            "valid": np.arange(GLOBAL_B) != 2}


def _state_out(state, steps) -> dict:
    return {"losses": [s["loss"] for s in steps], "steps": steps,
            "state": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "step": state.step}


def resnet_step_case(init: str, mesh=None, lr: float = 1e-2) -> dict:
    """Two sgd steps of resnet18 without head dropout from the JAX init
    ``init`` on :func:`resnet_batch`, through ``make_train_step``."""
    from skin_image_analysis_tpu_torch.train.state import create_train_state
    from skin_image_analysis_tpu_torch.train.step import make_train_step

    register_nodrop()
    state = create_train_state(
        C.ModelConfig(name=NODROP, image_size=SIDE, compute_dtype="float32"),
        C.OptimConfig(optimizer="sgd", learning_rate=lr), 0, "cpu")
    state.model.load_state_dict(torch.load(init))
    step = make_train_step(mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in resnet_batch().items()}
    steps = []
    for _ in range(2):
        _, m = step(state, batch)
        steps.append({k: v.item() for k, v in m.items()})
    return _state_out(state, steps)


def aug_data():
    """(arena [20, 3, 40, 40] u8, [k, B] calls): two steps of 8 and an
    inert padding step, row 4 invalid."""
    from skin_image_analysis_tpu_torch.train.loop import super_batches

    rng = np.random.default_rng(6)
    arena = rng.integers(0, 256, (20, 3, 40, 40), dtype=np.uint8)
    labels = rng.integers(0, 2, 20)
    row_ok = np.ones(20, bool)
    row_ok[4] = False
    order = rng.permutation(20)
    return arena, list(super_batches(order, labels, GLOBAL_B, 3, True,
                                     row_ok=row_ok))


def resnet_aug_case(mesh=None) -> dict:
    """resnet18 (head dropout 0.5) from the port's seed-0 init, sgd (as
    the step cases: adam's first step turns a near-zero gradient's
    rounding into up to lr of weight), two augmented steps a call from a
    planar arena through the fused preprocess (random crop 40 -> 32,
    flip, jitter), ImageNet-normalized, class weights, an invalid row and
    an inert step."""
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )
    from skin_image_analysis_tpu_torch.train.state import create_train_state
    from skin_image_analysis_tpu_torch.train.step import multi_train_step

    state = create_train_state(
        C.ModelConfig(name="resnet18", image_size=SIDE,
                      compute_dtype="float32"),
        C.OptimConfig(optimizer="sgd", learning_rate=1e-2), 0, "cpu")
    pre = make_preprocess_fn(
        SIDE, train=True, layout="planar", normalize_imagenet=True,
        augment=AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1))
    arena, calls = aug_data()
    steps = []
    for ib, lb, vd in calls:
        m = multi_train_step(state, torch.from_numpy(arena), ib, lb, vd,
                             (0.4, 1.6), pre, mesh=mesh)
        steps += [{k: v[i].item() for k, v in m.items()}
                  for i in range(ib.shape[0])]
    return _state_out(state, steps)


def run_config(root: str, results_dir: str) -> C.TrainConfig:
    return C.TrainConfig(
        epochs=2, seed=0, results_dir=results_dir, eval_every=1,
        checkpoint_every=1,
        data=C.DataConfig(root_dir=root, image_size=SIDE, canonical_size=40,
                          batch_size=GLOBAL_B, augment=True,
                          normalize_imagenet=True, steps_per_dispatch=2,
                          decode_workers=1),
        model=C.ModelConfig(name="resnet18", image_size=SIDE,
                            compute_dtype="float32"),
        optim=C.OptimConfig(optimizer="sgd", learning_rate=1e-2,
                            auto_class_weights=True))


def main() -> None:
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    os.environ.update(SIA_COORDINATOR=f"127.0.0.1:{port}",
                      SIA_NUM_PROCESSES=str(world),
                      SIA_PROCESS_ID=str(rank))
    from skin_image_analysis_tpu_torch.parallel import create_mesh
    from skin_image_analysis_tpu_torch.parallel import distributed as pd
    from skin_image_analysis_tpu_torch.train.loop import run_training

    assert pd.maybe_initialize(device="cpu")
    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)
    mesh = create_mesh()
    out = {}
    for name, (rows, first, _) in BN_CASES.items():
        lo, hi = (0, first) if rank == 0 else (first, rows)
        out[name] = bn_case(name, lo, hi, mesh)
    out["resnet_step"] = resnet_step_case(spec["init"], mesh)
    out["resnet_aug"] = resnet_aug_case(mesh)
    out["run"] = run_training(run_config(spec["root"],
                                         os.path.join(work, "run")),
                              verbose=False, device="cpu")
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
