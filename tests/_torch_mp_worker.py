"""Worker of tests/test_torch_parallel.py: one rank of a 2-rank gloo CPU
cluster running every data- and tensor-parallel case of the port.

Usage: python tests/_torch_mp_worker.py <rank> <world> <port> <dir>

``<dir>`` holds ``cases.json`` (the cohort root and the step cases' init
files) written by the test; each rank writes ``rank<r>.pt``: per case,
the losses and metrics of every step and the whole (gathered)
parameters, and the folders of the ``run_training`` cases with their
streamed loaders' decode counts.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from skin_image_analysis_tpu_torch import config as C

GLOBAL_B = 16
# JAX's tests/test_sharding.py MODEL: the flatten Dense (4 * 32 * 32 x
# 256, 1 << 20 elements) is the one the TP rule splits
MODEL = C.ModelConfig(conv_features=(4,), linear_features=(256,),
                      dropout=(0.0,), image_size=64,
                      compute_dtype="float32")
# the augmented case: random crop 40 -> 32, flip, jitter, dropout 0.5,
# and a 1024 x 1024 flatten Dense (1 << 20 elements: TP splits it)
AUG_MODEL = C.ModelConfig(conv_features=(4,), linear_features=(1024,),
                          dropout=(0.5,), image_size=32,
                          compute_dtype="float32")
# two 1 << 20-element Dense kernels: the first column-, the second
# row-parallel under TP (the Megatron pair; the flagship has one)
ROW_MODEL = C.ModelConfig(conv_features=(4,), linear_features=(1024, 1024),
                          dropout=(0.5, 0.5), image_size=32,
                          compute_dtype="float32")
WEIGHTS = (0.3, 1.7)
# the tiny cohort's run: a 8192 x 128 flatten Dense (1 << 20 elements)
RUN_MODEL = C.ModelConfig(conv_features=(32,), linear_features=(128,),
                          dropout=(0.5,), image_size=32,
                          compute_dtype="float32")


def step_batch(seed: int, n: int, uneven: bool = False) -> dict:
    """JAX's ``_batch``: float NHWC pixels at 64², labels shifting the
    mean. ``uneven``: five invalid rows in the first half, none in the
    second, so the halves' class-weighted denominators differ."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, n).astype(np.int32)
    pixels = rng.normal(0, 0.1, (n, 64, 64, 3)).astype(np.float32)
    pixels += labels[:, None, None, None] * 0.5
    valid = np.ones(n, bool)
    if uneven:
        valid[[0, 2, 3, 5, 6]] = False
    return {"pixels": pixels, "label": labels,
            "row_id": np.arange(n, dtype=np.int32), "valid": valid}


def aug_data():
    """(arena [24, 3, 40, 40] u8, labels, row_ok, [k, B] super-batches):
    three steps of 8, the last call padded with an inert step, row 5
    invalid."""
    from skin_image_analysis_tpu_torch.train.loop import super_batches

    rng = np.random.default_rng(5)
    arena = rng.integers(0, 256, (24, 3, 40, 40), dtype=np.uint8)
    labels = rng.integers(0, 2, 24)
    row_ok = np.ones(24, bool)
    row_ok[[5, 17, 18]] = False
    order = rng.permutation(24)
    calls = list(super_batches(order, labels, 8, 2, True, row_ok=row_ok))
    return arena, labels, calls


def aug_preprocess():
    from skin_image_analysis_tpu_torch.ops.preprocess import (
        AugmentConfig,
        make_preprocess_fn,
    )

    return make_preprocess_fn(
        32, train=True, layout="planar",
        augment=AugmentConfig(brightness=0.1, contrast=0.1, saturation=0.1))


def run_case(case: dict, mesh=None) -> dict:
    """One step case on ``mesh`` (None: the single process): the
    per-step metrics and the whole parameters after the steps."""
    from skin_image_analysis_tpu_torch.parallel import distributed as pd
    from skin_image_analysis_tpu_torch.parallel.tensor import (
        full_state_dict,
        shard_train_state,
    )
    from skin_image_analysis_tpu_torch.train.state import create_train_state
    from skin_image_analysis_tpu_torch.train.step import (
        make_train_step,
        multi_train_step,
    )

    aug = case["kind"] == "aug"
    model_cfg = (ROW_MODEL if case.get("rows") else AUG_MODEL) if aug \
        else MODEL
    state = create_train_state(model_cfg, C.OptimConfig(
        learning_rate=case["lr"], optimizer=case.get("optimizer", "adam")),
        0, "cpu")
    if case.get("init"):
        state.model.load_state_dict(torch.load(case["init"]))
    if mesh is not None:
        shard_train_state(state, mesh)
    weights = WEIGHTS if case.get("weights") else None
    steps = []
    if aug:
        arena, labels, calls = aug_data()
        pre = aug_preprocess()
        for ib, lb, vd in calls:
            m = multi_train_step(state, torch.from_numpy(arena), ib, lb, vd,
                                 weights, pre, mesh=mesh)
            steps += [{k: v[i].item() for k, v in m.items()}
                      for i in range(ib.shape[0])]
    else:
        step = make_train_step(class_weights=weights, mesh=mesh)
        batch = step_batch(case["seed"], case["batch"], case.get("uneven"))
        if case.get("local") and mesh is not None:
            lo, hi = pd.process_shard(case["batch"])
            batch = pd.global_batch(mesh, {k: v[lo:hi]
                                           for k, v in batch.items()})
        else:
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        for _ in range(case["steps"]):
            _, m = step(state, batch)
            steps.append({k: v.item() for k, v in m.items()})
    sd = (state.model.state_dict() if mesh is None
          else full_state_dict(state.model))
    return {"steps": steps, "params": {k: v.clone() for k, v in sd.items()},
            "step": state.step}


# The plain step cases are JAX's (tests/test_sharding.py: 3 steps of 16
# rows, 2 of 8, lr 1e-2) under sgd, as the makers' parity test runs them:
# adam's first step divides each gradient by its own size, so where a
# gradient is near zero the rounding of its sum (which differs between 2
# ranks, 8 devices and one process) becomes up to lr of weight
STEP_CASES = {
    # name: (data, model) and the case
    "dp": ((2, 1), dict(kind="step", seed=0, batch=GLOBAL_B, steps=3,
                        lr=1e-2, optimizer="sgd")),
    "tp": ((1, 2), dict(kind="step", seed=1, batch=8, steps=2, lr=1e-2,
                        optimizer="sgd")),
    "dp_masked": ((2, 1), dict(kind="step", seed=2, batch=GLOBAL_B,
                               steps=3, lr=1e-2, optimizer="sgd",
                               uneven=True, weights=True)),
    "tp_masked": ((1, 2), dict(kind="step", seed=2, batch=GLOBAL_B,
                               steps=3, lr=1e-2, optimizer="sgd",
                               uneven=True, weights=True)),
    "dp_local": ((2, 1), dict(kind="step", seed=3, batch=8, steps=3,
                              lr=1e-2, optimizer="sgd", local=True)),
    # adam at lr 1e-3
    "dp_aug": ((2, 1), dict(kind="aug", lr=1e-3, weights=True)),
    "tp_aug": ((1, 2), dict(kind="aug", lr=1e-3, weights=True)),
    "tp_rows": ((1, 2), dict(kind="aug", lr=1e-3, weights=True, rows=True)),
}


def run_config(root: str, results_dir: str, streaming: bool = False,
               model_parallel: int = 1) -> C.TrainConfig:
    return C.TrainConfig(
        epochs=2, seed=0, results_dir=results_dir, eval_every=1,
        checkpoint_every=1,
        data=C.DataConfig(root_dir=root, image_size=32, canonical_size=40,
                          batch_size=8, augment=True, steps_per_dispatch=2,
                          decode_workers=1, streaming=streaming,
                          chunk_size=16, stream_cache=streaming),
        model=RUN_MODEL,
        mesh=C.MeshConfig(model_parallel=model_parallel),
        # sgd, as the plain step cases (STEP_CASES says why)
        optim=C.OptimConfig(optimizer="sgd", learning_rate=1e-2,
                            auto_class_weights=True))


RUN_CASES = {
    # name: (model_parallel, streaming)
    "run_dp": (1, False),
    "run_tp": (2, False),
    "run_dp_stream": (1, True),
}


def main() -> None:
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    os.environ.update(SIA_COORDINATOR=f"127.0.0.1:{port}",
                      SIA_NUM_PROCESSES=str(world),
                      SIA_PROCESS_ID=str(rank))
    from skin_image_analysis_tpu_torch.data.streaming import (
        ChunkedBatchIterator,
    )
    from skin_image_analysis_tpu_torch.parallel import create_mesh
    from skin_image_analysis_tpu_torch.parallel import distributed as pd
    from skin_image_analysis_tpu_torch.train.loop import run_training

    assert pd.maybe_initialize(device="cpu") and pd.maybe_initialize()
    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)
    out = {"info": pd.process_info(),
           "shard": pd.process_shard(spec["shard_rows"])}
    for name, (shape, case) in STEP_CASES.items():
        mesh = create_mesh(C.MeshConfig(data_parallel=shape[0],
                                        model_parallel=shape[1]))
        out[name] = run_case(dict(case, init=spec["init"].get(name)), mesh)
    # each streamed loader's (frames decoded, frames read from the cache)
    made = []
    init = ChunkedBatchIterator.__init__

    def tracked(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    ChunkedBatchIterator.__init__ = tracked
    out["stream_counts"] = {}
    for name, (mp, streaming) in RUN_CASES.items():
        cfg = run_config(spec["root"], os.path.join(work, name),
                         streaming, mp)
        made.clear()
        out[name] = run_training(cfg, verbose=False, device="cpu")
        out["stream_counts"][name] = [(it.frames_decoded, it.frames_cached)
                                      for it in made]
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
