"""The evaluation CLI of the port (counterpart of the JAX package's
``cli.tone_bias_test``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_test \\
        <image root> <experiment folder> [--metadata other.csv] [--best]
        [--batch-size 64] [--grid out.png] [--device cuda|cpu]

Loads the folder's frozen ``session_test.csv`` (or, with ``--metadata``,
another cohort's metadata) and its model artifact, decodes the images at
the model's input size, runs the fairness audit, and prints the record
and the wall time. The train loop's eval decodes canonical frames and
resizes them on the device, so this record need not equal the last
epoch's. ``--grid`` writes a figure of the first 6 predictions
(``explain.viz.visualize_predictions_grid``).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

from skin_image_analysis_tpu_torch.cli._common import (
    input_convention,
    model_file,
    parse,
)
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import (
    read_csv,
    read_isic_metadata,
)
from skin_image_analysis_tpu_torch.data.loader import HostImageStore
from skin_image_analysis_tpu_torch.explain.viz import (
    visualize_predictions_grid,
)
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops.preprocess import make_preprocess_fn
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.evaluate import (
    collect_predictions,
    evaluate_fairness,
)
from skin_image_analysis_tpu_torch.train.loop import (
    TEST_SET_FILENAME,
    resolve_device,
    super_batches,
)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv, {"metadata": "", "batch-size": 64, "grid": "",
               "device": "cuda"},
        bool_flags={"best"},
    )
    if len(positional) != 2:
        print("Usage: <root directory of ISIC images> <root dir of model> "
              "[--metadata other_metadata.csv] [--grid out.png] [--best]")
        print("Example: tone results/balanced_2024-10-12_09-22-38/")
        print("--metadata evaluates the model cross-dataset against a "
              "different cohort instead of the experiment's frozen test "
              "split")
        return 1
    root, folder = positional
    dev = resolve_device(opts["device"])

    start = time.time()
    if opts["metadata"]:
        path = os.path.abspath(opts["metadata"])
        test_df = read_isic_metadata(os.path.dirname(path) or root,
                                     csv_name=os.path.basename(path), seed=0)
    else:
        test_df = read_csv(os.path.join(folder, TEST_SET_FILENAME),
                           index_col=True)
    model_cfg, state_dict = ckpt_lib.load_model(
        model_file(folder, best=opts["best"]))
    model = build_model(model_cfg, device=dev)
    model.load_state_dict(state_dict)
    table = LesionTable(test_df, root)
    store = HostImageStore(table, canonical_size=model_cfg.image_size)
    norm, affine = input_convention(folder)
    eval_pre = make_preprocess_fn(
        model_cfg.image_size, train=False, normalize_imagenet=norm,
        input_affine=affine, layout="planar")
    arena = store.to_device(dev)

    def batches():
        return super_batches(np.arange(len(table)), table.labels,
                             opts["batch-size"], 1, drop_remainder=False,
                             with_row_ids=True, row_ok=store.row_ok)

    record = evaluate_fairness(model, arena, batches(), table.labels,
                               table.group_codes, eval_pre)
    print(json.dumps(record, indent=2))
    if opts["grid"]:
        out = collect_predictions(model, arena, batches(), eval_pre)
        k = min(6, len(out["pred"]))
        row_ids = out["row_id"][:k]
        images = store.images[row_ids].transpose(0, 2, 3, 1).astype(
            np.float32) / 255.0
        visualize_predictions_grid(
            images, [table.class_names[int(p)] for p in out["pred"][:k]],
            [table.instance(int(r))["benign_malignant"] for r in row_ids],
            n_images=k, save_path=opts["grid"])
        print(f"wrote {opts['grid']}")
    elapsed = time.time() - start
    print(f"Evaluation complete in {elapsed // 60:.0f}m {elapsed % 60:.0f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
