"""The batch-inference CLI of the port (counterpart of the JAX package's
``cli.tone_bias_predict``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_predict \\
        <image root> <experiment folder> <out.csv> [--batch-size 64]
        [--metadata CSV] [--images] [--best] [--device cuda|cpu]

Runs the folder's model over a cohort and writes one CSV row per image:
``isic_id,prediction,p_malignant``, plus ``benign_malignant,skin_tone,sex``
when the images are labelled. The rows are the folder's
``session_test.csv``, or another cohort's ``--metadata``, or with
``--images`` every ``.jpg``/``.jpeg``/``.png``/``.dcm`` file under the
root (the extension in any case, one row per stem), unlabelled. ``--best``
reads the keep-best model. The prediction names come from the folder's
``train_config.json`` ``class_names`` where it has them.
"""

from __future__ import annotations

import csv
import json
import os
import sys

import numpy as np

from skin_image_analysis_tpu_torch.cli._common import (
    input_convention,
    model_file,
    parse,
)
from skin_image_analysis_tpu_torch.data.dataset import LesionTable
from skin_image_analysis_tpu_torch.data.ingest import (
    Frame,
    read_csv,
    read_isic_metadata,
)
from skin_image_analysis_tpu_torch.data.loader import (
    BatchIterator,
    HostImageStore,
)
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.ops.preprocess import make_preprocess_fn
from skin_image_analysis_tpu_torch.train import checkpoint as ckpt_lib
from skin_image_analysis_tpu_torch.train.evaluate import collect_predictions
from skin_image_analysis_tpu_torch.train.loop import (
    TEST_SET_FILENAME,
    resolve_device,
)

_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".dcm"}


def _image_rows(root: str) -> Frame:
    """One unlabelled row per image stem under ``root`` (the first file
    of each stem in directory order; the loader probes by stem anyway),
    sorted by stem."""
    stems: dict[str, str] = {}
    for entry in os.scandir(root):
        if not entry.is_file():
            continue
        stem, ext = os.path.splitext(entry.name)
        if ext.lower() in _IMAGE_EXTS:
            stems.setdefault(stem, entry.name)
    if not stems:
        raise SystemExit(f"--images: no image files under {root}")
    # the label is a placeholder that LesionTable's contract asks for
    return Frame(["isic_id", "benign_malignant"],
                 ([stem, "benign"] for stem in sorted(stems)))


def _class_names(folder: str, default) -> list[str]:
    """The folder's label space: ``train_config.json``'s ``class_names``
    where it has them."""
    cfg_path = os.path.join(folder, "train_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            return list(json.load(f).get("class_names", default))
    return list(default)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv, {"batch-size": 64, "metadata": "", "device": "cuda"},
        bool_flags={"best", "images"})
    if len(positional) != 3:
        print("Usage: <image root> <experiment folder> <out.csv> "
              "[--batch-size N] [--metadata CSV] [--images] [--best] "
              "[--device cuda|cpu]")
        return 1
    root, folder, out_csv = positional
    dev = resolve_device(opts["device"])

    unlabelled = bool(opts["images"])
    if unlabelled:
        df = _image_rows(root)
    elif opts["metadata"]:
        meta = os.path.abspath(opts["metadata"])
        df = read_isic_metadata(os.path.dirname(meta) or root,
                                csv_name=os.path.basename(meta), seed=0)
    else:
        df = read_csv(os.path.join(folder, TEST_SET_FILENAME),
                      index_col=True)

    model_cfg, state_dict = ckpt_lib.load_model(
        model_file(folder, best=opts["best"]))
    model = build_model(model_cfg, device=dev)
    model.load_state_dict(state_dict)
    table = LesionTable(df, root)
    store = HostImageStore(table, canonical_size=model_cfg.image_size)
    loader = BatchIterator(store, opts["batch-size"], device=dev,
                           shuffle=False)
    norm, affine = input_convention(folder)
    out = collect_predictions(model, None, loader, make_preprocess_fn(
        model_cfg.image_size, train=False, normalize_imagenet=norm,
        input_affine=affine, layout="planar"))
    class_names = _class_names(folder, table.class_names)

    header = ["isic_id", "prediction", "p_malignant"]
    if not unlabelled:
        header += ["benign_malignant", "skin_tone", "sex"]
    ids = df.column("isic_id")
    rows = []
    for i in np.argsort(out["row_id"]):
        rid = int(out["row_id"][i])
        row = [ids[rid], class_names[int(out["pred"][i])],
               repr(float(out["score_malignant"][i]))]
        if not unlabelled:
            inst = table.instance(rid)
            row += [inst["benign_malignant"], inst["skin_tone"], inst["sex"]]
        rows.append(["" if v is None else v for v in row])
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)
    print(f"wrote {out_csv} ({len(rows)} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
