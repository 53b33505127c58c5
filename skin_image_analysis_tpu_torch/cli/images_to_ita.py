"""The ITA-matrix preprocessor CLI (counterpart of the JAX package's
``cli.images_to_ita``)::

    python -m skin_image_analysis_tpu_torch.cli.images_to_ita \\
        <image dir> <output dir> [--batch-size N] [--size N]
        [--summary-csv PATH] [--device cuda|cpu]

Decodes every ``.jpg`` / ``.jpeg`` / ``.png`` of the directory to ``size``
x ``size`` RGB, computes the per-pixel ITA matrix on the device in
batches (``data.ita.ita_pipeline``; the last batch padded to a full one),
and saves one ``<name>.npy`` per image. Resumable: images whose output
already exists are skipped. ``--summary-csv`` writes each processed
image's modal ITA and binary tone. Decoding goes through cv2, else PIL,
as the port's loader does; where neither is installed the loader's
ImportError names them. ``--device`` is ``cuda`` by default, ``cpu`` for
the CPU.
"""

from __future__ import annotations

import csv
import os
import sys
import time

import numpy as np
import torch

from skin_image_analysis_tpu_torch.cli._common import parse
from skin_image_analysis_tpu_torch.data.ita import ita_pipeline
from skin_image_analysis_tpu_torch.data.loader import decode_image
from skin_image_analysis_tpu_torch.train.loop import resolve_device


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    positional, opts = parse(
        argv, {"batch-size": 32, "size": 224, "summary-csv": "",
               "device": "cuda"})
    if len(positional) != 2:
        print("Usage: <image dir> <output dir> [--batch-size N] [--size N] "
              "[--summary-csv PATH] [--device cuda|cpu]")
        return 1
    image_dir, out_dir = positional
    dev = resolve_device(opts["device"])
    os.makedirs(out_dir, exist_ok=True)

    names = sorted(n for n in os.listdir(image_dir)
                   if n.lower().endswith((".jpg", ".jpeg", ".png")))
    todo = [n for n in names
            if not os.path.exists(os.path.join(
                out_dir, os.path.splitext(n)[0] + ".npy"))]
    print(f"{len(names)} images, {len(todo)} to process")

    size, bs = opts["size"], opts["batch-size"]
    summary = []
    start = time.time()
    for i in range(0, len(todo), bs):
        chunk = todo[i:i + bs]
        batch = np.zeros((bs, size, size, 3), np.uint8)
        for j, n in enumerate(chunk):
            batch[j] = decode_image(os.path.join(image_dir, n), size)
        out = ita_pipeline(torch.from_numpy(batch).to(dev))
        ita, modal, tone = (out[k][:len(chunk)].cpu().numpy()
                            for k in ("ita", "modal_ita", "tone"))
        for j, n in enumerate(chunk):
            stem = os.path.splitext(n)[0]
            np.save(os.path.join(out_dir, f"{stem}.npy"), ita[j])
            summary.append({"image": stem, "modal_ita": float(modal[j]),
                            "tone": int(tone[j])})
        print(f"  {min(i + bs, len(todo))}/{len(todo)}")
    elapsed = time.time() - start
    if todo:
        print(f"processed {len(todo)} images in {elapsed:.1f}s "
              f"({len(todo) / elapsed:.1f} img/s)")

    if opts["summary-csv"] and summary:
        with open(opts["summary-csv"], "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["image", "modal_ita",
                                                   "tone"])
            writer.writeheader()
            writer.writerows(summary)
        print(f"wrote {opts['summary-csv']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
