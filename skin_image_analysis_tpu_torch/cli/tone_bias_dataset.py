"""Dataset CLI (counterpart of the JAX package's
``cli.tone_bias_dataset``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_dataset \\
        <image root> <balance|imbalanced> [--device cuda|cpu]

Prints the metadata's counts; ``balance`` writes ``balanced_metadata.csv``
beside the originals. Either mode then runs the loader smoke: the 70/30
split, the train split decoded into a ``HostImageStore`` at 224², as the
JAX CLI's, and every train batch of 32 iterated through ``BatchIterator``
onto ``--device`` (``cuda`` by default). A frame of another size needs
cv2 or PIL to resize.
"""

from __future__ import annotations

import os
import sys
import time

from skin_image_analysis_tpu_torch.cli._common import parse
from skin_image_analysis_tpu_torch.data import (
    LesionTable,
    balance_dataset,
    print_counts,
    read_isic_metadata,
    shuffle_split,
)
from skin_image_analysis_tpu_torch.data.loader import BatchIterator, HostImageStore
from skin_image_analysis_tpu_torch.train.loop import resolve_device


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, opts = parse(argv, {"device": "cuda"})
    if len(pos) != 2:
        print("Usage: <root directory of ISIC images> <balance|imbalanced>")
        return 1
    root, mode = pos
    device = resolve_device(opts["device"])
    df = read_isic_metadata(root)
    print_counts(df)
    if mode == "balance":
        df = balance_dataset(df)
        out_path = os.path.join(root, "balanced_metadata.csv")
        df.to_csv(out_path)
        print(f"Wrote {out_path}")

    # the loader smoke: split, decode, iterate every train batch
    train_df, _ = shuffle_split(df, ratio=0.7)
    start = time.time()
    store = HostImageStore(LesionTable(train_df, root), canonical_size=224)
    print(f"decoded {len(store)} images in {time.time() - start:.1f}s")
    loader = BatchIterator(store, batch_size=32, device=device, shuffle=True)
    n = 0
    start = time.time()
    for batch in loader:
        n += int(batch["valid"].sum())
    print(f"iterated {n} instances in {time.time() - start:.1f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
