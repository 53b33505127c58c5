"""Train/test split files for the tone-classifier task (port of the JAX
package's ``toneclassifier.split``, on the pandas-free ``Frame``).

A seeded 70/30 split written to ``trainmeta.csv`` / ``testmeta.csv`` in
pandas' layout without the index: the train rows are
``DataFrame.sample(frac=frac, random_state=default_rng(seed))``, that is
``rng.choice(n, round(frac * n), replace=False)`` in draw order, and the
test rows are the rest in file order."""

from __future__ import annotations

import os

import numpy as np

from skin_image_analysis_tpu_torch.data.ingest import read_csv


def split_metadata_csv(
    metadata_csv: str,
    out_dir: str | None = None,
    frac: float = 0.7,
    seed: int | None = 0,
) -> tuple[str, str]:
    """Returns (trainmeta_path, testmeta_path)."""
    df = read_csv(metadata_csv)
    rng = np.random.default_rng(seed)
    picked = rng.choice(len(df), size=round(frac * len(df)), replace=False)
    chosen = set(int(i) for i in picked)
    train = df.take(picked)
    test = df.take(i for i in range(len(df)) if i not in chosen)
    out_dir = out_dir or os.path.dirname(os.path.abspath(metadata_csv))
    train_path = os.path.join(out_dir, "trainmeta.csv")
    test_path = os.path.join(out_dir, "testmeta.csv")
    train.to_csv(train_path, index=False)
    test.to_csv(test_path, index=False)
    return train_path, test_path
