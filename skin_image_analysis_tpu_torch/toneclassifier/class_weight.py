"""Class weights for the imbalanced tone task, and the small-image census
(a copy of the JAX package's ``toneclassifier.class_weight``).

``balanced_class_weights`` is sklearn's 'balanced' formula ``n_samples /
(n_classes * n_c)``."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def balanced_class_weights(labels: Sequence[int],
                           n_classes: int = 2) -> np.ndarray:
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=n_classes).astype(np.float64)
    if (counts == 0).any():
        raise ValueError(f"empty class in labels: counts={counts}")
    return labels.size / (n_classes * counts)


def count_small_images(paths: Sequence[str], min_size: int = 224) -> int:
    """How many images have either side below ``min_size`` (the check
    before committing to a 224 random crop). Needs PIL."""
    from PIL import Image

    small = 0
    for p in paths:
        with Image.open(p) as im:
            w, h = im.size
        if w < min_size or h < min_size:
            small += 1
    return small
