"""LesionTable: one split's metadata as the arrays the train and eval
steps take (port of the JAX package's ``data.dataset``, over a
:class:`~skin_image_analysis_tpu_torch.data.ingest.Frame`).

It exposes the label codes, ``row_ids`` and integer group codes for
skin_tone, sex and control (-1 where the value is missing or unknown),
and per row the ``instance`` dict of the reference's ``lookup_path``.
Cells are strings as read from the CSV (``None`` where missing), where
the JAX package's pandas gives numbers for numeric columns and NaN for
missing cells.
"""

from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np

from skin_image_analysis_tpu_torch.data.ingest import Frame

CLASS_NAMES = ("benign", "malignant")

#: fixed vocabularies of the group codes the device reductions take
GROUP_VOCABS: dict[str, tuple[str, ...]] = {
    "skin_tone": ("light", "dark"),
    "sex": ("male", "female"),
    "control": ("poor", "rich"),
}


def _encode(values: Sequence[Any], vocab: tuple[str, ...]) -> np.ndarray:
    """Map values to vocab indices; unknown or missing -> -1."""
    lut = {v: i for i, v in enumerate(vocab)}
    return np.asarray([lut.get(v, -1) for v in values], dtype=np.int32)


class LesionTable:
    """Immutable table of lesion instances for one split (train or test)."""

    #: probe order when ``<isic_id>.jpg`` is absent: the ISIC-2020 archive
    #: ships ``.dcm``; png covers re-exports; uppercase camera exports
    _EXT_PROBE = (".jpg", ".jpeg", ".png", ".dcm",
                  ".JPG", ".JPEG", ".PNG", ".DCM")

    def __init__(
        self,
        metadata: Frame,
        root_dir: str,
        class_names: Sequence[str] = CLASS_NAMES,
        label_column: str = "benign_malignant",
    ):
        self.metadata = metadata
        self.root_dir = root_dir
        self.class_names = tuple(class_names)
        self.label_column = label_column
        self._path_cache: dict[str, str] = {}

        values = metadata.column(label_column)
        self.labels = _encode(values, self.class_names)
        if (self.labels < 0).any():
            bad = sorted(set(map(str, values)) - set(self.class_names))
            raise ValueError(f"unknown {label_column} values: {bad}")
        self.row_ids = np.arange(len(metadata), dtype=np.int32)
        self.group_codes = {
            col: _encode(metadata.column(col), vocab)
            for col, vocab in GROUP_VOCABS.items() if col in metadata
        }

    def __len__(self) -> int:
        return len(self.metadata)

    def get_class_names(self) -> tuple[str, ...]:
        """The label vocabulary (the reference dataset's API)."""
        return self.class_names

    def get_class(self, index: int) -> str:
        """The class name of label ``index``."""
        return self.class_names[index]

    def get_file_path(self, image_name: str) -> str:
        """``<root>/<isic_id>.jpg``, else the first of ``.jpeg``, ``.png``,
        ``.dcm`` (and their uppercase forms) on disk, probed once per
        image; the ``.jpg`` path when none exists (decode reports it)."""
        hit = self._path_cache.get(image_name)
        if hit is not None:
            return hit
        path = os.path.join(self.root_dir, image_name + ".jpg")
        if not os.path.exists(path):
            for ext in self._EXT_PROBE[1:]:
                p = os.path.join(self.root_dir, image_name + ext)
                if os.path.exists(p):
                    path = p
                    break
        self._path_cache[image_name] = path
        return path

    def file_paths(self) -> list[str]:
        return [self.get_file_path(n) for n in self.metadata.column("isic_id")]

    def instance(self, idx: int) -> dict[str, Any]:
        """Row ``idx``'s metadata with the keys of the reference's
        ``lookup_path``."""
        row = self.metadata.row(int(idx))
        image_name = row["isic_id"]
        return {
            "file_path": self.get_file_path(image_name),
            "image_name": image_name,
            "patient_id": row.get("patient_id"),
            "diagnosis": row.get("diagnosis"),
            "benign_malignant": row["benign_malignant"],
            "age": row.get("age_approx"),
            "sex": row.get("sex"),
            "location": row.get("anatom_site_general"),
            "skin_type": row.get("fitzpatrick_skin_type"),
            "skin_tone": row.get("skin_tone"),
            "control": row.get("control"),
        }

    def instances_for(self, row_ids: Sequence[int]) -> dict[int, dict]:
        return {int(i): self.instance(int(i)) for i in row_ids}
