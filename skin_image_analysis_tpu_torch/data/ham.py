"""HAM-10000 metadata ingest (port of the JAX package's ``data.ham``, on
the pandas-free ``Frame``).

The HAM-10000 CSV (lesion_id, image_id, dx, dx_type, age, sex,
localization) has the 7-class ``dx`` labels; the binary framing calls
mel, bcc and akiec malignant. Both framings come out in the ISIC
``LesionTable`` shape: ``isic_id`` from ``image_id``,
``benign_malignant`` from ``dx``, ``dx`` kept for
``label_column="dx"`` with ``class_names=DX_CLASSES``.
"""

from __future__ import annotations

from skin_image_analysis_tpu_torch.data.ingest import Frame, read_csv
from skin_image_analysis_tpu_torch.data.ita import FITZ_THRESHOLDS

DX_CLASSES = ("akiec", "bcc", "bkl", "df", "mel", "nv", "vasc")

#: the standard HAM binarization's malignant classes
MALIGNANT_DX = {"mel", "bcc", "akiec"}


def read_ham_metadata(csv_path: str, binary: bool = True) -> Frame:
    """HAM-10000 CSV -> Frame in the ISIC LesionTable shape. HAM has no
    Fitzpatrick labels, so ``skin_tone`` stays absent; ``sex`` is added
    empty when missing, ``age_approx`` copied from ``age``."""
    df = read_csv(csv_path)
    missing = {"image_id", "dx"} - set(df.columns)
    if missing:
        raise ValueError(f"not a HAM-10000 metadata csv; missing {missing}")
    df = df.with_column("isic_id", df.column("image_id"))
    df = df.with_column("benign_malignant", [
        "malignant" if dx in MALIGNANT_DX else "benign"
        for dx in df.column("dx")])
    if "sex" not in df:
        df = df.with_column("sex", [None] * len(df))
    if "age_approx" not in df and "age" in df:
        df = df.with_column("age_approx", df.column("age"))
    return df


def attach_ita_tone(df: Frame, modal_ita_by_image: dict) -> Frame:
    """An estimated binary ``skin_tone`` column from modal-ITA values by
    image id (light where ITA >= 41), so the fairness audit can run on
    cohorts without Fitzpatrick labels; missing or NaN -> None."""
    tones = []
    for image_id in df.column("isic_id"):
        ita = modal_ita_by_image.get(image_id)
        if ita is None or ita != ita:
            tones.append(None)
        else:
            tones.append("light" if ita >= FITZ_THRESHOLDS[3] else "dark")
    return df.with_column("skin_tone", tones)
