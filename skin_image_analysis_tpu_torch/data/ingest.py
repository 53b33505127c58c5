"""ISIC metadata ingest, tone derivation, balancing and splits, without
pandas (port of the JAX package's ``data.ingest``).

:class:`Frame` stands in for the DataFrame: rows of string cells in CSV
column order, ``None`` where pandas reads a missing value. The functions
make the same random draws, in the same order, as the JAX package's
pandas calls, so a seed gives the same rows in the same order:

- ``read_isic_metadata``: drop rows with a missing
  ``fitzpatrick_skin_type``, keep ``benign_malignant`` in {benign,
  malignant}, derive ``skin_tone`` (Fitzpatrick I/II light, III-VI dark)
  and draw the placebo ``control`` column from ``default_rng(seed)``;
- ``balance_dataset``: undersample the larger diagnosis group, then the
  larger tone group, from one ``default_rng(seed)``; each keeps the
  minority rows, then ``rng.choice(len(majority), len(minority),
  replace=False)`` of the majority (``DataFrame.sample(n=...)``);
- ``shuffle_split``: ``rng.choice(n, n, replace=False)``
  (``sample(frac=1)``), then the first ``int(ratio * n)`` rows train.

The split CSVs keep pandas' layout: a leading unnamed index column,
missing cells empty.
"""

from __future__ import annotations

import csv
from collections import Counter
from typing import Iterable, Sequence

import numpy as np

TONE_LIGHT_TYPES = ("I", "II")

#: the strings ``pandas.read_csv`` reads as missing by default
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


class Frame:
    """A table of string cells with named columns; ``None`` is missing.
    ``index`` holds each row's label, as a DataFrame's index: rows keep
    theirs through ``take``, ``where`` and ``concat``, and
    ``reset_index`` numbers them 0..n-1 again."""

    def __init__(self, columns: Sequence[str], rows: Iterable[Sequence],
                 index: Sequence[int] | None = None):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        self.index = (list(range(len(self.rows))) if index is None
                      else list(index))
        if len(self.index) != len(self.rows):
            raise ValueError(f"{len(self.index)} index labels for "
                             f"{len(self.rows)} rows")
        self._pos = {c: i for i, c in enumerate(self.columns)}

    def __len__(self) -> int:
        return len(self.rows)

    def __contains__(self, column: str) -> bool:
        return column in self._pos

    def column(self, name: str) -> list:
        i = self._pos[name]
        return [r[i] for r in self.rows]

    def row(self, idx: int) -> dict:
        return dict(zip(self.columns, self.rows[idx]))

    def take(self, indices: Iterable[int]) -> "Frame":
        """The rows at these positions, with their labels."""
        pos = [int(i) for i in indices]
        return Frame(self.columns, (self.rows[i] for i in pos),
                     [self.index[i] for i in pos])

    def where(self, column: str, keep) -> "Frame":
        """The rows whose ``column`` value passes ``keep``."""
        i = self._pos[column]
        return self.take(j for j, r in enumerate(self.rows) if keep(r[i]))

    def reset_index(self) -> "Frame":
        return Frame(self.columns, self.rows)

    def with_column(self, name: str, values: Sequence) -> "Frame":
        if len(values) != len(self.rows):
            raise ValueError(f"{len(values)} values for {len(self)} rows")
        if name in self._pos:
            i = self._pos[name]
            rows = [r[:i] + [v] + r[i + 1:]
                    for r, v in zip(self.rows, values)]
            return Frame(self.columns, rows, self.index)
        return Frame(self.columns + [name],
                     (r + [v] for r, v in zip(self.rows, values)),
                     self.index)

    @staticmethod
    def concat(frames: Sequence["Frame"]) -> "Frame":
        columns = frames[0].columns
        if any(f.columns != columns for f in frames):
            raise ValueError("frames with different columns")
        return Frame(columns, (r for f in frames for r in f.rows),
                     [i for f in frames for i in f.index])

    def to_csv(self, path: str, index: bool = True) -> None:
        """pandas' ``to_csv`` layout: an unnamed leading column of the
        index labels (unless ``index`` is False), missing cells empty. A
        column that pandas reads as numbers with a missing cell comes back
        from pandas as floats (``55`` is written ``55.0``); this writer
        keeps the cell text as read."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", *self.columns] if index else self.columns)
            for label, r in zip(self.index, self.rows):
                cells = ["" if v is None else v for v in r]
                w.writerow([label, *cells] if index else cells)


def read_csv(path: str, index_col: bool = False) -> Frame:
    """Read a CSV as ``pandas.read_csv`` splits it into cells: every cell
    in :data:`NA_STRINGS` becomes ``None``, blank lines are skipped. With
    ``index_col`` the first column (the index of a split CSV) is
    dropped."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [[None if v in NA_STRINGS else v for v in r]
                for r in reader if r]
    if index_col:
        header = header[1:]
        rows = [r[1:] for r in rows]
    for r in rows:
        if len(r) > len(header):
            raise ValueError(f"{path}: a row has {len(r)} cells, the header "
                             f"{len(header)}")
        r += [None] * (len(header) - len(r))  # pandas fills short rows
    return Frame(header, rows)


def convert_type2tone(fitzpatrick: str) -> str:
    """Fitzpatrick {I..VI} -> binary tone; I/II light, III-VI dark."""
    return "light" if fitzpatrick in TONE_LIGHT_TYPES else "dark"


def read_isic_metadata(
    root_dir_name: str,
    seed: int | None = None,
    csv_name: str = "metadata.csv",
) -> Frame:
    """Read and filter ``<root>/<csv_name>``; unshuffled, with the derived
    ``skin_tone`` and the random placebo ``control`` columns."""
    df = read_csv(f"{root_dir_name}/{csv_name}")
    df = df.where("fitzpatrick_skin_type", lambda v: v is not None)
    df = df.where("benign_malignant", lambda v: v in ("benign", "malignant"))
    df = df.with_column("skin_tone", [
        convert_type2tone(t) for t in df.column("fitzpatrick_skin_type")])
    rng = np.random.default_rng(seed)
    return df.with_column(
        "control", [str(v) for v in rng.choice(["poor", "rich"], len(df))])


def print_counts(df: Frame) -> dict[str, dict[str, int]]:
    """Print and return diagnosis, tone and (tone x diagnosis) counts."""
    out = {
        "benign_malignant": dict(Counter(
            v for v in df.column("benign_malignant") if v is not None
        ).most_common()),
        "skin_tone": dict(Counter(df.column("skin_tone")).most_common()),
    }
    joint = Counter(zip(df.column("skin_tone"),
                        df.column("benign_malignant")))
    out["joint"] = {f"{t}/{d}": n for (t, d), n in sorted(
        (k, n) for k, n in joint.items() if None not in k)}
    for name, counts in out.items():
        print(f"{name}: {counts}")
    return out


def _sample(rng: np.random.Generator, n_rows: int, size: int) -> np.ndarray:
    """The row positions ``DataFrame.sample(n=size, random_state=rng)``
    takes."""
    return rng.choice(n_rows, size=size, replace=False)


def balance_dataset(
    df: Frame, seed: int | None = None, verbose: bool = True
) -> Frame:
    """Diagnosis-then-tone undersampling to about 50/50 on both axes."""
    rng = np.random.default_rng(seed)
    if verbose:
        print("\nUNDERSAMPLING: BEFORE")
        print_counts(df)

    def undersample(frame: Frame, column: str, a: str, b: str) -> Frame:
        ga = frame.where(column, lambda v: v == a)
        gb = frame.where(column, lambda v: v == b)
        minority, majority = (ga, gb) if len(ga) <= len(gb) else (gb, ga)
        majority = majority.take(_sample(rng, len(majority), len(minority)))
        return Frame.concat([minority, majority])

    df = undersample(df, "benign_malignant", "malignant", "benign")
    df = undersample(df, "skin_tone", "dark", "light")

    if verbose:
        print("\nUNDERSAMPLING: AFTER")
        print_counts(df)
    return df


def sample_dataframe(
    df: Frame, class_name: str, no_sample: int, seed: int | None = None
) -> Frame:
    """Per-class sampling with replacement: ``no_sample`` rows of each
    value of ``class_name`` (rows where it is missing are dropped), the
    values in sorted order. The draws are ``groupby(...).sample(n,
    replace=True)``'s: ``rng.choice(len(group), n, replace=True)`` a
    group, from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    values = sorted({v for v in df.column(class_name) if v is not None})
    parts = []
    for value in values:
        group = df.where(class_name, lambda v, value=value: v == value)
        parts.append(group.take(
            rng.choice(len(group), size=no_sample, replace=True)))
    return Frame.concat(parts).reset_index()


def shuffle_split(
    df: Frame, ratio: float = 0.7, seed: int | None = None
) -> tuple[Frame, Frame]:
    """Shuffle, then slice into train and test."""
    rng = np.random.default_rng(seed)
    df = df.take(_sample(rng, len(df), len(df)))
    train_size = int(ratio * len(df))
    return (df.take(range(train_size)).reset_index(),
            df.take(range(train_size, len(df))).reset_index())
