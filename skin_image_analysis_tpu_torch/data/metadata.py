"""Dependency-free ISIC metadata utilities (a copy of the JAX package's
``data.metadata``): a stdlib CSV reader with a key-uniqueness check and a
small row table with the partition and report operations of metadata
exploration. It uses only ``csv``.
"""

from __future__ import annotations

import csv
from collections import Counter, defaultdict
from typing import Iterable, Mapping, Sequence

FITZPATRICK_TYPES = ("I", "II", "III", "IV", "V", "VI")


class Table:
    """A tiny immutable row-oriented table keyed by a unique id column."""

    def __init__(self, rows: Sequence[Mapping[str, str]], key: str = "isic_id"):
        self.key = key
        self.rows = [dict(r) for r in rows]
        self.columns = list(self.rows[0].keys()) if self.rows else []
        seen: set[str] = set()
        for row in self.rows:
            k = row.get(key, "")
            if k in seen:
                raise ValueError(f"duplicate key {k!r} in column {key!r}")
            seen.add(k)

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> list[str]:
        return [row.get(name, "") for row in self.rows]

    def partition(self, column: str) -> dict[str, "Table"]:
        """Split rows into sub-tables by the value of ``column``."""
        groups: dict[str, list[dict]] = defaultdict(list)
        for row in self.rows:
            groups[row.get(column, "")].append(row)
        return {v: Table(rows, key=self.key) for v, rows in groups.items()}

    def counts(self, column: str) -> Counter:
        return Counter(self.column(column))

    def cross_counts(self, a: str, b: str) -> dict[tuple[str, str], int]:
        """Joint counts over two columns (e.g. skin type x diagnosis grid)."""
        out: Counter = Counter()
        for row in self.rows:
            out[(row.get(a, ""), row.get(b, ""))] += 1
        return dict(out)

    def filter(self, column: str, values: Iterable[str]) -> "Table":
        allow = set(values)
        return Table([r for r in self.rows if r.get(column, "") in allow],
                     key=self.key)


def read_metadata_csv(path: str, key: str = "isic_id") -> Table:
    """Read a metadata CSV into a :class:`Table`, enforcing key uniqueness
    (reference: tone_bias_metadata.py:42-44)."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    return Table(rows, key=key)


def report_attribution(table: Table) -> dict[str, int]:
    return dict(table.counts("attribution"))


def report_skin_types(table: Table) -> dict[str, int]:
    """Counts per Fitzpatrick type I–VI ('' = missing)."""
    counts = table.counts("fitzpatrick_skin_type")
    return {t: counts.get(t, 0) for t in (*FITZPATRICK_TYPES, "")}


def report_tone_diagnosis_grid(table: Table) -> dict[tuple[str, str], int]:
    """Fitzpatrick type x benign_malignant joint counts
    (reference grid reports, tone_bias_metadata.py:88-189)."""
    return table.cross_counts("fitzpatrick_skin_type", "benign_malignant")
