"""Metadata report CLI (counterpart of the JAX package's
``cli.tone_bias_metadata``)::

    python -m skin_image_analysis_tpu_torch.cli.tone_bias_metadata \\
        <path to metadata.csv>

Prints the attribution, Fitzpatrick skin-type and skin-type x diagnosis
counts of an ISIC metadata CSV (``data.metadata``).
"""

from __future__ import annotations

import sys

from skin_image_analysis_tpu_torch.data.metadata import (
    read_metadata_csv,
    report_attribution,
    report_skin_types,
    report_tone_diagnosis_grid,
)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 1:
        print("Usage: <path to metadata.csv>")
        return 1
    table = read_metadata_csv(argv[0])
    print(f"records: {len(table)}")
    print(f"columns: {table.columns}")
    print("\nAttribution counts:")
    for k, v in sorted(report_attribution(table).items(),
                       key=lambda kv: -kv[1]):
        print(f"  {k}: {v}")
    print("\nFitzpatrick skin-type counts:")
    for k, v in report_skin_types(table).items():
        print(f"  {k or '<missing>'}: {v}")
    print("\nSkin-type x diagnosis grid:")
    for (t, d), v in sorted(report_tone_diagnosis_grid(table).items()):
        print(f"  {t or '<missing>'} / {d or '<missing>'}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
