"""matplotlib, imported at first use by the figures of ``explain.viz`` and
``analysis.plots``; the port's other paths run without it."""

from __future__ import annotations


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; without matplotlib an
    ImportError that names it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("drawing a figure needs matplotlib, which does "
                          f"not import here: {e}") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
