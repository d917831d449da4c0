"""Metric plots (a port of dbw_tpu/utils/plot.py). matplotlib is optional:
without it ``plot_lines`` returns None and the Trainer writes no PDF, as
the JAX package does. A metric log is the table ``Metrics.read_log``
returns: {column: (rows,) array}, with the iterations under
"iteration"."""

from __future__ import annotations

import numpy as np


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def plot_lines(table, columns, title, colors=None):
    """Line chart of the table's columns against its iterations -> a
    matplotlib Figure, or None without matplotlib. NaN points are
    dropped."""
    plt = _pyplot()
    if plt is None:
        return None
    if colors is None:
        colors = [None] * len(columns)
    fig, ax = plt.subplots(figsize=(10, 5.625))
    its = np.asarray(table["iteration"])
    for col, color in zip(columns, colors):
        if col not in table:
            continue
        y = np.asarray(table[col], np.float64)
        keep = np.isfinite(y)
        ax.plot(its[keep], y[keep], label=col, color=color, lw=2)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig
