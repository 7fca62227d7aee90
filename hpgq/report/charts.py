"""Native PNG chart rendering for the stats report.

The reference renders its report images by shelling out to gnuplot
unconditionally (``src/stats_report.c:654-655``); environments without a
gnuplot binary would previously get the ``.gnuplot`` scripts but no images.
This module renders the same ``<prefix>.png`` (640x360, one chart per
``.data`` file) natively with matplotlib's Agg backend, so the image half
of the report contract holds everywhere.

Selection: ``HPGQ_CHARTS`` = ``gnuplot`` (only shell out, reference
behavior) | ``native`` (always matplotlib) | ``off`` | ``auto`` (default:
gnuplot when present, else matplotlib).
"""

from __future__ import annotations

import os

import numpy as np


def render_native(graph, data_filename: str, prefix: str) -> bool:
    """Render ``<prefix>.png`` from a report ``.data`` file (whitespace
    columns, 1-based gnuplot column indices in ``graph``).  Returns True on
    success; any failure (missing/empty data, broken matplotlib backend)
    leaves no partial file and returns False."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return False

    try:
        cols = _read_columns(data_filename)
        if cols is None or not cols.size:
            return False
        fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=100)
        x = cols[graph.x_column - 1]
        for i, ycol in enumerate(graph.y_columns):
            y = cols[ycol - 1]
            label = (graph.y_titles[i] if i < len(graph.y_titles) else "") or None
            if graph.type == "boxes":
                width = (np.min(np.diff(np.sort(x))) if x.size > 1 else 1.0)
                ax.bar(x, y, width=width, align="center", label=label,
                       edgecolor="none")
            else:
                ax.plot(x, y, linewidth=1.0, label=label)
        ax.set_title(graph.title, fontsize=10)
        ax.set_xlabel(graph.xlabel, fontsize=9)
        ax.set_ylabel(graph.ylabel, fontsize=9)
        ax.tick_params(labelsize=8)
        if graph.x_autoscale != 1:
            ax.set_xlim(graph.x_start, graph.x_end)
        if graph.y_autoscale != 1:
            # reference quirk preserved: y-range from the X bounds
            # (src/stats_report.c:626)
            ax.set_ylim(graph.x_start, graph.x_end)
        if any(graph.y_titles):
            ax.legend(fontsize=8)
        fig.tight_layout()
        fig.savefig(prefix + ".png")
        plt.close(fig)
        return True
    except Exception:
        try:
            plt.close("all")
        except Exception:
            pass
        try:
            if os.path.exists(prefix + ".png"):
                os.unlink(prefix + ".png")
        except OSError:
            pass
        return False


def _read_columns(path: str):
    """Whitespace-separated numeric columns -> float array [ncols, nrows]."""
    rows = []
    try:
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts and not parts[0].startswith("#"):
                    rows.append([float(p) for p in parts])
    except (OSError, ValueError):
        return None
    if not rows:
        return None
    width = min(len(r) for r in rows)
    return np.asarray([r[:width] for r in rows], dtype=np.float64).T
