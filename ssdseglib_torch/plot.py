"""Plot helpers, counterpart of ssdseglib_tpu/plot.py (reference plot.py:3-25:
`move_figure`)."""

from __future__ import annotations


def move_figure(figure, x: int, y: int) -> None:
    """Move a matplotlib figure window to (x, y), per backend; a backend
    without a window (Agg) leaves the figure as it is."""
    import matplotlib

    backend = matplotlib.get_backend().lower()
    manager = figure.canvas.manager
    try:
        if "tkagg" in backend:
            manager.window.wm_geometry(f"+{x}+{y}")
        elif "wxagg" in backend:
            manager.window.SetPosition((x, y))
        elif "qt" in backend:
            manager.window.move(x, y)
    except AttributeError:
        # a manager without a movable window
        pass
