"""Color helpers for diagnostics plots (a copy of
``xicsrt_tpu/utils/colors.py``).

Equivalent of the reference's ``xicsrt/util/mircolor.py:99-221`` (color
gradients used to color ray histories): value-mapped colors and discrete
gradients, backed by matplotlib colormaps instead of hand-rolled
interpolation tables.
"""

from __future__ import annotations

import numpy as np


def gradient(n: int, cmap: str = "viridis", vmin: float = 0.0,
             vmax: float = 1.0) -> list:
    """``n`` RGBA tuples sampled evenly along a colormap segment."""
    import matplotlib.pyplot as plt

    cm = plt.get_cmap(cmap)
    if n == 1:
        return [cm(0.5 * (vmin + vmax))]
    ts = np.linspace(vmin, vmax, n)
    return [cm(float(t)) for t in ts]


def color_by_value(values, cmap: str = "viridis", vmin=None, vmax=None):
    """Per-item RGBA colors mapped from a value array (e.g. wavelengths).

    Returns (colors [n,4], norm) — the norm can build a colorbar.
    """
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    values = np.asarray(values, dtype=float)
    if vmin is None:
        vmin = float(values.min()) if values.size else 0.0
    if vmax is None:
        vmax = float(values.max()) if values.size else 1.0
    if vmax <= vmin:
        vmax = vmin + 1e-12
    norm = Normalize(vmin=vmin, vmax=vmax)
    cm = plt.get_cmap(cmap)
    return cm(norm(values)), norm


def to_hex(color) -> str:
    """RGB(A) tuple -> '#rrggbb' (plotly-friendly)."""
    import matplotlib.colors as mcolors

    return mcolors.to_hex(color)
