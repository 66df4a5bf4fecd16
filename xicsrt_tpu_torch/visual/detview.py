"""Interactive detector-image viewer with marginal-sum panes and
colormap scaling controls (``xicsrt_tpu/visual/detview.py``).

Equivalent of the reference's ``xicsrt/visual/detview.py:14-256``: the
2x2 marginal layout (``:44-70`` — main image bottom-left, column-sum
pane above sharing its x axis, row-sum pane to the right sharing its y
axis) plus interactive intensity scaling — here via matplotlib Slider
widgets (lower/upper percentile of the displayed range) and a
log/linear RadioButtons toggle. Works with any matplotlib backend; on a
non-interactive backend the widgets are still constructed (drag events
are simply never delivered), so the same code path is testable headless.
"""

from __future__ import annotations

import numpy as np


class DetViewer:
    """Holds the figure, image artist, marginal panes and widgets.

    Keeping widget references on an object prevents their garbage
    collection (which silently disables matplotlib widget callbacks).
    ``fig.axesdict`` maps {'image', 'xsum', 'ysum'} to their axes
    (the reference's interface, ``detview.py:54-60``).
    """

    def __init__(self, image, extent=None, title="detector", cmap="viridis"):
        import matplotlib.pyplot as plt
        from matplotlib.widgets import RadioButtons, Slider

        self.image = np.asarray(image, dtype=float)
        self.fig = plt.figure(figsize=(8, 8))
        # The reference's marginal layout (detview.py:44-60): image in
        # the big bottom-left cell, x-sum above it, y-sum to its right.
        gs = self.fig.add_gridspec(
            2, 2, width_ratios=[3, 1], height_ratios=[1, 3],
            left=0.10, right=0.82, bottom=0.25, top=0.95,
            wspace=0.05, hspace=0.05,
        )
        self.ax = self.fig.add_subplot(gs[1, 0])
        self.ax_xsum = self.fig.add_subplot(gs[0, 0], sharex=self.ax)
        self.ax_ysum = self.fig.add_subplot(gs[1, 1], sharey=self.ax)
        cax = self.fig.add_axes((0.86, 0.25, 0.03, 0.52))
        self.fig.axesdict = {
            "image": self.ax, "xsum": self.ax_xsum, "ysum": self.ax_ysum,
        }

        self._finite_max = float(self.image.max()) if self.image.size else 1.0
        self.im = self.ax.imshow(
            self.image.T,
            origin="lower",
            extent=extent,
            cmap=cmap,
            aspect="auto",
            interpolation="nearest",
        )
        self.fig.colorbar(self.im, cax=cax, label="counts")

        # Marginal sums in the image's data coordinates.
        nx, ny = self.image.shape
        if extent is not None:
            xs = np.linspace(extent[0], extent[1], nx, endpoint=False)
            xs += (extent[1] - extent[0]) / (2 * nx)
            ys = np.linspace(extent[2], extent[3], ny, endpoint=False)
            ys += (extent[3] - extent[2]) / (2 * ny)
        else:
            xs = np.arange(nx)
            ys = np.arange(ny)
        self.ax_xsum.plot(xs, self.image.sum(axis=1),
                          drawstyle="steps-mid")
        self.ax_ysum.plot(self.image.sum(axis=0), ys,
                          drawstyle="steps-mid")
        self.ax_xsum.tick_params(labelbottom=False)
        self.ax_ysum.tick_params(labelleft=False)
        self.ax_xsum.set_ylabel("column sum")
        self.ax_ysum.set_xlabel("row sum")
        self.ax_xsum.set_title(title)

        ax_lo = self.fig.add_axes((0.15, 0.12, 0.55, 0.03))
        ax_hi = self.fig.add_axes((0.15, 0.07, 0.55, 0.03))
        self.slider_lo = Slider(ax_lo, "low %", 0.0, 100.0, valinit=0.0)
        self.slider_hi = Slider(ax_hi, "high %", 0.0, 100.0, valinit=100.0)
        ax_scale = self.fig.add_axes((0.78, 0.05, 0.14, 0.12))
        self.radio = RadioButtons(ax_scale, ("linear", "log"))

        self.slider_lo.on_changed(self._update)
        self.slider_hi.on_changed(self._update)
        self.radio.on_clicked(self._update)
        self._update(None)

    # ------------------------------------------------------------------
    def _limits(self):
        lo_pct = min(self.slider_lo.val, self.slider_hi.val)
        hi_pct = max(self.slider_lo.val, self.slider_hi.val)
        if hi_pct <= lo_pct:
            hi_pct = lo_pct + 1e-3
        vmin = float(np.percentile(self.image, lo_pct))
        vmax = float(np.percentile(self.image, hi_pct))
        if vmax <= vmin:
            vmax = vmin + max(abs(vmin), 1.0) * 1e-6
        return vmin, vmax

    def _update(self, _event):
        from matplotlib.colors import LogNorm, Normalize

        vmin, vmax = self._limits()
        if self.radio.value_selected == "log":
            positive = self.image[self.image > 0]
            floor = float(positive.min()) if positive.size else 1e-12
            self.im.set_norm(LogNorm(vmin=max(vmin, floor), vmax=max(vmax, floor * 10)))
        else:
            self.im.set_norm(Normalize(vmin=vmin, vmax=vmax))
        self.fig.canvas.draw_idle()


def view(results_or_image, name=None, **kwargs):
    """Open an interactive viewer for a detector image.

    Accepts either a results dict (optic ``name``, defaulting to the last
    configured optic) or a bare [nx, ny] image array. Returns the
    ``DetViewer`` (its ``.fig`` is the matplotlib figure).
    """
    if isinstance(results_or_image, dict):
        results = results_or_image
        config = results["config"]
        if name is None:
            name = list(config["optics"].keys())[-1]
        image = np.asarray(results["total"]["image"][name])
        from xicsrt_tpu_torch.public import get_element

        element = get_element(config, name, device="cpu")
        xsize = element.param.get("xsize")
        ysize = element.param.get("ysize")
        extent = (
            (-xsize / 2, xsize / 2, -ysize / 2, ysize / 2)
            if (xsize and ysize) else None
        )
        kwargs.setdefault("extent", extent)
        kwargs.setdefault("title", f"Image: {name}")
    else:
        image = np.asarray(results_or_image)
    return DetViewer(image, **kwargs)
