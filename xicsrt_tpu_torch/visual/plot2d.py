"""2D diagnostics: intersection scatter plots and detector images
(``xicsrt_tpu/visual/plot2d.py``).

Equivalent of ``xicsrt/visual/xicsrt_2d__matplotlib.py``: ``plot_intersect``
shows found/lost ray intersections in optic-local coordinates with marginal
histograms and bounds/aperture outlines; ``plot_image`` renders the binned
pixel image.
"""

from __future__ import annotations

import numpy as np

import torch

from xicsrt_tpu_torch.public import get_element


def _element(config, name):
    """The element ``name``, built on the CPU for its frame and sizes."""
    return get_element(config, name, device="cpu")


def _local(element, pts):
    """Global points (numpy [n, 3]) in the element's local frame."""
    frame = element.frame
    return frame.point_to_local(torch.as_tensor(pts, dtype=frame.origin.dtype)).numpy()


def _local_points(results, name, section):
    """Intersection points of `section` ('found'|'lost') rays at optic
    ``name``, in the optic local frame.

    Lost rays that never reached this optic keep their upstream positions
    (the engine leaves non-intersecting origins unchanged so arrays stay
    finite for gradients, ``optics/base.py``); those stale points are
    filtered out by requiring the local position to lie in the optic's
    bounding region (its x/y extent with a small margin, and near the
    surface in z).
    """
    history = results.get(section, {}).get("history", {})
    if name not in history:
        return np.zeros((0, 3))
    element = _element(results["config"], name)
    pts = np.asarray(history[name]["origin"])
    mask = np.asarray(history[name]["mask"])
    if section == "lost":
        sel = np.ones(len(pts), dtype=bool)
    else:
        sel = mask
    local = _local(element, pts[sel])
    if section == "lost" and len(local):
        xsize = element.param.get("xsize")
        ysize = element.param.get("ysize")
        keep = np.ones(len(local), dtype=bool)
        if xsize:
            keep &= np.abs(local[:, 0]) <= 0.75 * xsize
        if ysize:
            keep &= np.abs(local[:, 1]) <= 0.75 * ysize
        if xsize and ysize:
            # Rays that stopped upstream sit far off the optic surface.
            keep &= np.abs(local[:, 2]) <= 0.5 * max(xsize, ysize)
        local = local[keep]
    return local


def _bounds_outline(element):
    xsize = element.param.get("xsize")
    ysize = element.param.get("ysize")
    if not (xsize and ysize):
        return None
    x = xsize / 2.0
    y = ysize / 2.0
    return np.array(
        [[-x, -y], [x, -y], [x, y], [-x, y], [-x, -y]], dtype=np.float64
    )


def _aperture_outlines(element):
    outlines = []
    for spec in getattr(element, "aperture_spec", []) or []:
        shape = spec["shape"]
        ox, oy = spec["origin"][0], spec["origin"][1]
        t = np.linspace(0, 2 * np.pi, 181)
        if shape == "circle":
            r = spec["size"][0]
            outlines.append(np.stack([ox + r * np.cos(t), oy + r * np.sin(t)], 1))
        elif shape == "ellipse":
            sx, sy = spec["size"][0], spec["size"][1]
            outlines.append(np.stack([ox + sx * np.cos(t), oy + sy * np.sin(t)], 1))
        elif shape in ("square", "rectangle"):
            sx = spec["size"][0]
            sy = spec["size"][1] if shape == "rectangle" else spec["size"][0]
            x, y = sx / 2.0, sy / 2.0
            outlines.append(
                np.array([[ox - x, oy - y], [ox + x, oy - y], [ox + x, oy + y],
                          [ox - x, oy + y], [ox - x, oy - y]])
            )
        elif shape == "triangle":
            v = spec["vertices"][:, :2] + spec["origin"][None, :2]
            outlines.append(np.vstack([v, v[:1]]))
    return outlines


def plot_intersect(results, name=None, show_lost=True, ax=None,
                   marker_size=2.0, histograms=True, bins=64):
    """Scatter of ray intersections at an optic, in local coordinates, with
    marginal per-axis histograms of the found rays.

    Cf. ``xicsrt_2d__matplotlib.plot_intersect`` (:66-129), which draws the
    same joint scatter + marginal histogram layout. Passing an existing
    ``ax`` (or ``histograms=False``) draws the scatter only.
    """
    import matplotlib.pyplot as plt

    config = results["config"]
    if name is None:
        name = list(config["optics"].keys())[-1]
    element = _element(config, name)

    hist_x = hist_y = None
    if ax is None:
        if histograms:
            fig = plt.figure(figsize=(8, 7))
            gs = fig.add_gridspec(
                2, 2, width_ratios=(5, 1), height_ratios=(1, 5),
                wspace=0.05, hspace=0.05,
            )
            ax = fig.add_subplot(gs[1, 0])
            hist_x = fig.add_subplot(gs[0, 0], sharex=ax)
            hist_y = fig.add_subplot(gs[1, 1], sharey=ax)
            hist_x.tick_params(labelbottom=False)
            hist_y.tick_params(labelleft=False)
        else:
            fig, ax = plt.subplots(figsize=(7, 6))
    else:
        fig = ax.figure

    if show_lost:
        lost = _local_points(results, name, "lost")
        if len(lost):
            ax.plot(lost[:, 0], lost[:, 1], ".", color="0.6",
                    markersize=marker_size, label="lost")
    found = _local_points(results, name, "found")
    if len(found):
        ax.plot(found[:, 0], found[:, 1], ".", color="tab:red",
                markersize=marker_size, label="found")
        if hist_x is not None:
            hist_x.hist(found[:, 0], bins=bins, color="tab:red", alpha=0.75)
            hist_y.hist(found[:, 1], bins=bins, color="tab:red", alpha=0.75,
                        orientation="horizontal")

    outline = _bounds_outline(element)
    if outline is not None:
        ax.plot(outline[:, 0], outline[:, 1], "-", color="k", linewidth=0.8)
    for ap in _aperture_outlines(element):
        ax.plot(ap[:, 0], ap[:, 1], "--", color="tab:blue", linewidth=0.8)

    ax.set_xlabel("x [m] (optic local)")
    ax.set_ylabel("y [m] (optic local)")
    title = f"Intersections: {name}"
    if hist_x is not None:
        hist_x.set_title(title)
    else:
        ax.set_title(title)
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    return fig


def plot_image(results, name=None, scale=None, ax=None, cmap="viridis"):
    """Render the binned pixel image of an optic.

    Cf. ``xicsrt_2d__matplotlib.plot_image`` (:466-495) / ``detview``.
    ``scale``: None (linear) or 'log'.
    """
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    config = results["config"]
    if name is None:
        name = list(config["optics"].keys())[-1]
    image = np.asarray(results["total"]["image"][name])
    element = _element(config, name)
    xsize = element.param["xsize"]
    ysize = element.param["ysize"]

    if ax is None:
        fig, ax = plt.subplots(figsize=(7, 6))
    else:
        fig = ax.figure

    norm = LogNorm(vmin=max(image[image > 0].min(), 1e-12), vmax=image.max()) \
        if (scale == "log" and (image > 0).any()) else None
    im = ax.imshow(
        image.T,
        origin="lower",
        extent=(-xsize / 2, xsize / 2, -ysize / 2, ysize / 2),
        cmap=cmap,
        norm=norm,
        aspect="equal",
        interpolation="nearest",
    )
    fig.colorbar(im, ax=ax, label="counts")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(f"Image: {name}")
    return fig
