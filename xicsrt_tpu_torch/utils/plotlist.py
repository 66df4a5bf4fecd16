"""Declarative plot specification -> matplotlib figure (a copy of
``xicsrt_tpu/utils/plotlist.py``).

Equivalent of the reference's ``xicsrt/util/mirplot.py:111-420``: diagnostics
are described as a list of dict specs ("plotlist") and rendered in one call,
so notebook/analysis code stays free of matplotlib boilerplate.

Each item is a dict:

- ``type``: 'line' (default) | 'scatter' | 'hist' | 'image' | 'errorbar' |
  'fill' | 'fill_between' | 'hline' | 'vline' | 'hspan' | 'vspan' |
  'axes' (style-only item) | 'figure' (figure-level item)
- ``x``, ``y`` (data), ``xerr``/``yerr``/``capsize`` (errorbar), ``bins``
  (hist), ``z`` (image), ``y1`` (fill_between), ``s``/``marker`` (scatter)
- ``axes``: subplot selector — an integer index or a string NAME (named
  axes, as in the reference); subplots are laid out on a near-square grid
  in first-appearance order
- styling: ``label``, ``color``, ``alpha``, ``markersize``, ``linestyle``,
  plus ANY artist property settable via ``set_<key>`` (generic
  passthrough, mirroring ``mirplot._apply_plot_prop``)
- axis-level keys (applied to the item's subplot): ``xlabel``, ``ylabel``,
  ``title``, ``xbound``, ``ybound``, ``xscale``, ``yscale``, ``aspect``,
  ``label_outer``, ``legend`` (bool) with ``legend_location`` /
  ``legend_fontsize`` / ``legend_framealpha``, plus any ``set_<key>``
  axes property
- figure-level keys on a ``type='figure'`` item: ``suptitle`` (with
  ``suptitle_x/y/ha/weight``), plus any ``set_<key>`` figure property
"""

from __future__ import annotations

import math

import numpy as np

_AXIS_KEYS = ("xlabel", "ylabel", "title", "xbound", "ybound", "xscale",
              "yscale", "aspect", "legend", "label_outer")
# Keys that are plotlist bookkeeping or consumed explicitly, never passed
# through the generic set_<key> mechanism.
_RESERVED = {
    "type", "axes", "x", "y", "z", "y1", "xerr", "yerr", "bins", "extent",
    "cmap", "colorbar", "s", "marker", "capsize", "legend",
    "legend_location", "legend_fontsize", "legend_framealpha",
    "suptitle", "suptitle_x", "suptitle_y", "suptitle_ha",
    "suptitle_weight", "label_outer", "aspect",
}


def plot_to_screen(plotlist, filename=None, show=False, figsize=None):
    """Render a plotlist; optionally save to ``filename``. Returns the fig."""
    import matplotlib.pyplot as plt

    plotlist = [dict(item) for item in plotlist]
    # Subplot selectors: ints and string names, in first-appearance order
    # (reference: _autoname_plots).
    indices = []
    for item in plotlist:
        if str(item.get("type", "line")).lower() == "figure":
            continue
        sel = item.get("axes", 0)
        if sel not in indices:
            indices.append(sel)
    if not indices:
        indices = [0]
    ncols = int(math.ceil(math.sqrt(len(indices))))
    nrows = int(math.ceil(len(indices) / ncols))
    if figsize is None:
        figsize = (5.5 * ncols, 4.5 * nrows)
    fig, axs = plt.subplots(nrows, ncols, figsize=figsize, squeeze=False)
    ax_of = {sel: axs.flat[k] for k, sel in enumerate(indices)}
    fig.axesdict = ax_of
    for extra in axs.flat[len(indices):]:
        extra.set_visible(False)

    for item in plotlist:
        kind = str(item.get("type", "line")).lower()
        if kind == "figure":
            _style_figure(fig, item)
            continue
        ax = ax_of[item.get("axes", 0)]
        if kind != "axes":
            _draw(ax, item, kind)
        _style_axis(ax, item)
    for sel in indices:
        ax = ax_of[sel]
        handles, _ = ax.get_legend_handles_labels()
        if handles and not any(
            item.get("legend") is False
            for item in plotlist
            if item.get("axes", 0) == sel
        ):
            ax.legend(fontsize=8)

    if filename:
        fig.savefig(filename)
    if show:  # pragma: no cover - interactive
        plt.show()
    return fig


def plot_to_file(plotlist, filename, figsize=None):
    """Render a plotlist straight to a file (reference ``plot_to_file``)."""
    return plot_to_screen(plotlist, filename=filename, figsize=figsize)


def _passthrough(obj, item):
    """Apply any ``set_<key>`` property the object supports (generic
    property mechanism of ``mirplot._apply_plot_prop``)."""
    for key, value in item.items():
        if key in _RESERVED or value is None:
            continue
        setter = getattr(obj, f"set_{key}", None)
        if callable(setter):
            try:
                setter(value)
            except (TypeError, ValueError):
                pass


def _draw(ax, item, kind):
    style = {
        k: item[k]
        for k in ("label", "color", "alpha", "markersize", "linestyle")
        if k in item
    }
    artists = []
    if kind == "line":
        x = item.get("x")
        y = np.asarray(item["y"])
        x = np.arange(len(y)) if x is None else np.asarray(x)
        artists = ax.plot(x, y, **style)
    elif kind == "scatter":
        style.pop("linestyle", None)
        ms = style.pop("markersize", item.get("s", 4.0))
        artists = ax.plot(np.asarray(item["x"]), np.asarray(item["y"]),
                          item.get("marker", ".") or ".",
                          markersize=ms, **style)
    elif kind == "hist":
        style.pop("linestyle", None)
        style.pop("markersize", None)
        ax.hist(np.asarray(item["x"]), bins=item.get("bins", 50), **style)
    elif kind == "errorbar":
        container = ax.errorbar(
            np.asarray(item["x"]), np.asarray(item["y"]),
            xerr=None if item.get("xerr") is None else np.asarray(item["xerr"]),
            yerr=None if item.get("yerr") is None else np.asarray(item["yerr"]),
            fmt=".", capsize=item.get("capsize"), **style)
        artists = [container.lines[0]]
    elif kind == "fill":
        artists = ax.fill(np.asarray(item["x"]), np.asarray(item["y"]),
                          color=item.get("color"), alpha=item.get("alpha"))
    elif kind in ("fill_between", "fillbetween"):
        artists = [ax.fill_between(
            np.asarray(item["x"]), np.asarray(item["y"]),
            np.asarray(item.get("y1", 0.0)),
            color=item.get("color"), alpha=item.get("alpha"),
            label=item.get("label"))]
    elif kind == "hline":
        y = item.get("y", 0.0)
        artists = [ax.axhline(np.atleast_1d(y)[0], **style)]
    elif kind == "vline":
        x = item.get("x", 0.0)
        artists = [ax.axvline(np.atleast_1d(x)[0], **style)]
    elif kind == "hspan":
        y = np.atleast_1d(item["y"])
        artists = [ax.axhspan(y[0], y[1], color=item.get("color"),
                              alpha=item.get("alpha"))]
    elif kind == "vspan":
        x = np.atleast_1d(item["x"])
        artists = [ax.axvspan(x[0], x[1], color=item.get("color"),
                              alpha=item.get("alpha"))]
    elif kind == "image":
        im = ax.imshow(
            np.asarray(item["z"]).T,
            origin="lower",
            extent=item.get("extent"),
            cmap=item.get("cmap", "viridis"),
            aspect=item.get("aspect", "auto"),
            interpolation="nearest",
        )
        if item.get("colorbar", True):
            ax.figure.colorbar(im, ax=ax)
        artists = [im]
    else:
        raise ValueError(f"Unknown plotlist item type: {kind}")
    for artist in artists:
        _passthrough(artist, {k: v for k, v in item.items()
                              if k not in _AXIS_KEYS and k not in style})


def _style_axis(ax, item):
    if "xlabel" in item:
        ax.set_xlabel(item["xlabel"])
    if "ylabel" in item:
        ax.set_ylabel(item["ylabel"])
    if "title" in item:
        ax.set_title(item["title"])
    if "xscale" in item:
        kw = {"nonpositive": "clip"} if item["xscale"] == "log" else {}
        ax.set_xscale(item["xscale"], **kw)
    if "yscale" in item:
        kw = {"nonpositive": "clip"} if item["yscale"] == "log" else {}
        ax.set_yscale(item["yscale"], **kw)
    if "xbound" in item:
        ax.set_xbound(*item["xbound"])
    if "ybound" in item:
        ax.set_ybound(*item["ybound"])
    if item.get("aspect") and str(item.get("type", "line")) != "image":
        ax.set_aspect(item["aspect"])
    if item.get("label_outer"):
        ax.label_outer()
    if item.get("legend"):
        ax.legend(loc=item.get("legend_location"),
                  fontsize=item.get("legend_fontsize", 8),
                  framealpha=item.get("legend_framealpha", 0.7))
    if str(item.get("type", "line")).lower() == "axes":
        _passthrough(ax, item)


def _style_figure(fig, item):
    if "suptitle" in item:
        fig.suptitle(
            item["suptitle"],
            x=item.get("suptitle_x", 0.02),
            y=item.get("suptitle_y", 0.98),
            ha=item.get("suptitle_ha", "left"),
            weight=item.get("suptitle_weight"),
        )
    _passthrough(fig, item)
