"""3D scene rendering: ray paths and optic outlines
(``xicsrt_tpu/visual/plot3d.py``).

Equivalent of ``xicsrt/visual/xicsrt_3d__plotly.py`` /
``xicsrt_3d__ipyvolume.py``. One scene API — ``figure`` then ``add_rays``
/ ``add_optics`` / ``add_sources``, then ``show`` — with three renderers:
plotly (default when installed), ipyvolume (notebook widget,
``backend='ipyvolume'``), and a matplotlib-3D fallback.
"""

from __future__ import annotations

import numpy as np

import torch

from xicsrt_tpu_torch.public import get_element

try:
    import plotly.graph_objects as go

    HAVE_PLOTLY = True
except ImportError:  # pragma: no cover - plotly optional
    HAVE_PLOTLY = False


def _element(config, name):
    """The element ``name``, built on the CPU for its frame and sizes."""
    return get_element(config, name, device="cpu")


def _external(element, pts):
    """Local points (numpy [n, 3]) of the element in global coordinates."""
    frame = element.frame
    return frame.point_to_external(torch.as_tensor(pts, dtype=frame.origin.dtype)).numpy()


class Scene:
    """Accumulates 3D traces; renders with plotly or matplotlib."""

    def __init__(self, backend=None):
        if backend is None:
            backend = "plotly" if HAVE_PLOTLY else "matplotlib"
        self.backend = backend
        self._lines = []  # (segments [M, 2, 3], color, name)
        self._points = []  # (points [M, 3], color, name)
        self._meshes = []  # (points [P, 3], faces [F, 3], color, opacity, name)

    def add_line_segments(self, segments, color="red", name="rays"):
        segments = np.asarray(segments)
        if len(segments):
            self._lines.append((segments, color, name))

    def add_points(self, points, color="blue", name="points"):
        points = np.asarray(points)
        if len(points):
            self._points.append((points, color, name))

    def add_mesh(self, points, faces, color="purple", opacity=0.5,
                 name="mesh"):
        """Add a triangle-mesh surface ([P,3] points, [F,3] faces)."""
        points = np.asarray(points)
        faces = np.asarray(faces)
        if len(points) and len(faces):
            self._meshes.append((points, faces, color, opacity, name))

    # ------------------------------------------------------------------
    def show(self, filename=None):
        if self.backend == "plotly" and HAVE_PLOTLY:
            return self._show_plotly(filename)
        if self.backend == "ipyvolume":
            return self._show_ipyvolume(filename)
        return self._show_matplotlib(filename)

    def _show_ipyvolume(self, filename):
        """Interactive notebook-widget renderer
        (cf. ``xicsrt_3d__ipyvolume.py:37-366``); imported lazily so the
        package has no hard ipyvolume dependency."""
        try:
            import ipyvolume as ipv
        except ImportError as err:  # pragma: no cover - optional extra
            raise ImportError(
                "backend='ipyvolume' requires the ipyvolume package "
                "(pip install ipyvolume); use backend='plotly' or "
                "'matplotlib' otherwise."
            ) from err

        fig = ipv.figure()
        for segments, color, name in self._lines:
            # NaN-separated polyline batching, one widget per batch.
            m = len(segments)
            pts = np.full((m * 3, 3), np.nan)
            pts[0::3] = segments[:, 0]
            pts[1::3] = segments[:, 1]
            ipv.plot(pts[:, 0], pts[:, 1], pts[:, 2], color=color)
        for points, color, name in self._points:
            ipv.scatter(points[:, 0], points[:, 1], points[:, 2],
                        color=color, size=1.0, marker="sphere")
        for points, faces, color, opacity, name in self._meshes:
            ipv.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                             triangles=faces, color=color)
        all_pts = np.concatenate(
            [s.reshape(-1, 3) for s, _, _ in self._lines]
            + [p for p, _, _ in self._points]
            + [p for p, _, _, _, _ in self._meshes]
        ) if (self._lines or self._points or self._meshes) else np.zeros((1, 3))
        lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
        ipv.xlim(float(lo[0]), float(hi[0]))
        ipv.ylim(float(lo[1]), float(hi[1]))
        ipv.zlim(float(lo[2]), float(hi[2]))
        if filename:
            ipv.save(filename)
        else:  # pragma: no cover - notebook widget display
            ipv.show()
        return fig

    def _show_plotly(self, filename):
        fig = go.Figure()
        for segments, color, name in self._lines:
            # NaN-separated polyline batching.
            m = len(segments)
            pts = np.full((m * 3, 3), np.nan)
            pts[0::3] = segments[:, 0]
            pts[1::3] = segments[:, 1]
            fig.add_trace(
                go.Scatter3d(
                    x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                    mode="lines", line={"color": color, "width": 1}, name=name,
                )
            )
        for points, color, name in self._points:
            fig.add_trace(
                go.Scatter3d(
                    x=points[:, 0], y=points[:, 1], z=points[:, 2],
                    mode="markers", marker={"color": color, "size": 2},
                    name=name,
                )
            )
        for points, faces, color, opacity, name in self._meshes:
            fig.add_trace(
                go.Mesh3d(
                    x=points[:, 0], y=points[:, 1], z=points[:, 2],
                    i=faces[:, 0], j=faces[:, 1], k=faces[:, 2],
                    color=color, opacity=opacity, flatshading=True,
                    name=name,
                )
            )
        fig.update_layout(scene={"aspectmode": "data"})
        if filename:
            fig.write_html(filename)
        else:
            fig.show()
        return fig

    def _show_matplotlib(self, filename):
        import matplotlib.pyplot as plt
        from mpl_toolkits.mplot3d.art3d import Line3DCollection

        fig = plt.figure(figsize=(8, 7))
        ax = fig.add_subplot(projection="3d")
        for segments, color, name in self._lines:
            ax.add_collection3d(
                Line3DCollection(segments, colors=color, linewidths=0.3)
            )
        for points, color, name in self._points:
            ax.scatter(points[:, 0], points[:, 1], points[:, 2],
                       c=color, s=2, label=name)
        for points, faces, color, opacity, name in self._meshes:
            ax.plot_trisurf(points[:, 0], points[:, 1], points[:, 2],
                            triangles=faces, color=color, alpha=opacity)
        all_pts = np.concatenate(
            [s.reshape(-1, 3) for s, _, _ in self._lines]
            + [p for p, _, _ in self._points]
            + [p for p, _, _, _, _ in self._meshes]
        ) if (self._lines or self._points or self._meshes) else np.zeros((1, 3))
        lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")
        if filename:
            fig.savefig(filename, dpi=150)
        return fig


def figure(backend=None) -> Scene:
    """Create a 3D scene (cf. ``xicsrt_3d__plotly.figure``)."""
    return Scene(backend=backend)


def add_rays(scene: Scene, results, section="found", max_rays=1000,
             color=None, color_by=None, cmap="plasma", color_groups=8):
    """Add ray paths between consecutive elements from the history.

    Cf. ``xicsrt_3d__plotly.add_rays`` (:113-229). ``color_by='wavelength'``
    colors rays by a gradient over their wavelengths (the ray-history
    color-gradient capability of the reference's ``mircolor.py:99-221``),
    quantized into ``color_groups`` buckets so each bucket renders as one
    line batch.
    """
    history = results.get(section, {}).get("history", {})
    names = list(history.keys())
    if len(names) < 2:
        return scene
    n = len(history[names[0]]["origin"])
    take = min(n, max_rays)
    idx = np.linspace(0, n - 1, take).astype(int) if n else []
    if color is None:
        color = "red" if section == "found" else "gray"

    if color_by is not None:
        from xicsrt_tpu_torch.utils import colors as mcol

        values = np.asarray(history[names[-1]][color_by])[idx]
        edges = np.quantile(values, np.linspace(0, 1, color_groups + 1))
        group = np.clip(
            np.searchsorted(edges[1:-1], values, side="right"),
            0, color_groups - 1,
        )
        palette = [mcol.to_hex(c) for c in mcol.gradient(color_groups, cmap)]
    else:
        group = np.zeros(len(idx), dtype=int)
        palette = {0: color}
        color_groups = 1

    for gi in range(color_groups):
        sel = group == gi
        if not np.any(sel):
            continue
        segments = []
        for a, b in zip(names[:-1], names[1:]):
            p0 = np.asarray(history[a]["origin"])[idx][sel]
            p1 = np.asarray(history[b]["origin"])[idx][sel]
            # Only draw segments for rays that actually moved to element b.
            moved = np.linalg.norm(p1 - p0, axis=1) > 1e-12
            segments.append(np.stack([p0[moved], p1[moved]], axis=1))
        if segments:
            scene.add_line_segments(
                np.concatenate(segments), color=palette[gi],
                name=f"{section} rays" if color_groups == 1
                else f"{section} rays [{gi}]",
            )
    return scene


def add_optics(scene: Scene, config, color="blue"):
    """Add optic bound outlines (cf. ``xicsrt_3d__plotly.add_optics``)."""
    for name in config.get("optics", {}):
        element = _element(config, name)
        xsize = element.param.get("xsize")
        ysize = element.param.get("ysize")
        if not (xsize and ysize):
            continue
        x = xsize / 2.0
        y = ysize / 2.0
        corners_local = np.array(
            [[-x, -y, 0], [x, -y, 0], [x, y, 0], [-x, y, 0], [-x, -y, 0]],
            dtype=np.float64,
        )
        corners = _external(element, corners_local)
        segs = np.stack([corners[:-1], corners[1:]], axis=1)
        scene.add_line_segments(segs, color=color, name=name)
    return scene


def add_sources(scene: Scene, config, color="green"):
    """Add source bound outlines (cf. ``xicsrt_3d__plotly.add_sources``)."""
    for name in config.get("sources", {}):
        element = _element(config, name)
        sizes = [element.param.get(k) or 0.0 for k in ("xsize", "ysize", "zsize")]
        x, y, z = (s / 2.0 for s in sizes)
        corners = np.array(
            [
                [-x, -y, -z], [x, -y, -z], [x, y, -z], [-x, y, -z],
                [-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z],
            ]
        )
        edges = [
            (0, 1), (1, 2), (2, 3), (3, 0),
            (4, 5), (5, 6), (6, 7), (7, 4),
            (0, 4), (1, 5), (2, 6), (3, 7),
        ]
        pts = _external(element, corners)
        segs = np.stack([pts[[a for a, b in edges]],
                         pts[[b for a, b in edges]]], axis=1)
        scene.add_line_segments(segs, color=color, name=name)
    return scene


def add_fluxsurfaces(scene: Scene, config, num_surfaces=10,
                     range_m=None, range_n=None, cmap="plasma_r"):
    """Add nested plasma flux surfaces for every source exposing
    ``car_from_flx`` (cf. ``xicsrt_3d__plotly.add_fluxsurfaces`` :352-473).

    Surfaces at rho = linspace(0, 1, num_surfaces) are sampled on a regular
    (poloidal, toroidal) angle grid and triangulated directly (the grid
    ordering is known, so no Delaunay pass is needed).
    """
    import matplotlib.cm
    import matplotlib.colors

    from xicsrt_tpu_torch.optics.mesh_shapes import grid_faces

    if range_m is None:
        range_m = (0.0, 2.0 * np.pi)
    if range_n is None:
        range_n = (0.0, np.pi / 4.0)
    num_m = num_n = 51
    val_m = np.linspace(range_m[0], range_m[1], num_m)
    val_n = np.linspace(range_n[0], range_n[1], num_n)
    mm, nn = np.meshgrid(val_m, val_n, indexing="ij")
    faces = grid_faces(num_m, num_n)
    cm = matplotlib.cm.ScalarMappable(
        matplotlib.colors.Normalize(0.0, 1.0), cmap=cmap
    )

    for name in config.get("sources", {}):
        element = _element(config, name)
        if not hasattr(element, "car_from_flx"):
            continue
        for rho in np.linspace(0.0, 1.0, num_surfaces)[::-1]:
            flx = np.stack(
                [np.full(mm.size, rho**2), mm.ravel(), nn.ravel()], axis=-1
            )
            car = element.car_from_flx(flx)
            rgba = cm.to_rgba(rho)
            color = "rgb(%d, %d, %d)" % tuple(int(255 * c) for c in rgba[:3])
            if scene.backend != "plotly":
                color = rgba[:3]
            scene.add_mesh(car, faces, color=color, opacity=0.5,
                           name=f"{name} rho={rho:.2f}")
    return scene
