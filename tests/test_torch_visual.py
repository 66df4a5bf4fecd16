"""The port's visual layer (``tests/test_visual_io.py``'s plotting half):
``plot_intersect`` and ``plot_image``, ``detview``, the 3D scene, the
plotlist and colour helpers, on the port's results, and ``plot_intersect``
on the fused engine's found history (the reservoir K1e, its twin here).
Agg backend."""

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import xicsrt_tpu_torch  # noqa: E402
from xicsrt_tpu_torch.visual import detview, plot2d, plot3d  # noqa: E402
from tests.test_torch_io_cli import _config  # noqa: E402


@pytest.fixture(scope="module")
def results():
    return xicsrt_tpu_torch.raytrace(_config(), device="cpu")


@pytest.fixture(scope="module")
def found_results():
    from __graft_entry__ import _spectrometer_config

    cfg = _spectrometer_config(8192, engine="fused", keep_history="found",
                               history_found_slots=1)
    return xicsrt_tpu_torch.raytrace(cfg, device="cpu")


def test_plot_intersect_with_marginals(results, tmp_path):
    fig = plot2d.plot_intersect(results, "detector")
    assert len(fig.axes) >= 3
    out = tmp_path / "intersect.png"
    fig.savefig(out)
    assert out.stat().st_size > 1000
    assert len(plot2d.plot_intersect(results, histograms=False).axes) == 1


def test_lost_points_filtered_to_optic_region(results):
    """Every lost ray stopped at the aperture, 0.5 m upstream: none is drawn
    on the detector."""
    assert len(results["lost"]["history"]["detector"]["origin"]) > 0
    assert len(plot2d._local_points(results, "detector", "lost")) == 0
    found = plot2d._local_points(results, "detector", "found")
    assert len(found) == results["total"]["meta"]["detector"]["num_out"]
    assert np.abs(found[:, 2]).max() < 1e-5


@pytest.mark.parametrize("scale", [None, "log"])
def test_plot_image(results, tmp_path, scale):
    fig = plot2d.plot_image(results, "detector", scale=scale)
    out = tmp_path / "image.png"
    fig.savefig(out)
    assert out.stat().st_size > 1000


def test_plot_intersect_on_found_history(found_results, tmp_path):
    """The reservoir's found rays land inside the detector's bounds."""
    found = plot2d._local_points(found_results, "detector", "found")
    n_found = found_results["found"]["history"]["detector"]["origin"].shape[0]
    assert 0 < len(found) == n_found
    assert np.all(np.abs(found[:, 0]) <= 0.2) and np.all(np.abs(found[:, 1]) <= 0.1)
    fig = plot2d.plot_intersect(found_results, "detector")
    out = tmp_path / "found.png"
    fig.savefig(out)
    assert out.stat().st_size > 1000


def test_detview_scaling_and_marginals(found_results):
    from matplotlib.colors import LogNorm

    v = detview.view(found_results, "detector")
    vmax = v.im.norm.vmax
    v.slider_hi.set_val(50.0)
    assert v.im.norm.vmax <= vmax
    v.radio.set_active(1)
    assert isinstance(v.im.norm, LogNorm)
    axd = v.fig.axesdict
    img = np.asarray(found_results["total"]["image"]["detector"], float)
    np.testing.assert_allclose(axd["xsum"].lines[0].get_ydata(), img.sum(axis=1))
    np.testing.assert_allclose(axd["ysum"].lines[0].get_xdata(), img.sum(axis=0))
    assert detview.view(np.random.default_rng(0).random((20, 10))).fig is not None


def test_scene_rays_optics_sources(results, tmp_path):
    scene = plot3d.figure(backend="matplotlib")
    plot3d.add_rays(scene, results, "found", max_rays=100)
    plot3d.add_rays(scene, results, "found", color_by="wavelength", max_rays=50)
    plot3d.add_optics(scene, results["config"])
    plot3d.add_sources(scene, results["config"])
    corners = scene._lines[-2][0]  # the detector's outline, 0.2 m square at z = 1
    np.testing.assert_allclose(np.abs(corners[:, :, :2]).max(), 0.1, rtol=1e-6)
    np.testing.assert_allclose(corners[:, :, 2], 1.0, rtol=1e-6)
    out = tmp_path / "scene.png"
    scene.show(filename=str(out))
    assert out.stat().st_size > 1000


def test_fluxsurfaces(tmp_path):
    config = {
        "general": {"print_results": False},
        "sources": {"plasma": {
            "class_name": "XicsrtPlasmaToroidal", "major_radius": 1.5,
            "minor_radius": 0.4, "xsize": 0.5, "ysize": 0.5, "zsize": 0.5,
            "emissivity": 1e10, "spread": 0.1, "target": [0.0, 0.0, 1.0]}},
        "optics": {},
    }
    scene = plot3d.figure(backend="matplotlib")
    plot3d.add_fluxsurfaces(scene, config, num_surfaces=3)
    assert len(scene._meshes) == 3
    pts = scene._meshes[0][0]
    np.testing.assert_allclose(np.hypot(np.hypot(pts[:, 0], pts[:, 1]) - 1.5, pts[:, 2]),
                               0.4, atol=1e-12)
    out = tmp_path / "flux.png"
    scene.show(filename=str(out))
    assert out.stat().st_size > 1000


def test_plotlist_and_colors(tmp_path):
    from xicsrt_tpu_torch.utils import colors
    from xicsrt_tpu_torch.utils.plotlist import plot_to_file, plot_to_screen

    x = np.linspace(0, 1, 20)
    fig = plot_to_file([
        {"type": "figure", "suptitle": "Diagnostics"},
        {"type": "line", "y": x**2, "axes": "upper", "label": "sq", "linewidth": 3.0},
        {"type": "hline", "y": 0.5, "axes": "upper", "color": "red"},
        {"type": "fill_between", "x": x, "y": x, "y1": x**2, "axes": "lower"},
        {"type": "axes", "axes": "lower", "xlabel": "t", "legend": False},
        {"type": "hist", "x": np.random.default_rng(0).normal(size=200), "axes": "h",
         "yscale": "log"},
        {"type": "image", "z": np.arange(12.0).reshape(3, 4), "axes": "im"},
    ], str(tmp_path / "plotlist.png"))
    assert (tmp_path / "plotlist.png").stat().st_size > 1000
    assert set(fig.axesdict) == {"upper", "lower", "h", "im"}
    assert fig.axesdict["lower"].get_xlabel() == "t"
    assert fig.axesdict["upper"].get_legend() is not None
    with pytest.raises(ValueError):
        plot_to_screen([{"type": "nope", "x": [1], "y": [1]}])
    g = colors.gradient(5, "viridis")
    assert len(g) == 5 and len(g[0]) == 4
    c, norm = colors.color_by_value([1.0, 2.0, 3.0])
    assert c.shape == (3, 4) and (norm.vmin, norm.vmax) == (1.0, 3.0)
    assert colors.to_hex((1.0, 0.0, 0.0)) == "#ff0000"


def test_ipyvolume_backend_drives_the_widget_api(monkeypatch, tmp_path):
    """The optional ipyvolume package, stubbed: the calls the renderer
    makes, and an ImportError naming it when it is missing."""
    import builtins
    import sys
    import types

    calls = []
    stub = types.ModuleType("ipyvolume")
    for fn in ("figure", "plot", "scatter", "plot_trisurf", "xlim", "ylim", "zlim",
               "save", "show"):
        stub.__dict__[fn] = lambda *a, _fn=fn, **k: calls.append(_fn) or object()
    monkeypatch.setitem(sys.modules, "ipyvolume", stub)
    scene = plot3d.figure(backend="ipyvolume")
    scene.add_line_segments(np.zeros((4, 2, 3)) + np.arange(3))
    scene.add_points(np.ones((5, 3)))
    scene.add_mesh(np.random.default_rng(0).normal(size=(6, 3)), np.array([[0, 1, 2]]))
    scene.show(filename=str(tmp_path / "scene.html"))
    assert {"figure", "plot", "scatter", "plot_trisurf", "save"} <= set(calls)
    assert "show" not in calls

    monkeypatch.delitem(sys.modules, "ipyvolume")
    real_import = builtins.__import__

    def block(name, *args, **kwargs):
        if name == "ipyvolume":
            raise ImportError("no module")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", block)
    with pytest.raises(ImportError, match="ipyvolume"):
        scene.show()
