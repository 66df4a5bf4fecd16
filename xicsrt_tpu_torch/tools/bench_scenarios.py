"""The scenario configurations the roofline measures, and a launch timer.

The port's own copy of what ``tools/bench_scenarios.py`` (``_crystal``,
``_config``, ``_plasma_config`` and ``SCENARIOS``, :20-125) and
``__graft_entry__.py`` (``_spectrometer_config``, the flagship, :15) hold:
plain config dicts, the same in both packages; and :func:`baffle_config`,
the flagship behind a stack of aperture plates (the long optic chains).
:func:`time_launches` is the counterpart of ``time_chained``: CUDA events
around several launches after a warm-up, each launch with a fresh seed,
the best of a few blocks.
"""

from __future__ import annotations

import numpy as np
import torch


def _crystal(**kw):
    crystal = {
        "origin": [0.0, 0.0, 0.80374151],
        "zaxis": [0.0, 0.59497864, -0.80374151],
        "xsize": 0.2,
        "ysize": 0.2,
        "crystal_spacing": 2.45676,
        "rocking_type": "gaussian",
        "rocking_fwhm": 48.070e-6,
    }
    crystal.update(kw)
    return crystal


def _config(crystal, intensity, num_iter, **general):
    g = {"number_of_iter": num_iter, "random_seed": 0,
         "keep_history": False, "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": intensity,
                "wavelength": 3.9492,
                "angular_dist": "isotropic_xy",
                "spread": np.radians(10.0),
            }
        },
        "optics": {
            "crystal": crystal,
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4,
                "ysize": 0.2,
            },
        },
    }


def _plasma_config(intensity, num_iter, bundle_count=1000):
    # time_resolution chosen so the expected photon count equals
    # `intensity`: N = emissivity * t * volume * sin^2(spread/2).
    emissivity = 1e16
    volume = 0.02**3
    omega_frac = np.sin(np.radians(10.0) / 2.0) ** 2
    t_res = intensity / (emissivity * volume * omega_frac)
    return {
        "general": {"number_of_iter": num_iter, "random_seed": 0,
                    "keep_history": False, "print_results": False},
        "sources": {
            "plasma": {
                "class_name": "XicsrtPlasmaCubic",
                "origin": [0.0, 0.0, 0.0],
                "xsize": 0.02, "ysize": 0.02, "zsize": 0.02,
                "target": [0.0, 0.0, 0.80374151],
                "spread": np.radians(10.0),
                "emissivity": emissivity,
                "temperature": 1000.0,
                "mass_number": 40.0,
                "wavelength": 3.9492,
                "time_resolution": t_res,
                "bundle_volume": 1e-6,
                "bundle_count": bundle_count,
                "max_bundles": max(bundle_count * 2, 10000),
                "use_poisson": True,
                # The static budget carries headroom above the expectation;
                # 1.5x covers it.
                "max_rays": int(intensity * 1.5 + 1e5),
            }
        },
        "optics": {
            "crystal": _crystal(
                class_name="XicsrtOpticToroidalCrystal",
                radius_major=1.0, radius_minor=0.64,
                rocking_fwhm=100e-6,
            ),
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4, "ysize": 0.2,
            },
        },
    }


SCENARIOS = {
    "toroidal": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticToroidalCrystal",
                 radius_major=1.0, radius_minor=0.2), n, it),
    "mosaic15": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticSphericalMosaicCrystal",
                 radius=1.0, mosaic_spread=np.radians(0.05),
                 mosaic_depth=15, rocking_fwhm=150e-6), n, it),
    "mesh41": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticMeshSphericalCrystal",
                 radius=1.0, mesh_size=(41, 41),
                 mesh_coarse_size=(11, 11)), n, it),
    "plasma_torus": _plasma_config,
    # Reference-scale plasma (1e5 bundles).
    "plasma_100k": lambda n, it: _plasma_config(n, it, bundle_count=100000),
    "diff_fwd_bwd": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticSphericalCrystal", radius=1.0),
        n, it),
    "fused_diff": lambda n, it: _config(
        _crystal(class_name="XicsrtOpticSphericalCrystal", radius=1.0),
        n, it),
}


def _spectrometer_config(intensity, num_iter=1, **general):
    """The flagship: a directed point source, a boolean aperture (circle AND
    NOT circle), a spherical Bragg crystal and a detector."""
    g = {
        "number_of_iter": num_iter,
        "random_seed": 0,
        "keep_history": False,
        "print_results": False,
    }
    g.update(general)
    return {
        "general": g,
        "sources": {
            "source": {
                "class_name": "XicsrtSourceDirected",
                "intensity": intensity,
                "wavelength": 3.9492,
                "angular_dist": "isotropic_xy",
                "spread": np.radians(10.0),
            }
        },
        "optics": {
            "aperture": {
                "class_name": "XicsrtOpticAperture",
                "origin": [0.0, 0.0, 0.4],
                "zaxis": [0.0, 0.0, -1.0],
                "aperture": [
                    {"shape": "circle", "size": [0.09], "logic": "and"},
                    {"shape": "circle", "size": [0.03], "origin": [-0.02, 0.0],
                     "logic": "not"},
                ],
            },
            "crystal": {
                "class_name": "XicsrtOpticSphericalCrystal",
                "origin": [0.0, 0.0, 0.80374151],
                "zaxis": [0.0, 0.59497864, -0.80374151],
                "xsize": 0.2,
                "ysize": 0.2,
                "radius": 1.0,
                "crystal_spacing": 2.45676,
                "rocking_type": "gaussian",
                "rocking_fwhm": 48.070e-6,
            },
            "detector": {
                "class_name": "XicsrtOpticDetector",
                "origin": [0.0, 0.76871290, 0.56904832],
                "zaxis": [0.0, -0.95641806, 0.29200084],
                "xsize": 0.4,
                "ysize": 0.2,
            },
        },
    }


def with_baffles(cfg, n_planes):
    """``cfg`` (a source at the origin aimed along +z) with ``n_planes``
    circular aperture plates ahead of its optics, as a spectrometer looking
    into a plasma through a port tube limits its view. Plate k of N (k = 0
    ... N-1) sits at z_k = 0.05 + 0.30 k / N on the source axis, facing -z,
    a circle of radius 0.2 z_k with logic 'and': it clips the corners of
    the flagship's ``isotropic_xy`` 10 degree box. Returns a new dict."""
    optics = {}
    for k in range(n_planes):
        z = 0.05 + 0.30 * k / n_planes
        optics[f"baffle{k:03d}"] = {
            "class_name": "XicsrtOpticAperture",
            "origin": [0.0, 0.0, z],
            "zaxis": [0.0, 0.0, -1.0],
            "aperture": [{"shape": "circle", "size": [0.2 * z], "logic": "and"}],
        }
    optics.update(cfg["optics"])
    return dict(cfg, optics=optics)


def baffle_config(n_planes, intensity, num_iter=1, **general):
    """The flagship behind ``n_planes`` baffle plates (:func:`with_baffles`):
    ``baffle127`` is 124 plates (127 optics, the fused trace kernels'
    longest chain), ``baffle42`` 39 (42, the fused gradient's), ``baffle27``
    24."""
    return with_baffles(_spectrometer_config(intensity, num_iter, **general), n_planes)


# time_launches: warm-up calls, then blocks of timed calls, the best block
# kept; LAUNCHES calls in all, so a caller can make one seed for each.
WARMUP, REPS, BLOCKS = 2, 5, 3
LAUNCHES = WARMUP + REPS * BLOCKS


def time_launches(launch) -> float:
    """Milliseconds per call of ``launch(k)`` on the current CUDA device: the
    least, over BLOCKS blocks, of the CUDA-event time of REPS calls over
    REPS, after WARMUP calls. Call ``k`` (0 .. LAUNCHES - 1) passes its own
    index, so each launch can take a fresh seed."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_launches needs a CUDA device")
    for k in range(WARMUP):
        launch(k)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for b in range(BLOCKS):
        torch.cuda.synchronize()
        start.record()
        for k in range(REPS):
            launch(WARMUP + b * REPS + k)
        stop.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(stop) / REPS)
    return best
