"""Fused trace engine K1 (counterpart of ``xicsrt_tpu/ops/fused_trace.py``).

One CUDA kernel (``csrc/fused_trace.cu``) generates every ray, traces it
through the optic chain, counts the survivors of each element and bins the
nearest-pixel images, with all per-ray state in registers. It replaces the
ported cuts of the TPU megakernel ``build_fused_run`` (kernel): the main
chain (K1a), the generic source matrix (K1b), the in-kernel plasma source
(K1f), the torus, cylinder, mesh (K1c-cheb), file rocking (K1c-file),
mirror (K1c-mirror) and mosaic (K1c-mosaic) stages of K1c, weight mode
with bilinear images (K1d), and the history reservoir (K1e, two more
launches, ``csrc/fused_history.cu``). A second kernel, K3
(``csrc/trace_only.cu``, :func:`fused_trace_run_cuda`), traces rays the
eager engine generated through the same chain (``csrc/trace_chain.cuh``);
it replaces the TPU's ``build_fused_trace_run``.

Supported subset (``general.engine='fused'``; outside it the build raises
``FusedUnsupported``, and ``'auto'`` falls back to the eager engine):

- Generic, Directed and Focused sources: point, uniform or gaussian boxes;
  ``isotropic``, ``isotropic_xy`` (symmetric in closed form, asymmetric by
  12 bracketed Newton steps on the TPU kernel's polynomial arcsin),
  ``flat``, ``flat_xy`` and ``gaussian`` cones; one wavelength, a uniform
  band or an exact Voigt line (a Gaussian plus a Cauchy, not the eager
  engine's table); the bulk Doppler shift; counted or Poisson budgets;
  sightline filters, tested on each ray's origin in the kernel;
- plasma sources of up to 2^22 bundles (K1f): the O(bundle_count) stage
  runs in PyTorch on the device per iteration (the source's
  ``bundle_tables``) and the kernel gives each ray its bundle by binary
  search over the iteration's cumulative counts (``csrc/bundle_lookup.cuh``),
  then samples the voxel offset, the cone to the target, the exact Voigt
  wavelength and the Doppler shift;
- plane, sphere, torus and cylinder optics (the torus by the
  local-quadratic Newton root of ``torus_local_quadratic_t``, the cylinder
  by the stable quadratic about its x axis) and smooth meshes, traced by the
  Chebyshev height field :func:`_fit_cheb_surface` fits at build time (4
  Newton steps in the kernel; faceted or rough meshes raise), with x/y/z
  bounds and aperture logic (every logic op; shapes
  none/circle/square/rectangle/ellipse);
- no interaction, a mirror (or a crystal without its Bragg check), a
  Bragg crystal with gaussian, step or file rocking, or a mosaic crystal
  of any depth (its layers a run-time loop) with an optional cutoff, with
  per-ray Bragg angles where the source varies the wavelength; a file
  curve is resampled on the host onto at most 2048 uniform points
  (``fused_trace.py:540-559``) and read by the kernels as two loads;
- ``interact_mode`` mc (Bernoulli acceptance) or weight (each ray carries
  a weight: a crystal multiplies it by its probability and draws nothing,
  a mosaic crystal by its survival estimator), nearest-pixel or bilinear
  images of the weights, float32;
- the history reservoirs ``keep_history='found'`` and ``'sampled'`` (K1e,
  :func:`history_probe_cuda`, :func:`history_record_cuda`,
  ``csrc/fused_history.cu``): 'found' probes the run's first chunks for
  the kept ones, and K1 marks chunks only where the probe found too few;
  the kept chunks' rays traced again, each element's state recorded, K1
  only.

Chains of up to 127 optics (K1, K1e, K3; 42 for the gradient kernels K5),
with any number of apertures and filters that fits a block's shared memory
(``HEAD_MAX_BYTES``). A source K1 refuses (a plasma of more than 2^22
bundles) runs on K3 when the chain is in the subset (:func:`build_fast_run`,
as ``fused_trace.py:2229-2262``): the eager engine generates each
iteration's rays and K3 traces them.

Unlike the TPU kernel, geometry is not compiled in: :func:`pack_params`
packs the run's ``params`` into two small buffers at every call, so one
build serves every configuration and a changed ``params`` takes effect at
once. Per-optic data too large for them (file tables, Chebyshev
coefficients) goes into a third, ``aux``, which the kernels read from
global memory.

The Bragg deviation is the sine-difference identity with a cubic asin
correction, ``sd + sd^3/6`` with ``sd = |d.n| cos_b - sqrt(1-(d.n)^2) sin_b``
(``fused_trace.py:995-1002``), in the kernel and in its twin alike; its
error is below 1e-11 rad inside the rocking support.

``fused_run_cuda`` launches the kernel for buffers on a CUDA device and
takes the plain PyTorch twin :func:`fused_run_plain` for buffers on the
CPU; ``fused_trace_run_cuda`` and :func:`fused_trace_run_plain` likewise.
The twins do the kernels' float32 operations in the kernels' order.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from xicsrt_tpu_torch.draws import Draws
from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import fused_multiply_add
from xicsrt_tpu_torch.ops.bundle_gather import bundle_rows


class FusedUnsupported(NotImplementedError):
    """Raised when a config is outside the fused-kernel subset."""


# Buffer layout, mirrored by the XRT_* offsets of csrc/trace_common.cuh.
# Header ints 0-7: n_optics, n_apertures, cone kind, n_draws, image floats,
# source kind (0 generic, 1 plasma of bundle tables, 2 plasma of one bundle
# per ray, the gradient kernels' own, 3 rays from memory, K3's), voxel
# draws (plasma), Cauchy draw; 8-15 the generic source's structure (H_*);
# 16-17 the run's modes: weight mode (the rays carry weights; crystals
# weigh instead of drawing) and bilinear images.
# K1, K1e and K3 take chains of up to MAX_OPTICS optics, as JAX's K1
# (``fused_trace.py:1296-1298``). Apertures and source filters have no count
# limit: the kernels copy the packed buffers into the head of their dynamic
# shared memory (``xrt_head_floats``, ``csrc/trace_common.cuh``: the
# per-element counters of MAX_OPTICS + 1 elements, ip, fp), sized by the
# run, so only a head past HEAD_MAX_BYTES, which leaves a block's 227 KB
# room for a build's static shared memory, is refused (about 8000
# apertures).
MAX_OPTICS = 127
HEAD_MAX_BYTES = 192 * 1024
SRC_F, OPT_F, AP_F, FILT_F = 64, 32, 4, 8
HDR_I, OPT_I, AP_I = 18, 16, 2
(H_FILTERS, H_SPATIAL, H_FOCUSED, H_WAVE, H_GAUSS, H_CAUCHY, H_VELOCITY,
 H_PER_RAY_WL, H_WEIGHT, H_BILINEAR) = range(8, 18)
SRC_RAYS = 3
# Generic source floats: origin, rotation rows (o2, o1, axis), then these.
S_CONE, S_BASIS, S_SIZES, S_TARGET, S_HINT, S_WAVE, S_VELOCITY, S_CINV = (
    12, 24, 33, 36, 39, 42, 45, 48)
_CONES = {"isotropic": 0, "isotropic_xy": 1, "isotropic_xy_asym": 2, "flat": 3,
          "flat_xy": 4, "flat_gaussian": 5}
_APERTURE_SHAPES = {"none": 0, "circle": 1, "square": 2, "rectangle": 3,
                    "ellipse": 4}
_LOGIC = {"and": 0, "not": 1, "or": 2, "nand": 3, "nor": 4, "xor": 5, "xnor": 6}
_SHAPES = {"plane": 0, "sphere": 1, "torus": 2, "cylinder": 3, "cheb": 4}
_INTERACT = {"none": 0, "crystal": 1, "mirror": 2, "mosaic": 3}
_ROCKING = {"gaussian": 0, "step": 1, "file": 2}
# Optic floats of a torus read by the gradient kernels (XRT_O_MADJ,
# XRT_O_CSIGN): the convex pair folded into (major_adjust, center_sign).
O_MAJOR_ADJUST, O_CENTER_SIGN = 29, 30
# A file rocking curve's table start (XRT_O_LO, in the rocking width's
# float) and 1 / grid step (XRT_O_INV_STEP); its aux offset and length in
# the optic's ints 10-11 (XRT_OI_TABLE, XRT_OI_K). A Chebyshev surface's
# centre and scales in the sphere's floats 12-15, its mid-plane and
# convergence tolerance in the torus's 26-27, its terms' aux offset (even),
# degree and term count in ints 12-14 (XRT_OI_CHEB, XRT_OI_DEG,
# XRT_OI_TERMS): the terms are the nonzero coefficients of C, Cx and Cy
# (:func:`cheb_terms`); the aux offset (a multiple of 4) of the dense
# coefficients the kernels sum (:func:`cheb_dense`) in the sphere's int 1
# (XRT_OI_DENSE).
O_LO, O_INV_STEP = 20, 31
OI_TABLE, OI_K, OI_CHEB, OI_DEG, OI_TERMS = 10, 11, 12, 13, 14
OI_DENSE = 1
# A mosaic crystal: its crystallite sigma sin(hwhm / sqrt(2 ln 2)) and its
# cutoff angle (-1 without a cutoff) in the torus's floats 29-30
# (XRT_O_MSIGMA, XRT_O_MCUT; no mosaic composite is a torus), its depth in
# the optic's int 15 (XRT_OI_DEPTH).
O_MOSAIC_SIGMA, O_MOSAIC_CUT = 29, 30
OI_DEPTH = 15
CHEB_MAX_DEG = 12
_TWO_PI = 2.0 * math.pi
_SIGMA_PER_FWHM = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
_C_LIGHT = 299792458.0
# The largest plasma of the fused path (``fused_trace.py:308-317``).
MAX_BUNDLES = 1 << 22
# Rays per slice of the plain twin, which bounds its temporaries.
_TWIN_SLICE = 1 << 20
# K1e's probe traces at most 1/PROBE_SHARE of a 'found' run's chunks (and
# at least its first ``slots``) before K1 marks them instead. Where it
# finds too few, its rays cost the run about 1.6 times what K1 spends on
# them (1/64 of the run cost a sparse flagship 2-6 % on an H100, 1/256
# 1 %), and it need not find more: a chain whose first chunks rarely keep
# a ray pays little for its marks, which cost a run in proportion to its
# warps with a hit; a dense chain is found in the first window. It runs
# for runs of PROBE_MIN_RAYS rays or more: on an H100 the flagship's
# 'found' call ran 0.02-0.13 ms faster probed than marked at 2^28 rays,
# 0.03 ms slower (median) at 2^26 and 0.02-0.05 ms slower at 2^24
# (chip_ab.py --k1e-only, PERF.md).
PROBE_SHARE = 1024
PROBE_MIN_RAYS = 1 << 28


# ---------------------------------------------------------------------------
# Build-time extraction of the pipeline structure.
# ---------------------------------------------------------------------------

def _cone_spec(p) -> tuple:
    """(cone kind, float32 constants) of a generic source's angular
    distribution (JAX ``_source_spec``, ``fused_trace.py:162-205``)."""
    from xicsrt_tpu_torch.ops.spread import parse_spread_single, parse_spread_xy

    angular = str(p["angular_dist"]).lower()
    if angular == "isotropic":
        cos_t = math.cos(parse_spread_single(p["spread"]))
        return _CONES["isotropic"], [cos_t, 1.0 - cos_t]
    if angular == "isotropic_xy":
        tx0, tx1, ty0, ty1 = parse_spread_xy(p["spread"])
        tyl, tyh = math.tan(ty0), math.tan(ty1)
        tail = [tyl, tyl * tyl, tyh, tyh * tyh]
        if ty0 == -ty1 and ty1 > 0:
            sb1 = math.sin(ty1)
            g0 = 2.0 * math.asin(math.sin(tx0) * sb1)
            g1 = 2.0 * math.asin(math.sin(tx1) * sb1)
            return _CONES["isotropic_xy"], [g0, g1 - g0, sb1] + tail
        sx0, sx1 = math.sin(tx0), math.sin(tx1)
        sb0, sb1 = math.sin(ty0), math.sin(ty1)

        def marginal(sx):
            return (math.asin(max(-1.0, min(1.0, sx * sb1)))
                    - math.asin(max(-1.0, min(1.0, sx * sb0))))

        g0, g1 = marginal(sx0), marginal(sx1)
        return (_CONES["isotropic_xy_asym"],
                [sx0, sx1 - sx0, sb0, sb1, g0, g1 - g0] + tail + [sx1])
    if angular == "flat":
        return _CONES["flat"], [math.tan(parse_spread_single(p["spread"]))]
    if angular == "flat_xy":
        t = [math.tan(a) for a in parse_spread_xy(p["spread"])]
        return _CONES["flat_xy"], [t[0], t[1] - t[0], t[2], t[3] - t[2]]
    if angular in ("gaussian", "flat_gaussian"):
        hwhm = parse_spread_single(p["spread"])
        return _CONES["flat_gaussian"], [math.sin(hwhm / math.sqrt(2.0 * math.log(2.0)))]
    raise FusedUnsupported(f"angular_dist {angular}")


def _filter_specs(p, filter_map) -> list:
    """Names of a source's sightline filters, tested in the kernel; a
    pass-through filter drops out (JAX ``_filter_specs``,
    ``fused_trace.py:267-291``)."""
    from xicsrt_tpu_torch.filters import FilterBase, FilterSightline

    names = []
    filters = p.get("filters")
    for fname in [] if filters is None else list(filters):
        flt = (filter_map or {}).get(fname)
        if isinstance(flt, FilterSightline):
            names.append(fname)
        elif type(flt) is not FilterBase:
            raise FusedUnsupported(f"source filter {fname!r}")
    return names


def _source_spec(source, filter_map=None) -> dict:
    """Structure of the source: sampling program and budget (JAX
    ``_source_spec``, ``fused_trace.py:125-264``). Draws per ray of a
    generic source: one per nonzero box size, the cone's two, one for a
    uniform band, one each for a Voigt line's Gauss and Cauchy parts.
    ``filter_map``: the pipeline's filters by name."""
    from xicsrt_tpu_torch.ops.voigt import doppler_sigma, natural_gamma
    from xicsrt_tpu_torch.sources.generic import (
        SourceDirected, SourceFocused, SourceGeneric,
    )
    from xicsrt_tpu_torch.sources.plasma import PlasmaGeneric

    if isinstance(source, PlasmaGeneric):
        return _plasma_spec(source)
    if not isinstance(source, SourceGeneric):
        raise FusedUnsupported(f"source {type(source).__name__}")
    p = source.param
    filters = _filter_specs(p, filter_map)
    sizes = [float(p.get(k) or 0.0) for k in ("xsize", "ysize", "zsize")]
    spatial = str(p.get("spatial_dist", "uniform")).lower()
    if not any(sizes):
        spatial_kind = 0
    elif spatial == "uniform":
        spatial_kind = 1
    elif spatial == "gaussian":  # FWHM -> sigma
        spatial_kind = 2
        sizes = [x / (2.0 * math.sqrt(2.0 * math.log(2.0))) for x in sizes]
    else:
        raise FusedUnsupported(f"spatial_dist {spatial}")
    n_draws = sum(1 for x in sizes if x != 0.0) if spatial_kind else 0
    cone = _cone_spec(p)
    n_draws += 2

    w0 = float(p["wavelength"])
    wtype = str(p["wavelength_dist"]).lower()
    if wtype == "uniform":
        lo, hi = (float(x) for x in np.asarray(p["wavelength_range"], np.float64)[:2])
        wave = (1, [lo, hi - lo, 0.0])
        n_draws += 1
    elif wtype == "voigt" and source.voigt_table is not None:
        # The exact Gauss + Cauchy decomposition, as the plasmas sample.
        sigma = doppler_sigma(float(p["temperature"]), float(p["mass_number"]), w0)
        gamma = natural_gamma(float(p["linewidth"]), w0)
        wave = (2, [w0, sigma, gamma])
        n_draws += int(sigma > 0.0) + int(gamma > 0.0)
    else:
        wave = (0, [w0, 0.0, 0.0])
    velocity = bool(np.any(np.asarray(p["velocity"], np.float64) != 0.0))
    focused = isinstance(source, SourceFocused)
    return {
        "name": source.name,
        "kind": 0,
        "directed": isinstance(source, SourceDirected),
        "focused": focused,
        "dist": cone,
        "spatial": spatial_kind,
        "sizes": sizes,
        "wave": wave,
        "velocity": velocity,
        "filters": filters,
        "per_ray_wl": wave[0] != 0 or velocity,
        # The whole sampler; else the kernels' point-source cut.
        "full": bool(spatial_kind or cone[0] >= 2 or focused or wave[0] or velocity
                     or filters),
        "poisson": bool(p.get("use_poisson")),
        "rate": float(source._scaled_intensity),
        "n_draws": n_draws,
    }


def _plasma_spec(source) -> dict:
    """Structure of a plasma source (``_plasma_spec``, JAX
    ``fused_trace.py:294-343``). Draws per ray: 3 voxel uniforms (voxel
    bundles), the cone's u and v, one uniform for the normal, one Cauchy
    uniform (natural linewidth)."""
    p = source.param
    if source.bundle_count > MAX_BUNDLES:
        raise FusedUnsupported(
            f"bundle_count {source.bundle_count} > 2^22 (the per-iteration "
            "bundle stage would dominate)")
    from xicsrt_tpu_torch.ops.voigt import doppler_sigma

    voxel = float(source.voxel_size)
    gamma = float(source.gamma)
    w0 = float(p["wavelength"])
    return {
        "name": source.name,
        "kind": 1,
        "voxel": voxel,
        "gamma": gamma,
        "wavelength": w0,
        # Doppler sigma per sqrt(eV): the kernel scales it by sqrt(T).
        "sigma_conv": doppler_sigma(1.0, float(p["mass_number"]), w0),
        "poisson": False,
        "n_draws": (3 if voxel > 0.0 else 0) + 3 + (1 if gamma > 0.0 else 0),
    }


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _file_table(optic) -> dict:
    """A file rocking curve resampled as the TPU kernels take it
    (``fused_trace.py:540-559``): the sigma/pi mix by ``rocking_mix`` on
    ``K = min(2048, round_up(max(4 len, 128), 128))`` uniform points over
    the table's support, 0 outside it, float32; ``lo`` and ``inv_step =
    (K - 1) / (hi - lo)`` map a deviation to its fractional index."""
    tab = optic.rocking_table
    mix = float(optic.param.get("rocking_mix", 0.5))
    dtheta = np.asarray(tab["dtheta"], dtype=np.float64)
    curve = (mix * np.asarray(tab["reflect_s"], np.float64)
             + (1.0 - mix) * np.asarray(tab["reflect_p"], np.float64))
    K = int(min(2048, _round_up(max(4 * len(dtheta), 128), 128)))
    lo, hi = float(dtheta.min()), float(dtheta.max())
    grid = np.linspace(lo, hi, K)
    return {"table": np.interp(grid, dtheta, curve, left=0.0, right=0.0).astype(np.float32),
            "lo": lo, "inv_step": (K - 1) / (hi - lo), "K": K}


def _fit_cheb_surface(optic) -> dict:
    """Fit the mesh with a tensor-Chebyshev height field z(x, y) in the
    optic's local frame (build time; a copy of JAX ``_fit_cheb_surface``,
    ``fused_trace.py:346-448``).

    z = sum_ij C_ij T_i(u) T_j(v) by least squares at the lowest degree of
    4, 6, ..., 12 that reproduces the vertices to 1e-6 of the span, checked
    against the vertex normals to 5e-4 rad; the kernels intersect it by
    Newton steps. Raises ``FusedUnsupported`` for meshes that are not
    smooth height fields: faceted meshes and rough ones stay on the eager
    engine's exact triangles.
    """
    import numpy.polynomial.chebyshev as ncheb

    p = optic.param
    if not bool(p.get("mesh_interpolate", False)):
        raise FusedUnsupported(
            "faceted mesh (mesh_interpolate=False): the fused surrogate "
            "is smooth; the eager engine traces exact triangles")
    pts = np.asarray(p["mesh_points"], dtype=np.float64)
    normals = p.get("mesh_normals")
    if not bool(p.get("trace_local", False)):
        basis = _vec(optic.frame.basis)
        origin = _vec(optic.frame.origin)
        pts = (pts - origin) @ basis.T
        if normals is not None:
            normals = np.asarray(normals, dtype=np.float64) @ basis.T
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    lox, hix = float(x.min()), float(x.max())
    loy, hiy = float(y.min()), float(y.max())
    spanx = max(hix - lox, 1e-12)
    spany = max(hiy - loy, 1e-12)
    u = (x - lox) / spanx * 2.0 - 1.0
    v = (y - loy) / spany * 2.0 - 1.0
    tol = 1e-6 * max(spanx, spany)
    C = resid = None
    for deg in (4, 6, 8, 10, 12):
        if deg > 4 and (deg + 1) ** 2 * 1.2 > len(pts):
            break  # under-determined: higher degrees would interpolate noise
        V = ncheb.chebvander2d(u, v, [deg, deg])
        coef, *_ = np.linalg.lstsq(V, z, rcond=None)
        resid = float(np.abs(V @ coef - z).max())
        if resid <= tol:
            C = coef.reshape(deg + 1, deg + 1)
            break
    if C is None:
        raise FusedUnsupported(
            f"mesh is not a smooth height field (Chebyshev fit residual "
            f"{resid:.2e} > {tol:.2e})")
    # Derivative coefficient matrices in the same basis (du/dx = 2/spanx).
    Cx = np.zeros_like(C)
    Cx[:-1, :] = ncheb.chebder(C, axis=0) * (2.0 / spanx)
    Cy = np.zeros_like(C)
    Cy[:, :-1] = ncheb.chebder(C, axis=1) * (2.0 / spany)
    if normals is not None:
        # The surrogate's normals must reproduce the vertex normals.
        zx = ncheb.chebval2d(u, v, Cx)
        zy = ncheb.chebval2d(u, v, Cy)
        m = np.stack([-zx, -zy, np.ones_like(zx)], axis=-1)
        m /= np.linalg.norm(m, axis=-1, keepdims=True)
        n = np.asarray(normals, dtype=np.float64)
        n = n / np.linalg.norm(n, axis=-1, keepdims=True)
        dot = np.clip(np.abs(np.sum(m * n, axis=-1)), -1.0, 1.0)
        worst = float(np.arccos(dot).max())
        if worst > 5e-4:
            raise FusedUnsupported(
                f"mesh normals deviate {worst:.2e} rad from the fitted "
                "surface gradient")
    zmid = float(z.min() + z.max()) / 2.0
    # Negligible coefficients (odd terms of symmetric surfaces) are zeroed,
    # as JAX zeroes them: its kernel unrolls only the nonzero terms
    # (:func:`cheb_terms`).
    cut = 1e-13 * max(np.abs(C).max(), 1.0)
    C[np.abs(C) < cut] = 0.0
    Cx[np.abs(Cx) < cut * (2.0 / spanx)] = 0.0
    Cy[np.abs(Cy) < cut * (2.0 / spany)] = 0.0
    return {
        "deg": int(C.shape[0] - 1), "C": C, "Cx": Cx, "Cy": Cy,
        "cx": (lox + hix) / 2.0, "cy": (loy + hiy) / 2.0,
        "sx": 2.0 / spanx, "sy": 2.0 / spany,
        # Quadratic convergence from the mid-plane seed: 4 Newton steps
        # land at float32 rounding with one to spare.
        "zmid": zmid, "tol_c": 1e-5 * max(spanx, spany, 1e-3),
    }


def cheb_terms(ch: dict) -> np.ndarray:
    """The kernels' terms of a fitted surface: an (n, 2) float32 row
    (value, 256 s + 16 i + j) for each nonzero float32 coefficient of
    matrix s (0 C, 1 Cx, 2 Cy) at (i, j), i outer, j inner, s innermost, so
    that each matrix's terms keep the order of the TPU kernel's unrolled
    sums (``fused_trace.py:830-840``)."""
    if ch["deg"] > CHEB_MAX_DEG:
        raise FusedUnsupported(f"Chebyshev degree {ch['deg']} > {CHEB_MAX_DEG}")
    coef = np.stack([np.asarray(ch[k], np.float32) for k in ("C", "Cx", "Cy")], axis=-1)
    i, j, s = np.nonzero(coef)
    return np.stack([coef[i, j, s], (256 * s + 16 * i + j).astype(np.float32)], axis=1)


def cheb_dense(ch: dict) -> np.ndarray:
    """The coefficients the kernels sum (``xrt_cheb_sums``): a
    ((deg + 1)^2, 4) float32 row (C_ij, Cx_ij, Cy_ij, 0) for each (i, j), i
    outer, j inner. The zeros that :func:`cheb_terms` skips add +-0 to
    sums that start at +0, so each dense sum equals the sum of its matrix's
    terms bit for bit."""
    if ch["deg"] not in (4, 6, 8, 10, 12):
        raise FusedUnsupported(f"Chebyshev degree {ch['deg']}")
    coef = np.zeros((ch["deg"] + 1, ch["deg"] + 1, 4), np.float32)
    for k, key in enumerate(("C", "Cx", "Cy")):
        coef[..., k] = np.asarray(ch[key], np.float32)
    return coef.reshape(-1, 4)


def _optic_spec(optic) -> dict:
    """Structure of one optic: shape, bounds, apertures, interaction, image.

    Interact codes: 0 none, 1 a Bragg crystal (rocking codes 0 gaussian, 1
    step, 2 file, its resampled table in ``spec["file"]``), 2 a mirror or a
    crystal without its Bragg check (JAX ``fused_trace.py:523-526``), 3 a
    mosaic crystal (``spec["mosaic"]``; JAX ``fused_trace.py:572-586``). A
    mesh is fitted by its Chebyshev surrogate (``spec["cheb"]``). Draws per
    ray: a mosaic crystal three per layer; a crystal's, one in mc mode and
    none in weight mode (JAX ``fused_trace.py:532-533``), are the run's
    mode's, counted by :func:`pack_params`."""
    from xicsrt_tpu_torch.optics.interactions import (
        InteractCrystal, InteractMirror, InteractMosaicCrystal, InteractNone,
    )
    from xicsrt_tpu_torch.optics.mesh_shapes import ShapeMesh
    from xicsrt_tpu_torch.optics.shapes import (
        ShapeCylinder, ShapePlane, ShapeSphere, ShapeTorus,
    )

    p = optic.param
    spec = {"name": optic.name, "n_draws": 0, "apertures": [], "image": None}
    if isinstance(optic, ShapePlane):
        spec["shape"] = _SHAPES["plane"]
    elif isinstance(optic, ShapeSphere):
        spec["shape"] = _SHAPES["sphere"]
        spec["convex"] = bool(p.get("convex", False))
    elif isinstance(optic, ShapeCylinder):
        spec["shape"] = _SHAPES["cylinder"]
        spec["convex"] = bool(p.get("convex", False))
    elif isinstance(optic, ShapeTorus):
        spec["shape"] = _SHAPES["torus"]
        spec["major_adjust"] = float(p["major_adjust"])
        spec["center_sign"] = float(p["center_sign"])
    elif isinstance(optic, ShapeMesh):
        spec["shape"] = _SHAPES["cheb"]
        spec["cheb"] = _fit_cheb_surface(optic)
    else:
        raise FusedUnsupported(f"shape of {type(optic).__name__}")

    spec["half"] = [float(p[k]) / 2.0 if p.get(k) else 0.0
                    for k in ("xsize", "ysize", "zsize")]
    spec["checks"] = 0
    if p.get("check_size", True):
        spec["checks"] = sum(1 << i for i, k in enumerate(("xsize", "ysize", "zsize"))
                             if p.get(k))
    if p.get("check_aperture", True):
        for ap in optic.aperture_spec:
            if ap["shape"] not in _APERTURE_SHAPES:
                raise FusedUnsupported(f"aperture shape {ap['shape']}")
            size = [float(s) for s in ap.get("size", ())] + [0.0, 0.0]
            if ap["shape"] == "circle":
                params = (size[0] * size[0], 0.0)
            elif ap["shape"] == "square":
                params = (size[0] / 2.0, 0.0)
            elif ap["shape"] == "rectangle":
                params = (size[0] / 2.0, size[1] / 2.0)
            elif ap["shape"] == "ellipse":
                params = (size[0], size[1])
            else:
                params = (0.0, 0.0)
            spec["apertures"].append({
                "shape": _APERTURE_SHAPES[ap["shape"]],
                "logic": _LOGIC[ap["logic"]],
                "floats": (float(ap["origin"][0]), float(ap["origin"][1])) + params,
            })

    if isinstance(optic, InteractCrystal) and p.get("check_bragg", True):
        spec["interact"] = _INTERACT["crystal"]
        if p["rocking_type"] not in _ROCKING:
            raise FusedUnsupported(f"rocking_type {p['rocking_type']}")
        spec["rocking"] = _ROCKING[p["rocking_type"]]
        if p["rocking_type"] == "file":
            spec["file"] = _file_table(optic)
        if isinstance(optic, InteractMosaicCrystal):
            spec["interact"] = _INTERACT["mosaic"]
            depth = int(p["mosaic_depth"])
            spread = float(p["mosaic_spread"])
            cutoff = p.get("mosaic_cutoff")
            spec["mosaic"] = {
                "depth": depth,
                "sigma_n": math.sin(spread / 2.0 / math.sqrt(2.0 * math.log(2.0))),
                "cut": (-1.0 if cutoff is None else
                        math.sqrt(-math.log(float(cutoff)) * 2.0) * spread * _SIGMA_PER_FWHM),
            }
            spec["n_draws"] = 3 * depth
    elif isinstance(optic, InteractMirror):  # a crystal without its check too
        spec["interact"] = _INTERACT["mirror"]
    elif isinstance(optic, InteractNone):
        spec["interact"] = _INTERACT["none"]
    else:
        raise FusedUnsupported(f"interaction of {type(optic).__name__}")

    if optic.enable_image:
        nx, ny = optic.image_shape
        spec["image"] = {"nx": int(nx), "ny": int(ny),
                         "ps": float(optic.pixel_size)}
    return spec


# ---------------------------------------------------------------------------
# Run-time packing of the geometry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedParams:
    """Packed kernel parameters: ``fp`` float32 and ``ip`` int32 buffers on
    one device, plus the sizes the host needs to allocate the outputs.
    ``source_kind``: 0 generic, 1 plasma of bundle tables, 2 plasma of one
    bundle per ray, 3 rays from memory (K3); ``shape_mask``: bit s set where
    the chain holds an optic of shape code s; ``full_source``: the generic
    source needs the kernels' whole sampler, not their point-source cut;
    ``aux``: float32 per-optic data too large for ``fp`` (file rocking
    tables, Chebyshev terms), read by the kernels from global memory, never
    empty; ``ip_host``: ``ip`` as packed, on the host, where the build of
    K1 and K3 (:attr:`stages`) is read from the header the kernels read."""

    fp: torch.Tensor
    ip: torch.Tensor
    n_optics: int
    img_total: int
    n_draws: int
    aux: torch.Tensor
    ip_host: np.ndarray
    source_kind: int = 0
    shape_mask: int = 0
    full_source: bool = False

    def __post_init__(self):
        if tuple(self.ip.shape) != self.ip_host.shape:
            raise ValueError("FusedParams: ip and ip_host differ in shape")

    @property
    def weight(self) -> bool:
        """Weight mode (header int 16)."""
        return bool(self.ip_host[H_WEIGHT])

    @property
    def bilinear(self) -> bool:
        """Bilinear images (header int 17)."""
        return bool(self.ip_host[H_BILINEAR])

    @property
    def interact_mask(self) -> int:
        """Bit c set where the chain holds an optic of interact code c."""
        codes = self.ip_host[HDR_I + 2: HDR_I + self.n_optics * OPT_I: OPT_I]
        return sum({1 << int(c) for c in codes})

    @property
    def cheb(self) -> bool:
        """The chain holds a mesh surrogate, so K1 and K3 take their build
        with the Chebyshev stage."""
        return bool(self.shape_mask >> _SHAPES["cheb"] & 1)

    @property
    def shapes(self) -> int:
        """The chain's curved shapes, the set K1 compiles them by: 1 a
        torus, 2 a cylinder (``XRT_SHAPES_*``, ``csrc/trace_chain.cuh``).
        K1's point-source builds without the Chebyshev and mosaic stages
        compile no torus: for a chain with none, the plane and the sphere
        alone (the flagship's), or those and the cylinder
        (``xrt_fused_trace_build`` says which build the launcher picks)."""
        return (self.shape_mask >> _SHAPES["torus"] & 1
                | (self.shape_mask >> _SHAPES["cylinder"] & 1) << 1)

    def _images(self) -> list:
        """(first pixel, pixels, thinned) of each imaging element in chain
        order; thinned: a Bragg or mosaic crystal at or before it keeps a
        few of its rays (the flagship's 1.3 %)."""
        out, thinned = [], False
        for e in range(self.n_optics):
            oi = self.ip_host[HDR_I + e * OPT_I: HDR_I + (e + 1) * OPT_I]
            thinned = thinned or oi[2] in (_INTERACT["crystal"], _INTERACT["mosaic"])
            if oi[7] >= 0:
                out.append((int(oi[7]), int(oi[8] * oi[9]), thinned))
        return out

    @property
    def dense_images(self) -> bool:
        """An mc run with nearest images and no mosaic whose rays reach an
        image that no Bragg or mosaic crystal at or before it thins (the
        mirror chains): K1 takes, for a point source's chain of planes and
        spheres, its build that stages a window of the images
        (``fused_trace_dense_kernel``), not K1a's."""
        return self.stages == 0 and any(not t for _, _, t in self._images())

    @property
    def stage_window(self) -> tuple:
        """The pixels [lo, hi) that K1's window builds stage in shared memory
        as integer counts where the whole image does not fit beside their
        blocks: the last image no Bragg or mosaic crystal thins, else the
        last image, where a spectrometer's optics focus its rays onto a few
        pixels; (0, 0) without an image."""
        images = self._images()
        dense = [(lo, n) for lo, n, thinned in images if not thinned]
        lo, n = (dense or [(lo, n) for lo, n, _ in images] or [(0, 0)])[-1]
        return lo, lo + n

    @property
    def stages(self) -> int:
        """The build of K1 and K3 the run takes: 2 with the mosaic stage
        (and weight mode and bilinear images) for a chain with a mosaic
        crystal, 1 with weight mode and bilinear images for a run that
        weighs its rays or splats its images, else 0."""
        if self.interact_mask >> _INTERACT["mosaic"] & 1:
            return 2
        return int(self.weight or self.bilinear)

    @property
    def plasma(self) -> bool:
        """The rays take their bundles from per-iteration tables (K1f)."""
        return self.source_kind == 1


def _vec(t) -> np.ndarray:
    return np.asarray(t.detach().cpu(), dtype=np.float64)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-300)


def _pack_generic_source(src: dict, sp: dict, fp: np.ndarray) -> None:
    """fp[0:49] of a generic source: origin, the constant emission basis
    (rows o2, o1, axis; JAX ``fused_trace.py:250-262``), the cone's
    constants, the source basis rows, the box sizes (sigmas of a gaussian
    box), the Focused target and basis hint x + z, the wavelength's three
    constants (centre or lower edge; band width or Doppler sigma; natural
    gamma), the bulk velocity and 1/c."""
    basis = _vec(sp["frame"].basis)
    axis = _unit(_vec(sp["direction"])) if src["directed"] else basis[2]
    o1 = _unit(np.cross(axis, basis[0]) + np.cross(axis, basis[2]))
    o2 = _unit(np.cross(axis, o1))
    fp[0:3] = _vec(sp["frame"].origin)
    fp[3:12] = np.stack([o2, o1, axis]).reshape(-1)
    _, dist_consts = src["dist"]
    fp[S_CONE:S_CONE + len(dist_consts)] = dist_consts
    fp[S_BASIS:S_BASIS + 9] = basis.reshape(-1)
    fp[S_SIZES:S_SIZES + 3] = src["sizes"]
    if src["focused"]:
        fp[S_TARGET:S_TARGET + 3] = _vec(sp["target"])
    fp[S_HINT:S_HINT + 3] = basis[0] + basis[2]
    kind, consts = src["wave"]
    fp[S_WAVE:S_WAVE + 3] = consts
    if kind != 1:  # the line centre of the run's params
        fp[S_WAVE] = float(_vec(sp["wavelength"]))
    fp[S_VELOCITY:S_VELOCITY + 3] = _vec(sp["velocity"])
    fp[S_CINV] = 1.0 / _C_LIGHT


def _pack_filters(names: list, params: dict, fp: np.ndarray, base: int) -> None:
    """The sightline filters from ``base``: origin, unit z axis, radius^2."""
    for k, name in enumerate(names):
        fl = params["filters"][name]
        f = fp[base + k * FILT_F: base + (k + 1) * FILT_F]
        f[0:3] = _vec(fl["frame"].origin)
        f[3:6] = _vec(fl["frame"].basis)[2]
        f[6] = float(_vec(fl["radius"])) ** 2


def _pack_plasma_source(src: dict, sp: dict, fp: np.ndarray) -> None:
    """fp[0:24] of a plasma: the source basis rows (voxel offsets), the
    target, the basis hint x + z of the per-ray cone basis, the line centre,
    the Doppler and natural widths, the voxel edge and 1/c."""
    basis = _vec(sp["frame"].basis)
    fp[0:9] = basis.reshape(-1)
    fp[9:12] = _vec(sp["target"])
    fp[12:15] = basis[0] + basis[2]
    fp[15] = src["wavelength"]
    fp[16] = src["sigma_conv"]
    fp[17] = src["gamma"]
    fp[18] = src["voxel"]
    fp[19] = 1.0 / _C_LIGHT


def _pack_ray_plasma_source(src: dict, sp: dict, fp: np.ndarray) -> None:
    """fp[0:31] of a plasma sampled one bundle per ray (source kind 2, the
    gradient kernels' ``ops/fused_grad._grad_plasma_spec``): the K1
    plasma's first 20 floats, then the origin, the box sizes,
    1 - cos(spread), the bulk velocity and the initial weight per unit
    emissivity."""
    _pack_plasma_source(src, sp, fp)
    fp[20:23] = _vec(sp["frame"].origin)
    fp[23:26] = src["sizes"]
    fp[26] = src["omc"]
    fp[27:30] = src["velocity"]
    fp[30] = src["w0_per_E"]


def head_bytes(n_fp: int, n_ip: int) -> int:
    """Bytes of the trace kernels' head (``xrt_head_floats``): MAX_OPTICS + 1
    per-element counters, then n_ip ints and n_fp floats, each rounded up
    to 16 bytes."""
    return 4 * (MAX_OPTICS + 1 + -(-n_ip // 4) * 4 + -(-n_fp // 4) * 4)


def pack_params(src: dict, optics: list, params: dict, device, weight: bool = False,
                bilinear: bool = False) -> FusedParams:
    """Pack the structure specs and the run's ``params`` into the kernel's
    buffers. Derived constants are computed in float64 from the parameter
    values and rounded once to float32. ``weight``, ``bilinear``: the run's
    interact and image modes."""
    n_opt = len(optics)
    n_ap = sum(len(o["apertures"]) for o in optics)
    filters = src.get("filters", [])
    if n_opt > MAX_OPTICS:
        raise FusedUnsupported(f"more than {MAX_OPTICS} optics")
    flt_base = SRC_F + n_opt * OPT_F + n_ap * AP_F
    fp = np.zeros(flt_base + len(filters) * FILT_F, np.float64)
    ip = np.zeros(HDR_I + n_opt * OPT_I + n_ap * AP_I, np.int32)
    if head_bytes(fp.size, ip.size) > HEAD_MAX_BYTES:
        raise FusedUnsupported(f"{n_ap} apertures and {len(filters)} filters: packed "
                               f"buffers of {head_bytes(fp.size, ip.size)} bytes pass a "
                               f"block's shared memory")

    kind = src["kind"]
    wavelength = None  # per ray unless a generic source holds it constant
    if kind == 0:
        sp = params["sources"][src["name"]]
        _pack_generic_source(src, sp, fp)
        _pack_filters(filters, params, fp, flt_base)
        if not src["per_ray_wl"]:
            wavelength = float(_vec(sp["wavelength"]))
    elif kind == 1:
        _pack_plasma_source(src, params["sources"][src["name"]], fp)
    elif kind == 2:
        _pack_ray_plasma_source(src, params["sources"][src["name"]], fp)

    img_total = 0
    ap_index = 0
    aux = [np.zeros(1, np.float32)]  # never empty, so its pointer is valid
    n_aux = 1
    ap_f = SRC_F + n_opt * OPT_F
    ap_i = HDR_I + n_opt * OPT_I
    for e, o in enumerate(optics):
        f = fp[SRC_F + e * OPT_F: SRC_F + (e + 1) * OPT_F]
        i = ip[HDR_I + e * OPT_I: HDR_I + (e + 1) * OPT_I]
        op = params["optics"][o["name"]]
        origin = _vec(op["frame"].origin)
        ob = _vec(op["frame"].basis)
        f[0:3] = origin
        f[3:12] = ob.reshape(-1)
        i[0] = o["shape"]
        if o["shape"] in (_SHAPES["sphere"], _SHAPES["cylinder"]):
            radius = float(_vec(op["radius"]))
            sign = -1.0 if o["convex"] else 1.0
            f[12:15] = origin + sign * radius * ob[2]
            f[15] = radius * radius
            i[1] = int(o["convex"])
        elif o["shape"] == _SHAPES["torus"]:
            # torus_local_quadratic_t (fused_trace.py:634-639, 699).
            radius_major = float(_vec(op["radius_major"]))
            r_min = float(_vec(op["radius_minor"]))
            r_maj = radius_major + o["major_adjust"] * r_min
            f[12:15] = origin + o["center_sign"] * radius_major * ob[2]
            f[15] = r_maj
            f[26] = r_min * r_min
            f[27] = 1e-5 * max(1.0, r_maj)
            f[O_MAJOR_ADJUST] = o["major_adjust"]
            f[O_CENTER_SIGN] = o["center_sign"]
        elif o["shape"] == _SHAPES["cheb"]:
            ch = o["cheb"]
            f[12:16] = (ch["cx"], ch["cy"], ch["sx"], ch["sy"])
            f[26] = ch["zmid"]
            f[27] = ch["tol_c"]
            terms, dense = cheb_terms(ch), cheb_dense(ch)
            pad = n_aux % 2  # the terms are float2 rows
            aux.append(np.zeros(pad, np.float32))
            n_aux += pad
            i[OI_CHEB], i[OI_DEG], i[OI_TERMS] = n_aux, ch["deg"], len(terms)
            aux.append(terms.reshape(-1))
            n_aux += terms.size
            pad = -n_aux % 4  # the kernels read the dense rows as float4
            aux.append(np.zeros(pad, np.float32))
            n_aux += pad
            i[OI_DENSE] = n_aux
            aux.append(dense.reshape(-1))
            n_aux += dense.size
        f[16:19] = o["half"]
        i[4] = o["checks"]
        i[2] = o["interact"]
        if o["interact"] in (_INTERACT["crystal"], _INTERACT["mosaic"]):
            spacing = float(_vec(op["crystal_spacing"]))
            f[19] = float(_vec(op["reflectivity"]))
            if o["rocking"] == _ROCKING["file"]:
                tab = o["file"]
                f[O_LO], f[O_INV_STEP] = tab["lo"], tab["inv_step"]
                i[OI_TABLE], i[OI_K] = n_aux, tab["K"]
                aux.append(tab["table"])
                n_aux += tab["K"]
            else:
                fwhm = float(_vec(op["rocking_fwhm"]))
                f[20] = fwhm * _SIGMA_PER_FWHM if o["rocking"] == 0 else fwhm / 2.0
            f[28] = 1.0 / (2.0 * spacing)
            if wavelength is not None:
                sin_b = wavelength / (2.0 * spacing)
                if not (0.0 < sin_b < 1.0):
                    raise FusedUnsupported("wavelength outside Bragg range")
                f[21] = sin_b
                f[22] = math.sqrt(1.0 - sin_b * sin_b)
            i[3] = o["rocking"]
        if o["interact"] == _INTERACT["mosaic"]:
            mz = o["mosaic"]
            f[O_MOSAIC_SIGMA], f[O_MOSAIC_CUT] = mz["sigma_n"], mz["cut"]
            i[OI_DEPTH] = mz["depth"]
        i[5] = len(o["apertures"])
        i[6] = ap_index
        for ap in o["apertures"]:
            fp[ap_f + ap_index * AP_F: ap_f + (ap_index + 1) * AP_F] = ap["floats"]
            ip[ap_i + ap_index * AP_I] = ap["shape"]
            ip[ap_i + ap_index * AP_I + 1] = ap["logic"]
            ap_index += 1
        im = o["image"]
        i[7] = -1
        if im is not None:
            f[23] = 1.0 / im["ps"]
            f[24] = (im["nx"] - 1) / 2.0
            f[25] = (im["ny"] - 1) / 2.0
            i[7] = img_total
            i[8] = im["nx"]
            i[9] = im["ny"]
            img_total += im["nx"] * im["ny"]

    # A crystal draws its acceptance in mc mode and weighs in weight mode.
    n_draws = src["n_draws"] + sum(int(not weight) if o["interact"] == _INTERACT["crystal"]
                                   else o["n_draws"] for o in optics)
    plasma = kind in (1, 2)
    ip[0:8] = (n_opt, n_ap, src["dist"][0] if kind == 0 else 0, n_draws, img_total,
               kind, int(plasma and src["voxel"] > 0.0),
               int(plasma and src["gamma"] > 0.0))
    if kind == 0:
        wave = src["wave"][0]
        ip[8:16] = (len(filters), src["spatial"], int(src["focused"]), wave,
                    int(wave == 2 and src["wave"][1][1] > 0.0),
                    int(wave == 2 and src["wave"][1][2] > 0.0),
                    int(src["velocity"]), int(src["per_ray_wl"]))
    else:
        ip[H_PER_RAY_WL] = 1
    ip[H_WEIGHT], ip[H_BILINEAR] = int(weight), int(bilinear)
    return FusedParams(
        fp=torch.as_tensor(fp.astype(np.float32), device=device),
        ip=torch.as_tensor(ip, device=device),
        n_optics=n_opt, img_total=img_total, n_draws=n_draws,
        source_kind=kind,
        shape_mask=sum({1 << o["shape"] for o in optics}),
        full_source=bool(src.get("full")),
        aux=torch.as_tensor(np.concatenate(aux), device=device), ip_host=ip,
    )


# ---------------------------------------------------------------------------
# The kernel's plain twin.
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a and int64 b < 2^32,
    exact in int64 arithmetic."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((t >> 32) + (p_hi >> 16)) & _M32, t & _M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int) -> tuple:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    32-bit words: counter (c0..c3), key (k0, k1) -> four output words."""
    k0, k1 = k0 & _M32, k1 & _M32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + 0x9E3779B9) & _M32
            k1 = (k1 + 0xBB67AE85) & _M32
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(rays: torch.Tensor, n_draws: int, seed0: int,
                    seed1: int) -> list:
    """The kernel's counter-based uniforms: Philox4x32-10 with counter
    (ray lo, ray hi, draw // 4, 0) and key (seed0, seed1); draw k takes word
    k % 4, keeping its top 24 bits. ``rays``: int64 ray indices."""
    out = []
    for group in range(-(-n_draws // 4)):
        words = philox4x32_10(rays & _M32, rays >> 32,
                              torch.full_like(rays, group),
                              torch.zeros_like(rays), seed0, seed1)
        out += [(w >> 8).to(torch.float32) * (1.0 / 16777216.0) for w in words]
    return out[:n_draws]


def _inv_sqrt(x):
    return 1.0 / torch.sqrt(x)


def _div(x, scalar: float):
    """``x / scalar`` as a true division, like the kernel's: PyTorch's CUDA
    kernels multiply by the reciprocal when the divisor is a Python scalar."""
    return x / torch.tensor(scalar, dtype=x.dtype, device=x.device)


_ASIN_COEFFS = (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
                0.0889789874, -0.2145988016, 1.5707963050)


def asin_poly_plain(x):
    """The kernels' arcsin (``xrt_asin_poly``): pi/2 - acos_kernel(x), the
    TPU megakernel's polynomial acos with one Newton step
    (``xicsrt_tpu/ops/polynomials.py:53-68``)."""
    x = torch.clamp(x, -1.0, 1.0)
    ax = torch.clamp(torch.abs(x), 0.0, 1.0)
    p = torch.full_like(ax, -0.0012624911)
    for coef in _ASIN_COEFFS:
        p = p * ax + coef
    theta = p * torch.sqrt(torch.clamp_min(1.0 - ax, 0.0))
    theta = theta + (torch.cos(theta) - ax) / torch.clamp_min(torch.sin(theta), 1e-6)
    return math.pi / 2.0 - torch.where(x >= 0.0, theta, math.pi - theta)


def _xy_tail(sx, v, c):
    """The kernels' ``xrt_xy_tail``: isotropic_xy's conditional in ty and the
    unit vector, from sx and v; c = (tan ty0, its square, tan ty1, its
    square)."""
    tx = sx * _inv_sqrt(torch.clamp_min(1.0 - sx * sx, 1e-12))
    k2 = 1.0 + tx * tx
    h0 = c[0] * _inv_sqrt(k2 + c[1])
    h1 = c[2] * _inv_sqrt(k2 + c[3])
    h = h0 + v * (h1 - h0)
    ty = torch.sqrt(k2) * h * _inv_sqrt(torch.clamp_min(1.0 - h * h, 1e-12))
    w = _inv_sqrt(1.0 + tx * tx + ty * ty)
    return tx * w, ty * w, w


def aim_plain(T, H, px, py, pz, lx, ly, lz):
    """The kernels' ``xrt_aim``: the local direction in the per-ray basis of
    ``vec.orthogonal_basis`` about the unit vector from p to the target
    ``T``, with the basis hint ``H``. Returns (dx, dy, dz)."""
    nx, ny, nz = T[0] - px, T[1] - py, T[2] - pz
    inv = _inv_sqrt(torch.clamp_min(nx * nx + ny * ny + nz * nz, 1e-30))
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    hx, hy, hz = H
    o1x, o1y, o1z = ny * hz - nz * hy, nz * hx - nx * hz, nx * hy - ny * hx
    inv = _inv_sqrt(torch.clamp_min(o1x * o1x + o1y * o1y + o1z * o1z, 1e-30))
    o1x, o1y, o1z = o1x * inv, o1y * inv, o1z * inv
    o2x, o2y, o2z = ny * o1z - nz * o1y, nz * o1x - nx * o1z, nx * o1y - ny * o1x
    return (lx * o2x + ly * o1x + lz * nx, lx * o2y + ly * o1y + lz * ny,
            lx * o2z + ly * o1z + lz * nz)


def sample_source_plain(F, I, draw, full):
    """The kernels' generic sampler (``xrt_sample_source`` in
    ``csrc/trace_common.cuh``; JAX ``fused_trace.py:1538-1713``), in their
    float32 operations: box, cone, axis, wavelength, Doppler, sightlines.
    ``full(value)`` makes a tensor of the slice's shape. Returns (px, py,
    pz, dx, dy, dz, wavelength, keep), ``keep`` None without filters."""
    px, py, pz = full(F[0]), full(F[1]), full(F[2])
    wl = full(F[S_WAVE])
    if I[H_SPATIAL]:
        for k in range(3):
            size = F[S_SIZES + k]
            if size == 0.0:
                continue
            o_l = (normal_plain(draw) * size if I[H_SPATIAL] == 2
                   else (draw() - 0.5) * size)
            px = px + o_l * F[S_BASIS + 3 * k]
            py = py + o_l * F[S_BASIS + 3 * k + 1]
            pz = pz + o_l * F[S_BASIS + 3 * k + 2]
    c = F[S_CONE:S_CONE + 12]
    dist = I[2]
    if dist == _CONES["isotropic"]:
        u, v = draw(), draw()
        lz = c[0] + u * c[1]
        rho = torch.sqrt(torch.clamp_min(1.0 - lz * lz, 0.0))
        phi = v * _TWO_PI
        lx, ly = rho * torch.cos(phi), rho * torch.sin(phi)
    elif dist == _CONES["isotropic_xy"]:
        u, v = draw(), draw()
        sx = _div(torch.sin((c[0] + u * c[1]) * 0.5), c[2])
        lx, ly, lz = _xy_tail(sx, v, c[3:7])
    elif dist == _CONES["isotropic_xy_asym"]:
        u, v = draw(), draw()
        target = c[4] + u * c[5]
        sx = c[0] + u * c[1]
        for _ in range(12):
            a1, a0 = sx * c[3], sx * c[2]
            gm = asin_poly_plain(a1) - asin_poly_plain(a0)
            dg = (c[3] * _inv_sqrt(torch.clamp_min(1.0 - a1 * a1, 1e-12))
                  - c[2] * _inv_sqrt(torch.clamp_min(1.0 - a0 * a0, 1e-12)))
            sx = torch.clamp(torch.clamp_min(sx - (gm - target) / torch.clamp_min(dg, 1e-12),
                                             c[0]), max=c[10])
        lx, ly, lz = _xy_tail(sx, v, c[6:10])
    elif dist == _CONES["flat"]:
        r = c[0] * torch.sqrt(draw())
        phi = draw() * _TWO_PI
        w = _inv_sqrt(1.0 + r * r)
        lx, ly, lz = torch.cos(phi) * r * w, torch.sin(phi) * r * w, w
    elif dist == _CONES["flat_xy"]:
        x = c[0] + draw() * c[1]
        y = c[2] + draw() * c[3]
        w = _inv_sqrt(1.0 + x * x + y * y)
        lx, ly, lz = x * w, y * w, w
    else:  # flat gaussian
        x = c[0] * normal_plain(draw)
        y = c[0] * normal_plain(draw)
        w = _inv_sqrt(1.0 + x * x + y * y)
        lx, ly, lz = x * w, y * w, w
    if I[H_FOCUSED]:
        dx, dy, dz = aim_plain(F[S_TARGET:S_TARGET + 3], F[S_HINT:S_HINT + 3],
                               px, py, pz, lx, ly, lz)
    else:
        dx = lx * F[3] + ly * F[6] + lz * F[9]
        dy = lx * F[4] + ly * F[7] + lz * F[10]
        dz = lx * F[5] + ly * F[8] + lz * F[11]
    if I[H_WAVE] == 1:
        wl = F[S_WAVE] + draw() * F[S_WAVE + 1]
    elif I[H_WAVE] == 2:
        if I[H_GAUSS]:
            wl = wl + F[S_WAVE + 1] * normal_plain(draw)
        if I[H_CAUCHY]:
            wl = wl + cauchy_plain(draw, F[S_WAVE + 2])
    if I[H_VELOCITY]:
        vx, vy, vz = F[S_VELOCITY:S_VELOCITY + 3]
        wl = wl * (1.0 - (vx * dx + vy * dy + vz * dz) * F[S_CINV])
    keep = None
    base = SRC_F + I[0] * OPT_F + I[1] * AP_F
    for k in range(I[H_FILTERS]):
        f = F[base + k * FILT_F: base + (k + 1) * FILT_F]
        lx_, ly_, lz_ = f[0] - px, f[1] - py, f[2] - pz
        proj = lx_ * f[3] + ly_ * f[4] + lz_ * f[5]
        ex, ey, ez = lx_ - proj * f[3], ly_ - proj * f[4], lz_ - proj * f[5]
        inside = ex * ex + ey * ey + ez * ez <= f[6]
        keep = inside if keep is None else keep & inside
    return px, py, pz, dx, dy, dz, wl, keep


def plasma_cone_plain(F, omc, draw, px, py, pz):
    """The kernels' plasma cone (``xrt_plasma_cone``): an isotropic cone of
    ``omc = 1 - cos(half-angle)`` about the unit direction from each ray's
    origin to the target F[9:12], in the per-ray basis of
    ``vec.orthogonal_basis`` with the hint F[12:15]. Draws u, v; returns
    the unit direction (dx, dy, dz)."""
    u, v = draw(), draw()
    lz = 1.0 - u * omc
    rho = torch.sqrt(torch.clamp_min(1.0 - lz * lz, 0.0))
    phi = v * _TWO_PI
    return aim_plain(F[9:12], F[12:15], px, py, pz, rho * torch.cos(phi),
                     rho * torch.sin(phi), lz)


def normal_plain(draw):
    """The kernels' standard normal (``xrt_normal``): sqrt(2) erfinv(2u - 1)
    of a uniform clipped to [1e-7, 1 - 1e-7]."""
    un = torch.clamp(draw(), 1e-7, 1.0 - 1e-7)
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * un - 1.0)


def cauchy_plain(draw, gamma: float):
    """The natural (Cauchy) part of an exact Voigt line (``xrt_cauchy``)."""
    uc = torch.clamp(draw(), 1e-7, 1.0 - 1e-7)
    return gamma * torch.tan(math.pi * (uc - 0.5))


def sample_plasma_plain(F, I, attrs, draw):
    """The kernel's plasma sampler (``xrt_sample_plasma``, JAX
    ``fused_trace.py:1484-1537``): from each ray's bundle row ``attrs``
    [n, 8] and its draws, the origin, unit direction and wavelength.
    Returns (px, py, pz, dx, dy, dz, wl)."""
    px, py, pz = attrs[:, 0], attrs[:, 1], attrs[:, 2]
    theta, temp = attrs[:, 3], attrs[:, 4]
    vxb, vyb, vzb = attrs[:, 5], attrs[:, 6], attrs[:, 7]
    if I[6]:  # voxel offset in the source frame
        h = F[18]
        vx = (draw() - 0.5) * h
        vy = (draw() - 0.5) * h
        vz = (draw() - 0.5) * h
        px = px + vx * F[0] + vy * F[3] + vz * F[6]
        py = py + vx * F[1] + vy * F[4] + vz * F[7]
        pz = pz + vx * F[2] + vy * F[5] + vz * F[8]
    dx, dy, dz = plasma_cone_plain(F, 1.0 - torch.cos(theta), draw, px, py, pz)
    # Exact Voigt: a normal scaled by the bundle's Doppler width, plus a
    # Cauchy; then the bulk Doppler shift.
    gauss = normal_plain(draw)
    wl = F[15] + F[16] * torch.sqrt(torch.clamp_min(temp, 0.0)) * gauss
    if I[7]:
        wl = wl + cauchy_plain(draw, F[17])
    wl = wl * (1.0 - (vxb * dx + vyb * dy + vzb * dz) * F[19])
    return px, py, pz, dx, dy, dz, wl


def torus_root_plain(olx, oly, olz, dlx, dly, dlz, z0, r_maj, rmin2, full):
    """The kernels' torus root (``xrt_torus_root``; JAX
    ``torus_local_quadratic_t``, ``fused_trace.py:616-702``) in
    torus-centred local coordinates: four local-quadratic Newton steps on
    G(t) = (|xz|(t) - r_maj)^2 + y(t)^2 - rmin2 from the tangent-plane hit
    -z0 / dlz. Returns (t, the last step)."""
    t = -z0 / torch.where(torch.abs(dlz) > 1e-9, dlz, full(1e-9))
    step = full(0.0)
    for _ in range(4):
        X, Y, Z = olx + t * dlx, oly + t * dly, olz + t * dlz
        s2 = torch.clamp_min(X * X + Z * Z, 1e-30)
        inv_rho = _inv_sqrt(s2)
        rr = s2 * inv_rho - r_maj
        G = rr * rr + Y * Y - rmin2
        rhop = (X * dlx + Z * dlz) * inv_rho
        Gp = 2.0 * rr * rhop + 2.0 * Y * dly
        rhopp = ((dlx * dlx + dlz * dlz) - rhop * rhop) * inv_rho
        Gpp = 2.0 * (rhop * rhop + rr * rhopp) + 2.0 * dly * dly
        disc = Gp * Gp - 2.0 * Gpp * G
        sgn = torch.where(Gp >= 0.0, full(1.0), full(-1.0))
        dq = Gp + sgn * torch.sqrt(torch.clamp_min(disc, 0.0))
        dq = torch.where(torch.abs(dq) > 1e-12, dq, sgn * 1e-12)
        gp_safe = torch.where(torch.abs(Gp) > 1e-12, Gp, sgn * 1e-12)
        step = G / torch.where(disc >= 0.0, 0.5 * dq, gp_safe)
        t = t - step
    return t, step


def torus_hit_plain(o, px, py, pz, dx, dy, dz, alive, full):
    """The kernel's torus stage (``xrt_torus_hit``) of the optic block
    ``o``. Returns (t, hit), t zero where the ray misses."""
    rx, ry, rz = px - o[12], py - o[13], pz - o[14]
    olx = rx * o[3] + ry * o[4] + rz * o[5]
    oly = rx * o[6] + ry * o[7] + rz * o[8]
    olz = rx * o[9] + ry * o[10] + rz * o[11]
    dlx = dx * o[3] + dy * o[4] + dz * o[5]
    dly = dx * o[6] + dy * o[7] + dz * o[8]
    dlz = dx * o[9] + dy * o[10] + dz * o[11]
    z0 = (px - o[0]) * o[9] + (py - o[1]) * o[10] + (pz - o[2]) * o[11]
    t, step = torus_root_plain(olx, oly, olz, dlx, dly, dlz, z0, o[15], o[26], full)
    hit = alive & (torch.abs(step) < o[27]) & (t > 1e-6)
    return torch.where(hit, t, full(0.0)), hit


def cylinder_hit_plain(C, ax, r2, convex: bool, p, d, full):
    """The kernels' cylinder (``xrt_cylinder_hit``; JAX
    ``fused_trace.py:784-812``): axis ``ax`` through ``C``, squared radius
    ``r2``, the stable quadratic of the ray's components across the axis,
    the near root (convex) or the far one. Returns a dict of the
    intermediates, ``disc`` (the ray hits where it is >= 0) and ``t``."""
    (px, py, pz), (dx, dy, dz) = p, d
    h = {"dpx": px - C[0], "dpy": py - C[1], "dpz": pz - C[2]}
    h["d_ax"] = dx * ax[0] + dy * ax[1] + dz * ax[2]
    h["p_ax"] = h["dpx"] * ax[0] + h["dpy"] * ax[1] + h["dpz"] * ax[2]
    h["A1x"], h["A1y"], h["A1z"] = (dx - h["d_ax"] * ax[0], dy - h["d_ax"] * ax[1],
                                    dz - h["d_ax"] * ax[2])
    h["B1x"], h["B1y"], h["B1z"] = (h["dpx"] - h["p_ax"] * ax[0],
                                    h["dpy"] - h["p_ax"] * ax[1],
                                    h["dpz"] - h["p_ax"] * ax[2])
    h["qa"] = h["A1x"] * h["A1x"] + h["A1y"] * h["A1y"] + h["A1z"] * h["A1z"]
    h["qb"] = 2.0 * (h["A1x"] * h["B1x"] + h["A1y"] * h["B1y"] + h["A1z"] * h["B1z"])
    qc = h["B1x"] * h["B1x"] + h["B1y"] * h["B1y"] + h["B1z"] * h["B1z"] - r2
    h["disc"] = h["qb"] * h["qb"] - 4.0 * h["qa"] * qc
    sq = torch.sqrt(torch.clamp_min(h["disc"], 0.0))
    sgn = torch.where(h["qb"] >= 0.0, full(1.0), full(-1.0))
    qq = -0.5 * (h["qb"] + sgn * sq)
    t0 = qq / torch.where(torch.abs(h["qa"]) > 1e-30, h["qa"], full(1e-30))
    big = torch.abs(qq) > 1e-30
    t1 = torch.where(big, qc / torch.where(big, qq, full(1e-30)), t0)
    h["t"] = torch.minimum(t0, t1) if convex else torch.maximum(t0, t1)
    return h


def _fclip(x, bound: float, full):
    """Clip to [-bound, bound] as fminf(fmaxf(x, -bound), bound) does: a
    NaN goes to -bound."""
    return torch.fmin(torch.fmax(x, full(-bound)), full(bound))


def cheb_hit_plain(o, oi, A, px, py, pz, dx, dy, dz, alive, full):
    """The kernels' Chebyshev surface (``xrt_cheb_hit``; JAX
    ``fused_trace.py:813-887``) of the optic block ``o`` in its local frame:
    4 Newton steps on F(t) = Olz + t Dlz - z(x(t), y(t)) from the mid-plane
    o[26], the recurrence on u, v clipped to 1.25, the sums over the packed
    dense coefficients, i outer, j inner (:func:`cheb_dense`; ``A``: the aux
    buffer as floats).
    Returns (t, hit, normal); t is zero where the ray misses, the hit needs
    the last step below o[27] and |u|, |v| <= 1 unclipped, the normal is
    the last gradient's, in the global frame."""
    rx, ry, rz = px - o[0], py - o[1], pz - o[2]
    Olx = rx * o[3] + ry * o[4] + rz * o[5]
    Oly = rx * o[6] + ry * o[7] + rz * o[8]
    Olz = rx * o[9] + ry * o[10] + rz * o[11]
    Dlx = dx * o[3] + dy * o[4] + dz * o[5]
    Dly = dx * o[6] + dy * o[7] + dz * o[8]
    Dlz = dx * o[9] + dy * o[10] + dz * o[11]
    deg, base = oi[OI_DEG], oi[OI_DENSE]
    safe_dz = torch.where(torch.abs(Dlz) > 1e-9, Dlz, full(1e-9))
    t = (o[26] - Olz) / safe_dz
    for _ in range(4):
        u = (Olx + t * Dlx - o[12]) * o[14]
        v = (Oly + t * Dly - o[13]) * o[15]
        uc, vc = _fclip(u, 1.25, full), _fclip(v, 1.25, full)
        Ti, Tj = [torch.ones_like(uc), uc], [torch.ones_like(vc), vc]
        for _k in range(deg - 1):
            Ti.append(2.0 * uc * Ti[-1] - Ti[-2])
            Tj.append(2.0 * vc * Tj[-1] - Tj[-2])
        zs, zxs, zys = full(0.0), full(0.0), full(0.0)
        for i in range(deg + 1):
            for j in range(deg + 1):
                c = base + 4 * ((deg + 1) * i + j)
                zs = zs + A[c] * Ti[i] * Tj[j]
                zxs = zxs + A[c + 1] * Ti[i] * Tj[j]
                zys = zys + A[c + 2] * Ti[i] * Tj[j]
        F = Olz + t * Dlz - zs
        Fp = Dlz - zxs * Dlx - zys * Dly
        Fp = torch.where(torch.abs(Fp) > 1e-9, Fp, full(1e-9))
        step = F / Fp
        t = t - step
    hit = (alive & (torch.abs(step) < o[27]) & (t > 1e-6)
           & (torch.abs(u) <= 1.0) & (torch.abs(v) <= 1.0))
    inv = _inv_sqrt(zxs * zxs + zys * zys + 1.0)
    nlx, nly, nlz = -zxs * inv, -zys * inv, inv
    normal = (nlx * o[3] + nly * o[6] + nlz * o[9], nlx * o[4] + nly * o[7] + nlz * o[10],
              nlx * o[5] + nly * o[8] + nlz * o[11])
    return torch.where(hit, t, full(0.0)), hit, normal


def file_value_plain(T, lo: float, inv_step: float, delta):
    """The kernels' file rocking curve (``xrt_file_value``): the resampled
    table ``T`` (K float32 values) at ``delta``, the two nonzero tent
    weights of the TPU kernels' matvec (``fused_trace.py:738-754``) in their
    order, as a load at k = floor(f) and min(k + 1, K - 1). Returns (value,
    in range, f, k); f is the fractional index clipped to [0, K - 1] (a NaN
    to 0, as fmaxf does), in range is taken before the clip."""
    K = T.shape[0]
    fidx = (delta - lo) * inv_step
    inr = (fidx >= 0.0) & (fidx <= K - 1)
    f = torch.fmin(torch.fmax(fidx, torch.zeros_like(fidx)), torch.full_like(fidx, K - 1.0))
    k = torch.floor(f).detach()
    ki = k.long()
    val = T[ki] * (1.0 - (f - k)) + T[torch.clamp(ki + 1, max=K - 1)] * (1.0 - ((k + 1.0) - f))
    return val, inr, f, k


def bounds_plain(mask, o, oi, lxv, lyv, r, bz):
    """The kernels' x/y/z bounds (``xrt_bounds``) of the optic whose blocks
    are ``o``, ``oi``: local coordinates (lxv, lyv), offset ``r`` of the hit
    from the optic origin, the optic's z axis ``bz``."""
    if oi[4] & 1:
        mask = mask & (torch.abs(lxv) < o[16])
    if oi[4] & 2:
        mask = mask & (torch.abs(lyv) < o[17])
    if oi[4] & 4:
        lzv = r[0] * bz[0] + r[1] * bz[1] + r[2] * bz[2]
        mask = mask & (torch.abs(lzv) < o[18])
    return mask


def aperture_logic_plain(F, I, oi, lxv, lyv, m_in):
    """The kernels' aperture logic (``xrt_apertures``, ``ops/aperture.py``)
    for the optic whose int block is ``oi``: ``m_in`` is the bounds mask,
    the running value changes only inside it. Returns the optic's mask."""
    apf = SRC_F + I[0] * OPT_F
    api = HDR_I + I[0] * OPT_I
    m_out = m_in
    for a in range(oi[6], oi[6] + oi[5]):
        ox, oy, p0, p1 = F[apf + a * AP_F: apf + (a + 1) * AP_F]
        ap_shape, logic = I[api + a * AP_I: api + (a + 1) * AP_I]
        ax, ay = lxv - ox, lyv - oy
        if ap_shape == 0:
            test = torch.ones_like(m_in)
        elif ap_shape == 1:
            test = ax * ax + ay * ay < p0
        elif ap_shape == 2:
            test = (torch.abs(ax) < p0) & (torch.abs(ay) < p0)
        elif ap_shape == 3:
            test = (torch.abs(ax) < p0) & (torch.abs(ay) < p1)
        else:
            ex, ey = _div(ax, p0), _div(ay, p1)
            test = ex * ex + ey * ey < 1.0
        test = test & m_in
        new = (m_out & test, m_out & ~test, m_out | test, ~(m_out & test),
               ~(m_out | test), m_out ^ test, ~(m_out ^ test))[logic]
        m_out = torch.where(m_in, new, m_out)
    return m_out & m_in


def _trace_slice(F, I, aux, alive, draw, counts, image, attrs=None, tally=None,
                 record=None):
    """Trace one slice of rays exactly as K1 does; adds into ``counts``
    (int64) and the flat ``image``. ``aux``: the packed aux buffer;
    ``alive``: the rays alive at the source before its filters; ``attrs``:
    their bundle rows for a plasma source; ``tally``: see
    :func:`_trace_chain_plain`. In weight mode every ray leaves the source
    with weight 1 (JAX ``fused_trace.py:1719``). ``record(e, px, py, pz,
    dx, dy, dz, alive, wt, wl=...)`` takes each element's state, the
    source's as element 0, with the rays' wavelengths. Returns the rays
    alive after the last element."""
    shape = alive.shape

    def full(value):
        return torch.full(shape, value, dtype=torch.float32, device=alive.device)

    if attrs is None:
        px, py, pz, dx, dy, dz, wl, keep = sample_source_plain(F, I, draw, full)
        if keep is not None:
            alive = alive & keep
    else:
        px, py, pz, dx, dy, dz, wl = sample_plasma_plain(F, I, attrs, draw)
    counts[0] += alive.sum()
    wt = full(1.0) if I[H_WEIGHT] else None
    if record is not None:
        record = functools.partial(record, wl=wl)
        record(0, px, py, pz, dx, dy, dz, alive, wt)
    return _trace_chain_plain(F, I, aux, (px, py, pz, dx, dy, dz),
                              wl if I[H_PER_RAY_WL] else None, alive, draw, counts, image,
                              wt, tally, record)


def rock_prob_plain(o, oi, aux, delta, full):
    """The kernels' rocking curve (``xrt_rock_prob``) of the crystal whose
    blocks are ``o``, ``oi`` at the deviation ``delta``, times its
    reflectivity: gaussian (o[20] sigma), step (o[20] half width) or the
    resampled file table in ``aux``."""
    if oi[3] == 0:
        z = _div(delta, o[20])
        return o[19] * torch.exp(-0.5 * (z * z))
    if oi[3] == 1:
        return torch.where(torch.abs(delta) <= o[20], full(o[19]), full(0.0))
    val, inr, _, _ = file_value_plain(aux[oi[OI_TABLE]:oi[OI_TABLE] + oi[OI_K]],
                                      o[O_LO], o[O_INV_STEP], delta)
    return torch.where(inr, val * o[19], full(0.0))


def bragg_delta_plain(dx, dy, dz, nx, ny, nz, sin_b, cos_b):
    """(d.n, the Bragg deviation ``sd + sd^3 / 6``) of directions d on
    normals n (``fused_trace.py:995-1002``)."""
    dot = dx * nx + dy * ny + dz * nz
    adot = torch.abs(dot)
    cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, 0.0))
    sd = adot * cos_b - cosi * sin_b
    return dot, sd + sd * sd * sd * (1.0 / 6.0)


def mosaic_basis_plain(nx, ny, nz):
    """The crystallite basis about the normal n (the kernels' mosaic stage;
    JAX ``fused_trace.py:1030-1041``): o1 = normalize(n x (e1 + e3)) =
    normalize(ny, nz - nx, -ny), o2 = normalize(n x o1). Returns (o1, o2,
    and the two normalisers 1 / |.|, which the gradient's adjoint takes)."""
    o1x, o1y, o1z = ny, nz - nx, -ny
    inv1 = _inv_sqrt(torch.clamp_min(o1x * o1x + o1y * o1y + o1z * o1z, 1e-30))
    o1x, o1y, o1z = o1x * inv1, o1y * inv1, o1z * inv1
    o2x, o2y, o2z = ny * o1z - nz * o1y, nz * o1x - nx * o1z, nx * o1y - ny * o1x
    inv2 = _inv_sqrt(torch.clamp_min(o2x * o2x + o2y * o2y + o2z * o2z, 1e-30))
    return (o1x, o1y, o1z), (o2x * inv2, o2y * inv2, o2z * inv2), inv1, inv2


def mosaic_normal_plain(draw, sigma_n: float, o1, o2, n):
    """One layer's crystallite normal (the kernels' ``xrt_mosaic_normal``):
    gx, gy = sigma_n times two normals, wn = 1 / sqrt(1 + gx^2 + gy^2),
    nm = gx wn o2 + gy wn o1 + wn n. Returns (nm, gx wn, gy wn, wn), the
    coefficients for the gradient's adjoint."""
    gx = sigma_n * normal_plain(draw)
    gy = sigma_n * normal_plain(draw)
    wn = _inv_sqrt(1.0 + gx * gx + gy * gy)
    gxw, gyw = gx * wn, gy * wn
    nm = tuple(gxw * o2[k] + gyw * o1[k] + wn * n[k] for k in range(3))
    return nm, gxw, gyw, wn


def mosaic_plain(o, oi, aux, d, n, sin_b, cos_b, mask, wt, draw, full):
    """The kernels' mosaic stage (``xrt_mosaic``; JAX ``fused_trace.py:
    1014-1098``): the cutoff prefilter, then ``oi[OI_DEPTH]`` layers of
    three draws each. mc (``wt`` None): the first layer whose crystallite
    accepts reflects the ray; weight: every layer tests the incoming
    direction, the weight takes the survival estimator's total ``cum`` and
    the direction the last reservoir pick's reflection. Returns (direction,
    mask, weight)."""
    dx, dy, dz = d
    if o[O_MOSAIC_CUT] >= 0.0:
        _, d0 = bragg_delta_plain(dx, dy, dz, *n, sin_b, cos_b)
        mask = mask & (torch.abs(d0) < o[O_MOSAIC_CUT])
    o1, o2, _, _ = mosaic_basis_plain(*n)
    if wt is None:
        refl = torch.zeros_like(mask)
        for _ in range(oi[OI_DEPTH]):
            (nmx, nmy, nmz), _, _, _ = mosaic_normal_plain(draw, o[O_MOSAIC_SIGMA], o1, o2, n)
            dotm, delta = bragg_delta_plain(dx, dy, dz, nmx, nmy, nmz, sin_b, cos_b)
            prob = rock_prob_plain(o, oi, aux, delta, full)
            accept = mask & ~refl & (prob >= draw())
            kk = 2.0 * dotm
            dx = torch.where(accept, dx - kk * nmx, dx)
            dy = torch.where(accept, dy - kk * nmy, dy)
            dz = torch.where(accept, dz - kk * nmz, dz)
            refl = refl | accept
        return (dx, dy, dz), mask & refl, wt
    d0x, d0y, d0z = d
    surv, cum = full(1.0), full(0.0)
    for _ in range(oi[OI_DEPTH]):
        (nmx, nmy, nmz), _, _, _ = mosaic_normal_plain(draw, o[O_MOSAIC_SIGMA], o1, o2, n)
        dotm, delta = bragg_delta_plain(d0x, d0y, d0z, nmx, nmy, nmz, sin_b, cos_b)
        prob = rock_prob_plain(o, oi, aux, delta, full)
        q = prob * surv
        cum_new = cum + q
        pick = mask & (draw() * cum_new < q)
        kk = 2.0 * dotm
        dx = torch.where(pick, d0x - kk * nmx, dx)
        dy = torch.where(pick, d0y - kk * nmy, dy)
        dz = torch.where(pick, d0z - kk * nmz, dz)
        surv = surv * (1.0 - prob)
        cum = cum_new
    return (dx, dy, dz), mask, torch.where(mask, wt * cum, wt)


def _add_terms(image, idx, terms, tally):
    """Add float32 ``terms`` into ``image`` at ``idx``; with a ``tally``
    (count, magnitude), also each term's 1 and its |value| in float64."""
    image.index_put_((idx,), terms, accumulate=True)
    if tally is not None:
        tally[0].index_put_((idx,), torch.ones_like(terms, dtype=torch.float64),
                            accumulate=True)
        tally[1].index_put_((idx,), terms.double().abs(), accumulate=True)


def splat_plain(image, base: int, fx, fy, nx: int, ny: int, w, tally=None):
    """The kernels' bilinear splat (``xrt_splat``; JAX
    ``fused_trace.py:1165-1194``): the pixel coordinates clipped to [-2,
    n + 1], the tents 1 - |f - i| at the two grid neighbours, the corner
    weight (tx w) ty, each corner dropped off the grid."""
    fxc = torch.clamp(fx, -2.0, nx + 1.0)
    fyc = torch.clamp(fy, -2.0, ny + 1.0)
    x0, y0 = torch.floor(fxc), torch.floor(fyc)
    for xi in (x0, x0 + 1.0):
        wx = (1.0 - torch.abs(fxc - xi)) * w
        for yi in (y0, y0 + 1.0):
            ok = (xi >= 0) & (xi < nx) & (yi >= 0) & (yi < ny)
            idx = base + xi[ok].long() * ny + yi[ok].long()
            _add_terms(image, idx, (wx * (1.0 - torch.abs(fyc - yi)))[ok], tally)


def _trace_chain_plain(F, I, aux, ray, wl, alive, draw, counts, image, wt=None,
                       tally=None, record=None):
    """The kernels' optic chain (``xrt_trace_chain``, ``csrc/
    trace_chain.cuh``) on a slice: ``aux`` the packed aux buffer, ``ray`` =
    (px, py, pz, dx, dy, dz), ``wl`` the per-ray wavelengths or None for the
    optics' constant Bragg angles, ``wt`` the rays' weights in weight mode,
    else None. Adds into ``counts[1:]`` and ``image``, and with a ``tally``
    (two float64 images) the number of terms each pixel sums and the sum of
    their magnitudes. ``record(1 + e, px, py, pz, dx, dy, dz, alive, wt)``
    takes each element's post-element state (the kernels' record hook).
    Returns the rays alive after the last element."""
    f32 = torch.float32
    n_opt = I[0]
    px, py, pz, dx, dy, dz = ray
    A = [float(x) for x in aux.tolist()] if any(
        I[HDR_I + e * OPT_I] == _SHAPES["cheb"] for e in range(n_opt)) else None

    def full(value):
        return torch.full(alive.shape, value, dtype=f32, device=alive.device)

    for e in range(n_opt):
        o = F[SRC_F + e * OPT_F: SRC_F + (e + 1) * OPT_F]
        oi = I[HDR_I + e * OPT_I: HDR_I + (e + 1) * OPT_I]
        if oi[0] == _SHAPES["plane"]:
            denom = dx * o[9] + dy * o[10] + dz * o[11]
            numer = (o[0] - px) * o[9] + (o[1] - py) * o[10] + (o[2] - pz) * o[11]
            nz = torch.abs(denom) > 1e-30
            t = numer / torch.where(nz, denom, full(1e-30))
            m_int = alive & (t >= 0.0) & nz
            nxv, nyv, nzv = full(o[9]), full(o[10]), full(o[11])
        elif oi[0] == _SHAPES["sphere"]:
            Lx, Ly, Lz = o[12] - px, o[13] - py, o[14] - pz
            t_ca = Lx * dx + Ly * dy + Lz * dz
            d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca
            m_int = alive & (d2 <= o[15])
            t_hc = torch.sqrt(torch.clamp_min(o[15] - d2, 0.0))
            t = t_ca - t_hc if oi[1] else t_ca + t_hc
        elif oi[0] == _SHAPES["torus"]:
            t, m_int = torus_hit_plain(o, px, py, pz, dx, dy, dz, alive, full)
        elif oi[0] == _SHAPES["cheb"]:
            t, m_int, (nxv, nyv, nzv) = cheb_hit_plain(o, oi, A, px, py, pz, dx, dy, dz,
                                                       alive, full)
        else:  # cylinder of axis bx through o[12:15]
            h = cylinder_hit_plain(o[12:15], o[3:6], o[15], bool(oi[1]),
                                   (px, py, pz), (dx, dy, dz), full)
            m_int = alive & (h["disc"] >= 0.0)
            t = torch.where(m_int, h["t"], full(0.0))
        qx = torch.where(m_int, px + t * dx, px)
        qy = torch.where(m_int, py + t * dy, py)
        qz = torch.where(m_int, pz + t * dz, pz)
        if oi[0] == _SHAPES["sphere"]:
            nxv, nyv, nzv = o[12] - qx, o[13] - qy, o[14] - qz
        elif oi[0] == _SHAPES["torus"]:
            # From the tube centre (the hit projected onto the axis circle).
            ptx, pty, ptz = qx - o[12], qy - o[13], qz - o[14]
            d_y = ptx * o[6] + pty * o[7] + ptz * o[8]
            plx, ply, plz = ptx - d_y * o[6], pty - d_y * o[7], ptz - d_y * o[8]
            inv = _inv_sqrt(torch.clamp_min(plx * plx + ply * ply + plz * plz, 1e-30))
            nxv = ptx - o[15] * plx * inv
            nyv = pty - o[15] * ply * inv
            nzv = ptz - o[15] * plz * inv
        elif oi[0] == _SHAPES["cylinder"]:  # towards the axis
            tcx, tcy, tcz = o[12] - qx, o[13] - qy, o[14] - qz
            along = tcx * o[3] + tcy * o[4] + tcz * o[5]
            nxv, nyv, nzv = tcx - along * o[3], tcy - along * o[4], tcz - along * o[5]
        if oi[0] not in (_SHAPES["plane"], _SHAPES["cheb"]):
            inv = _inv_sqrt(torch.clamp_min(nxv * nxv + nyv * nyv + nzv * nzv, 1e-30))
            nxv, nyv, nzv = nxv * inv, nyv * inv, nzv * inv
        rx, ry, rz = qx - o[0], qy - o[1], qz - o[2]
        lxv = rx * o[3] + ry * o[4] + rz * o[5]
        lyv = rx * o[6] + ry * o[7] + rz * o[8]
        mask = bounds_plain(m_int, o, oi, lxv, lyv, (rx, ry, rz), o[9:12])
        mask = aperture_logic_plain(F, I, oi, lxv, lyv, mask)

        if oi[2] in (_INTERACT["crystal"], _INTERACT["mosaic"]):
            if wl is None:
                sin_b, cos_b = o[21], o[22]
            else:  # per-ray Bragg angle (fused_trace.py:997-1001)
                sin_b = torch.clamp(wl * o[28], 0.0, 1.0)
                cos_b = torch.sqrt(torch.clamp_min(1.0 - sin_b * sin_b, 0.0))
        if oi[2] == _INTERACT["crystal"]:
            _, delta = bragg_delta_plain(dx, dy, dz, nxv, nyv, nzv, sin_b, cos_b)
            prob = rock_prob_plain(o, oi, aux, delta, full)
            if wt is None:
                mask = mask & (prob >= draw())
            else:  # weight mode: no draw (fused_trace.py:1007-1008)
                wt = torch.where(mask, wt * prob, wt)
        if oi[2] in (_INTERACT["crystal"], _INTERACT["mirror"]):  # reflect
            kk = 2.0 * (dx * nxv + dy * nyv + dz * nzv)
            dx = torch.where(mask, dx - kk * nxv, dx)
            dy = torch.where(mask, dy - kk * nyv, dy)
            dz = torch.where(mask, dz - kk * nzv, dz)
        elif oi[2] == _INTERACT["mosaic"]:
            (dx, dy, dz), mask, wt = mosaic_plain(o, oi, aux, (dx, dy, dz), (nxv, nyv, nzv),
                                                  sin_b, cos_b, mask, wt, draw, full)
        px, py, pz = qx, qy, qz
        alive = mask
        counts[1 + e] += alive.sum()
        if record is not None:
            record(1 + e, px, py, pz, dx, dy, dz, alive, wt)

        if oi[7] >= 0:
            nx, ny = oi[8], oi[9]
            fx = fused_multiply_add(lxv, o[23], o[24])
            fy = fused_multiply_add(lyv, o[23], o[25])
            w = full(1.0) if wt is None else wt
            if I[H_BILINEAR]:
                splat_plain(image, oi[7], fx[alive], fy[alive], nx, ny, w[alive], tally)
                continue
            fx, fy = torch.round(fx), torch.round(fy)
            ok = alive & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
            idx = oi[7] + fx[ok].long() * ny + fy[ok].long()
            _add_terms(image, idx, w[ok], tally)
    return alive


def _slices(fparams: FusedParams, n_total: int, count: int, bundles):
    """(global ray indices, alive, bundle rows or None) per twin slice: for a
    plasma, iteration ``j`` holds rays ``[j n, (j + 1) n)`` with ``n =
    n_total / num_iter``, and ray ``j n + l`` is alive iff ``l`` is below
    the iteration's realised count."""
    device = fparams.fp.device
    if not fparams.plasma:
        for start in range(0, n_total, _TWIN_SLICE):
            rays = torch.arange(start, min(start + _TWIN_SLICE, n_total),
                                dtype=torch.int64, device=device)
            yield rays, rays < count, None
        return
    cum, table = bundles
    n_per_iter = n_total // cum.shape[0]
    for j in range(cum.shape[0]):
        for start in range(0, n_per_iter, _TWIN_SLICE):
            local = torch.arange(start, min(start + _TWIN_SLICE, n_per_iter),
                                 dtype=torch.int64, device=device)
            yield (j * n_per_iter + local, *_plasma_rays(cum[j], table[j], local))


def _plasma_rays(cum, table, local):
    """(alive, bundle rows) of one iteration's rays at iteration-local
    indices ``local``: alive below the realised count ``cum[-1]``, zero rows
    past it."""
    return local < cum[-1], bundle_rows(cum, table, local)


def _chunk_rays(fparams: FusedParams, n_total: int, count: int, bundles, rays):
    """(alive, bundle rows or None) of the ascending global ray indices
    ``rays`` of one history chunk, as K1 sees them: rays past ``n_total`` are
    dead (their draws and bundle rows are ray ``n_total - 1``'s, their rows
    zero), a generic source's past ``count`` too; a plasma's chunk may span
    two iterations."""
    if not fparams.plasma:
        return (rays < count) & (rays < n_total), None
    cum, table = bundles
    n_per_iter = n_total // cum.shape[0]
    clamped = torch.clamp_max(rays, n_total - 1)
    alive = torch.zeros_like(rays, dtype=torch.bool)
    attrs = torch.zeros((rays.shape[0], 8), dtype=table.dtype, device=table.device)
    for j in range(int(clamped[0]) // n_per_iter, int(clamped[-1]) // n_per_iter + 1):
        here = clamped // n_per_iter == j
        alive[here], attrs[here] = _plasma_rays(cum[j], table[j], clamped[here] - j * n_per_iter)
    alive &= rays < n_total
    return alive, torch.where(alive[:, None], attrs, torch.zeros_like(attrs))


def _tally(fparams: FusedParams, terms: bool):
    """Two float64 images for a twin's ``terms=True``, else None."""
    if not terms:
        return None
    return tuple(torch.zeros(fparams.img_total, dtype=torch.float64,
                             device=fparams.fp.device) for _ in range(2))


@dataclasses.dataclass(frozen=True)
class HistorySpec:
    """K1e's reservoir (JAX ``build_fused_run``, ``fused_trace.py:
    1306-1321``): ``mode`` 'found' keeps the first ``slots`` chunks, in
    chunk order, whose final element keeps a ray; 'sampled' keeps chunks 0
    .. ``slots`` - 1. Chunk ``c`` holds rays ``[c chunk, (c + 1) chunk)``;
    ``chunk`` is a multiple of 1024."""

    mode: str
    slots: int
    chunk: int

    def __post_init__(self):
        if self.mode not in ("found", "sampled"):
            raise ValueError(f"history_mode {self.mode!r}")
        if self.slots <= 0 or self.chunk <= 0 or self.chunk % 1024:
            raise ValueError("history: slots > 0, chunk a multiple of 1024")

    def n_chunks(self, n_total: int) -> int:
        return -(-n_total // self.chunk)


@dataclasses.dataclass(frozen=True)
class History:
    """A filled reservoir: ``slots`` (S, n_fields (1 + n_optics), chunk)
    float32, element e's fields at rows ``e n_fields ..``: origin (3),
    direction (3), wavelength, alive (1.0 or 0.0) and in weight mode the
    weight; ``chunks`` (S,) int32, the kept chunk of each used slot;
    ``used`` a 0-d int32 tensor, the slots used. Slots past ``used`` stay
    zero."""

    slots: torch.Tensor
    chunks: torch.Tensor
    used: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Probe:
    """K1e's probe of a 'found' run (:func:`history_probe_cuda`): ``marks``
    (n_chunks + 1,) int32, 1 at each probed chunk whose final element keeps
    a ray, and last the flag, set once ``slots`` chunks are marked, which
    stops K1's marks; ``used`` a 0-d int32 tensor, the marked chunks of the
    probed prefix, at most ``slots``; ``chunks`` the prefix of chunks its
    windows cover (with the flag set, the windows after it probed
    nothing)."""

    marks: torch.Tensor
    used: torch.Tensor
    chunks: int


def probe_windows(spec: HistorySpec, n_total: int) -> list:
    """The chunk windows ``[lo, hi)`` K1e's probe traces in turn: ``slots``,
    ``2 slots``, ``4 slots``, ... chunks from chunk 0, up to 1/PROBE_SHARE
    of the run's chunks and at least the first ``slots`` (all of a run of
    fewer)."""
    n_chunks = spec.n_chunks(n_total)
    budget = min(n_chunks, max(spec.slots, -(-n_chunks // PROBE_SHARE)))
    windows, lo, size = [], 0, spec.slots
    while lo < budget:
        windows.append((lo, min(lo + size, budget)))
        lo, size = windows[-1][1], 2 * size
    return windows


def _history_buffers(fparams: FusedParams, spec: HistorySpec, device) -> tuple:
    """Zeroed (slots, chunks, used) of a reservoir on ``device``."""
    n_fields = 9 if fparams.weight else 8
    return (torch.zeros((spec.slots, n_fields * (1 + fparams.n_optics), spec.chunk),
                        dtype=torch.float32, device=device),
            torch.zeros(spec.slots, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def reach_counts_plain(reach: torch.Tensor, n_optics: int) -> torch.Tensor:
    """The kernels' per-element counts from the rays' reaches
    (``xrt_count_reach``, ``xrt_flush_counts`` in ``csrc/trace_chain.cuh``):
    ``reach`` the source and the elements each ray leaves alive (-1 for a
    ray dead at the source). Alive never returns along a chain, so element
    k's count (k = 0 the source) is the rays that reach k or further, the
    suffix sum of the histogram of reaches. int64 [1 + n_optics]."""
    hist = torch.bincount(reach[reach >= 0], minlength=n_optics + 1)
    return hist.flip(0).cumsum(0).flip(0)


def fused_run_plain(fparams: FusedParams, n_total: int, count: int,
                    uniforms: torch.Tensor | None = None, seed=(0, 0),
                    bundles=None, terms: bool = False,
                    history: HistorySpec | None = None):
    """The kernel's plain twin: same arguments, same outputs.

    Returns (counts int64 [1 + n_optics], flat images float32 [img_total]).
    ``uniforms``: (n_draws, n_total) float32, or None for the kernel's
    Philox stream keyed by ``seed``. ``bundles``: for a plasma, the
    per-iteration tables (cum (num_iter, B) int32, table (num_iter, B, 8)
    float32); ``count`` is then unused. ``terms``: also return, third, the
    number of float32 terms each pixel sums and the sum of their
    magnitudes (two float64 images), which bound how far another order of
    the same sums may round from this one. ``history``: also return, last,
    the filled reservoir (:func:`history_record_plain`); 'found' finds the
    kept chunks as ``fused_run_cuda`` does: the probe first in a run of
    PROBE_MIN_RAYS rays or more (:func:`history_probe_plain`), and marks in
    the run where it found too few.
    """
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    tally = _tally(fparams, terms)
    marks, _ = _found_marks(fparams, n_total, count, history, uniforms, seed, bundles,
                            history_probe_plain)
    mark = marks is not None and int(marks[-1]) == 0
    for rays, alive, attrs in _slices(fparams, n_total, count, bundles):
        final = _trace_slice(F, I, fparams.aux, alive, _draws(fparams, rays, uniforms, seed),
                             counts, image, attrs, tally)
        if mark:
            marks[rays[final] // history.chunk] = 1
    out = (counts, image) if tally is None else (counts, image, tally)
    if history is None:
        return out
    return (*out, history_record_plain(fparams, n_total, count, history,
                                       None if marks is None else marks[:-1], uniforms,
                                       seed, bundles))


def _found_marks(fparams, n_total, count, history, uniforms, seed, bundles,
                 prober) -> tuple:
    """(marks, probed) of a run's 'found' reservoir: in a run of
    PROBE_MIN_RAYS rays or more the probe's marks (``prober``:
    :func:`history_probe_cuda` or its twin), else zeroed marks that K1
    makes. K1 marks the chunks while the marks' flag is clear. (None,
    False) for no 'found' reservoir."""
    if history is None or history.mode != "found":
        return None, False
    if n_total < PROBE_MIN_RAYS:
        n_chunks = history.n_chunks(n_total)
        return torch.zeros(n_chunks + 1, dtype=torch.int32, device=fparams.fp.device), False
    return prober(fparams, n_total, count, history, uniforms, seed, bundles).marks, True


def _draws(fparams: FusedParams, rays, uniforms, seed):
    """The draw function of the rays ``rays``: their columns of
    ``uniforms``, or their Philox stream keyed by ``seed``."""
    if uniforms is None:
        rows = philox_uniforms(rays, fparams.n_draws, int(seed[0]), int(seed[1]))
    else:
        rows = [uniforms[k, rays] for k in range(fparams.n_draws)]
    return iter(rows).__next__


def _record_into(out, n_fields: int):
    """A twin record hook writing element ``e``'s fields into rows ``e
    n_fields ..`` of ``out`` (one slot's (rows, chunk))."""

    def record(e, px, py, pz, dx, dy, dz, alive, wt, wl):
        fields = (px, py, pz, dx, dy, dz, wl, alive.to(torch.float32))
        for k, value in enumerate(fields + ((wt,) if n_fields == 9 else ())):
            out[e * n_fields + k] = value

    return record


def history_record_plain(fparams: FusedParams, n_total: int, count: int,
                         spec: HistorySpec, marks=None, uniforms=None, seed=(0, 0),
                         bundles=None) -> History:
    """K1e's plain twin: the selection of the kept chunks (the first
    ``spec.slots`` marked ones in chunk order, or with no ``marks`` chunks
    0 .. slots - 1) and the record pass over their rays, traced again with
    the run's draws and bundle tables (the arguments of
    :func:`fused_run_plain`). ``marks``: (n_chunks,) int32, 1 where the
    final element kept a ray."""
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    slots, chunks, used = _history_buffers(fparams, spec, device)
    if marks is None:
        kept = torch.arange(min(spec.slots, spec.n_chunks(n_total)), device=device)
    else:
        kept = torch.nonzero(marks).flatten()[:spec.slots]
    chunks[:kept.numel()] = kept.to(torch.int32)
    used.fill_(kept.numel())
    n_fields = slots.shape[1] // (1 + fparams.n_optics)
    scratch = (torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device),
               torch.zeros(fparams.img_total, dtype=torch.float32, device=device))
    for s, c in enumerate(kept.tolist()):
        rays = torch.arange(c * spec.chunk, (c + 1) * spec.chunk, dtype=torch.int64,
                            device=device)
        alive, attrs = _chunk_rays(fparams, n_total, count, bundles, rays)
        draw = _draws(fparams, torch.clamp_max(rays, n_total - 1), uniforms, seed)
        _trace_slice(F, I, fparams.aux, alive, draw, *scratch, attrs,
                     record=_record_into(slots[s], n_fields))
    return History(slots, chunks, used)


def history_probe_plain(fparams: FusedParams, n_total: int, count: int,
                        spec: HistorySpec, uniforms=None, seed=(0, 0),
                        bundles=None) -> Probe:
    """K1e's probe's plain twin: the windows of :func:`probe_windows` in
    turn, each chunk's rays traced with the run's draws and bundle tables
    (the arguments of :func:`fused_run_plain`) and marked where the final
    element keeps a ray, the marked chunks of the prefix counted after each
    window and the flag set once ``spec.slots`` are; a window after that
    traces nothing, as the kernel's leaves at once."""
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    n_chunks = spec.n_chunks(n_total)
    marks = torch.zeros(n_chunks + 1, dtype=torch.int32, device=device)
    used = torch.zeros((), dtype=torch.int32, device=device)
    scratch = (torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device),
               torch.zeros(fparams.img_total, dtype=torch.float32, device=device))
    windows = probe_windows(spec, n_total)
    for lo, hi in windows:
        if int(used) >= spec.slots:
            continue
        for start in range(lo * spec.chunk, hi * spec.chunk, _TWIN_SLICE):
            rays = torch.arange(start, min(start + _TWIN_SLICE, hi * spec.chunk),
                                dtype=torch.int64, device=device)
            alive, attrs = _chunk_rays(fparams, n_total, count, bundles, rays)
            draw = _draws(fparams, torch.clamp_max(rays, n_total - 1), uniforms, seed)
            final = _trace_slice(F, I, fparams.aux, alive, draw, *scratch, attrs)
            marks[rays[final] // spec.chunk] = 1
        used.fill_(min(int(marks[:hi].sum()), spec.slots))
        if int(used) >= spec.slots:
            marks[n_chunks] = 1
    return Probe(marks, used, windows[-1][1])


def _check_bundles(fparams: FusedParams, n_total: int, bundles, device):
    if not fparams.plasma:
        return None, None, 0, 0
    if bundles is None:
        raise ValueError("fused_run_cuda: a plasma source needs its bundle tables")
    cum, table = bundles
    if cum.dim() != 2 or cum.dtype != torch.int32 or cum.device != device:
        raise ValueError(f"cum must be (num_iter, B) int32 on {device}")
    if (table.dtype != torch.float32 or table.device != device
            or tuple(table.shape) != (*cum.shape, 8)):
        raise ValueError(f"table must be (num_iter, B, 8) float32 on {device}")
    if cum.shape[1] > MAX_BUNDLES or n_total % cum.shape[0]:
        raise ValueError("fused_run_cuda: at most 2^22 bundles, and num_iter "
                         "must divide n_total")
    return cum.contiguous(), table.contiguous(), cum.shape[1], n_total // cum.shape[0]


def _check_uniforms(fparams: FusedParams, uniforms, n_total: int, device):
    """``uniforms`` contiguous, checked: float32 (n_draws, n_total) on
    ``device``, or None."""
    if uniforms is None:
        return None
    if (uniforms.device != device or uniforms.dtype != torch.float32
            or tuple(uniforms.shape) != (fparams.n_draws, n_total)):
        raise ValueError(
            f"uniforms must be float32 ({fparams.n_draws}, {n_total}) on {device}")
    return uniforms.contiguous()


def fused_run_cuda(fparams: FusedParams, n_total: int, count: int,
                   uniforms: torch.Tensor | None = None, seed=(0, 0),
                   bundles=None, history: HistorySpec | None = None):
    """Trace ``n_total`` rays through the packed chain (kernel K1).

    Point sources: rays at index >= ``count`` are dead at the source.
    Plasma sources: ``bundles`` = (cum, table) per iteration, as
    :func:`fused_run_plain` takes them. Returns (counts int64
    [1 + n_optics], flat images float32 [img_total]), and with a
    ``history`` the filled reservoir third: 'found' probes the first
    chunks for the kept ones (:func:`history_probe_cuda`, for runs of
    PROBE_MIN_RAYS rays or more), then launches K1's build that marks the
    chunks with a found ray beside its build without marks, of which the
    probe's flag runs one on the card (two launches; without the probe,
    the marked build alone), then K1e
    (:func:`history_record_cuda`). Weighted and bilinear images
    (``fparams.stages`` >= 1) are summed by the kernel in float64 and
    rounded here once to float32. Buffers on a CUDA device launch the
    kernels (or raise); buffers on the CPU take :func:`fused_run_plain`.
    """
    device = fparams.fp.device
    if device.type == "cpu":
        return fused_run_plain(fparams, n_total, count, uniforms, seed, bundles,
                               history=history)
    if device.type != "cuda":
        raise ValueError(f"fused_run_cuda: unsupported device {device}")
    if not 0 <= n_total < 2**31:
        raise ValueError("fused_run_cuda: n_total must be in [0, 2^31)")
    if history is not None and n_total == 0:
        raise ValueError("fused_run_cuda: a history needs rays")
    cum, table, n_bundles, n_per_iter = _check_bundles(fparams, n_total, bundles, device)
    uniforms = _check_uniforms(fparams, uniforms, n_total, device)
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    sums = torch.zeros(fparams.img_total, device=device,
                       dtype=torch.float64 if fparams.stages >= 1 else torch.float32)
    if n_total == 0:
        return counts, sums.to(torch.float32)
    fp, ip, aux = _buffers(fparams, "fused_run_cuda")
    args = (fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
            aux.numel(), n_total, int(count),
            None if uniforms is None else uniforms.data_ptr(), int(seed[0]) & _M32,
            int(seed[1]) & _M32, None if cum is None else cum.data_ptr(),
            None if table is None else table.data_ptr(), n_bundles, n_per_iter,
            counts.data_ptr(), sums.data_ptr(), fparams.img_total,
            int(fparams.full_source), int(fparams.cheb), fparams.stages,
            fparams.shapes, int(fparams.dense_images), *fparams.stage_window)
    marks, probed = _found_marks(fparams, n_total, count, history, uniforms, seed, bundles,
                                 history_probe_cuda)
    lib = native.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    # The probe's flag picks one of K1's two launches on the card: the host
    # waits for nothing between the probe and K1.
    if marks is None:
        err = lib.xrt_fused_trace(*args, stream)
    else:
        err = lib.xrt_fused_trace_marked(*args, marks.data_ptr(), history.chunk, stream)
        if err == 0 and probed:
            err = lib.xrt_fused_trace_flagged(*args, marks.data_ptr(), history.chunk, stream)
    native.check(err, "xrt_fused_trace")
    fused_run_cuda.launches += 2 if probed else 1
    image = sums.to(torch.float32)
    if history is None:
        return counts, image
    return counts, image, history_record_cuda(fparams, n_total, count, history,
                                              None if marks is None else marks[:-1],
                                              uniforms, seed, bundles)


fused_run_cuda.launches = 0


def history_record_cuda(fparams: FusedParams, n_total: int, count: int,
                        spec: HistorySpec, marks=None, uniforms=None, seed=(0, 0),
                        bundles=None) -> History:
    """K1e: select the kept chunks and trace their rays again into the
    reservoir (``csrc/fused_history.cu``), for the run K1 traced with the
    same ``n_total``, ``count``, ``uniforms`` or ``seed`` and ``bundles``.
    ``marks``: 'found' mode's (n_chunks,) chunk marks, the probe's and K1's
    (:class:`Probe`, less its flag), None in 'sampled' mode. Buffers on a
    CUDA device launch the kernels (or raise); buffers on the CPU take
    :func:`history_record_plain`."""
    device = fparams.fp.device
    if device.type == "cpu":
        return history_record_plain(fparams, n_total, count, spec, marks, uniforms, seed,
                                    bundles)
    if device.type != "cuda":
        raise ValueError(f"history_record_cuda: unsupported device {device}")
    if not 0 < n_total < 2**31:
        raise ValueError("history_record_cuda: n_total must be in (0, 2^31)")
    if (marks is None) != (spec.mode == "sampled"):
        raise ValueError("history_record_cuda: 'found' takes the chunk marks, "
                         "'sampled' none")
    n_chunks = spec.n_chunks(n_total)
    if marks is not None and (marks.device != device or marks.dtype != torch.int32
                              or tuple(marks.shape) != (n_chunks,)):
        raise ValueError(f"marks must be int32 ({n_chunks},) on {device}")
    cum, table, n_bundles, n_per_iter = _check_bundles(fparams, n_total, bundles, device)
    uniforms = _check_uniforms(fparams, uniforms, n_total, device)
    slots, chunks, used = _history_buffers(fparams, spec, device)
    fp, ip, aux = _buffers(fparams, "history_record_cuda")
    err = native.library().xrt_history_record(
        fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
        aux.numel(), n_total, int(count),
        None if uniforms is None else uniforms.data_ptr(), int(seed[0]) & _M32,
        int(seed[1]) & _M32, None if cum is None else cum.data_ptr(),
        None if table is None else table.data_ptr(), n_bundles, n_per_iter,
        None if marks is None else marks.contiguous().data_ptr(), n_chunks, spec.slots,
        spec.chunk, slots.shape[1] // (1 + fparams.n_optics), chunks.data_ptr(),
        used.data_ptr(), slots.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_history_record")
    history_record_cuda.launches += 1
    return History(slots, chunks, used)


history_record_cuda.launches = 0


def history_probe_cuda(fparams: FusedParams, n_total: int, count: int,
                       spec: HistorySpec, uniforms=None, seed=(0, 0),
                       bundles=None) -> Probe:
    """K1e's probe of a 'found' run (``csrc/fused_history.cu``,
    ``history_probe_kernel``): every window of :func:`probe_windows`, in one
    call, each one launch that traces its chunks with the run's
    ``n_total``, ``count``, ``uniforms`` or ``seed`` and ``bundles`` and
    marks those that keep a ray, then selects the marked chunks of the
    prefix and sets the flag once ``spec.slots`` are marked; the windows
    after it leave at once on the card. The host reads nothing back. Buffers on a CUDA
    device launch the kernels (or raise); buffers on the CPU take
    :func:`history_probe_plain`."""
    device = fparams.fp.device
    if device.type == "cpu":
        return history_probe_plain(fparams, n_total, count, spec, uniforms, seed, bundles)
    if device.type != "cuda":
        raise ValueError(f"history_probe_cuda: unsupported device {device}")
    if not 0 < n_total < 2**31:
        raise ValueError("history_probe_cuda: n_total must be in (0, 2^31)")
    if spec.mode != "found":
        raise ValueError("history_probe_cuda: only 'found' probes")
    cum, table, n_bundles, n_per_iter = _check_bundles(fparams, n_total, bundles, device)
    uniforms = _check_uniforms(fparams, uniforms, n_total, device)
    n_chunks = spec.n_chunks(n_total)
    buf = torch.zeros(n_chunks + 2 + spec.slots, dtype=torch.int32, device=device)
    marks, used, sel = buf[:n_chunks + 1], buf[n_chunks + 1], buf[n_chunks + 2:]
    fp, ip, aux = _buffers(fparams, "history_probe_cuda")
    args = (fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
            aux.numel(), n_total, int(count),
            None if uniforms is None else uniforms.data_ptr(), int(seed[0]) & _M32,
            int(seed[1]) & _M32, None if cum is None else cum.data_ptr(),
            None if table is None else table.data_ptr(), n_bundles, n_per_iter,
            marks.data_ptr(), n_chunks)
    windows = probe_windows(spec, n_total)
    bounds = (ctypes.c_int * (len(windows) + 1))(0, *(hi for _, hi in windows))
    err = native.library().xrt_history_probe(
        *args, bounds, len(windows), spec.slots, spec.chunk, sel.data_ptr(),
        used.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_history_probe")
    history_probe_cuda.launches += len(windows)
    return Probe(marks, used, windows[-1][1])


history_probe_cuda.launches = 0


def _buffers(fparams: FusedParams, name: str) -> tuple:
    """The packed fp, ip and aux buffers, checked for the kernels: float32,
    int32 and float32 on one device, contiguous."""
    fp, ip, aux = fparams.fp, fparams.ip, fparams.aux
    if fp.dtype != torch.float32 or ip.dtype != torch.int32 or aux.dtype != torch.float32:
        raise ValueError(f"{name}: fp and aux must be float32, ip int32")
    if not fp.device == ip.device == aux.device:
        raise ValueError(f"{name}: fp, ip and aux must share one device")
    return fp.contiguous(), ip.contiguous(), aux.contiguous()


# ---------------------------------------------------------------------------
# The trace-only kernel K3: rays from memory through K1's chain.
# ---------------------------------------------------------------------------

def fused_trace_run_plain(fparams: FusedParams, origin, direction, wavelength, mask,
                          uniforms: torch.Tensor | None = None, seed=(0, 0), weight=None,
                          terms: bool = False):
    """K3's plain twin: the rays (origin and direction (n, 3), wavelength
    (n,), mask (n,), and in weight mode their weights (n,)) through the
    packed chain, each at its own wavelength. Ray ``r`` takes draw ``k``
    from ``uniforms[k, r]`` ((n_draws, n) float32), or from the Philox
    stream keyed by ``seed``. Returns (counts int64 [1 + n_optics], flat
    images float32 [img_total]) and, with ``terms``, the third output of
    :func:`fused_run_plain`."""
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    n = mask.shape[0]
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    tally = _tally(fparams, terms)
    for start in range(0, n, _TWIN_SLICE):
        stop = min(start + _TWIN_SLICE, n)
        rays = torch.arange(start, stop, dtype=torch.int64, device=device)
        if uniforms is None:
            rows = philox_uniforms(rays, fparams.n_draws, int(seed[0]), int(seed[1]))
        else:
            rows = [uniforms[k, start:stop] for k in range(fparams.n_draws)]
        alive = mask[start:stop].to(torch.bool)
        counts[0] += alive.sum()
        o, d = origin[start:stop], direction[start:stop]
        _trace_chain_plain(F, I, fparams.aux,
                           (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]),
                           wavelength[start:stop], alive, iter(rows).__next__, counts,
                           image, None if weight is None else weight[start:stop], tally)
    return (counts, image) if tally is None else (counts, image, tally)


def fused_trace_run_cuda(fparams: FusedParams, origin, direction, wavelength, mask,
                         uniforms: torch.Tensor | None = None, seed=(0, 0), weight=None):
    """Trace the given rays through the packed chain (kernel K3), as
    :func:`fused_trace_run_plain` takes them: float32 rays, a bool or uint8
    mask, packed for source kind 3 (rays from memory); ``weight`` float32
    (n,) in weight mode (JAX streams it only then, ``fused_trace.py:
    2054-2056``), else None. Buffers on a CUDA device launch the kernel (or
    raise); buffers on the CPU take the twin."""
    device = fparams.fp.device
    if (weight is None) == fparams.weight:
        raise ValueError("fused_trace_run_cuda: weight mode takes the rays' weights, "
                         "mc mode none")
    if device.type == "cpu":
        return fused_trace_run_plain(fparams, origin, direction, wavelength, mask,
                                     uniforms, seed, weight)
    if device.type != "cuda":
        raise ValueError(f"fused_trace_run_cuda: unsupported device {device}")
    if fparams.source_kind != SRC_RAYS:
        raise ValueError("fused_trace_run_cuda: the chain must be packed for rays "
                         "from memory (source kind 3)")
    n = mask.shape[0]
    if not 0 <= n < 2**31:
        raise ValueError("fused_trace_run_cuda: n must be in [0, 2^31)")
    for name, t, shape in (("origin", origin, (n, 3)), ("direction", direction, (n, 3)),
                           ("wavelength", wavelength, (n,)),
                           ("weight", wavelength if weight is None else weight, (n,))):
        if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"fused_trace_run_cuda: {name} must be float32 {shape} "
                             f"on {device}")
    if (mask.device != device or mask.dtype not in (torch.bool, torch.uint8)
            or tuple(mask.shape) != (n,)):
        raise ValueError(f"fused_trace_run_cuda: mask must be bool ({n},) on {device}")
    u_ptr = None
    if uniforms is not None:
        if (uniforms.device != device or uniforms.dtype != torch.float32
                or tuple(uniforms.shape) != (fparams.n_draws, n)):
            raise ValueError(
                f"uniforms must be float32 ({fparams.n_draws}, {n}) on {device}")
        uniforms = uniforms.contiguous()
        u_ptr = uniforms.data_ptr()
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    if n == 0:
        return counts, image
    origin, direction = origin.contiguous(), direction.contiguous()
    wavelength = wavelength.contiguous()
    mask = mask.contiguous().view(torch.uint8)
    if weight is not None:
        weight = weight.contiguous()
    fp, ip, aux = _buffers(fparams, "fused_trace_run_cuda")
    err = native.library().xrt_trace_only(
        fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
        aux.numel(), n, origin.data_ptr(), direction.data_ptr(),
        wavelength.data_ptr(), mask.data_ptr(),
        None if weight is None else weight.data_ptr(), u_ptr, int(seed[0]) & _M32,
        int(seed[1]) & _M32, counts.data_ptr(), image.data_ptr(), fparams.img_total,
        int(fparams.cheb), fparams.stages, torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_trace_only")
    fused_trace_run_cuda.launches += 1
    return counts, image


fused_trace_run_cuda.launches = 0


# ---------------------------------------------------------------------------
# Engine entry points.
# ---------------------------------------------------------------------------

def plasma_bundles(source, source_params: dict, filter_params: dict, draws,
                   num_iter: int):
    """A plasma's bundle tables for ``num_iter`` iterations, drawn in turn
    and stacked as the kernel takes them: (cum (num_iter, B) int32, table
    (num_iter, B, 8) float32). The source's filters cut the bundles here."""
    tables = [source.bundle_tables(source_params, draws, filter_params)
              for _ in range(num_iter)]
    return (torch.stack([c for c, _, _ in tables]),
            torch.stack([t for _, t, _ in tables]).detach())


def _history_spec(pipeline, src: dict, chunk: int, history_slots, history_mode: str):
    """The run's reservoir, or None (JAX ``fused_trace.py:1250-1323``): a
    plasma caps ``chunk`` at 4096, and at 2048 beyond 4096 bundles; 'found'
    keeps ``history_slots`` chunks (none without), 'sampled' ``history_slots``
    or enough for ``general.history_max_lost`` rays."""
    if history_mode not in ("found", "sampled"):
        raise ValueError(f"history_mode {history_mode!r}")
    if chunk % 1024:
        raise ValueError("chunk must be a multiple of 1024")
    if src["kind"] == 1:
        chunk = min(chunk, 4096)
        if _round_up(max(pipeline.source.bundle_count, 128), 128) > 4096:
            chunk = min(chunk, 2048)
    if history_slots:
        slots = int(history_slots)
    elif history_mode == "sampled":
        slots = max(1, -(-int(pipeline.general.get("history_max_lost") or 10000) // chunk))
    else:
        return None
    return HistorySpec(history_mode, slots, chunk)


def build_fused_run(pipeline, num_iter: int | None = None,
                    rng: str = "hw", history_slots: int | None = None,
                    history_mode: str = "found", chunk: int = 8192):
    """Build ``run(params, generator, uniforms=None, bundles=None) ->
    {"meta", "image", "history"}`` tracing ``pipeline.num_rays * num_iter``
    rays in one launch.

    ``rng``: 'hw' draws the kernel's Philox stream from two seed words taken
    from the generator; 'input' streams explicit (n_draws, n_total) float32
    uniforms: ``uniforms`` when given, else drawn from the generator. Ray
    ``r`` takes draw ``k`` from row ``k``, column ``r``; the draws of a ray
    are the source's (point: u, v; plasma: 3 voxel offsets, u, v, the
    normal's uniform, the Cauchy uniform), then the optics' in chain order:
    one per crystal in mc mode, three per layer of a mosaic crystal.
    ``interact_mode='weight'`` carries each ray's weight through the chain
    and into the images; ``image_mode='bilinear'`` splats them.

    Poisson budgets draw the realised count on the host from the generator
    (the sum of per-iteration Poisson draws is one Poisson draw of the
    summed rate), as ``fused_trace.py:1902-1907`` does. A plasma draws its
    bundle tables per iteration from the generator, on the device, before
    the launch (``fused_trace.py:1911-1969``); iteration ``j`` traces rays
    ``[j N, (j + 1) N)`` of the budget ``N``. ``bundles`` may give them
    instead, as ``fused_run_cuda`` takes them.

    ``history_slots``, ``history_mode``: the history reservoir K1e
    (``keep_history='found'`` or ``'sampled'``, :class:`HistorySpec`, JAX
    ``fused_trace.py:1212-1223``): at most ``slots * chunk`` rays of
    history per element, rebuilt as per-element ``Rays`` of ``slots *
    chunk`` rays whose mask is false past the used slots. ``chunk`` (8192;
    a plasma's capped as JAX caps it) sets only the history's granularity.
    """
    g = pipeline.general
    modes = _chain_modes(g)
    if rng not in ("hw", "input"):
        raise ValueError(f"rng must be 'hw' or 'input', got {rng!r}")

    src = _source_spec(pipeline.source, {f.name: f for f in pipeline.filters})
    optics = [_optic_spec(o) for o in pipeline.optics]
    history = _history_spec(pipeline, src, chunk, history_slots, history_mode)
    # Packing the build-time params raises FusedUnsupported for what only
    # the values show: buffer limits, a wavelength outside the Bragg range.
    pack_params(src, optics, pipeline.params, "cpu", **modes)
    if num_iter is None:
        num_iter = int(g["number_of_iter"])
    n_total = pipeline.num_rays * num_iter
    if n_total >= 2**31:
        raise FusedUnsupported(
            f"num_rays*num_iter = {n_total:.3e} overflows int32 ray indexing")
    keep_meta = bool(g.get("keep_meta", True))
    keep_images = bool(g.get("keep_images", True))
    names = pipeline.element_names
    device = pipeline.device

    source = pipeline.source

    def run(params, generator: torch.Generator, uniforms=None, bundles=None):
        fparams = pack_params(src, optics, params, device, **modes)
        if fparams.plasma and bundles is None:
            bundles = plasma_bundles(source, params["sources"][source.name],
                                     params["filters"], Draws(generator), num_iter)
        count = n_total
        if src["poisson"]:
            count = min(Draws(generator).poisson(src["rate"] * num_iter), n_total)
        seed = (0, 0)
        if rng == "input" and uniforms is None:
            uniforms = torch.rand((fparams.n_draws, n_total), generator=generator,
                                  dtype=torch.float32, device=generator.device)
        if rng == "hw":
            seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                                 device=generator.device).tolist()
        if uniforms is not None:
            uniforms = uniforms.to(device)
        counts, flat, *hist = fused_run_cuda(fparams, n_total, count, uniforms, seed,
                                             bundles, history)
        return _results(counts, flat, optics, names, keep_meta, keep_images, *hist)

    return run


def _results(counts, flat, optics, names, keep_meta: bool, keep_images: bool,
             hist: History | None = None) -> dict:
    """The run's ``{"meta", "image", "history"}`` from the kernels' counts
    and flat images, and per-element ``Rays`` rebuilt from a reservoir
    (JAX ``fused_trace.py:1992-2021``): ``mask = alive & valid`` (the slot
    is used), the weight field 8 in weight mode, else ones."""
    from xicsrt_tpu_torch.rays import Rays

    meta = {name: counts[i] for i, name in enumerate(names)} if keep_meta else {}
    image = {}
    if keep_images:
        off = 0
        for o in optics:
            im = o["image"]
            if im is not None:
                size = im["nx"] * im["ny"]
                image[o["name"]] = flat[off:off + size].reshape(im["nx"], im["ny"])
                off += size
    history = {}
    if hist is not None:
        n_slots, n_rows, chunk = hist.slots.shape
        n_fields = n_rows // len(names)
        rows = hist.slots.view(n_slots, len(names), n_fields, chunk)

        def field(lo: int, hi: int):  # rows lo .. hi - 1 of every element: (E, N, hi - lo)
            return rows[:, :, lo:hi].permute(1, 0, 3, 2).reshape(len(names), -1, hi - lo)

        valid = torch.repeat_interleave(
            torch.arange(n_slots, device=hist.slots.device) < hist.used, chunk)
        origin, direction, rest = field(0, 3), field(3, 6), field(6, n_fields)
        wavelength = rest[..., 0].contiguous()
        mask = (rest[..., 1] != 0.0) & valid
        weight = (rest[..., 2].contiguous() if n_fields == 9
                  else torch.ones_like(wavelength))
        for i, name in enumerate(names):
            history[name] = Rays(origin=origin[i], direction=direction[i],
                                 wavelength=wavelength[i], weight=weight[i], mask=mask[i])
    return {"meta": meta, "image": image, "history": history}


def _chain_modes(g: dict) -> dict:
    """The run modes of K1's and K3's chain, as ``pack_params`` takes them:
    mc or weight, nearest or bilinear images; float32 only."""
    mode = str(g.get("interact_mode", "mc")).lower()
    if mode not in ("mc", "weight"):
        raise FusedUnsupported(f"interact_mode {mode!r}")
    image_mode = str(g.get("image_mode", "nearest")).lower()
    if image_mode not in ("nearest", "bilinear"):
        raise FusedUnsupported(f"image_mode {image_mode!r}")
    if str(g.get("dtype", "float32")).lower() not in ("float32", "f32"):
        raise FusedUnsupported("dtype != float32")
    return {"weight": mode == "weight", "bilinear": image_mode == "bilinear"}


def build_fused_trace_run(pipeline, num_iter: int | None = None):
    """Build ``run(params, generator) -> {"meta", "image", "history"}``: per
    iteration the eager engine generates the source's rays
    (``pipeline.source.generate``; a plasma's bundles through K4) and K3
    traces them through the chain (JAX ``build_fused_trace_run``,
    ``fused_trace.py:2029-2226``), its draws (the optics', as in K1) from a
    Philox stream keyed by two seed words from the generator; in weight
    mode it streams the rays' weights too. It keeps no history.
    """
    g = pipeline.general
    modes = _chain_modes(g)
    optics = [_optic_spec(o) for o in pipeline.optics]
    src = {"name": None, "kind": SRC_RAYS, "n_draws": 0}
    pack_params(src, optics, pipeline.params, "cpu", **modes)
    if num_iter is None:
        num_iter = int(g["number_of_iter"])
    n = pipeline.num_rays
    if n * num_iter >= 2**31:
        raise FusedUnsupported(f"num_rays*num_iter = {n * num_iter:.3e} overflows "
                               "int32 ray indexing")
    keep_meta = bool(g.get("keep_meta", True))
    keep_images = bool(g.get("keep_images", True))
    names = pipeline.element_names
    device = pipeline.device
    source = pipeline.source

    def run(params, generator: torch.Generator):
        fparams = pack_params(src, optics, params, device, **modes)
        draws = Draws(generator)
        counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
        flat = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
        for _ in range(num_iter):
            rays = source.generate(params["sources"][source.name], draws,
                                   params["filters"])
            seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                                 device=generator.device).tolist()
            c, im = fused_trace_run_cuda(
                fparams, rays.origin, rays.direction, rays.wavelength, rays.mask,
                seed=seed, weight=rays.weight if fparams.weight else None)
            counts += c
            flat += im
        return _results(counts, flat, optics, names, keep_meta, keep_images)

    return run


def build_fast_run(pipeline, num_iter: int | None = None,
                   history_slots: int | None = None,
                   history_mode: str = "found"):
    """Fastest applicable fused path: ``(run, kind)``, kind "fused" (K1)
    or "fused_trace" (K3).

    K1 first; where it refuses and no history is asked, the trace-only
    path, which raises ``FusedUnsupported`` itself where the chain is
    outside the subset (JAX ``fused_trace.py:2229-2262``). The reservoir
    exists only in K1: with a history, K1's refusal raises. On this card
    K3 serves the sources K1 refuses: plasmas of more than 2^22 bundles.
    """
    try:
        return (build_fused_run(pipeline, num_iter=num_iter,
                                history_slots=history_slots,
                                history_mode=history_mode),
                "fused")
    except FusedUnsupported:
        if history_slots or history_mode != "found":
            raise FusedUnsupported("history reservoir requires the megakernel path")
    return build_fused_trace_run(pipeline, num_iter=num_iter), "fused_trace"
