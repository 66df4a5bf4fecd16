"""Fused gradient kernels K5f and K5b (counterpart of
``xicsrt_tpu/ops/fused_grad.py``).

K5f (``csrc/fused_grad.cu``, ``fused_grad_forward_cuda``) generates every
ray, traces it through the chain in ``interact_mode='weight'`` and splats
bilinear images; it replaces ``build_fused_diff``'s ``make_kernel(False)``.
K5b (``fused_grad_vjp_cuda``) regenerates the same rays from the same seed,
gathers the cotangent images at each hit's four corners and runs the
hand-derived adjoint sweep, accumulating the gradient of
``sum(g * image)`` with respect to the flat parameter vector; it replaces
``make_kernel(True)``.

The differentiated parameters arrive at run time in ``pvec``: per optic 24
slots (``fused_grad.py:74-80``): 0:3 origin, 3:6 bx, 6:9 by, 9:12 bz,
12 radius (radius_major of a torus), 13 crystal_spacing, 14 rocking_fwhm,
15 reflectivity, 16 radius_minor, 17:24 reserved; after the optics, for a
plasma, ``SRC_SLOTS`` = 8 source slots (``fused_grad.py:116-119``): 0
emissivity, 1 temperature, 2:8 reserved. The structure (source sampler,
shapes, bounds, apertures, images) is the K1 buffer layout of
``ops/fused_trace.py``, packed once at build time.

Subset (``FusedGradUnsupported`` otherwise): Generic, Directed and Focused
sources with every box, cone and wavelength distribution and bulk Doppler
that K1 samples (``ops/fused_trace.sample_source_plain``; K5e-generic), a
counted budget and no filters; constant-profile plasmas (``XicsrtPlasmaGeneric``,
``XicsrtPlasmaCubic``) with a counted budget and a constant ``spread``,
sampled one bundle per ray (``fused_grad.py:122-199``): emissivity enters
each ray's weight, temperature its Doppler width, so the wavelength is per
ray and its adjoint reaches the temperature slot; plane, sphere, cylinder
and torus optics (concave and convex; the torus root found on detached
copies and differentiated through one Newton correction, the
implicit-function adjoint) with x/y/z bounds and apertures as hard edges;
no interaction, mirror, or crystal with gaussian, step or file rocking (the
resampled table of K1, differentiated through its argument: the slope of
its linear segment; K5c-file); planar and spherical mosaic crystals by the
survival estimator with reservoir picks (K5d; the picks are hard edges, as
in ``jax.grad`` of the XLA estimator, and the adjoint's per-layer sums run
forward with the layers, so nothing is stored per layer); bilinear images
on any optic; float32.

On CPU tensors the wrappers run the plain PyTorch twins
(:func:`fused_grad_forward_plain`, :func:`fused_grad_vjp_plain`), which
follow the JAX ``_trace_fwd`` / ``_trace_bwd`` (``fused_grad.py:747-1670``)
in the kernels' order of operations, in the dtype of ``pvec``: at float64
they are the truth the float32 kernels are held to.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import splat_bilinear, tent_transpose


class FusedGradUnsupported(ft.FusedUnsupported):
    """Config outside the fused-gradient subset."""


SLOTS_PER_OPTIC = 24
SRC_SLOTS = 8
# pvec's most slots, and so K5's longest chain (XRT_GRAD_MAX_SLOTS,
# XRT_GRAD_MAX_OPTICS of csrc/fused_grad.cu; JAX's fused_grad.py:1709-1711).
MAX_SLOTS = 1024
MAX_OPTICS = 42
_EPS = 1e-12
_SIGMA_PER_FWHM = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
_M32 = 0xFFFFFFFF


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# Build-time structure.
# ---------------------------------------------------------------------------

def check_config(config: dict) -> None:
    """Raise ``FusedGradUnsupported`` for element classes and rocking curves
    outside the subset before a pipeline is built (profiled plasmas are not
    in the kernels; meshes, the mesh mosaic crystal too, raise at the
    build)."""
    from xicsrt_tpu_torch.dispatch import lookup
    from xicsrt_tpu_torch.sources.plasma import PlasmaCubic, PlasmaGeneric

    for section in ("sources", "optics"):
        for name, element in config.get(section, {}).items():
            if element.get("enabled", True) is False:
                continue
            class_name = element.get("class_name")
            try:
                cls = lookup(class_name)
            except KeyError:
                raise FusedGradUnsupported(
                    f'"{name}": {class_name} is outside the fused-gradient '
                    "subset of this port") from None
            if issubclass(cls, PlasmaGeneric) and cls not in (PlasmaGeneric, PlasmaCubic):
                raise FusedGradUnsupported(
                    f'"{name}": {class_name} has profiles that are not constant')
            rocking = str(element.get("rocking_type", "gaussian")).lower()
            if rocking not in ("gaussian", "step", "file"):
                raise FusedGradUnsupported(f"rocking_type {rocking}")


def _grad_source_spec(source) -> dict:
    """K1's generic source spec restricted to counted budgets and no
    filters (``fused_grad.py:89-113``), or a constant-profile plasma's. The
    generic sampling depends on no parameter, so the adjoint is unchanged
    by it; a per-ray wavelength's adjoint ends at the source."""
    from xicsrt_tpu_torch.sources.plasma import PlasmaGeneric

    if isinstance(source, PlasmaGeneric):
        return _grad_plasma_spec(source)
    filters = source.param.get("filters")
    if filters is not None and len(filters) > 0:
        raise FusedGradUnsupported("ray-filtered source")
    try:
        spec = ft._source_spec(source, {})
    except ft.FusedUnsupported as err:
        raise FusedGradUnsupported(str(err)) from None
    if spec["poisson"]:
        raise FusedGradUnsupported("Poisson budget (use counted intensity)")
    spec["n_rays"] = int(source.num_rays)
    return spec


def _grad_plasma_spec(source) -> dict:
    """A plasma of constant profiles with a counted budget and a constant
    spread (``_grad_plasma_spec``, ``fused_grad.py:122-199``), sampled one
    fresh bundle per ray: ``n_rays = max(round(expected), 1)`` rays, each of
    initial weight ``(expected / n_rays) (E / E0)``. Draws per ray: one per
    nonzero box size, 3 voxel offsets (voxel bundles), the cone's u and v,
    one normal and, with a natural linewidth, one Cauchy uniform."""
    from xicsrt_tpu_torch.ops.voigt import doppler_sigma
    from xicsrt_tpu_torch.sources.plasma import PlasmaCubic, PlasmaGeneric

    if type(source) not in (PlasmaGeneric, PlasmaCubic):
        raise FusedGradUnsupported("plasma with profiles that are not constant")
    p = source.param
    filters = p.get("filters")
    if filters is not None and len(filters) > 0:
        raise FusedGradUnsupported("ray-filtered plasma")
    if bool(p["use_poisson"]):
        raise FusedGradUnsupported("Poisson budget (set use_poisson=False)")
    if p.get("spread") is None:
        raise FusedGradUnsupported("spread_radius plasma (use a constant spread)")
    spread = float(p["spread"])
    omega = 4.0 * math.pi * math.sin(spread / 2.0) ** 2
    E0 = float(p["emissivity"])
    if E0 <= 0.0:
        raise FusedGradUnsupported("emissivity must be positive")
    expected = (E0 * float(p["time_resolution"]) * float(p["volume"])
                * omega / (4.0 * math.pi) * float(p["intensity_scale"]))
    n_rays = max(int(round(expected)), 1)
    w0 = float(p["wavelength"])
    voxel = float(source.voxel_size)
    sizes = [float(p[k] or 0.0) for k in ("xsize", "ysize", "zsize")]
    gamma = float(source.gamma)
    return {
        "name": source.name,
        "kind": 2,
        "poisson": False,
        "voxel": voxel,
        "gamma": gamma,
        "wavelength": w0,
        # sigma(T) = sigma_conv sqrt(T), the Doppler width.
        "sigma_conv": doppler_sigma(1.0, float(p["mass_number"]), w0),
        "sizes": sizes,
        "omc": 1.0 - math.cos(spread),
        "velocity": [float(v) for v in np.asarray(p["velocity"], np.float64).reshape(3)],
        "w0_per_E": expected / n_rays / E0,
        "n_rays": n_rays,
        "n_draws": (sum(1 for x in sizes if x != 0.0) + (3 if voxel > 0.0 else 0)
                    + 2 + 1 + (1 if gamma > 0.0 else 0)),
    }


def _grad_optic_spec(optic) -> dict:
    """The K1 optic spec of an analytic shape (``fused_grad.py:294-406``),
    packed in weight mode: a crystal draws nothing, a mosaic crystal (plane
    or sphere, ``fused_grad.py:322-324``) three uniforms per layer. Meshes and
    crystals without their Bragg check stay outside K5, as in JAX."""
    from xicsrt_tpu_torch.optics.mesh_shapes import ShapeMesh

    if isinstance(optic, ShapeMesh):
        raise FusedGradUnsupported(type(optic).__name__)
    if not optic.param.get("check_bragg", True):
        raise FusedGradUnsupported("check_bragg=False crystal")
    try:
        return ft._optic_spec(optic)
    except ft.FusedUnsupported as err:
        raise FusedGradUnsupported(str(err)) from None


def _is_plasma(pipeline) -> bool:
    from xicsrt_tpu_torch.sources.plasma import PlasmaGeneric

    return isinstance(pipeline.source, PlasmaGeneric)


def pack_params(pipeline):
    """``pack(params) -> pvec``: the differentiated leaves of ``params`` as
    one float32 vector (``fused_grad.py:409-447``), padded to a multiple
    of 8. Autograd flows from ``pvec`` back into ``params``."""
    names = [o.name for o in pipeline.optics]
    src_name = pipeline.source.name if _is_plasma(pipeline) else None

    def pack(params):
        vals = []
        for name in names:
            po = params["optics"][name]
            device = po["frame"].origin.device

            def scalar(key, default):
                v = po.get(key, default)
                return torch.as_tensor(v, device=device).reshape(1)

            vals += [po["frame"].origin.reshape(3), po["frame"].basis.reshape(9),
                     scalar("radius", po.get("radius_major", 0.0)),
                     scalar("crystal_spacing", 0.0),
                     scalar("rocking_fwhm", 0.0), scalar("reflectivity", 1.0),
                     scalar("radius_minor", 0.0),
                     torch.zeros(SLOTS_PER_OPTIC - 17, device=device)]
        if src_name is not None:
            ps = params["sources"][src_name]
            device = ps["emissivity"].device
            vals += [ps["emissivity"].reshape(1), ps["temperature"].reshape(1),
                     torch.zeros(SRC_SLOTS - 2, device=device)]
        vec = torch.cat([v.to(torch.float32) for v in vals])
        pad = _round_up(vec.numel(), 8) - vec.numel()
        return torch.nn.functional.pad(vec, (0, pad))

    return pack


def unpack_grads(pipeline, gvec) -> dict:
    """Map the flat gradient vector to ``{element: {leaf: numpy}}``
    (``fused_grad.py:450-475``); slot 12 is radius_major on a torus."""
    g = np.asarray(torch.as_tensor(gvec).detach().cpu(), dtype=np.float64)
    out = {}
    for i, o in enumerate(pipeline.optics):
        b = i * SLOTS_PER_OPTIC
        out[o.name] = {
            "origin": g[b:b + 3].copy(),
            "basis": g[b + 3:b + 12].reshape(3, 3).copy(),
            "radius": float(g[b + 12]),
            "crystal_spacing": float(g[b + 13]),
            "rocking_fwhm": float(g[b + 14]),
            "reflectivity": float(g[b + 15]),
            "radius_minor": float(g[b + 16]),
        }
    if _is_plasma(pipeline):
        b = len(pipeline.optics) * SLOTS_PER_OPTIC
        out[pipeline.source.name] = {"emissivity": float(g[b]),
                                     "temperature": float(g[b + 1])}
    return out


# ---------------------------------------------------------------------------
# The kernels' plain twins.
# ---------------------------------------------------------------------------

def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def file_slope_plain(T, inv_step: float, f, k):
    """The slope in delta of a file curve's segment at the clipped index
    ``f`` (floor ``k``), the adjoint's (JAX ``_file_interp``'s tent
    derivative, ``fused_grad.py:679-686``): (T[k+1] - T[k]) inv_step
    strictly inside a segment, exactly 0 where f lands on a node (sign(0)
    = 0)."""
    ki = k.long()
    t0, t1 = (T[i].to(f.dtype) for i in (ki, torch.clamp(ki + 1, max=T.shape[0] - 1)))
    return torch.where(f == k, 0.0, (t1 - t0) * inv_step)


def _rock_fwd(o, oi, aux, P, b, delta):
    """The rocking curve at ``delta`` (``_rock_fwd``, ``fused_grad.py:
    690-716``): (prob, the locals its adjoint needs)."""
    fwhm, refl = P[b + 14], P[b + 15]
    if oi[3] == 0:  # gaussian
        sigma = torch.clamp_min(fwhm * _SIGMA_PER_FWHM, _EPS)
        z = delta / sigma
        return refl * torch.exp(-0.5 * z * z), {"sigma": sigma, "z": z, "refl": refl}
    if oi[3] == 1:  # step: hard edges, zero gradient in delta and fwhm
        inside = torch.abs(delta) <= fwhm / 2.0
        return torch.where(inside, refl, 0.0), {"step_in": inside, "refl": refl}
    # file: the static table, its gradient through delta only
    T = aux[oi[ft.OI_TABLE]:oi[ft.OI_TABLE] + oi[ft.OI_K]]
    val, inr, f, k = ft.file_value_plain(T, o[ft.O_LO], o[ft.O_INV_STEP], delta)
    return torch.where(inr, refl * val, 0.0), {
        "file_val": val, "file_in": inr, "refl": refl,
        "file_slope": file_slope_plain(T, o[ft.O_INV_STEP], f, k)}


def _rock_unit(oi, prob, r, zeros):
    """The rocking curve's adjoint per unit cotangent of ``prob``
    (``_rock_bwd``, ``fused_grad.py:719-744``): (d delta, d rocking_fwhm's
    sigma, d reflectivity)."""
    if oi[3] == 0:
        z, sigma = r["z"], r["sigma"]
        return (prob * (-z / sigma), prob * (z * z / sigma),
                prob / torch.clamp_min(r["refl"], _EPS))
    if oi[3] == 1:
        return zeros, zeros, r["step_in"].to(zeros.dtype)
    inf_ = r["file_in"].to(zeros.dtype)
    return r["refl"] * r["file_slope"] * inf_, zeros, r["file_val"] * inf_


def _mosaic_fwd(o, oi, aux, P, b, d, n, sin_b, cos_b, mask, draw, s):
    """The mosaic crystal's weight-mode forward (``fused_grad.py:1049-1130``,
    the survival estimator with reservoir picks, three draws per layer) and
    what its adjoint needs, without a per-layer store: with cum = sum_l q_l,
    q_l = p_l prod_{j<l} (1 - p_j), the cotangent of p_l is cum_b prod_{j !=
    l} (1 - p_j), so each of the adjoint's six per-layer sums (the Bragg
    chain's d(d.n_l) times gx_l w_l, gy_l w_l and w_l, and its d sin_b,
    d sigma and d reflectivity) runs forward as V <- V (1 - p_l) + prod_{j<l}
    (1 - p_j) X_l, with no division by 1 - p_l. The last pick's normal and
    coefficients route the direction's adjoint. Returns (direction, mask,
    cum); the locals go into ``s``."""
    d0x, d0y, d0z = d
    nxv, nyv, nzv = n
    if o[ft.O_MOSAIC_CUT] >= 0.0:  # a hard mask, zero gradient
        adot0 = torch.abs(d0x * nxv + d0y * nyv + d0z * nzv)
        cosi0 = torch.sqrt(torch.clamp_min(1.0 - adot0 * adot0, _EPS))
        sd0 = adot0 * cos_b - cosi0 * sin_b
        mask = mask & (torch.abs(sd0 + sd0 * sd0 * sd0 * (1.0 / 6.0)) < o[ft.O_MOSAIC_CUT])
    o1, o2, inv1, inv2 = ft.mosaic_basis_plain(nxv, nyv, nzv)
    zeros = torch.zeros_like(d0x)
    surv, cum = zeros + 1.0, zeros
    cdx, cdy, cdz = d0x, d0y, d0z
    V = [zeros] * 6
    pick_nm, pick_dot, pick_c = (zeros, zeros, zeros), zeros, (zeros, zeros, zeros)
    picked = torch.zeros_like(mask)
    sigma_n = o[ft.O_MOSAIC_SIGMA]
    for _ in range(oi[ft.OI_DEPTH]):
        (nmx, nmy, nmz), gxw, gyw, wn = ft.mosaic_normal_plain(draw, sigma_n, o1, o2, n)
        dotm = d0x * nmx + d0y * nmy + d0z * nmz
        adot = torch.abs(dotm)
        cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, _EPS))
        sd = adot * cos_b - cosi * sin_b
        delta = sd + sd * sd * sd * (1.0 / 6.0)
        prob, r = _rock_fwd(o, oi, aux, P, b, delta)
        q = prob * surv
        cum_new = cum + q
        pick = mask & (draw() * cum_new < q)
        kk = 2.0 * dotm
        cdx = torch.where(pick, d0x - kk * nmx, cdx)
        cdy = torch.where(pick, d0y - kk * nmy, cdy)
        cdz = torch.where(pick, d0z - kk * nmz, cdz)
        delta_u, sig_u, refl_u = _rock_unit(oi, prob, r, zeros)
        sd_u = delta_u * (1.0 + 0.5 * sd * sd)
        adot_u = sd_u * (cos_b + adot / cosi * sin_b)
        sinb_u = sd_u * (-adot * sin_b / cos_b - cosi)
        dot_u = torch.sign(dotm) * adot_u
        keep = 1.0 - prob
        V = [v * keep + surv * x for v, x in
             zip(V, (gxw * dot_u, gyw * dot_u, wn * dot_u, sinb_u, sig_u, refl_u))]
        pick_nm = tuple(torch.where(pick, a, old) for a, old in zip((nmx, nmy, nmz), pick_nm))
        pick_dot = torch.where(pick, dotm, pick_dot)
        pick_c = tuple(torch.where(pick, a, old) for a, old in zip((gxw, gyw, wn), pick_c))
        picked = picked | pick
        surv = surv * keep
        cum = cum_new
    s.update(cum=cum, V=V, pick_nm=pick_nm, pick_dot=pick_dot, pick_c=pick_c,
             picked=picked, o1=o1, o2=o2, inv1=inv1, inv2=inv2)
    return (cdx, cdy, cdz), mask, cum


def _mosaic_bwd(s, n, d0, db, cum_b):
    """The mosaic crystal's adjoint from its forward's sums (the reverse of
    ``fused_grad.py:1281-1400``): returns (d d_pre, d n, d sin_b, d sigma,
    d reflectivity)."""
    (nxv, nyv, nzv), (d0x, d0y, d0z), (dbx, dby, dbz) = n, d0, db
    A2, A1, An, sinb, sig, refl = (cum_b * v for v in s["V"])
    # The direction's adjoint goes to the last pick's reflection.
    pnx, pny, pnz = s["pick_nm"]
    pf = s["picked"].to(cum_b.dtype)
    a = dbx * pnx + dby * pny + dbz * pnz
    pnbx = -2.0 * pf * (a * d0x + s["pick_dot"] * dbx)
    pnby = -2.0 * pf * (a * d0y + s["pick_dot"] * dby)
    pnbz = -2.0 * pf * (a * d0z + s["pick_dot"] * dbz)
    gxw, gyw, wn = s["pick_c"]
    (o1x, o1y, o1z), (o2x, o2y, o2z) = s["o1"], s["o2"]
    d0bx = dbx - 2.0 * pf * a * pnx + A2 * o2x + A1 * o1x + An * nxv
    d0by = dby - 2.0 * pf * a * pny + A2 * o2y + A1 * o1y + An * nyv
    d0bz = dbz - 2.0 * pf * a * pnz + A2 * o2z + A1 * o1z + An * nzv
    # nm_l = gx_l w_l o2 + gy_l w_l o1 + w_l n, and every layer's dot chain
    # adds its d(d.n_l) d_pre.
    o2bx, o2by, o2bz = A2 * d0x + gxw * pnbx, A2 * d0y + gxw * pnby, A2 * d0z + gxw * pnbz
    o1bx, o1by, o1bz = A1 * d0x + gyw * pnbx, A1 * d0y + gyw * pnby, A1 * d0z + gyw * pnbz
    nbx, nby, nbz = An * d0x + wn * pnbx, An * d0y + wn * pnby, An * d0z + wn * pnbz
    # o2 = normalize(n x o1): d o2_raw, then the cross product's two sides.
    o2d = o2x * o2bx + o2y * o2by + o2z * o2bz
    o2rbx = s["inv2"] * (o2bx - o2x * o2d)
    o2rby = s["inv2"] * (o2by - o2y * o2d)
    o2rbz = s["inv2"] * (o2bz - o2z * o2d)
    nbx = nbx + (o1y * o2rbz - o1z * o2rby)
    nby = nby + (o1z * o2rbx - o1x * o2rbz)
    nbz = nbz + (o1x * o2rby - o1y * o2rbx)
    o1bx = o1bx + (o2rby * nzv - o2rbz * nyv)
    o1by = o1by + (o2rbz * nxv - o2rbx * nzv)
    o1bz = o1bz + (o2rbx * nyv - o2rby * nxv)
    # o1 = normalize(ny, nz - nx, -ny).
    o1d = o1x * o1bx + o1y * o1by + o1z * o1bz
    o1rbx = s["inv1"] * (o1bx - o1x * o1d)
    o1rby = s["inv1"] * (o1by - o1y * o1d)
    o1rbz = s["inv1"] * (o1bz - o1z * o1d)
    nbx = nbx - o1rby
    nby = nby + o1rbx - o1rbz
    nbz = nbz + o1rby
    return (d0bx, d0by, d0bz), (nbx, nby, nbz), sinb, sig, refl


def _optic_fwd(F, I, aux, e, P, lam, state, draw=None):
    """Weight-mode forward of optic ``e`` (``_trace_fwd``,
    ``fused_grad.py:747-1158``, for planes, spheres, cylinders and tori with
    no interaction, a mirror, a crystal or a mosaic crystal; ``aux``: the
    packed aux buffer, a file curve's table; ``draw``: the ray's draws, a
    mosaic crystal's three per layer). ``lam``: the wavelength, a 0-d
    tensor or one per ray (a true division, as the kernel's; PyTorch
    multiplies a Python scalar by the reciprocal). ``state``: (px, py, pz,
    dx, dy, dz, w, alive) entering the optic. Returns (state leaving it, the
    locals the adjoint needs, (w_img, fx, fy) or None)."""
    px, py, pz, dx, dy, dz, w, alive = state
    o = F[ft.SRC_F + e * ft.OPT_F: ft.SRC_F + (e + 1) * ft.OPT_F]
    oi = I[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
    b = e * SLOTS_PER_OPTIC
    oxp, oyp, ozp = P[b], P[b + 1], P[b + 2]
    bxx, bxy, bxz = P[b + 3], P[b + 4], P[b + 5]
    byx, byy, byz = P[b + 6], P[b + 7], P[b + 8]
    bzx, bzy, bzz = P[b + 9], P[b + 10], P[b + 11]

    def full(value):
        return torch.full(px.shape, value, dtype=px.dtype, device=px.device)

    s = {"dpre": (dx, dy, dz)}
    shape = oi[0]
    if shape == 0:  # plane
        D = dx * bzx + dy * bzy + dz * bzz
        D = torch.where(torch.abs(D) > 1e-30, D, 1e-30)
        N = (oxp - px) * bzx + (oyp - py) * bzy + (ozp - pz) * bzz
        t = N / D
        mask = alive & (t >= 0.0)
        s["D"] = D
    elif shape == 1:  # sphere, center o + sign r bz
        r = P[b + 12]
        sign = -1.0 if oi[1] else 1.0
        Cx, Cy, Cz = oxp + sign * r * bzx, oyp + sign * r * bzy, ozp + sign * r * bzz
        Lx, Ly, Lz = Cx - px, Cy - py, Cz - pz
        t_ca = Lx * dx + Ly * dy + Lz * dz
        d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca
        r2 = r * r
        mask = alive & (d2 <= r2)
        t_hc = torch.sqrt(torch.clamp_min(r2 - d2, _EPS))
        t = t_ca - t_hc if oi[1] else t_ca + t_hc
        s.update(Lx=Lx, Ly=Ly, Lz=Lz, t_ca=t_ca, t_hc=t_hc, r=r)
    elif shape == 2:  # torus of axis by, center o + center_sign R bz
        Rmj, rmn = P[b + 12], P[b + 16]
        r_maj = Rmj + o[ft.O_MAJOR_ADJUST] * rmn
        cs = o[ft.O_CENTER_SIGN]
        Cx, Cy, Cz = oxp + cs * Rmj * bzx, oyp + cs * Rmj * bzy, ozp + cs * Rmj * bzz
        rx, ry, rz = px - Cx, py - Cy, pz - Cz
        Olx, Oly, Olz = _dot3(rx, ry, rz, bxx, bxy, bxz), _dot3(rx, ry, rz, byx, byy, byz), \
            _dot3(rx, ry, rz, bzx, bzy, bzz)
        Dlx, Dly, Dlz = _dot3(dx, dy, dz, bxx, bxy, bxz), _dot3(dx, dy, dz, byx, byy, byz), \
            _dot3(dx, dy, dz, bzx, bzy, bzz)
        # The root on detached copies (the kernels' shared Newton root); the
        # gradient flows through one Newton correction at the frozen root,
        # the implicit-function derivative (fused_grad.py:819-876).
        z0 = (px - oxp) * bzx + (py - oyp) * bzy + (pz - ozp) * bzz
        rmaj0 = r_maj.detach()
        t0, step = ft.torus_root_plain(
            Olx.detach(), Oly.detach(), Olz.detach(), Dlx.detach(), Dly.detach(),
            Dlz.detach(), z0.detach(), rmaj0, (rmn * rmn).detach(), full)
        m_int = ((torch.abs(step) < 1e-5 * torch.clamp_min(rmaj0, 1.0))
                 & (t0 > 1e-6) & (t0 < 1e6))
        mask = alive & m_int
        t0s = torch.where(m_int, t0, 0.0)
        X, Y, Z = Olx + t0s * Dlx, Oly + t0s * Dly, Olz + t0s * Dlz
        rho = torch.sqrt(torch.clamp_min(X * X + Z * Z, 1e-30))
        rr = rho - r_maj
        G = rr * rr + Y * Y - rmn * rmn
        rhop = (X * Dlx + Z * Dlz) / rho
        Gp = 2.0 * rr * rhop + 2.0 * Y * Dly
        Gp = torch.where(torch.abs(Gp) > 1e-9, Gp, torch.where(Gp >= 0.0, 1e-9, -1e-9))
        t = torch.where(m_int, t0s - G / Gp, 0.0)
        s.update(t0s=t0s, X=X, Y=Y, Z=Z, rho=rho, rr=rr, G=G, rhop=rhop, Gp=Gp,
                 m_int=m_int, Dlx=Dlx, Dly=Dly, Dlz=Dlz, rx=rx, ry=ry, rz=rz,
                 Cx=Cx, Cy=Cy, Cz=Cz, r_maj=r_maj, Rmj=Rmj, rmn=rmn)
    else:  # cylinder of axis bx, center o + sign r bz
        r = P[b + 12]
        sign = -1.0 if oi[1] else 1.0
        Cx, Cy, Cz = oxp + sign * r * bzx, oyp + sign * r * bzy, ozp + sign * r * bzz
        h = ft.cylinder_hit_plain((Cx, Cy, Cz), (bxx, bxy, bxz), r * r, bool(oi[1]),
                                  (px, py, pz), (dx, dy, dz), full)
        mask = alive & (h["disc"] >= 0.0)
        t = h["t"]
        s.update(h, Cx=Cx, Cy=Cy, Cz=Cz, r=r)
    qx, qy, qz = px + t * dx, py + t * dy, pz + t * dz
    if shape == 0:
        nxv, nyv, nzv = bzx, bzy, bzz
    elif shape == 1:  # toward the center for both convexities; |C - q| = r
        inv_r = 1.0 / torch.clamp_min(r, _EPS)
        nxv, nyv, nzv = (Cx - qx) * inv_r, (Cy - qy) * inv_r, (Cz - qz) * inv_r
        s["inv_r"] = inv_r
    elif shape == 2:  # from the tube centre (q projected on the axis circle)
        ptx, pty, ptz = qx - Cx, qy - Cy, qz - Cz
        dy_ax = _dot3(ptx, pty, ptz, byx, byy, byz)
        plx, ply, plz = ptx - dy_ax * byx, pty - dy_ax * byy, ptz - dy_ax * byz
        inv_pl = ft._inv_sqrt(torch.clamp_min(plx * plx + ply * ply + plz * plz, 1e-30))
        tux, tuy, tuz = plx * inv_pl, ply * inv_pl, plz * inv_pl
        tmx, tmy, tmz = ptx - r_maj * tux, pty - r_maj * tuy, ptz - r_maj * tuz
        inv_m = ft._inv_sqrt(torch.clamp_min(tmx * tmx + tmy * tmy + tmz * tmz, 1e-30))
        nxv, nyv, nzv = tmx * inv_m, tmy * inv_m, tmz * inv_m
        s.update(ptx=ptx, pty=pty, ptz=ptz, dy_ax=dy_ax, inv_pl=inv_pl, tux=tux,
                 tuy=tuy, tuz=tuz, inv_m=inv_m)
    else:  # toward the axis
        tcx, tcy, tcz = Cx - qx, Cy - qy, Cz - qz
        along = _dot3(tcx, tcy, tcz, bxx, bxy, bxz)
        ux, uy, uz = tcx - along * bxx, tcy - along * bxy, tcz - along * bxz
        inv_u = ft._inv_sqrt(torch.clamp_min(ux * ux + uy * uy + uz * uz, 1e-30))
        nxv, nyv, nzv = ux * inv_u, uy * inv_u, uz * inv_u
        s.update(tcx=tcx, tcy=tcy, tcz=tcz, along=along, inv_u=inv_u)
    rxq, ryq, rzq = qx - oxp, qy - oyp, qz - ozp
    lxv = rxq * bxx + ryq * bxy + rzq * bxz
    lyv = rxq * byx + ryq * byy + rzq * byz
    mask = ft.bounds_plain(mask, o, oi, lxv, lyv, (rxq, ryq, rzq), (bzx, bzy, bzz))
    mask = ft.aperture_logic_plain(F, I, oi, lxv, lyv, mask)

    if oi[2] in (1, 2):
        dot = dx * nxv + dy * nyv + dz * nzv
        s["dot"] = dot
    if oi[2] in (1, 3):  # the Bragg angle at the ray's wavelength
        d_s = P[b + 13]
        sin_b = torch.clamp(lam / (2.0 * torch.clamp_min(d_s, _EPS)), 0.0, 1.0)
        cos_b = torch.sqrt(torch.clamp_min(1.0 - sin_b * sin_b, _EPS))
        s.update(w_pre=w, sin_b=sin_b, cos_b=cos_b, d_s=d_s, lam=lam)
    if oi[2] == 1:  # crystal
        adot = torch.abs(dot)
        cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, _EPS))
        sd = adot * cos_b - cosi * sin_b
        delta = sd + sd * sd * sd * (1.0 / 6.0)
        prob, r = _rock_fwd(o, oi, aux, P, b, delta)
        s.update(r, adot=adot, cosi=cosi, sd=sd, prob=prob)
        w = torch.where(mask, w * prob, w)
    elif oi[2] == 3:  # mosaic crystal
        (dx, dy, dz), mask, cum = _mosaic_fwd(o, oi, aux, P, b, (dx, dy, dz),
                                              (nxv, nyv, nzv), sin_b, cos_b, mask, draw, s)
        w = torch.where(mask, w * cum, w)
    if oi[2] in (1, 2):  # crystal or mirror: reflect
        kk = 2.0 * dot
        dx = torch.where(mask, dx - kk * nxv, dx)
        dy = torch.where(mask, dy - kk * nyv, dy)
        dz = torch.where(mask, dz - kk * nzv, dz)

    img = None
    if oi[7] >= 0:
        fx = lxv * o[23] + o[24]
        fy = lyv * o[23] + o[25]
        img = (torch.where(mask, w, 0.0), fx, fy)
    s.update(t=t, qx=qx, qy=qy, qz=qz, nxv=nxv, nyv=nyv, nzv=nzv, mask=mask)
    return (qx, qy, qz, dx, dy, dz, w, mask), s, img


def _clipped(f, n: int):
    """The kernels' clip of a pixel coordinate to [-2, n + 1]
    (``fused_grad.py:1795-1796``): an off-grid hit stays off the grid."""
    return torch.clamp(f, -2.0, n + 1.0)


def _splat(nx: int, ny: int, w_img, fx, fy):
    """The flat bilinear image of one optic over a slice of rays."""
    return splat_bilinear(_clipped(fx, nx), _clipped(fy, ny), w_img, nx, ny).reshape(-1)


def _seeds(g_flat, off: int, nx: int, ny: int, w_img, fx, fy):
    """Cotangent seeds (gw, glx, gly) of one imaged optic: the cotangent
    image gathered at each hit's four corners with tent weights and tent
    slopes (``fused_grad.py:1812-1853``, a gather here, not a matmul)."""
    glx, gly, gw = tent_transpose(_clipped(fx, nx), _clipped(fy, ny), w_img,
                                  g_flat[off:off + nx * ny], nx, ny)
    return gw, glx, gly


def _optic_bwd(F, I, e, P, s, seed, carry, add_slot):
    """Hand adjoint of optic ``e`` (``_trace_bwd``, ``fused_grad.py:
    1161-1670``, for this subset). ``carry``: (pb, db, wb, lamb) adjoints of
    the position, direction and weight leaving the optic and of the ray's
    wavelength; returns them for the state entering it. ``add_slot(k,
    values)`` accumulates slot ``e*24+k``."""
    (pbx, pby, pbz), (dbx, dby, dbz), wb, lamb = carry
    o = F[ft.SRC_F + e * ft.OPT_F: ft.SRC_F + (e + 1) * ft.OPT_F]
    oi = I[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
    b = e * SLOTS_PER_OPTIC
    oxp, oyp, ozp = P[b], P[b + 1], P[b + 2]
    bxx, bxy, bxz = P[b + 3], P[b + 4], P[b + 5]
    byx, byy, byz = P[b + 6], P[b + 7], P[b + 8]
    bzx, bzy, bzz = P[b + 9], P[b + 10], P[b + 11]
    mask = s["mask"]
    mf = mask.to(wb.dtype)
    zeros = torch.zeros_like(wb)
    nxv, nyv, nzv = s["nxv"], s["nyv"], s["nzv"]
    d0x, d0y, d0z = s["dpre"]
    shape = oi[0]

    qbx, qby, qbz = pbx, pby, pbz
    lxb = lyb = zeros
    if seed is not None:
        gw, glx, gly = seed
        wb = wb + gw * mf
        lxb = glx * mf
        lyb = gly * mf

    # ---- interaction: d_post = d_pre - 2 (d_pre . n) n where mask -------
    nbx = nby = nbz = zeros
    sinb_b = None
    if oi[2] == 3:  # mosaic: w_post = where(mask, w_pre cum, w_pre)
        cum_b = torch.where(mask, wb * s["w_pre"], 0.0)
        wb = torch.where(mask, wb * s["cum"], wb)
        (dbx, dby, dbz), (nbx, nby, nbz), sinb_b, sig_b, refl_b = _mosaic_bwd(
            s, (nxv, nyv, nzv), (d0x, d0y, d0z), (dbx, dby, dbz), cum_b)
        add_slot(14, sig_b * _SIGMA_PER_FWHM)
        add_slot(15, refl_b)
    if oi[2] in (1, 2):
        dot = s["dot"]
        a = dbx * nxv + dby * nyv + dbz * nzv
        dpre_bx = torch.where(mask, dbx - 2.0 * a * nxv, dbx)
        dpre_by = torch.where(mask, dby - 2.0 * a * nyv, dby)
        dpre_bz = torch.where(mask, dbz - 2.0 * a * nzv, dbz)
        nbx = nbx - mf * 2.0 * (a * d0x + dot * dbx)
        nby = nby - mf * 2.0 * (a * d0y + dot * dby)
        nbz = nbz - mf * 2.0 * (a * d0z + dot * dbz)
        dbx, dby, dbz = dpre_bx, dpre_by, dpre_bz
        dot_b = zeros
        if oi[2] == 1:  # crystal: w_post = where(mask, w_pre * prob, w_pre)
            prob = s["prob"]
            prob_b = torch.where(mask, wb * s["w_pre"], 0.0)
            wb = torch.where(mask, wb * prob, wb)
            if oi[3] == 0:
                sigma, z = s["sigma"], s["z"]
                delta_b = prob_b * prob * (-z / sigma)
                sigma_b = prob_b * prob * (z * z / sigma)
                refl_b = prob_b * (prob / torch.clamp_min(s["refl"], _EPS))
                add_slot(14, sigma_b * mf * _SIGMA_PER_FWHM)
            elif oi[3] == 1:
                refl_b = prob_b * s["step_in"].to(wb.dtype)
                delta_b = zeros
            else:  # fused_grad.py:739-742
                inf_ = s["file_in"].to(wb.dtype)
                refl_b = prob_b * s["file_val"] * inf_
                delta_b = prob_b * s["refl"] * s["file_slope"] * inf_
            add_slot(15, refl_b * mf)
            sd = s["sd"]
            sd_b = delta_b * (1.0 + 0.5 * sd * sd)
            adot_b = sd_b * (s["cos_b"] + s["adot"] / s["cosi"] * s["sin_b"])
            sinb_b = sd_b * (-s["adot"] * s["sin_b"] / s["cos_b"] - s["cosi"])
            dot_b = torch.sign(dot) * adot_b * mf
        dbx = dbx + dot_b * nxv
        dby = dby + dot_b * nyv
        dbz = dbz + dot_b * nzv
        nbx = nbx + dot_b * d0x
        nby = nby + dot_b * d0y
        nbz = nbz + dot_b * d0z
    if sinb_b is not None:  # sin_b = lam / (2 d_s), a crystal's or a mosaic's
        d_s = s["d_s"]
        ds_b = sinb_b * (-s["lam"] / (2.0 * torch.clamp_min(d_s * d_s, _EPS)))
        inr = (s["sin_b"] > 0.0) & (s["sin_b"] < 1.0)
        add_slot(13, torch.where(inr, ds_b, 0.0) * mf)
        # The wavelength's adjoint, which a plasma carries to its
        # temperature slot (fused_grad.py:1268).
        lamb = lamb + torch.where(
            inr, sinb_b / (2.0 * torch.clamp_min(d_s, _EPS)), 0.0) * mf

    # ---- local coordinates: lx = bx . (q - o), ly = by . (q - o) ---------
    if oi[7] >= 0:
        lxb = lxb * o[23]
        lyb = lyb * o[23]
    rxq, ryq, rzq = s["qx"] - oxp, s["qy"] - oyp, s["qz"] - ozp
    qbx = qbx + lxb * bxx + lyb * byx
    qby = qby + lxb * bxy + lyb * byy
    qbz = qbz + lxb * bxz + lyb * byz
    add_slot(0, -(lxb * bxx + lyb * byx))
    add_slot(1, -(lxb * bxy + lyb * byy))
    add_slot(2, -(lxb * bxz + lyb * byz))
    add_slot(3, lxb * rxq)
    add_slot(4, lxb * ryq)
    add_slot(5, lxb * rzq)
    add_slot(6, lyb * rxq)
    add_slot(7, lyb * ryq)
    add_slot(8, lyb * rzq)

    # ---- normal ----------------------------------------------------------
    axbx = axby = axbz = zeros  # adjoint of the bx row (the cylinder's axis)
    Cbx = Cby = Cbz = r_b_n = zeros
    if shape == 0:  # n = bz
        add_slot(9, nbx)
        add_slot(10, nby)
        add_slot(11, nbz)
    elif shape == 1:  # n = (C - q) / r
        inv_r = s["inv_r"]
        Cbx, Cby, Cbz = inv_r * nbx, inv_r * nby, inv_r * nbz
        qbx, qby, qbz = qbx - Cbx, qby - Cby, qbz - Cbz
        ndot = nxv * nbx + nyv * nby + nzv * nbz
        r_b_n = -ndot * inv_r * s["r"] * inv_r
    elif shape == 2:  # n = normalize(pt - r_maj u), u = normalize(pl)
        inv_m = s["inv_m"]
        ndot = nxv * nbx + nyv * nby + nzv * nbz
        mbx, mby, mbz = (inv_m * (nbx - nxv * ndot), inv_m * (nby - nyv * ndot),
                         inv_m * (nbz - nzv * ndot))
        ptbx, ptby, ptbz = mbx, mby, mbz
        ubx, uby, ubz = -s["r_maj"] * mbx, -s["r_maj"] * mby, -s["r_maj"] * mbz
        r_b_n = -(mbx * s["tux"] + mby * s["tuy"] + mbz * s["tuz"])
        udot = s["tux"] * ubx + s["tuy"] * uby + s["tuz"] * ubz
        plbx = s["inv_pl"] * (ubx - s["tux"] * udot)
        plby = s["inv_pl"] * (uby - s["tuy"] * udot)
        plbz = s["inv_pl"] * (ubz - s["tuz"] * udot)
        ptbx, ptby, ptbz = ptbx + plbx, ptby + plby, ptbz + plbz
        dyax_b = -(plbx * byx + plby * byy + plbz * byz)
        add_slot(6, -s["dy_ax"] * plbx + dyax_b * s["ptx"])
        add_slot(7, -s["dy_ax"] * plby + dyax_b * s["pty"])
        add_slot(8, -s["dy_ax"] * plbz + dyax_b * s["ptz"])
        ptbx, ptby, ptbz = ptbx + dyax_b * byx, ptby + dyax_b * byy, ptbz + dyax_b * byz
        qbx, qby, qbz = qbx + ptbx, qby + ptby, qbz + ptbz
        Cbx, Cby, Cbz = -ptbx, -ptby, -ptbz
    else:  # n = normalize(u), u = tc - (tc . bx) bx, tc = C - q
        inv_u = s["inv_u"]
        ndot = nxv * nbx + nyv * nby + nzv * nbz
        ubx, uby, ubz = (inv_u * (nbx - nxv * ndot), inv_u * (nby - nyv * ndot),
                         inv_u * (nbz - nzv * ndot))
        au = ubx * bxx + uby * bxy + ubz * bxz
        Cbx, Cby, Cbz = ubx - au * bxx, uby - au * bxy, ubz - au * bxz
        axbx = axbx - au * s["tcx"] - s["along"] * ubx
        axby = axby - au * s["tcy"] - s["along"] * uby
        axbz = axbz - au * s["tcz"] - s["along"] * ubz
        qbx, qby, qbz = qbx - Cbx, qby - Cby, qbz - Cbz

    # ---- hit: q = p + t d --------------------------------------------------
    t = s["t"]
    t_b = qbx * d0x + qby * d0y + qbz * d0z
    pbx, pby, pbz = qbx, qby, qbz
    dbx, dby, dbz = dbx + t * qbx, dby + t * qby, dbz + t * qbz
    if shape == 0:  # t = ((o - p) . bz) / (d . bz)
        invD = 1.0 / s["D"]
        pbx = pbx - t_b * bzx * invD
        pby = pby - t_b * bzy * invD
        pbz = pbz - t_b * bzz * invD
        dbx = dbx - t_b * t * bzx * invD
        dby = dby - t_b * t * bzy * invD
        dbz = dbz - t_b * t * bzz * invD
        add_slot(0, t_b * bzx * invD)
        add_slot(1, t_b * bzy * invD)
        add_slot(2, t_b * bzz * invD)
        add_slot(9, t_b * (oxp - s["qx"]) * invD)
        add_slot(10, t_b * (oyp - s["qy"]) * invD)
        add_slot(11, t_b * (ozp - s["qz"]) * invD)
        return (pbx, pby, pbz), (dbx, dby, dbz), wb, lamb
    sign_c = -1.0 if oi[1] else 1.0
    if shape == 1:  # t = t_ca -+ t_hc, L = C - p
        t_hc = torch.clamp_min(s["t_hc"], 1e-6)
        t_ca = s["t_ca"]
        cx = d0x + sign_c * (t_ca * d0x - s["Lx"]) / t_hc
        cy = d0y + sign_c * (t_ca * d0y - s["Ly"]) / t_hc
        cz = d0z + sign_c * (t_ca * d0z - s["Lz"]) / t_hc
        Cbx, Cby, Cbz = Cbx + t_b * cx, Cby + t_b * cy, Cbz + t_b * cz
        pbx, pby, pbz = pbx - t_b * cx, pby - t_b * cy, pbz - t_b * cz
        dbx = dbx + t_b * s["Lx"] * (1.0 + sign_c * t_ca / t_hc)
        dby = dby + t_b * s["Ly"] * (1.0 + sign_c * t_ca / t_hc)
        dbz = dbz + t_b * s["Lz"] * (1.0 + sign_c * t_ca / t_hc)
        r_b = r_b_n + t_b * sign_c * s["r"] / t_hc
    elif shape == 3:
        # Implicit differentiation of qa t^2 + qb t + qc = 0 at the chosen
        # root: F'(t) = 2 qa t + qb, grazing rays guarded.
        Fp = 2.0 * s["qa"] * t + s["qb"]
        Fp = torch.where(torch.abs(Fp) > 1e-9, Fp, torch.where(Fp >= 0.0, 1e-9, -1e-9))
        ab, bb, cb = -t_b * t * t / Fp, -t_b * t / Fp, -t_b / Fp
        A1bx = 2.0 * ab * s["A1x"] + 2.0 * bb * s["B1x"]
        A1by = 2.0 * ab * s["A1y"] + 2.0 * bb * s["B1y"]
        A1bz = 2.0 * ab * s["A1z"] + 2.0 * bb * s["B1z"]
        B1bx = 2.0 * bb * s["A1x"] + 2.0 * cb * s["B1x"]
        B1by = 2.0 * bb * s["A1y"] + 2.0 * cb * s["B1y"]
        B1bz = 2.0 * bb * s["A1z"] + 2.0 * cb * s["B1z"]
        r_b = r_b_n - 2.0 * cb * s["r"]
        aA = A1bx * bxx + A1by * bxy + A1bz * bxz  # A1 = d - (d . ax) ax
        dbx, dby, dbz = dbx + A1bx - aA * bxx, dby + A1by - aA * bxy, dbz + A1bz - aA * bxz
        axbx = axbx - aA * d0x - s["d_ax"] * A1bx
        axby = axby - aA * d0y - s["d_ax"] * A1by
        axbz = axbz - aA * d0z - s["d_ax"] * A1bz
        aB = B1bx * bxx + B1by * bxy + B1bz * bxz  # B1 = dp - (dp . ax) ax
        dpbx, dpby, dpbz = B1bx - aB * bxx, B1by - aB * bxy, B1bz - aB * bxz
        axbx = axbx - aB * s["dpx"] - s["p_ax"] * B1bx
        axby = axby - aB * s["dpy"] - s["p_ax"] * B1by
        axbz = axbz - aB * s["dpz"] - s["p_ax"] * B1bz
        pbx, pby, pbz = pbx + dpbx, pby + dpby, pbz + dpbz
        Cbx, Cby, Cbz = Cbx - dpbx, Cby - dpby, Cbz - dpbz
        add_slot(3, axbx)
        add_slot(4, axby)
        add_slot(5, axbz)
    if shape in (1, 3):  # C = o + sign_c r bz
        add_slot(0, Cbx)
        add_slot(1, Cby)
        add_slot(2, Cbz)
        add_slot(9, sign_c * s["r"] * Cbx)
        add_slot(10, sign_c * s["r"] * Cby)
        add_slot(11, sign_c * s["r"] * Cbz)
        add_slot(12, r_b + sign_c * (bzx * Cbx + bzy * Cby + bzz * Cbz))
        return (pbx, pby, pbz), (dbx, dby, dbz), wb, lamb

    # Torus: t = where(m_int, t0 - G / G', 0) at the frozen root t0, the
    # implicit-function derivative plus the quotient term through G'.
    tb = t_b * s["m_int"].to(wb.dtype)
    Gp = s["Gp"]
    G_b = -tb / Gp
    Gp_b = (torch.abs(Gp) > 1e-9).to(wb.dtype) * tb * s["G"] / (Gp * Gp)
    rr, rhop, rho = s["rr"], s["rhop"], s["rho"]
    X, Y, Z = s["X"], s["Y"], s["Z"]
    Dlx, Dly, Dlz = s["Dlx"], s["Dly"], s["Dlz"]
    rr_b = 2.0 * rhop * Gp_b + 2.0 * rr * G_b  # Gp = 2 rr rhop + 2 Y Dly
    rhop_b = 2.0 * rr * Gp_b
    Y_b = 2.0 * Dly * Gp_b + 2.0 * Y * G_b
    Dly_b = 2.0 * Y * Gp_b
    rmn_b = -2.0 * s["rmn"] * G_b
    X_b = rhop_b * Dlx / rho  # rhop = (X Dlx + Z Dlz) / rho
    Dlx_b = rhop_b * X / rho
    Z_b = rhop_b * Dlz / rho
    Dlz_b = rhop_b * Z / rho
    rho_b = -rhop_b * rhop / rho + rr_b
    rmaj_b = r_b_n - rr_b
    X_b = X_b + rho_b * X / rho  # rho = sqrt(X^2 + Z^2)
    Z_b = Z_b + rho_b * Z / rho
    t0s = s["t0s"]  # X = Olx + t0 Dlx, t0 constant
    Olx_b, Oly_b, Olz_b = X_b, Y_b, Z_b
    Dlx_b, Dly_b, Dlz_b = Dlx_b + t0s * X_b, Dly_b + t0s * Y_b, Dlz_b + t0s * Z_b
    # Ol = (p - C) . rows, Dl = d . rows
    pbx = pbx + Olx_b * bxx + Oly_b * byx + Olz_b * bzx
    pby = pby + Olx_b * bxy + Oly_b * byy + Olz_b * bzy
    pbz = pbz + Olx_b * bxz + Oly_b * byz + Olz_b * bzz
    Cbx = Cbx - (Olx_b * bxx + Oly_b * byx + Olz_b * bzx)
    Cby = Cby - (Olx_b * bxy + Oly_b * byy + Olz_b * bzy)
    Cbz = Cbz - (Olx_b * bxz + Oly_b * byz + Olz_b * bzz)
    dbx = dbx + Dlx_b * bxx + Dly_b * byx + Dlz_b * bzx
    dby = dby + Dlx_b * bxy + Dly_b * byy + Dlz_b * bzy
    dbz = dbz + Dlx_b * bxz + Dly_b * byz + Dlz_b * bzz
    add_slot(3, Olx_b * s["rx"] + Dlx_b * d0x)
    add_slot(4, Olx_b * s["ry"] + Dlx_b * d0y)
    add_slot(5, Olx_b * s["rz"] + Dlx_b * d0z)
    add_slot(6, Oly_b * s["rx"] + Dly_b * d0x)
    add_slot(7, Oly_b * s["ry"] + Dly_b * d0y)
    add_slot(8, Oly_b * s["rz"] + Dly_b * d0z)
    cs = o[ft.O_CENTER_SIGN]  # C = o + cs R bz, r_maj = R + major_adjust r
    add_slot(0, Cbx)
    add_slot(1, Cby)
    add_slot(2, Cbz)
    add_slot(9, Olz_b * s["rx"] + Dlz_b * d0x + cs * s["Rmj"] * Cbx)
    add_slot(10, Olz_b * s["ry"] + Dlz_b * d0y + cs * s["Rmj"] * Cby)
    add_slot(11, Olz_b * s["rz"] + Dlz_b * d0z + cs * s["Rmj"] * Cbz)
    add_slot(12, cs * (Cbx * bzx + Cby * bzy + Cbz * bzz) + rmaj_b)
    add_slot(16, rmn_b + o[ft.O_MAJOR_ADJUST] * rmaj_b)
    return (pbx, pby, pbz), (dbx, dby, dbz), wb, lamb


def optic_draws_plain(I, e: int) -> int:
    """The draws optic ``e`` takes (K5b's ``optic_draws``): a mosaic
    crystal's three a layer, live or dead, else none; so the draws of optic
    ``e`` start at the source's draws plus those of the optics before it,
    where K5b's replay build restarts them."""
    oi = I[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
    return 3 * oi[ft.OI_DEPTH] if oi[2] == ft._INTERACT["mosaic"] else 0


def _image_slots(I):
    """(optic, flat offset, nx, ny) of every imaged optic."""
    out = []
    for e in range(I[0]):
        oi = I[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
        if oi[7] >= 0:
            out.append((e, oi[7], oi[8], oi[9]))
    return out


def _slices(n_total: int, chunk: int, n_draws: int, uniforms, seed, dtype, device):
    """(rays, draw) per slice of ``chunk`` rays: the kernels' Philox
    stream keyed by ``seed``, or the columns of ``uniforms``."""
    for start in range(0, n_total, chunk):
        stop = min(start + chunk, n_total)
        rays = torch.arange(start, stop, dtype=torch.int64, device=device)
        if uniforms is None:
            rows = ft.philox_uniforms(rays, n_draws, int(seed[0]), int(seed[1]))
        else:
            rows = [uniforms[k, start:stop] for k in range(n_draws)]
        yield rays, iter([r.to(dtype) for r in rows]).__next__


def _sample_plasma(F, I, P, draw, full):
    """The kernels' plasma of one bundle per ray (``_sample_plasma``,
    ``fused_grad.py:202-276``): box and voxel offsets, the cone to the
    target, the wavelength lambda = (lambda0 + sigma_conv sqrt(T) n
    [+ Cauchy]) dop with T from the temperature slot, and the initial weight
    (w0 / E0) E from the emissivity slot. Returns (state, lam, aux) with aux
    = (n, sqrt(T), dop), what the temperature's adjoint needs."""
    src_base = I[0] * SLOTS_PER_OPTIC
    px, py, pz = full(F[20]), full(F[21]), full(F[22])
    for k in range(3):  # box offsets, then voxel offsets, in the source frame
        if F[23 + k] != 0.0:
            o_l = (draw() - 0.5) * F[23 + k]
            px, py, pz = px + o_l * F[3 * k], py + o_l * F[3 * k + 1], pz + o_l * F[3 * k + 2]
    if I[6]:
        for k in range(3):
            o_l = (draw() - 0.5) * F[18]
            px, py, pz = px + o_l * F[3 * k], py + o_l * F[3 * k + 1], pz + o_l * F[3 * k + 2]
    dx, dy, dz = ft.plasma_cone_plain(F, F[26], draw, px, py, pz)
    E, T = P[src_base], P[src_base + 1]
    n_g = ft.normal_plain(draw)
    sqrt_t = torch.sqrt(torch.clamp_min(T, 1e-30))
    lam = F[15] + F[16] * sqrt_t * n_g
    if I[7]:
        lam = lam + ft.cauchy_plain(draw, F[17])
    dop = 1.0 - (F[27] * dx + F[28] * dy + F[29] * dz) * F[19]
    lam = lam * dop
    w = F[30] * E + torch.zeros_like(px)
    alive = torch.ones(px.shape, dtype=torch.bool, device=px.device)
    return (px, py, pz, dx, dy, dz, w, alive), lam, (n_g, sqrt_t, dop)


def _source_state(F, I, P, rays, draw, lam: float):
    """The state of each ray leaving the source, its wavelength (``lam``,
    unless the source varies it per ray) and, for a plasma, what the source
    slots' adjoint needs."""
    def full(value):
        return torch.full(rays.shape, value, dtype=P.dtype, device=rays.device)

    if I[5] == 2:
        return _sample_plasma(F, I, P, draw, full)
    px, py, pz, dx, dy, dz, wl, _ = ft.sample_source_plain(F, I, draw, full)
    state = (px, py, pz, dx, dy, dz, full(1.0), torch.ones_like(rays, dtype=torch.bool))
    if not I[ft.H_PER_RAY_WL]:
        wl = torch.tensor(lam, dtype=P.dtype, device=P.device)
    return state, wl, None


def _static_lists(static: ft.FusedParams):
    return ([float(x) for x in static.fp.tolist()],
            [int(x) for x in static.ip.tolist()])


def fused_grad_forward_plain(static: ft.FusedParams, pvec: torch.Tensor,
                             n_total: int, lam: float, uniforms=None,
                             seed=(0, 0), chunk: int = 32768) -> torch.Tensor:
    """K5f's plain twin: the flat bilinear images ``[img_total]`` of
    ``n_total`` rays in the dtype of ``pvec``, differentiable in ``pvec``.
    ``lam``: a point source's wavelength (a plasma's is per ray);
    ``uniforms``: (n_draws, n_total), or None for the Philox stream keyed
    by ``seed``."""
    F, I = _static_lists(static)
    P = pvec
    shapes = {e: (nx, ny) for e, _, nx, ny in _image_slots(I)}
    parts = {e: torch.zeros(nx * ny, dtype=P.dtype, device=P.device)
             for e, (nx, ny) in shapes.items()}
    for rays, draw in _slices(n_total, chunk, static.n_draws, uniforms, seed,
                              P.dtype, P.device):
        state, lam_r, _ = _source_state(F, I, P, rays, draw, lam)
        for e in range(I[0]):
            state, _, img = _optic_fwd(F, I, static.aux, e, P, lam_r, state, draw)
            if img is not None:
                parts[e] = parts[e] + _splat(*shapes[e], *img)
    # The images lie in optic order in the flat buffer.
    return torch.cat(list(parts.values()))


def fused_grad_vjp_plain(static: ft.FusedParams, pvec: torch.Tensor,
                         n_total: int, lam: float, g_flat: torch.Tensor,
                         uniforms=None, seed=(0, 0),
                         chunk: int = 32768) -> torch.Tensor:
    """K5b's plain twin: the gradient of ``sum(g_flat * images)`` with
    respect to ``pvec``, by the hand adjoint, summed in float64; returned
    in the dtype of ``pvec``."""
    F, I = _static_lists(static)
    P = pvec.detach()
    g_flat = g_flat.to(P.dtype)
    images = {e: (off, nx, ny) for e, off, nx, ny in _image_slots(I)}
    total = torch.zeros(P.numel(), dtype=torch.float64, device=P.device)
    src_base = I[0] * SLOTS_PER_OPTIC
    for rays, draw in _slices(n_total, chunk, static.n_draws, uniforms, seed,
                              P.dtype, P.device):
        state, lam_r, aux = _source_state(F, I, P, rays, draw, lam)
        saved, seeds = [], {}
        for e in range(I[0]):
            state, s, img = _optic_fwd(F, I, static.aux, e, P, lam_r, state, draw)
            saved.append(s)
            if img is not None:
                seeds[e] = _seeds(g_flat, *images[e], *img)
        zeros = torch.zeros_like(state[0])
        carry = ((zeros, zeros, zeros), (zeros, zeros, zeros), zeros, zeros)
        for e in range(I[0] - 1, -1, -1):
            base = e * SLOTS_PER_OPTIC

            def add_slot(k, values, base=base):
                total[base + k] += values.double().sum()

            carry = _optic_bwd(F, I, e, P, saved[e], seeds.get(e), carry,
                               add_slot)
        if aux is not None:  # the source slots (fused_grad.py:279-291)
            wb, lamb = carry[2], carry[3]
            n_g, sqrt_t, dop = aux
            total[src_base] += (wb * F[30]).double().sum()
            total[src_base + 1] += (lamb * (F[16] * n_g * dop / (2.0 * sqrt_t))).double().sum()
    return total.to(P.dtype)


def n_slots_of(static: ft.FusedParams) -> int:
    """The length of ``pvec``: 24 slots per optic, ``SRC_SLOTS`` for a
    plasma, padded to a multiple of 8."""
    plasma = static.source_kind == 2
    return _round_up(static.n_optics * SLOTS_PER_OPTIC + (SRC_SLOTS if plasma else 0), 8)


def _variant(static: ft.FusedParams) -> int:
    """The kernels' build variant: bit 0 a torus in the chain, bit 1 a
    cylinder; bits 2-3 the source: 0 the point-source cut of the generic
    sampler, 1 a plasma, 2 the whole generic sampler; plus 12 for a chain
    with a mosaic crystal."""
    source = 1 if static.source_kind == 2 else (2 if static.full_source else 0)
    mosaic = bool(static.interact_mask >> ft._INTERACT["mosaic"] & 1)
    return (int(bool(static.shape_mask & (1 << 2)))
            | int(bool(static.shape_mask & (1 << 3))) << 1
            | source << 2) + 12 * int(mosaic)


def _check_buffers(static: ft.FusedParams, pvec: torch.Tensor, n_total: int,
                   uniforms, name: str):
    device = static.fp.device
    if pvec.device != device or pvec.dtype != torch.float32 or pvec.dim() != 1:
        raise ValueError(f"{name}: pvec must be a float32 vector on {device}")
    if pvec.numel() < n_slots_of(static):
        raise ValueError(f"{name}: pvec holds {pvec.numel()} slots, need "
                         f"{n_slots_of(static)}")
    if not 0 <= n_total < 2**31:
        raise ValueError(f"{name}: n_total must be in [0, 2^31)")
    if uniforms is None:
        return None
    if (uniforms.device != device or uniforms.dtype != torch.float32
            or tuple(uniforms.shape) != (static.n_draws, n_total)):
        raise ValueError(f"{name}: uniforms must be float32 "
                         f"({static.n_draws}, {n_total}) on {device}")
    return uniforms.contiguous()


def fused_grad_forward_cuda(static: ft.FusedParams, pvec: torch.Tensor,
                            n_total: int, lam: float, uniforms=None,
                            seed=(0, 0), chunk: int = 32768) -> torch.Tensor:
    """Weight-mode bilinear images of ``n_total`` rays (kernel K5f), flat
    float32 ``[img_total]``. Buffers on a CUDA device launch the kernel (or
    raise); buffers on the CPU take :func:`fused_grad_forward_plain`, with
    ``chunk`` rays per slice."""
    device = static.fp.device
    if device.type == "cpu":
        return fused_grad_forward_plain(static, pvec, n_total, lam, uniforms, seed,
                                        chunk)
    if device.type != "cuda":
        raise ValueError(f"fused_grad_forward_cuda: unsupported device {device}")
    uniforms = _check_buffers(static, pvec, n_total, uniforms, "fused_grad_forward_cuda")
    image = torch.zeros(static.img_total, dtype=torch.float32, device=device)
    if n_total == 0:
        return image
    pvec = pvec.contiguous()
    fp, ip, aux = ft._buffers(static, "fused_grad_forward_cuda")
    err = native.library().xrt_fused_grad_fwd(
        fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
        aux.numel(), pvec.data_ptr(), pvec.numel(), n_total, float(lam),
        None if uniforms is None else uniforms.data_ptr(),
        int(seed[0]) & _M32, int(seed[1]) & _M32, image.data_ptr(),
        static.img_total, _variant(static),
        torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_fused_grad_fwd")
    fused_grad_forward_cuda.launches += 1
    return image


fused_grad_forward_cuda.launches = 0


# K5b's builds (``xrt_fused_grad_bwd``'s ``build``, csrc/fused_grad.cu): the
# build that recomputes each optic's forward from the source, and the replay
# build, which saves each optic's entry state and runs the optic once more
# from it before its adjoint.
K5B_BUILDS = ("recompute", "replay")


def k5b_layout(static: ft.FusedParams, n_slots: int, n_total: int,
               build: str | None = None) -> dict:
    """The launch K5b makes (``xrt_fused_grad_bwd_layout``) for ``static``,
    ``n_slots`` parameter slots and ``n_total`` rays, in ``build`` (one of
    :data:`K5B_BUILDS`, or None for the launcher's pick): its blocks,
    threads a block, the floats of device memory a block's saved states
    take, its dynamic shared bytes, the build taken, and where the replay
    build keeps its saved states (``"shared"`` where they fit beside the
    blocks its registers allow, else ``"device"``; None when it
    recomputes). A build that cannot run raises."""
    lib = native.library()
    fp, ip, _ = ft._buffers(static, "k5b_layout")
    out = (ctypes.c_longlong * 5)()
    code = -1 if build is None else K5B_BUILDS.index(build)
    native.check(lib.xrt_fused_grad_bwd_layout(
        n_total, static.img_total, fp.numel(), ip.numel(), n_slots, static.n_optics,
        _variant(static), code, out), "xrt_fused_grad_bwd_layout")
    taken = K5B_BUILDS[int(out[4])]
    states = None if taken == "recompute" else "device" if out[2] else "shared"
    return {"blocks": int(out[0]), "threads": int(out[1]), "device_floats": int(out[2]),
            "smem": int(out[3]), "build": taken, "states": states}


def k5b_forwards(n_optics: int, build: str) -> int:
    """Optic forwards K5b runs a ray in ``build`` (:func:`k5b_layout`'s
    ``build``): n(n + 1) / 2 where it recomputes from the source; where it
    replays, the first pass up to the last optic's entry and one replay an
    optic, 2n - 1."""
    n = n_optics
    return n * (n + 1) // 2 if build == "recompute" else 2 * n - 1


def fused_grad_vjp_cuda(static: ft.FusedParams, pvec: torch.Tensor,
                        n_total: int, lam: float, g_flat: torch.Tensor,
                        uniforms=None, seed=(0, 0),
                        chunk: int = 32768, _build: str | None = None) -> torch.Tensor:
    """Gradient of ``sum(g_flat * images)`` with respect to ``pvec``
    (kernel K5b), float32 ``[pvec.numel()]``. The kernel writes one float64
    row of slot sums per block; they are summed here in float64. The
    launcher picks the build (the recomputing build for short chains, the
    replay build for long ones, :func:`k5b_layout`); saved states that do
    not fit in shared memory take a scratch buffer allocated here. ``_build``
    (:data:`K5B_BUILDS`) forces a build, to hold both to the twin and time
    them; it raises where that build cannot run. Buffers on the CPU take
    :func:`fused_grad_vjp_plain`, with ``chunk`` rays per slice."""
    device = static.fp.device
    if device.type == "cpu":
        return fused_grad_vjp_plain(static, pvec, n_total, lam, g_flat, uniforms, seed,
                                    chunk)
    if device.type != "cuda":
        raise ValueError(f"fused_grad_vjp_cuda: unsupported device {device}")
    if _build is not None and _build not in K5B_BUILDS:
        raise ValueError(f"fused_grad_vjp_cuda: _build must be one of {K5B_BUILDS}")
    uniforms = _check_buffers(static, pvec, n_total, uniforms, "fused_grad_vjp_cuda")
    if (g_flat.device != device or g_flat.dtype != torch.float32
            or tuple(g_flat.shape) != (static.img_total,)):
        raise ValueError(f"fused_grad_vjp_cuda: g must be float32 "
                         f"({static.img_total},) on {device}")
    n_slots = pvec.numel()
    if n_total == 0:
        return torch.zeros(n_slots, dtype=torch.float32, device=device)
    lib = native.library()
    fp, ip, aux = ft._buffers(static, "fused_grad_vjp_cuda")
    launch = k5b_layout(static, n_slots, n_total, _build)
    n_blocks = launch["blocks"]
    n_states = n_blocks * launch["device_floats"]
    partial = torch.empty((n_blocks, n_slots), dtype=torch.float64, device=device)
    states = (torch.empty(n_states, dtype=torch.float32, device=device) if n_states else None)
    pvec, g_flat = pvec.contiguous(), g_flat.contiguous()
    err = lib.xrt_fused_grad_bwd(
        fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), aux.data_ptr(),
        aux.numel(), pvec.data_ptr(), n_slots, n_total, float(lam),
        None if uniforms is None else uniforms.data_ptr(),
        int(seed[0]) & _M32, int(seed[1]) & _M32, g_flat.data_ptr(),
        static.img_total, static.n_optics, partial.data_ptr(), n_blocks, _variant(static),
        None if states is None else states.data_ptr(), n_states,
        -1 if _build is None else K5B_BUILDS.index(_build),
        torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_fused_grad_bwd")
    fused_grad_vjp_cuda.launches += 1
    return partial.sum(dim=0).to(torch.float32)


fused_grad_vjp_cuda.launches = 0


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------

def seed_words(seed) -> tuple:
    """Two 32-bit Philox key words from an int seed (or a given pair)."""
    if isinstance(seed, (tuple, list)):
        return int(seed[0]) & _M32, int(seed[1]) & _M32
    w = np.random.SeedSequence(int(seed)).generate_state(2, np.uint32)
    return int(w[0]), int(w[1])


def build_fused_diff(pipeline, num_iter: int | None = None,
                     chunk: int = 32768, rng: str = "hw"):
    """Build the forward and adjoint for a pipeline in weight mode.

    Returns ``(forward, vjp, pack, spec)``:
    ``forward(pvec, seed, uniforms=None) -> {"image": {name: [nx, ny]}}``;
    ``vjp(pvec, seed, g_images, uniforms=None) -> gvec`` (float32, one value
    per slot of ``pvec``); ``pack(params) -> pvec``. Both regenerate the
    same rays from the same ``seed``, so ``gvec`` is the gradient of
    ``sum(g * forward(pvec, seed))``.

    ``rng``: 'hw' draws the kernels' Philox stream keyed by the seed;
    'input' streams explicit (n_draws, n_total) float32 uniforms, given as
    ``uniforms`` or drawn from a generator seeded with ``seed``. ``chunk``
    bounds the rays per slice of the plain twins (the kernels stride over
    every ray).
    """
    g = pipeline.general
    if str(g.get("interact_mode", "mc")).lower() != "weight":
        raise FusedGradUnsupported("interact_mode must be 'weight'")
    if str(g.get("dtype", "float32")).lower() not in ("float32", "f32"):
        raise FusedGradUnsupported("dtype != float32")
    if rng not in ("hw", "input"):
        raise ValueError(f"rng must be 'hw' or 'input', got {rng!r}")
    if chunk <= 0:
        raise ValueError("chunk must be positive")
    src = _grad_source_spec(pipeline.source)
    optics = [_grad_optic_spec(o) for o in pipeline.optics]
    # pvec holds at most 1024 slots, as JAX's (fused_grad.py:1709-1711).
    plasma = src["kind"] == 2
    if _round_up(len(optics) * SLOTS_PER_OPTIC + (SRC_SLOTS if plasma else 0), 8) > MAX_SLOTS:
        raise FusedGradUnsupported(f"more than {MAX_OPTICS} optics")
    if not any(o["image"] is not None for o in optics):
        raise FusedGradUnsupported("no imaged optic")
    device = pipeline.device
    static = ft.pack_params(src, optics, pipeline.params, device, weight=True,
                            bilinear=True)
    if num_iter is None:
        num_iter = int(g["number_of_iter"])
    n_total = src["n_rays"] * num_iter
    if n_total >= 2**31:
        raise FusedGradUnsupported(
            f"num_rays*num_iter = {n_total:.3e} overflows int32 ray indexing")
    n_slots = n_slots_of(static)
    # A point source's wavelength; a plasma's is drawn per ray.
    lam = float(pipeline.params["sources"][src["name"]]["wavelength"])
    images = [(o["name"], o["image"]["nx"], o["image"]["ny"])
              for o in optics if o["image"] is not None]

    def prepare(pvec, seed, uniforms):
        pvec = torch.as_tensor(pvec).detach().to(device=device, dtype=torch.float32)
        if pvec.shape != (n_slots,):
            raise ValueError(f"pvec must have {n_slots} slots, got {tuple(pvec.shape)}")
        words = seed_words(seed)
        if rng == "input" and uniforms is None:
            gen = torch.Generator(device=device)
            gen.manual_seed((words[0] << 32) | words[1])
            uniforms = torch.rand((static.n_draws, n_total), generator=gen,
                                  dtype=torch.float32, device=device)
        elif uniforms is not None:
            uniforms = uniforms.to(device=device, dtype=torch.float32)
        return pvec, words, uniforms

    def forward(pvec, seed, uniforms=None):
        pvec, words, uniforms = prepare(pvec, seed, uniforms)
        flat = fused_grad_forward_cuda(static, pvec, n_total, lam, uniforms, words,
                                       chunk)
        out, off = {}, 0
        for name, nx, ny in images:
            out[name] = flat[off:off + nx * ny].reshape(nx, ny)
            off += nx * ny
        return {"image": out}

    def vjp(pvec, seed, g_images, uniforms=None):
        pvec, words, uniforms = prepare(pvec, seed, uniforms)
        g_flat = torch.cat([
            torch.as_tensor(g_images[name], dtype=torch.float32,
                            device=device).reshape(nx * ny)
            for name, nx, ny in images])
        return fused_grad_vjp_cuda(static, pvec, n_total, lam, g_flat, uniforms,
                                   words, chunk)

    spec = {"static": static, "optics": optics, "n_total": n_total, "lam": lam,
            "images": images}
    return forward, vjp, pack_params(pipeline), spec
