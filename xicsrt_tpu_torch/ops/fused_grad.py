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
12 radius, 13 crystal_spacing, 14 rocking_fwhm, 15 reflectivity,
16 radius_minor (0 here), 17:24 reserved. The structure (source sampler,
shapes, bounds, apertures, images) is the K1a buffer layout of
``ops/fused_trace.py``, packed once at build time.

Subset (``FusedGradUnsupported`` otherwise): Generic/Directed point sources
with an ``isotropic`` or symmetric ``isotropic_xy`` cone, one wavelength,
counted budget; plane and sphere optics (concave and convex) with x/y/z
bounds and apertures as hard edges; no interaction, mirror, or crystal with
gaussian or step rocking; bilinear images on any optic; float32.

On CPU tensors the wrappers run the plain PyTorch twins
(:func:`fused_grad_forward_plain`, :func:`fused_grad_vjp_plain`), which
follow the JAX ``_trace_fwd`` / ``_trace_bwd`` (``fused_grad.py:747-1670``)
in the kernels' order of operations, in the dtype of ``pvec``: at float64
they are the truth the float32 kernels are held to.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xicsrt_tpu_torch.ops import fused_trace as ft
from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import splat_bilinear, tent_transpose


class FusedGradUnsupported(ft.FusedUnsupported):
    """Config outside the fused-gradient subset."""


SLOTS_PER_OPTIC = 24
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
    outside the subset before a pipeline is built (cylinder, torus and
    mosaic optics, plasma sources and file rocking curves are not ported)."""
    from xicsrt_tpu_torch.dispatch import lookup

    for section in ("sources", "optics"):
        for name, element in config.get(section, {}).items():
            if element.get("enabled", True) is False:
                continue
            class_name = element.get("class_name")
            try:
                lookup(class_name)
            except KeyError:
                raise FusedGradUnsupported(
                    f'"{name}": {class_name} is outside the fused-gradient '
                    "subset of this port") from None
            rocking = str(element.get("rocking_type", "gaussian")).lower()
            if rocking not in ("gaussian", "step"):
                raise FusedGradUnsupported(f"rocking_type {rocking}")


def _grad_source_spec(source) -> dict:
    """The K1a source spec, restricted to counted budgets
    (``fused_grad.py:89-113``)."""
    try:
        spec = ft._source_spec(source)
    except ft.FusedUnsupported as err:
        raise FusedGradUnsupported(str(err)) from None
    if spec["poisson"]:
        raise FusedGradUnsupported("Poisson budget (use counted intensity)")
    return spec


def _grad_optic_spec(optic) -> dict:
    """The K1a optic spec with mirrors allowed (``fused_grad.py:294-406``)."""
    if not optic.param.get("check_bragg", True):
        raise FusedGradUnsupported("check_bragg=False crystal")
    try:
        spec = ft._optic_spec(optic, mirror=True)
    except ft.FusedUnsupported as err:
        raise FusedGradUnsupported(str(err)) from None
    spec["n_draws"] = 0  # weight mode: a crystal draws no uniform
    return spec


def pack_params(pipeline):
    """``pack(params) -> pvec``: the differentiated leaves of ``params`` as
    one float32 vector (``fused_grad.py:409-447``), padded to a multiple
    of 8. Autograd flows from ``pvec`` back into ``params``."""
    names = [o.name for o in pipeline.optics]

    def pack(params):
        vals = []
        for name in names:
            po = params["optics"][name]
            device = po["frame"].origin.device

            def scalar(key, default):
                v = po.get(key, default)
                return torch.as_tensor(v, device=device).reshape(1)

            vals += [po["frame"].origin.reshape(3), po["frame"].basis.reshape(9),
                     scalar("radius", 0.0), scalar("crystal_spacing", 0.0),
                     scalar("rocking_fwhm", 0.0), scalar("reflectivity", 1.0),
                     scalar("radius_minor", 0.0),
                     torch.zeros(SLOTS_PER_OPTIC - 17, device=device)]
        vec = torch.cat([v.to(torch.float32) for v in vals])
        pad = _round_up(vec.numel(), 8) - vec.numel()
        return torch.nn.functional.pad(vec, (0, pad))

    return pack


def unpack_grads(pipeline, gvec) -> dict:
    """Map the flat gradient vector to ``{optic: {leaf: numpy}}``
    (``fused_grad.py:450-475``)."""
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
    return out


# ---------------------------------------------------------------------------
# The kernels' plain twins.
# ---------------------------------------------------------------------------

def _optic_fwd(F, I, e, P, lam, state):
    """Weight-mode forward of optic ``e`` (``_trace_fwd``,
    ``fused_grad.py:747-1158``, for planes and spheres with no interaction,
    a mirror or a crystal). ``lam``: the wavelength as a 0-d tensor (a true
    division, as the kernel's; PyTorch multiplies a Python scalar by the
    reciprocal). ``state``: (px, py, pz, dx, dy, dz, w, alive)
    entering the optic. Returns (state leaving it, the locals the adjoint
    needs, (w_img, fx, fy) or None)."""
    px, py, pz, dx, dy, dz, w, alive = state
    o = F[ft.SRC_F + e * ft.OPT_F: ft.SRC_F + (e + 1) * ft.OPT_F]
    oi = I[ft.HDR_I + e * ft.OPT_I: ft.HDR_I + (e + 1) * ft.OPT_I]
    b = e * SLOTS_PER_OPTIC
    oxp, oyp, ozp = P[b], P[b + 1], P[b + 2]
    bxx, bxy, bxz = P[b + 3], P[b + 4], P[b + 5]
    byx, byy, byz = P[b + 6], P[b + 7], P[b + 8]
    bzx, bzy, bzz = P[b + 9], P[b + 10], P[b + 11]
    s = {"dpre": (dx, dy, dz)}
    if oi[0] == 0:  # plane
        D = dx * bzx + dy * bzy + dz * bzz
        D = torch.where(torch.abs(D) > 1e-30, D, 1e-30)
        N = (oxp - px) * bzx + (oyp - py) * bzy + (ozp - pz) * bzz
        t = N / D
        mask = alive & (t >= 0.0)
        s["D"] = D
    else:  # sphere, center o + sign r bz
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
    qx, qy, qz = px + t * dx, py + t * dy, pz + t * dz
    if oi[0] == 0:
        nxv, nyv, nzv = bzx, bzy, bzz
    else:  # toward the center for both convexities; |C - q| = r at the hit
        inv_r = 1.0 / torch.clamp_min(r, _EPS)
        nxv, nyv, nzv = (Cx - qx) * inv_r, (Cy - qy) * inv_r, (Cz - qz) * inv_r
        s["inv_r"] = inv_r
    rxq, ryq, rzq = qx - oxp, qy - oyp, qz - ozp
    lxv = rxq * bxx + ryq * bxy + rzq * bxz
    lyv = rxq * byx + ryq * byy + rzq * byz
    mask = ft.bounds_plain(mask, o, oi, lxv, lyv, (rxq, ryq, rzq), (bzx, bzy, bzz))
    mask = ft.aperture_logic_plain(F, I, oi, lxv, lyv, mask)

    if oi[2] in (1, 2):
        dot = dx * nxv + dy * nyv + dz * nzv
        s["dot"] = dot
    if oi[2] == 1:  # crystal
        d_s, fwhm, refl = P[b + 13], P[b + 14], P[b + 15]
        sin_b = torch.clamp(lam / (2.0 * torch.clamp_min(d_s, _EPS)), 0.0, 1.0)
        cos_b = torch.sqrt(torch.clamp_min(1.0 - sin_b * sin_b, _EPS))
        adot = torch.abs(dot)
        cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, _EPS))
        sd = adot * cos_b - cosi * sin_b
        delta = sd + sd * sd * sd * (1.0 / 6.0)
        if oi[3] == 0:  # gaussian
            sigma = torch.clamp_min(fwhm * _SIGMA_PER_FWHM, _EPS)
            z = delta / sigma
            prob = refl * torch.exp(-0.5 * z * z)
            s.update(sigma=sigma, z=z)
        else:  # step: hard edges, zero gradient in delta and fwhm
            inside = torch.abs(delta) <= fwhm / 2.0
            prob = torch.where(inside, refl, 0.0)
            s["step_in"] = inside
        s.update(adot=adot, cosi=cosi, sd=sd, prob=prob, w_pre=w, sin_b=sin_b,
                 cos_b=cos_b, d_s=d_s, refl=refl, lam=lam)
        w = torch.where(mask, w * prob, w)
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
    1161-1670``, for this subset). ``carry``: (pb, db, wb) adjoints of the
    position, direction and weight leaving the optic; returns them for the
    state entering it. ``add_slot(k, values)`` accumulates slot ``e*24+k``."""
    (pbx, pby, pbz), (dbx, dby, dbz), wb = carry
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

    qbx, qby, qbz = pbx, pby, pbz
    lxb = lyb = zeros
    if seed is not None:
        gw, glx, gly = seed
        wb = wb + gw * mf
        lxb = glx * mf
        lyb = gly * mf

    # ---- interaction: d_post = d_pre - 2 (d_pre . n) n where mask -------
    nbx = nby = nbz = zeros
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
            else:
                refl_b = prob_b * s["step_in"].to(wb.dtype)
                delta_b = zeros
            add_slot(15, refl_b * mf)
            sd = s["sd"]
            sd_b = delta_b * (1.0 + 0.5 * sd * sd)
            adot_b = sd_b * (s["cos_b"] + s["adot"] / s["cosi"] * s["sin_b"])
            sinb_b = sd_b * (-s["adot"] * s["sin_b"] / s["cos_b"] - s["cosi"])
            d_s = s["d_s"]
            ds_b = sinb_b * (-s["lam"] / (2.0 * torch.clamp_min(d_s * d_s, _EPS)))
            inr = (s["sin_b"] > 0.0) & (s["sin_b"] < 1.0)
            add_slot(13, torch.where(inr, ds_b, 0.0) * mf)
            dot_b = torch.sign(dot) * adot_b * mf
        dbx = dbx + dot_b * nxv
        dby = dby + dot_b * nyv
        dbz = dbz + dot_b * nzv
        nbx = nbx + dot_b * d0x
        nby = nby + dot_b * d0y
        nbz = nbz + dot_b * d0z

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
    if oi[0] == 0:  # n = bz
        add_slot(9, nbx)
        add_slot(10, nby)
        add_slot(11, nbz)
        Cbx = Cby = Cbz = r_b_n = zeros
    else:  # n = (C - q) / r
        inv_r = s["inv_r"]
        Cbx, Cby, Cbz = inv_r * nbx, inv_r * nby, inv_r * nbz
        qbx, qby, qbz = qbx - Cbx, qby - Cby, qbz - Cbz
        ndot = nxv * nbx + nyv * nby + nzv * nbz
        r_b_n = -ndot * inv_r * s["r"] * inv_r

    # ---- hit: q = p + t d --------------------------------------------------
    t = s["t"]
    t_b = qbx * d0x + qby * d0y + qbz * d0z
    pbx, pby, pbz = qbx, qby, qbz
    dbx, dby, dbz = dbx + t * qbx, dby + t * qby, dbz + t * qbz
    if oi[0] == 0:  # t = ((o - p) . bz) / (d . bz)
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
    else:  # t = t_ca -+ t_hc, L = C - p
        t_hc = torch.clamp_min(s["t_hc"], 1e-6)
        sign_hc = -1.0 if oi[1] else 1.0
        t_ca = s["t_ca"]
        cx = d0x + sign_hc * (t_ca * d0x - s["Lx"]) / t_hc
        cy = d0y + sign_hc * (t_ca * d0y - s["Ly"]) / t_hc
        cz = d0z + sign_hc * (t_ca * d0z - s["Lz"]) / t_hc
        Cbx, Cby, Cbz = Cbx + t_b * cx, Cby + t_b * cy, Cbz + t_b * cz
        pbx, pby, pbz = pbx - t_b * cx, pby - t_b * cy, pbz - t_b * cz
        dbx = dbx + t_b * s["Lx"] * (1.0 + sign_hc * t_ca / t_hc)
        dby = dby + t_b * s["Ly"] * (1.0 + sign_hc * t_ca / t_hc)
        dbz = dbz + t_b * s["Lz"] * (1.0 + sign_hc * t_ca / t_hc)
        r_b = r_b_n + t_b * sign_hc * s["r"] / t_hc
        sign_c = -1.0 if oi[1] else 1.0
        add_slot(0, Cbx)
        add_slot(1, Cby)
        add_slot(2, Cbz)
        add_slot(9, sign_c * s["r"] * Cbx)
        add_slot(10, sign_c * s["r"] * Cby)
        add_slot(11, sign_c * s["r"] * Cbz)
        add_slot(12, r_b + sign_c * (bzx * Cbx + bzy * Cby + bzz * Cbz))
    return (pbx, pby, pbz), (dbx, dby, dbz), wb


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


def _source_state(F, I, rays, draw, dtype):
    def full(value):
        return torch.full(rays.shape, value, dtype=dtype, device=rays.device)

    px, py, pz, dx, dy, dz = ft.sample_source_plain(F, I[2], draw, full)
    return (px, py, pz, dx, dy, dz, full(1.0), torch.ones_like(rays, dtype=torch.bool))


def _static_lists(static: ft.FusedParams):
    return ([float(x) for x in static.fp.tolist()],
            [int(x) for x in static.ip.tolist()])


def fused_grad_forward_plain(static: ft.FusedParams, pvec: torch.Tensor,
                             n_total: int, lam: float, uniforms=None,
                             seed=(0, 0), chunk: int = 32768) -> torch.Tensor:
    """K5f's plain twin: the flat bilinear images ``[img_total]`` of
    ``n_total`` rays in the dtype of ``pvec``, differentiable in ``pvec``.
    ``uniforms``: (n_draws, n_total), or None for the Philox stream keyed
    by ``seed``."""
    F, I = _static_lists(static)
    P = pvec
    lam = torch.tensor(lam, dtype=P.dtype, device=P.device)
    shapes = {e: (nx, ny) for e, _, nx, ny in _image_slots(I)}
    parts = {e: torch.zeros(nx * ny, dtype=P.dtype, device=P.device)
             for e, (nx, ny) in shapes.items()}
    for rays, draw in _slices(n_total, chunk, static.n_draws, uniforms, seed,
                              P.dtype, P.device):
        state = _source_state(F, I, rays, draw, P.dtype)
        for e in range(I[0]):
            state, _, img = _optic_fwd(F, I, e, P, lam, state)
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
    lam = torch.tensor(lam, dtype=P.dtype, device=P.device)
    g_flat = g_flat.to(P.dtype)
    images = {e: (off, nx, ny) for e, off, nx, ny in _image_slots(I)}
    total = torch.zeros(P.numel(), dtype=torch.float64, device=P.device)
    for rays, draw in _slices(n_total, chunk, static.n_draws, uniforms, seed,
                              P.dtype, P.device):
        state = _source_state(F, I, rays, draw, P.dtype)
        saved, seeds = [], {}
        for e in range(I[0]):
            state, s, img = _optic_fwd(F, I, e, P, lam, state)
            saved.append(s)
            if img is not None:
                seeds[e] = _seeds(g_flat, *images[e], *img)
        zeros = torch.zeros_like(state[0])
        carry = ((zeros, zeros, zeros), (zeros, zeros, zeros), zeros)
        for e in range(I[0] - 1, -1, -1):
            base = e * SLOTS_PER_OPTIC

            def add_slot(k, values, base=base):
                total[base + k] += values.double().sum()

            carry = _optic_bwd(F, I, e, P, saved[e], seeds.get(e), carry,
                               add_slot)
    return total.to(P.dtype)


def _check_buffers(static: ft.FusedParams, pvec: torch.Tensor, n_total: int,
                   uniforms, name: str):
    device = static.fp.device
    if pvec.device != device or pvec.dtype != torch.float32 or pvec.dim() != 1:
        raise ValueError(f"{name}: pvec must be a float32 vector on {device}")
    if pvec.numel() < static.n_optics * SLOTS_PER_OPTIC:
        raise ValueError(f"{name}: pvec holds {pvec.numel()} slots, need "
                         f"{static.n_optics * SLOTS_PER_OPTIC}")
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
    err = native.library().xrt_fused_grad_fwd(
        static.fp.data_ptr(), static.fp.numel(), static.ip.data_ptr(),
        static.ip.numel(), pvec.data_ptr(), pvec.numel(), n_total, float(lam),
        None if uniforms is None else uniforms.data_ptr(),
        int(seed[0]) & _M32, int(seed[1]) & _M32, image.data_ptr(),
        static.img_total, torch.cuda.current_stream(device).cuda_stream)
    native.check(err, "xrt_fused_grad_fwd")
    fused_grad_forward_cuda.launches += 1
    return image


fused_grad_forward_cuda.launches = 0


def fused_grad_vjp_cuda(static: ft.FusedParams, pvec: torch.Tensor,
                        n_total: int, lam: float, g_flat: torch.Tensor,
                        uniforms=None, seed=(0, 0),
                        chunk: int = 32768) -> torch.Tensor:
    """Gradient of ``sum(g_flat * images)`` with respect to ``pvec``
    (kernel K5b), float32 ``[pvec.numel()]``. The kernel writes one float64
    row of slot sums per block; they are summed here in float64. Buffers on
    the CPU take :func:`fused_grad_vjp_plain`, with ``chunk`` rays per
    slice."""
    device = static.fp.device
    if device.type == "cpu":
        return fused_grad_vjp_plain(static, pvec, n_total, lam, g_flat, uniforms, seed,
                                    chunk)
    if device.type != "cuda":
        raise ValueError(f"fused_grad_vjp_cuda: unsupported device {device}")
    uniforms = _check_buffers(static, pvec, n_total, uniforms, "fused_grad_vjp_cuda")
    if (g_flat.device != device or g_flat.dtype != torch.float32
            or tuple(g_flat.shape) != (static.img_total,)):
        raise ValueError(f"fused_grad_vjp_cuda: g must be float32 "
                         f"({static.img_total},) on {device}")
    n_slots = pvec.numel()
    if n_total == 0:
        return torch.zeros(n_slots, dtype=torch.float32, device=device)
    lib = native.library()
    n_blocks = lib.xrt_fused_grad_bwd_blocks(n_total, static.img_total)
    if n_blocks <= 0:
        native.check(-n_blocks, "xrt_fused_grad_bwd_blocks")
    partial = torch.empty((n_blocks, n_slots), dtype=torch.float64, device=device)
    pvec, g_flat = pvec.contiguous(), g_flat.contiguous()
    err = lib.xrt_fused_grad_bwd(
        static.fp.data_ptr(), static.fp.numel(), static.ip.data_ptr(),
        static.ip.numel(), pvec.data_ptr(), n_slots, n_total, float(lam),
        None if uniforms is None else uniforms.data_ptr(),
        int(seed[0]) & _M32, int(seed[1]) & _M32, g_flat.data_ptr(),
        static.img_total, partial.data_ptr(), n_blocks,
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
    if not any(o["image"] is not None for o in optics):
        raise FusedGradUnsupported("no imaged optic")
    device = pipeline.device
    static = ft.pack_params(src, optics, pipeline.params, device)
    if num_iter is None:
        num_iter = int(g["number_of_iter"])
    n_total = pipeline.num_rays * num_iter
    if n_total >= 2**31:
        raise FusedGradUnsupported(
            f"num_rays*num_iter = {n_total:.3e} overflows int32 ray indexing")
    n_slots = _round_up(len(optics) * SLOTS_PER_OPTIC, 8)
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
