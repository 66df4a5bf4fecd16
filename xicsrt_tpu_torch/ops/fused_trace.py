"""Fused trace engine K1a (counterpart of ``xicsrt_tpu/ops/fused_trace.py``).

One CUDA kernel (``csrc/fused_trace.cu``) generates every ray, traces it
through the optic chain, counts the survivors of each element and bins the
nearest-pixel images, with all per-ray state in registers. It replaces the
main-chain cut of the TPU megakernel ``build_fused_run`` (kernel).

Supported subset (``general.engine='fused'``; outside it the build raises
``FusedUnsupported``, and ``'auto'`` falls back to the eager engine):

- Generic or Directed point sources with an ``isotropic`` or symmetric
  ``isotropic_xy`` cone, one wavelength, counted or Poisson budgets;
- plane and sphere optics with x/y/z bounds and aperture logic (every
  logic op; shapes none/circle/square/rectangle/ellipse);
- no interaction, or a Bragg crystal with gaussian or step rocking in
  ``mc`` mode;
- nearest-pixel images, float32, no history reservoir.

Unlike the TPU kernel, geometry is not compiled in: :func:`pack_params`
packs the run's ``params`` into two small buffers at every call, so one
build serves every configuration and a changed ``params`` takes effect at
once.

The Bragg deviation is the sine-difference identity with a cubic asin
correction, ``sd + sd^3/6`` with ``sd = |d.n| cos_b - sqrt(1-(d.n)^2) sin_b``
(``fused_trace.py:995-1002``), in the kernel and in its twin alike; its
error is below 1e-11 rad inside the rocking support.

``fused_run_cuda`` launches the kernel for buffers on a CUDA device and
takes the plain PyTorch twin :func:`fused_run_plain` for buffers on the
CPU. The twin does the kernel's float32 operations in the kernel's order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from xicsrt_tpu_torch.ops import native
from xicsrt_tpu_torch.ops.binning import fused_multiply_add


class FusedUnsupported(NotImplementedError):
    """Raised when a config is outside the fused-kernel subset."""


# Buffer layout, mirrored by the XRT_* offsets of csrc/fused_trace.cu.
MAX_OPTICS = 16
MAX_APERTURES = 64
SRC_F, OPT_F, AP_F = 24, 32, 4
HDR_I, OPT_I, AP_I = 8, 16, 2
_APERTURE_SHAPES = {"none": 0, "circle": 1, "square": 2, "rectangle": 3,
                    "ellipse": 4}
_LOGIC = {"and": 0, "not": 1, "or": 2, "nand": 3, "nor": 4, "xor": 5, "xnor": 6}
_TWO_PI = 2.0 * math.pi
_SIGMA_PER_FWHM = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
# Rays per slice of the plain twin, which bounds its temporaries.
_TWIN_SLICE = 1 << 20


# ---------------------------------------------------------------------------
# Build-time extraction of the pipeline structure.
# ---------------------------------------------------------------------------

def _source_spec(source) -> dict:
    """Structure of the source: sampling program and budget."""
    from xicsrt_tpu_torch.ops.spread import parse_spread_single, parse_spread_xy
    from xicsrt_tpu_torch.sources.generic import SourceDirected, SourceGeneric

    if type(source) not in (SourceGeneric, SourceDirected):
        raise FusedUnsupported(f"source {type(source).__name__}")
    p = source.param
    if any(float(p.get(k) or 0.0) != 0.0 for k in ("xsize", "ysize", "zsize")):
        raise FusedUnsupported("extended source")
    angular = str(p["angular_dist"]).lower()
    if angular == "isotropic":
        cos_t = math.cos(parse_spread_single(p["spread"]))
        dist = (0, [cos_t, 1.0 - cos_t])
    elif angular == "isotropic_xy":
        tx0, tx1, ty0, ty1 = parse_spread_xy(p["spread"])
        if not (ty0 == -ty1 and ty1 > 0):
            raise FusedUnsupported("isotropic_xy with asymmetric y-bounds")
        sb1 = math.sin(ty1)
        g0 = 2.0 * math.asin(math.sin(tx0) * sb1)
        g1 = 2.0 * math.asin(math.sin(tx1) * sb1)
        tyl, tyh = math.tan(ty0), math.tan(ty1)
        dist = (1, [g0, g1 - g0, sb1, tyl, tyl * tyl, tyh, tyh * tyh])
    else:
        raise FusedUnsupported(f"angular_dist {angular}")
    return {
        "name": source.name,
        "directed": isinstance(source, SourceDirected),
        "dist": dist,
        "poisson": bool(p.get("use_poisson")),
        "rate": float(source._scaled_intensity),
        "n_draws": 2,
    }


def _optic_spec(optic, mirror: bool = False) -> dict:
    """Structure of one optic: shape, bounds, apertures, interaction, image.

    ``mirror``: accept a mirror interaction (interact code 2), which the
    gradient kernels trace and K1a does not."""
    from xicsrt_tpu_torch.optics.interactions import (
        InteractCrystal, InteractMirror, InteractNone,
    )
    from xicsrt_tpu_torch.optics.shapes import ShapePlane, ShapeSphere

    p = optic.param
    spec = {"name": optic.name, "n_draws": 0, "apertures": [], "image": None}
    if isinstance(optic, ShapePlane):
        spec["shape"] = 0
    elif isinstance(optic, ShapeSphere):
        spec["shape"] = 1
        spec["convex"] = bool(p.get("convex", False))
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

    if isinstance(optic, InteractCrystal):
        if not p.get("check_bragg", True):
            raise FusedUnsupported("crystal without Bragg check (mirror)")
        spec["interact"] = 1
        spec["rocking"] = {"gaussian": 0, "step": 1}[p["rocking_type"]]
        spec["n_draws"] = 1
    elif isinstance(optic, InteractMirror):
        if not mirror:
            raise FusedUnsupported("mirror interaction")
        spec["interact"] = 2
    elif isinstance(optic, InteractNone):
        spec["interact"] = 0
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
    one device, plus the sizes the host needs to allocate the outputs."""

    fp: torch.Tensor
    ip: torch.Tensor
    n_optics: int
    img_total: int
    n_draws: int


def _vec(t) -> np.ndarray:
    return np.asarray(t.detach().cpu(), dtype=np.float64)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-300)


def pack_params(src: dict, optics: list, params: dict, device) -> FusedParams:
    """Pack the structure specs and the run's ``params`` into the kernel's
    buffers. Derived constants are computed in float64 from the parameter
    values and rounded once to float32."""
    n_opt = len(optics)
    n_ap = sum(len(o["apertures"]) for o in optics)
    if n_opt > MAX_OPTICS:
        raise FusedUnsupported(f"more than {MAX_OPTICS} optics")
    if n_ap > MAX_APERTURES:
        raise FusedUnsupported(f"more than {MAX_APERTURES} apertures")
    fp = np.zeros(SRC_F + n_opt * OPT_F + n_ap * AP_F, np.float64)
    ip = np.zeros(HDR_I + n_opt * OPT_I + n_ap * AP_I, np.int32)

    sp = params["sources"][src["name"]]
    basis = _vec(sp["frame"].basis)
    axis = _unit(_vec(sp["direction"])) if src["directed"] else basis[2]
    o1 = _unit(np.cross(axis, basis[0]) + np.cross(axis, basis[2]))
    o2 = _unit(np.cross(axis, o1))
    fp[0:3] = _vec(sp["frame"].origin)
    fp[3:12] = np.stack([o2, o1, axis]).reshape(-1)
    dist_kind, dist_consts = src["dist"]
    fp[12:12 + len(dist_consts)] = dist_consts
    wavelength = float(_vec(sp["wavelength"]))

    img_total = 0
    ap_index = 0
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
        if o["shape"] == 1:
            radius = float(_vec(op["radius"]))
            sign = -1.0 if o["convex"] else 1.0
            f[12:15] = origin + sign * radius * ob[2]
            f[15] = radius * radius
            i[1] = int(o["convex"])
        f[16:19] = o["half"]
        i[4] = o["checks"]
        i[2] = o["interact"]
        if o["interact"] == 1:
            spacing = float(_vec(op["crystal_spacing"]))
            fwhm = float(_vec(op["rocking_fwhm"]))
            sin_b = wavelength / (2.0 * spacing)
            if not (0.0 < sin_b < 1.0):
                raise FusedUnsupported("wavelength outside Bragg range")
            f[19] = float(_vec(op["reflectivity"]))
            f[20] = fwhm * _SIGMA_PER_FWHM if o["rocking"] == 0 else fwhm / 2.0
            f[21] = sin_b
            f[22] = math.sqrt(1.0 - sin_b * sin_b)
            i[3] = o["rocking"]
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

    n_draws = src["n_draws"] + sum(o["n_draws"] for o in optics)
    ip[0:5] = (n_opt, n_ap, dist_kind, n_draws, img_total)
    return FusedParams(
        fp=torch.as_tensor(fp.astype(np.float32), device=device),
        ip=torch.as_tensor(ip, device=device),
        n_optics=n_opt, img_total=img_total, n_draws=n_draws,
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


def sample_source_plain(F, dist: int, draw, full):
    """The kernels' point-source sampler (``xrt_sample_source`` in
    ``csrc/trace_common.cuh``): origin and unit direction of each ray from
    two draws, in the kernels' float32 operations. ``dist``: 0 isotropic,
    1 isotropic_xy; ``full(value)`` makes a tensor of the slice's shape.
    Returns (px, py, pz, dx, dy, dz)."""
    px, py, pz = full(F[0]), full(F[1]), full(F[2])
    u, v = draw(), draw()
    if dist == 0:
        lz = F[12] + u * F[13]
        rho = torch.sqrt(torch.clamp_min(1.0 - lz * lz, 0.0))
        phi = v * _TWO_PI
        lx, ly = rho * torch.cos(phi), rho * torch.sin(phi)
    else:
        sx = _div(torch.sin((F[12] + u * F[13]) * 0.5), F[14])
        tx = sx * _inv_sqrt(torch.clamp_min(1.0 - sx * sx, 1e-12))
        k2 = 1.0 + tx * tx
        h0 = F[15] * _inv_sqrt(k2 + F[16])
        h1 = F[17] * _inv_sqrt(k2 + F[18])
        h = h0 + v * (h1 - h0)
        ty = torch.sqrt(k2) * h * _inv_sqrt(torch.clamp_min(1.0 - h * h, 1e-12))
        w = _inv_sqrt(1.0 + tx * tx + ty * ty)
        lx, ly, lz = tx * w, ty * w, w
    dx = lx * F[3] + ly * F[6] + lz * F[9]
    dy = lx * F[4] + ly * F[7] + lz * F[10]
    dz = lx * F[5] + ly * F[8] + lz * F[11]
    return px, py, pz, dx, dy, dz


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


def _trace_slice(F, I, rays, count, draw, counts, image):
    """Trace one slice of rays exactly as the kernel does; adds into
    ``counts`` (int64) and the flat ``image``."""
    f32 = torch.float32
    n_opt = I[0]
    alive = rays < count
    counts[0] += alive.sum()
    shape = rays.shape

    def full(value):
        return torch.full(shape, value, dtype=f32, device=rays.device)

    px, py, pz, dx, dy, dz = sample_source_plain(F, I[2], draw, full)

    for e in range(n_opt):
        o = F[SRC_F + e * OPT_F: SRC_F + (e + 1) * OPT_F]
        oi = I[HDR_I + e * OPT_I: HDR_I + (e + 1) * OPT_I]
        if oi[0] == 0:
            denom = dx * o[9] + dy * o[10] + dz * o[11]
            numer = (o[0] - px) * o[9] + (o[1] - py) * o[10] + (o[2] - pz) * o[11]
            nz = torch.abs(denom) > 1e-30
            t = numer / torch.where(nz, denom, full(1e-30))
            m_int = alive & (t >= 0.0) & nz
            nxv, nyv, nzv = full(o[9]), full(o[10]), full(o[11])
        else:
            Lx, Ly, Lz = o[12] - px, o[13] - py, o[14] - pz
            t_ca = Lx * dx + Ly * dy + Lz * dz
            d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca
            m_int = alive & (d2 <= o[15])
            t_hc = torch.sqrt(torch.clamp_min(o[15] - d2, 0.0))
            t = t_ca - t_hc if oi[1] else t_ca + t_hc
        qx = torch.where(m_int, px + t * dx, px)
        qy = torch.where(m_int, py + t * dy, py)
        qz = torch.where(m_int, pz + t * dz, pz)
        if oi[0] != 0:
            nxv, nyv, nzv = o[12] - qx, o[13] - qy, o[14] - qz
            inv = _inv_sqrt(torch.clamp_min(nxv * nxv + nyv * nyv + nzv * nzv, 1e-30))
            nxv, nyv, nzv = nxv * inv, nyv * inv, nzv * inv
        rx, ry, rz = qx - o[0], qy - o[1], qz - o[2]
        lxv = rx * o[3] + ry * o[4] + rz * o[5]
        lyv = rx * o[6] + ry * o[7] + rz * o[8]
        mask = bounds_plain(m_int, o, oi, lxv, lyv, (rx, ry, rz), o[9:12])
        mask = aperture_logic_plain(F, I, oi, lxv, lyv, mask)

        if oi[2] == 1:
            dot = dx * nxv + dy * nyv + dz * nzv
            adot = torch.abs(dot)
            cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, 0.0))
            sd = adot * o[22] - cosi * o[21]
            delta = sd + sd * sd * sd * (1.0 / 6.0)
            if oi[3] == 0:
                z = _div(delta, o[20])
                prob = o[19] * torch.exp(-0.5 * (z * z))
            else:
                prob = torch.where(torch.abs(delta) <= o[20], full(o[19]), full(0.0))
            mask = mask & (prob >= draw())
            kk = 2.0 * dot
            dx = torch.where(mask, dx - kk * nxv, dx)
            dy = torch.where(mask, dy - kk * nyv, dy)
            dz = torch.where(mask, dz - kk * nzv, dz)
        px, py, pz = qx, qy, qz
        alive = mask
        counts[1 + e] += alive.sum()

        if oi[7] >= 0:
            nx, ny = oi[8], oi[9]
            fx = torch.round(fused_multiply_add(lxv, o[23], o[24]))
            fy = torch.round(fused_multiply_add(lyv, o[23], o[25]))
            ok = alive & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
            idx = oi[7] + fx[ok].long() * ny + fy[ok].long()
            image.index_put_((idx,), torch.ones_like(idx, dtype=f32),
                             accumulate=True)


def fused_run_plain(fparams: FusedParams, n_total: int, count: int,
                    uniforms: torch.Tensor | None = None, seed=(0, 0)):
    """The kernel's plain twin: same arguments, same outputs.

    Returns (counts int64 [1 + n_optics], flat images float32 [img_total]).
    ``uniforms``: (n_draws, n_total) float32, or None for the kernel's
    Philox stream keyed by ``seed``.
    """
    F = [float(x) for x in fparams.fp.tolist()]
    I = [int(x) for x in fparams.ip.tolist()]
    device = fparams.fp.device
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    for start in range(0, n_total, _TWIN_SLICE):
        stop = min(start + _TWIN_SLICE, n_total)
        rays = torch.arange(start, stop, dtype=torch.int64, device=device)
        if uniforms is None:
            rows = philox_uniforms(rays, fparams.n_draws, int(seed[0]), int(seed[1]))
        else:
            rows = [uniforms[k, start:stop] for k in range(fparams.n_draws)]
        _trace_slice(F, I, rays, count, iter(rows).__next__, counts, image)
    return counts, image


def fused_run_cuda(fparams: FusedParams, n_total: int, count: int,
                   uniforms: torch.Tensor | None = None, seed=(0, 0)):
    """Trace ``n_total`` rays through the packed chain (kernel K1a).

    Rays at index >= ``count`` are dead at the source. Returns (counts
    int64 [1 + n_optics], flat images float32 [img_total]). Buffers on a
    CUDA device launch the kernel (or raise); buffers on the CPU take
    :func:`fused_run_plain`.
    """
    device = fparams.fp.device
    if device.type == "cpu":
        return fused_run_plain(fparams, n_total, count, uniforms, seed)
    if device.type != "cuda":
        raise ValueError(f"fused_run_cuda: unsupported device {device}")
    if fparams.fp.dtype != torch.float32 or fparams.ip.dtype != torch.int32:
        raise ValueError("fused_run_cuda: fp must be float32 and ip int32")
    if fparams.ip.device != device:
        raise ValueError("fused_run_cuda: fp and ip must share one device")
    if not 0 <= n_total < 2**31:
        raise ValueError("fused_run_cuda: n_total must be in [0, 2^31)")
    u_ptr = None
    if uniforms is not None:
        if (uniforms.device != device or uniforms.dtype != torch.float32
                or tuple(uniforms.shape) != (fparams.n_draws, n_total)):
            raise ValueError(
                f"uniforms must be float32 ({fparams.n_draws}, {n_total}) on {device}")
        uniforms = uniforms.contiguous()
        u_ptr = uniforms.data_ptr()
    counts = torch.zeros(1 + fparams.n_optics, dtype=torch.int64, device=device)
    image = torch.zeros(fparams.img_total, dtype=torch.float32, device=device)
    if n_total == 0:
        return counts, image
    fp, ip = fparams.fp.contiguous(), fparams.ip.contiguous()
    err = native.library().xrt_fused_trace(
        fp.data_ptr(), fp.numel(), ip.data_ptr(), ip.numel(), n_total,
        int(count), u_ptr, int(seed[0]) & _M32, int(seed[1]) & _M32,
        counts.data_ptr(), image.data_ptr(), fparams.img_total,
        torch.cuda.current_stream(device).cuda_stream,
    )
    native.check(err, "xrt_fused_trace")
    fused_run_cuda.launches += 1
    return counts, image


fused_run_cuda.launches = 0


# ---------------------------------------------------------------------------
# Engine entry points.
# ---------------------------------------------------------------------------

def build_fused_run(pipeline, num_iter: int | None = None,
                    rng: str = "hw", history_slots: int | None = None,
                    history_mode: str = "found"):
    """Build ``run(params, generator, uniforms=None) -> {"meta", "image",
    "history"}`` tracing ``pipeline.num_rays * num_iter`` rays in one launch.

    ``rng``: 'hw' draws the kernel's Philox stream from two seed words taken
    from the generator; 'input' streams explicit (n_draws, n_total) float32
    uniforms: ``uniforms`` when given, else drawn from the generator. Ray
    ``r`` takes draw ``k`` from row ``k``, column ``r``; the draws of a ray
    are the source's u, v, then one per crystal.

    Poisson budgets draw the realised count on the host from the generator
    (the sum of per-iteration Poisson draws is one Poisson draw of the
    summed rate), as ``fused_trace.py:1902-1907`` does.
    """
    g = pipeline.general
    mode = str(g.get("interact_mode", "mc")).lower()
    if mode != "mc":
        raise FusedUnsupported(f"interact_mode {mode!r}")
    if str(g.get("image_mode", "nearest")).lower() != "nearest":
        raise FusedUnsupported("image_mode != nearest")
    if str(g.get("dtype", "float32")).lower() not in ("float32", "f32"):
        raise FusedUnsupported("dtype != float32")
    if history_slots or history_mode != "found":
        raise FusedUnsupported("history reservoirs are not ported yet")
    if rng not in ("hw", "input"):
        raise ValueError(f"rng must be 'hw' or 'input', got {rng!r}")

    src = _source_spec(pipeline.source)
    optics = [_optic_spec(o) for o in pipeline.optics]
    # Packing the build-time params raises FusedUnsupported for what only
    # the values show: buffer limits, a wavelength outside the Bragg range.
    pack_params(src, optics, pipeline.params, "cpu")
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

    def run(params, generator: torch.Generator, uniforms=None):
        fparams = pack_params(src, optics, params, device)
        count = n_total
        if src["poisson"]:
            lam = torch.tensor(src["rate"] * num_iter, dtype=torch.float64,
                               device=generator.device)
            count = min(int(torch.poisson(lam, generator=generator).item()), n_total)
        seed = (0, 0)
        if rng == "input" and uniforms is None:
            uniforms = torch.rand((fparams.n_draws, n_total), generator=generator,
                                  dtype=torch.float32, device=generator.device)
        if rng == "hw":
            seed = torch.randint(0, 2**31 - 1, (2,), generator=generator,
                                 device=generator.device).tolist()
        if uniforms is not None:
            uniforms = uniforms.to(device)
        counts, flat = fused_run_cuda(fparams, n_total, count, uniforms, seed)
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
        return {"meta": meta, "image": image, "history": {}}

    return run


def build_fast_run(pipeline, num_iter: int | None = None,
                   history_slots: int | None = None,
                   history_mode: str = "found"):
    """Fastest applicable fused path: ``(run, "fused")``.

    The JAX package falls back to its trace-only kernel when only the
    source is outside the megakernel subset; that kernel is not ported yet,
    so this raises ``FusedUnsupported`` instead.
    """
    return (build_fused_run(pipeline, num_iter=num_iter,
                            history_slots=history_slots,
                            history_mode=history_mode),
            "fused")
