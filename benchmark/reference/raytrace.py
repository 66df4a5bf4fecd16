"""Plain reference of a fused ``raytrace`` call: counts and images.

From a config dict (the benchmark's configuration with its call's
``random_seed``) this module works out, in plain PyTorch and NumPy, what
the port's ``raytrace(config, device)`` returns on ``general.engine
'fused'``: each element's ray count and each optic's nearest-pixel image.
It is a frozen copy of the plain twin the port keeps beside its trace
kernel K1, cut to the elements the benchmark's configurations use, with
its own reading of the config: element poses and constants are computed
in float64 from the config and rounded once to float32, the run's
``torch.Generator`` is seeded from ``random_seed``, a plasma's bundle
tables are drawn from it again, and every ray is traced with the same
Philox4x32-10 draws and the same float32 operations in the same order.
The kernel and its twin agree ray for ray, so the reference's counts and
images equal the program's exactly.

``dtype`` computes everything in another floating type (the lower
precision control of the benchmark's check); the images are then summed
in float32.

Elements: ``XicsrtSourceDirected`` (a point source, ``isotropic`` or
symmetric ``isotropic_xy`` cone, one wavelength), ``XicsrtPlasmaCubic``
(voxel bundles, constant profiles, Poisson counts); ``XicsrtOpticAperture``,
``XicsrtOpticDetector`` (planes), ``XicsrtOpticSphericalCrystal``,
``XicsrtOpticToroidalCrystal`` (gaussian rocking curves); mc mode,
nearest-pixel images. Anything else raises ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

C_LIGHT = 299792458.0
EV_J = 1.602176634e-19
AMU_KG = 1.66053906892e-27
SIGMA_PER_FWHM = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))
TWO_PI = 2.0 * math.pi
M32 = 0xFFFFFFFF

# Packed layout of one optic (floats, ints), as the kernel's buffers hold it.
SRC_F, OPT_F, AP_F = 64, 32, 4
PLANE, SPHERE, TORUS = 0, 1, 2
NONE, CRYSTAL = 0, 1
APERTURE_SHAPES = {"none": 0, "circle": 1, "square": 2, "rectangle": 3, "ellipse": 4}
LOGIC = {"and": 0, "not": 1, "or": 2, "nand": 3, "nor": 4, "xor": 5, "xnor": 6}
OPTICS = {
    "XicsrtOpticAperture": (PLANE, NONE),
    "XicsrtOpticDetector": (PLANE, NONE),
    "XicsrtOpticSphericalCrystal": (SPHERE, CRYSTAL),
    "XicsrtOpticToroidalCrystal": (TORUS, CRYSTAL),
}
# Torus (convex in x, convex in y) -> (major adjust, centre sign).
TORUS_CONVEX = {(False, False): (-1.0, 1.0), (False, True): (1.0, 1.0),
                (True, False): (1.0, -1.0), (True, True): (-1.0, -1.0)}
CONES = {"isotropic": 0, "isotropic_xy": 1}


def f32(x) -> np.ndarray:
    """``x`` rounded to float32, held as float64."""
    return np.asarray(x, np.float64).astype(np.float32).astype(np.float64)


def unit(v: np.ndarray) -> np.ndarray:
    return v / max(np.linalg.norm(v), 1e-300)


def frame(cfg: dict) -> tuple:
    """(origin, basis rows x, y, z) of an element, in float64 from the config,
    each rounded once to float32; x is cross(e_z, z) normalised where the
    config gives none, e_x for a vertical z."""
    origin = np.asarray(cfg.get("origin", [0.0, 0.0, 0.0]), np.float64)
    z = np.asarray(cfg.get("zaxis", [0.0, 0.0, 1.0]), np.float64)
    z = z / np.linalg.norm(z)
    if cfg.get("xaxis") is not None:
        x = np.asarray(cfg["xaxis"], np.float64)
        x = x / np.linalg.norm(x)
    else:
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        norm = np.linalg.norm(x)
        x = np.array([1.0, 0.0, 0.0]) if norm < 1e-12 else x / norm
    return f32(origin), f32(np.stack([x, np.cross(z, x), z]))


def poisson_budget(expected: float) -> int:
    """Ray slots comfortably above a Poisson draw of ``expected``."""
    expected = float(expected)
    return int(expected + 6.5 * math.sqrt(max(expected, 1.0)) + 16)


# ---------------------------------------------------------------------------
# The config read into the packed floats and ints.
# ---------------------------------------------------------------------------

def _spread_xy(spread) -> tuple:
    arr = np.atleast_1d(np.asarray(spread, np.float64))
    if arr.size == 1:
        return -float(arr[0]), float(arr[0]), -float(arr[0]), float(arr[0])
    if arr.size == 2:
        return -float(arr[0]), float(arr[0]), -float(arr[1]), float(arr[1])
    return tuple(float(v) for v in arr)


def _cone(p: dict) -> tuple:
    """(cone kind, its float64 constants) of a point source's cone."""
    angular = str(p.get("angular_dist", "isotropic")).lower()
    if angular == "isotropic":
        cos_t = math.cos(float(np.atleast_1d(np.asarray(p["spread"], np.float64))[0]))
        return CONES["isotropic"], [cos_t, 1.0 - cos_t]
    if angular == "isotropic_xy":
        tx0, tx1, ty0, ty1 = _spread_xy(p["spread"])
        if not (ty0 == -ty1 and ty1 > 0):
            raise NotImplementedError("an asymmetric isotropic_xy cone")
        tyl, tyh = math.tan(ty0), math.tan(ty1)
        sb1 = math.sin(ty1)
        g0 = 2.0 * math.asin(math.sin(tx0) * sb1)
        g1 = 2.0 * math.asin(math.sin(tx1) * sb1)
        return CONES["isotropic_xy"], [g0, g1 - g0, sb1, tyl, tyl * tyl, tyh, tyh * tyh]
    raise NotImplementedError(f"angular_dist {angular}")


def _directed_source(p: dict, fp: np.ndarray) -> dict:
    """A directed point source: fp[0:49] and its structure."""
    for key in ("xsize", "ysize", "zsize"):
        if float(p.get(key) or 0.0):
            raise NotImplementedError("an extended source")
    if np.any(np.asarray(p.get("velocity", [0.0, 0.0, 0.0]), np.float64) != 0.0):
        raise NotImplementedError("a moving source")
    if str(p.get("wavelength_dist", "voigt")).lower() != "voigt" or float(
            p.get("temperature", 0.0)) or float(p.get("linewidth", 0.0)):
        raise NotImplementedError("a source of more than one wavelength")
    if p.get("filters") or p.get("use_poisson"):
        raise NotImplementedError("source filters or a Poisson budget")
    origin, basis = frame(p)
    direction = np.asarray(p["direction"] if p.get("direction") is not None
                           else p.get("zaxis", [0.0, 0.0, 1.0]), np.float64)
    axis = unit(f32(direction / np.linalg.norm(direction)))
    o1 = unit(np.cross(axis, basis[0]) + np.cross(axis, basis[2]))
    o2 = unit(np.cross(axis, o1))
    kind, consts = _cone(p)
    fp[0:3] = origin
    fp[3:12] = np.stack([o2, o1, axis]).reshape(-1)
    fp[12:12 + len(consts)] = consts
    fp[24:33] = basis.reshape(-1)
    fp[39:42] = basis[0] + basis[2]
    wavelength = float(f32(p["wavelength"]))
    fp[42] = wavelength
    fp[48] = 1.0 / C_LIGHT
    intensity = float(p["intensity"]) * float(p.get("intensity_scale", 1.0))
    return {"kind": 0, "cone": kind, "n_draws": 2, "wavelength": wavelength,
            "num_rays": int(round(intensity))}


def _plasma_budget(p: dict, bundle_count: int, volume: float) -> int:
    """The plasma's static ray slots an iteration: the rate formula over
    bundle offsets from a fixed host seed, with headroom."""
    rng = np.random.default_rng(12345)
    nb = min(bundle_count, 65536)
    sizes = np.array([p["xsize"], p["ysize"], p["zsize"]], dtype=np.float64)
    rng.uniform(-0.5, 0.5, (nb, 3)) * sizes  # the offsets; constant profiles ignore them
    spreads = np.full(nb, float(p["spread"]))
    omega = 4.0 * np.pi * np.sin(spreads / 2.0) ** 2
    lam = (np.full(nb, float(p["emissivity"])) * float(p["time_resolution"])
           * float(p["bundle_volume"]) * omega / (4.0 * np.pi))
    lam *= volume / (bundle_count * float(p["bundle_volume"]))
    lam *= float(p.get("intensity_scale", 1.0))
    predicted = float(lam.mean() * bundle_count)
    budget = poisson_budget(predicted * (1.0 + 5.0 / math.sqrt(max(nb, 1))) * 1.15)
    return max(int(budget), 16)


def _plasma_source(p: dict, fp: np.ndarray) -> dict:
    """A cubic plasma of voxel bundles: fp[0:20] and its structure."""
    if p.get("filters") or p.get("spread_radius") is not None:
        raise NotImplementedError("plasma filters or spread_radius")
    if str(p.get("bundle_type", "voxel")) != "voxel" or not p.get("use_poisson", True):
        raise NotImplementedError("point bundles or counts without Poisson draws")
    if np.any(np.asarray(p.get("velocity", [0.0, 0.0, 0.0]), np.float64) != 0.0):
        raise NotImplementedError("a moving plasma")
    origin, basis = frame(p)
    volume = float(p["xsize"]) * float(p["ysize"]) * float(p["zsize"])
    bundle_count = int(round(float(p["bundle_count"])))
    w0 = float(p["wavelength"])
    mass = float(p.get("mass_number", 1.0))
    gamma = float(p.get("linewidth", 0.0)) * w0 ** 2 / (4.0 * math.pi * C_LIGHT * 1e10)
    voxel = float(p["bundle_volume"]) ** (1.0 / 3.0)
    num_rays = _plasma_budget(p, bundle_count, volume)
    if p.get("max_rays") and num_rays > int(p["max_rays"]):
        raise ValueError(f"plasma budget {num_rays} > max_rays {p['max_rays']}")
    fp[0:9] = basis.reshape(-1)
    fp[9:12] = f32(p["target"])
    fp[12:15] = basis[0] + basis[2]
    fp[15] = w0
    fp[16] = math.sqrt(1.0 * EV_J / (mass * AMU_KG * C_LIGHT ** 2)) * w0
    fp[17] = gamma
    fp[18] = voxel
    fp[19] = 1.0 / C_LIGHT
    expected = (float(p["emissivity"]) * float(p["time_resolution"]) * volume
                * math.sin(float(p["spread"]) / 2.0) ** 2
                * float(p.get("intensity_scale", 1.0)))
    return {"kind": 1, "n_draws": 3 + 3 + int(gamma > 0.0), "gamma": gamma,
            "num_rays": num_rays, "bundle_count": bundle_count, "volume": volume,
            "origin": origin, "basis": basis, "expected": expected, "param": p}


def _optic(name: str, p: dict, f: np.ndarray, i: np.ndarray, apertures: list,
           wavelength) -> dict:
    """One optic's packed floats ``f`` and ints ``i``; its apertures go on
    ``apertures``. Returns its image spec or None."""
    if p["class_name"] not in OPTICS:
        raise NotImplementedError(f"optic {p['class_name']}")
    shape, interact = OPTICS[p["class_name"]]
    origin, basis = frame(p)
    f[0:3] = origin
    f[3:12] = basis.reshape(-1)
    i[0], i[2] = shape, interact
    if shape == SPHERE:
        radius = float(f32(p["radius"]))
        convex = bool(p.get("convex", False))
        f[12:15] = origin + (-1.0 if convex else 1.0) * radius * basis[2]
        f[15] = radius * radius
        i[1] = int(convex)
    elif shape == TORUS:
        convex = [bool(v) for v in np.atleast_1d(p.get("convex", [False, False]))]
        adjust, sign = TORUS_CONVEX[tuple(convex * 2 if len(convex) == 1 else convex)]
        r_major = float(f32(p["radius_major"]))
        r_minor = float(f32(p["radius_minor"]))
        r_maj = r_major + adjust * r_minor
        f[12:15] = origin + sign * r_major * basis[2]
        f[15] = r_maj
        f[26] = r_minor * r_minor
        f[27] = 1e-5 * max(1.0, r_maj)
        f[29], f[30] = adjust, sign
    sizes = [p.get(k) for k in ("xsize", "ysize", "zsize")]
    f[16:19] = [float(s) / 2.0 if s else 0.0 for s in sizes]
    if p.get("check_size", True):
        i[4] = sum(1 << k for k, s in enumerate(sizes) if s)
    aps = p.get("aperture") or []
    aps = [aps] if isinstance(aps, dict) else list(aps)
    if not p.get("check_aperture", True):
        aps = []
    i[5], i[6] = len(aps), len(apertures)
    for ap in aps:
        kind = (ap.get("shape") or "none").lower()
        size = [float(s) for s in np.atleast_1d(ap.get("size", []))] + [0.0, 0.0]
        params = {"circle": (size[0] * size[0], 0.0), "square": (size[0] / 2.0, 0.0),
                  "rectangle": (size[0] / 2.0, size[1] / 2.0),
                  "ellipse": (size[0], size[1])}.get(kind, (0.0, 0.0))
        ao = ap.get("origin") if ap.get("origin") is not None else [0.0, 0.0]
        apertures.append(((float(ao[0]), float(ao[1])) + params,
                          APERTURE_SHAPES[kind], LOGIC[(ap.get("logic") or "and").lower()]))
    if interact == CRYSTAL:
        if not p.get("check_bragg", True) or p.get("rocking_type", "gaussian") != "gaussian":
            raise NotImplementedError("a crystal other than a gaussian Bragg crystal")
        spacing = float(f32(p["crystal_spacing"]))
        f[19] = float(f32(p.get("reflectivity", 1.0)))
        f[20] = float(f32(p["rocking_fwhm"])) * SIGMA_PER_FWHM
        f[28] = 1.0 / (2.0 * spacing)
        if wavelength is not None:
            sin_b = wavelength / (2.0 * spacing)
            f[21] = sin_b
            f[22] = math.sqrt(1.0 - sin_b * sin_b)
    i[7] = -1
    xsize, ysize = p.get("xsize"), p.get("ysize")
    if not (xsize and ysize):
        return None
    ps = p.get("pixel_size") or xsize / 100.0
    nx, ny = int(np.round(xsize / ps)), int(np.round(ysize / ps))
    f[23] = 1.0 / ps
    f[24] = (nx - 1) / 2.0
    f[25] = (ny - 1) / 2.0
    i[8], i[9] = nx, ny
    return {"name": name, "nx": nx, "ny": ny}


def build(config: dict) -> dict:
    """The run of ``config`` as packed float32 constants ``F`` (Python floats
    holding float32 values), ints ``I``, its source's structure, element
    names, image specs and ray budget."""
    general = config.get("general", {})
    if str(general.get("interact_mode", "mc")) != "mc" or str(
            general.get("image_mode", "nearest")) != "nearest":
        raise NotImplementedError("weight mode or bilinear images")
    (src_name, sp), = config["sources"].items()
    optics = list(config["optics"].items())
    n_opt = len(optics)
    n_ap = sum(len([o.get("aperture")] if isinstance(o.get("aperture"), dict)
                   else list(o.get("aperture") or [])) for _, o in optics)
    fp = np.zeros(SRC_F + n_opt * OPT_F + n_ap * AP_F, np.float64)
    ip = np.zeros(18 + n_opt * 16 + n_ap * 2, np.int64)
    if sp["class_name"] == "XicsrtSourceDirected":
        src = _directed_source(sp, fp)
    elif sp["class_name"] == "XicsrtPlasmaCubic":
        src = _plasma_source(sp, fp)
    else:
        raise NotImplementedError(f"source {sp['class_name']}")
    wavelength = src["wavelength"] if src["kind"] == 0 else None
    apertures, images, img_total = [], [], 0
    for e, (name, p) in enumerate(optics):
        f = fp[SRC_F + e * OPT_F: SRC_F + (e + 1) * OPT_F]
        i = ip[18 + e * 16: 18 + (e + 1) * 16]
        im = _optic(name, p, f, i, apertures, wavelength)
        if im is not None:
            i[7] = img_total
            im["offset"] = img_total
            images.append(im)
            img_total += im["nx"] * im["ny"]
    ap_f, ap_i = SRC_F + n_opt * OPT_F, 18 + n_opt * 16
    for a, (floats, shape, logic) in enumerate(apertures):
        fp[ap_f + a * AP_F: ap_f + (a + 1) * AP_F] = floats
        ip[ap_i + 2 * a], ip[ap_i + 2 * a + 1] = shape, logic
    n_draws = src["n_draws"] + sum(1 for _, p in optics if OPTICS[p["class_name"]][1] == CRYSTAL)
    ip[0:8] = (n_opt, n_ap, src.get("cone", 0), n_draws, img_total, src["kind"],
               int(src["kind"] == 1), int(src["kind"] == 1 and src["gamma"] > 0.0))
    ip[15] = int(src["kind"] == 1)  # per-ray wavelengths
    return {"F": [float(x) for x in fp.astype(np.float32)], "I": [int(x) for x in ip],
            "source": src, "names": [src_name] + [n for n, _ in optics],
            "images": images, "img_total": img_total, "n_draws": n_draws,
            "num_iter": int(general.get("number_of_iter", 1)),
            "seed": general.get("random_seed")}


# ---------------------------------------------------------------------------
# Random numbers: the run's generator and the rays' Philox stream.
# ---------------------------------------------------------------------------

def run_generator(seed, device) -> torch.Generator:
    """The generator of run 0 of a config whose ``random_seed`` is ``seed``."""
    state = np.random.SeedSequence(int(seed), spawn_key=(0,)).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & 0x7FFFFFFFFFFFFFFF)
    return gen


def fold_in(word: int, position: int) -> int:
    """The 63-bit seed of the shard at ``position`` from a run's word."""
    state = np.random.SeedSequence(int(word), spawn_key=(int(position),))
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor):
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((t >> 32) + (p_hi >> 16)) & M32, t & M32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int) -> tuple:
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors of 32-bit words."""
    k0, k1 = k0 & M32, k1 & M32
    for rnd in range(10):
        if rnd:
            k0 = (k0 + 0x9E3779B9) & M32
            k1 = (k1 + 0xBB67AE85) & M32
        hi0, lo0 = _mulhilo32(0xD2511F53, c0)
        hi1, lo1 = _mulhilo32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_uniforms(rays: torch.Tensor, n_draws: int, seed: tuple, dtype) -> list:
    """Draw k of ray r: word k % 4 of Philox with counter (r lo, r hi, k // 4,
    0) and key ``seed``, its top 24 bits as a uniform in [0, 1)."""
    out = []
    for group in range(-(-n_draws // 4)):
        words = philox4x32_10(rays & M32, rays >> 32, torch.full_like(rays, group),
                              torch.zeros_like(rays), int(seed[0]), int(seed[1]))
        out += [(w >> 8).to(torch.float32).to(dtype) * (1.0 / 16777216.0) for w in words]
    return out[:n_draws]


def poisson_counts(lam: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Poisson counts of the rates ``lam``, each rate of 64 or more drawn as
    ``ceil(rate / 63)`` counts of equal rate below 64 and summed."""
    flat = lam.detach().reshape(-1)
    parts = torch.where(flat >= 64.0, torch.ceil(flat / 63.0),
                        torch.ones_like(flat)).to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(flat.numel(), device=flat.device), parts)
    drawn = torch.poisson((flat / parts)[owner].float(), generator=generator).to(torch.int64)
    counts = torch.zeros(flat.shape, dtype=torch.int64, device=flat.device)
    return counts.index_add_(0, owner, drawn).reshape(lam.shape)


def bundle_tables(src: dict, gen: torch.Generator, dtype) -> tuple:
    """One iteration's plasma bundles: (cum int32 [B], table [B, 8]): uniform
    offsets in the box, constant emissivity and temperature, the rate of
    each bundle and its Poisson count."""
    p, B = src["param"], src["bundle_count"]
    device = gen.device
    sizes = torch.tensor([float(p[k] or 0.0) for k in ("xsize", "ysize", "zsize")],
                         dtype=dtype, device=device)
    basis = torch.as_tensor(src["basis"], dtype=dtype, device=device)
    origin = torch.as_tensor(src["origin"], dtype=dtype, device=device)
    offsets = (torch.rand(3 * B, generator=gen, dtype=dtype, device=device)
               .reshape(B, 3) - 0.5) * sizes
    b_origin = (offsets[..., 0:1] * basis[0] + offsets[..., 1:2] * basis[1]
                + offsets[..., 2:3] * basis[2]) + origin
    emissivity = torch.as_tensor(float(p["emissivity"]), dtype=dtype, device=device).expand(B)
    temperature = torch.as_tensor(float(p["temperature"]), dtype=dtype, device=device).expand(B)
    velocity = torch.zeros(3, dtype=dtype, device=device).expand(B, 3)
    b_spread = torch.full((B,), float(p["spread"]), dtype=dtype, device=device)
    omega = 4.0 * math.pi * torch.sin(b_spread / 2.0) ** 2
    bundle_volume = float(p["bundle_volume"])
    lam = (emissivity * float(p["time_resolution"]) * bundle_volume * omega
           / (4.0 * math.pi)) * (src["volume"] / (B * bundle_volume)) * float(
               p.get("intensity_scale", 1.0))
    counts = poisson_counts(lam, gen)
    cum = torch.cumsum(counts, 0).clamp_max(2**31 - 1).to(torch.int32)
    table = torch.cat([b_origin, b_spread[:, None], temperature[:, None], velocity], dim=1)
    return cum, table


# ---------------------------------------------------------------------------
# The rays: source and chain, in the kernel's float32 operations.
# ---------------------------------------------------------------------------

def _inv_sqrt(x):
    return 1.0 / torch.sqrt(x)


def _div(x, scalar: float):
    """A true division by a scalar (not a multiply by its reciprocal)."""
    return x / torch.tensor(scalar, dtype=x.dtype, device=x.device)


def _fma(x, scale: float, offset: float):
    """``x * scale + offset`` rounded once, as ``fmaf``."""
    if x.dtype == torch.float32:
        return (x.double() * scale + offset).float()
    return x * scale + offset


def _xy_tail(sx, v, c):
    tx = sx * _inv_sqrt(torch.clamp_min(1.0 - sx * sx, 1e-12))
    k2 = 1.0 + tx * tx
    h0 = c[0] * _inv_sqrt(k2 + c[1])
    h1 = c[2] * _inv_sqrt(k2 + c[3])
    h = h0 + v * (h1 - h0)
    ty = torch.sqrt(k2) * h * _inv_sqrt(torch.clamp_min(1.0 - h * h, 1e-12))
    w = _inv_sqrt(1.0 + tx * tx + ty * ty)
    return tx * w, ty * w, w


def _aim(T, H, px, py, pz, lx, ly, lz):
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


def _normal(draw):
    un = torch.clamp(draw(), 1e-7, 1.0 - 1e-7)
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * un - 1.0)


def point_source(F, I, draw, full):
    """A point source's origin and unit direction."""
    px, py, pz = full(F[0]), full(F[1]), full(F[2])
    c = F[12:24]
    u, v = draw(), draw()
    if I[2] == CONES["isotropic"]:
        lz = c[0] + u * c[1]
        rho = torch.sqrt(torch.clamp_min(1.0 - lz * lz, 0.0))
        phi = v * TWO_PI
        lx, ly = rho * torch.cos(phi), rho * torch.sin(phi)
    else:
        sx = _div(torch.sin((c[0] + u * c[1]) * 0.5), c[2])
        lx, ly, lz = _xy_tail(sx, v, c[3:7])
    dx = lx * F[3] + ly * F[6] + lz * F[9]
    dy = lx * F[4] + ly * F[7] + lz * F[10]
    dz = lx * F[5] + ly * F[8] + lz * F[11]
    return px, py, pz, dx, dy, dz


def plasma_source(F, I, attrs, draw):
    """A plasma ray from its bundle row: voxel offset, cone to the target,
    Voigt wavelength. Returns (px, py, pz, dx, dy, dz, wl)."""
    px, py, pz = attrs[:, 0], attrs[:, 1], attrs[:, 2]
    theta, temp = attrs[:, 3], attrs[:, 4]
    vxb, vyb, vzb = attrs[:, 5], attrs[:, 6], attrs[:, 7]
    h = F[18]
    vx = (draw() - 0.5) * h
    vy = (draw() - 0.5) * h
    vz = (draw() - 0.5) * h
    px = px + vx * F[0] + vy * F[3] + vz * F[6]
    py = py + vx * F[1] + vy * F[4] + vz * F[7]
    pz = pz + vx * F[2] + vy * F[5] + vz * F[8]
    omc = 1.0 - torch.cos(theta)
    u, v = draw(), draw()
    lz = 1.0 - u * omc
    rho = torch.sqrt(torch.clamp_min(1.0 - lz * lz, 0.0))
    phi = v * TWO_PI
    dx, dy, dz = _aim(F[9:12], F[12:15], px, py, pz, rho * torch.cos(phi),
                      rho * torch.sin(phi), lz)
    wl = F[15] + F[16] * torch.sqrt(torch.clamp_min(temp, 0.0)) * _normal(draw)
    if I[7]:
        uc = torch.clamp(draw(), 1e-7, 1.0 - 1e-7)
        wl = wl + F[17] * torch.tan(math.pi * (uc - 0.5))
    wl = wl * (1.0 - (vxb * dx + vyb * dy + vzb * dz) * F[19])
    return px, py, pz, dx, dy, dz, wl


def _torus_hit(o, px, py, pz, dx, dy, dz, alive, full):
    rx, ry, rz = px - o[12], py - o[13], pz - o[14]
    olx = rx * o[3] + ry * o[4] + rz * o[5]
    oly = rx * o[6] + ry * o[7] + rz * o[8]
    olz = rx * o[9] + ry * o[10] + rz * o[11]
    dlx = dx * o[3] + dy * o[4] + dz * o[5]
    dly = dx * o[6] + dy * o[7] + dz * o[8]
    dlz = dx * o[9] + dy * o[10] + dz * o[11]
    z0 = (px - o[0]) * o[9] + (py - o[1]) * o[10] + (pz - o[2]) * o[11]
    r_maj, rmin2 = o[15], o[26]
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
    hit = alive & (torch.abs(step) < o[27]) & (t > 1e-6)
    return torch.where(hit, t, full(0.0)), hit


def _apertures(F, I, oi, lxv, lyv, m_in):
    apf = SRC_F + I[0] * OPT_F
    api = 18 + I[0] * 16
    m_out = m_in
    for a in range(oi[6], oi[6] + oi[5]):
        ox, oy, p0, p1 = F[apf + a * AP_F: apf + (a + 1) * AP_F]
        shape, logic = I[api + 2 * a], I[api + 2 * a + 1]
        ax, ay = lxv - ox, lyv - oy
        if shape == 0:
            test = torch.ones_like(m_in)
        elif shape == 1:
            test = ax * ax + ay * ay < p0
        elif shape == 2:
            test = (torch.abs(ax) < p0) & (torch.abs(ay) < p0)
        elif shape == 3:
            test = (torch.abs(ax) < p0) & (torch.abs(ay) < p1)
        else:
            ex, ey = _div(ax, p0), _div(ay, p1)
            test = ex * ex + ey * ey < 1.0
        test = test & m_in
        new = (m_out & test, m_out & ~test, m_out | test, ~(m_out & test),
               ~(m_out | test), m_out ^ test, ~(m_out ^ test))[logic]
        m_out = torch.where(m_in, new, m_out)
    return m_out & m_in


def trace_slice(F, I, alive, draw, counts, image, attrs=None, dtype=torch.float32):
    """Trace one slice of rays through the chain in ``dtype``; adds each
    element's survivors into ``counts`` (int64) and the hits into the flat
    ``image`` (float32). ``attrs``: a plasma's bundle rows of the slice."""

    def full(value):
        return torch.full(alive.shape, value, dtype=dtype, device=alive.device)

    if attrs is None:
        px, py, pz, dx, dy, dz = point_source(F, I, draw, full)
        wl = None
    else:
        px, py, pz, dx, dy, dz, wl = plasma_source(F, I, attrs, draw)
    counts[0] += alive.sum()
    for e in range(I[0]):
        o = F[SRC_F + e * OPT_F: SRC_F + (e + 1) * OPT_F]
        oi = I[18 + e * 16: 18 + (e + 1) * 16]
        if oi[0] == PLANE:
            denom = dx * o[9] + dy * o[10] + dz * o[11]
            numer = (o[0] - px) * o[9] + (o[1] - py) * o[10] + (o[2] - pz) * o[11]
            nz = torch.abs(denom) > 1e-30
            t = numer / torch.where(nz, denom, full(1e-30))
            m_int = alive & (t >= 0.0) & nz
            nxv, nyv, nzv = full(o[9]), full(o[10]), full(o[11])
        elif oi[0] == SPHERE:
            Lx, Ly, Lz = o[12] - px, o[13] - py, o[14] - pz
            t_ca = Lx * dx + Ly * dy + Lz * dz
            d2 = Lx * Lx + Ly * Ly + Lz * Lz - t_ca * t_ca
            m_int = alive & (d2 <= o[15])
            t_hc = torch.sqrt(torch.clamp_min(o[15] - d2, 0.0))
            t = t_ca - t_hc if oi[1] else t_ca + t_hc
        else:
            t, m_int = _torus_hit(o, px, py, pz, dx, dy, dz, alive, full)
        qx = torch.where(m_int, px + t * dx, px)
        qy = torch.where(m_int, py + t * dy, py)
        qz = torch.where(m_int, pz + t * dz, pz)
        if oi[0] == SPHERE:
            nxv, nyv, nzv = o[12] - qx, o[13] - qy, o[14] - qz
        elif oi[0] == TORUS:
            ptx, pty, ptz = qx - o[12], qy - o[13], qz - o[14]
            d_y = ptx * o[6] + pty * o[7] + ptz * o[8]
            plx, ply, plz = ptx - d_y * o[6], pty - d_y * o[7], ptz - d_y * o[8]
            inv = _inv_sqrt(torch.clamp_min(plx * plx + ply * ply + plz * plz, 1e-30))
            nxv = ptx - o[15] * plx * inv
            nyv = pty - o[15] * ply * inv
            nzv = ptz - o[15] * plz * inv
        if oi[0] != PLANE:
            inv = _inv_sqrt(torch.clamp_min(nxv * nxv + nyv * nyv + nzv * nzv, 1e-30))
            nxv, nyv, nzv = nxv * inv, nyv * inv, nzv * inv
        rx, ry, rz = qx - o[0], qy - o[1], qz - o[2]
        lxv = rx * o[3] + ry * o[4] + rz * o[5]
        lyv = rx * o[6] + ry * o[7] + rz * o[8]
        mask = m_int
        if oi[4] & 1:
            mask = mask & (torch.abs(lxv) < o[16])
        if oi[4] & 2:
            mask = mask & (torch.abs(lyv) < o[17])
        if oi[4] & 4:
            lzv = rx * o[9] + ry * o[10] + rz * o[11]
            mask = mask & (torch.abs(lzv) < o[18])
        mask = _apertures(F, I, oi, lxv, lyv, mask)
        if oi[2] == CRYSTAL:
            if wl is None:
                sin_b, cos_b = o[21], o[22]
            else:
                sin_b = torch.clamp(wl * o[28], 0.0, 1.0)
                cos_b = torch.sqrt(torch.clamp_min(1.0 - sin_b * sin_b, 0.0))
            adot = torch.abs(dx * nxv + dy * nyv + dz * nzv)
            cosi = torch.sqrt(torch.clamp_min(1.0 - adot * adot, 0.0))
            sd = adot * cos_b - cosi * sin_b
            delta = sd + sd * sd * sd * (1.0 / 6.0)
            z = _div(delta, o[20])
            prob = o[19] * torch.exp(-0.5 * (z * z))
            mask = mask & (prob >= draw())
            kk = 2.0 * (dx * nxv + dy * nyv + dz * nzv)
            dx = torch.where(mask, dx - kk * nxv, dx)
            dy = torch.where(mask, dy - kk * nyv, dy)
            dz = torch.where(mask, dz - kk * nzv, dz)
        px, py, pz = qx, qy, qz
        alive = mask
        counts[1 + e] += alive.sum()
        if oi[7] >= 0:
            nx, ny = oi[8], oi[9]
            fx = torch.round(_fma(lxv, o[23], o[24]))
            fy = torch.round(_fma(lyv, o[23], o[25]))
            ok = alive & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
            idx = oi[7] + fx[ok].long() * ny + fy[ok].long()
            image.index_add_(0, idx, torch.ones(idx.shape, dtype=image.dtype,
                                                device=image.device))
    return alive


# ---------------------------------------------------------------------------
# A call: one device, or shards over several.
# ---------------------------------------------------------------------------

def _run(run: dict, gen: torch.Generator, device, dtype, slice_rays: int):
    """(counts int64, flat image float32) of one unsharded run drawing from
    ``gen``."""
    F, I, src = run["F"], run["I"], run["source"]
    num_iter = run["num_iter"]
    n_per_iter = src["num_rays"]
    n_total = n_per_iter * num_iter
    counts = torch.zeros(1 + I[0], dtype=torch.int64, device=device)
    image = torch.zeros(max(run["img_total"], 1), dtype=torch.float32, device=device)
    bundles = None
    if src["kind"] == 1:
        bundles = [bundle_tables(src, gen, dtype) for _ in range(num_iter)]
    seed = torch.randint(0, 2**31 - 1, (2,), generator=gen, device=gen.device).tolist()
    for j in range(num_iter if bundles else 1):
        span = n_per_iter if bundles else n_total
        for start in range(0, span, slice_rays):
            local = torch.arange(start, min(start + slice_rays, span), dtype=torch.int64,
                                 device=device)
            rays = local + j * n_per_iter if bundles else local
            draws = iter(philox_uniforms(rays, run["n_draws"], seed, dtype)).__next__
            attrs = None
            if bundles:
                cum, table = bundles[j]
                b = torch.searchsorted(cum, local.to(cum.dtype), right=True)
                rows = table[torch.clamp_max(b, table.shape[0] - 1)]
                alive = local < cum[-1]
                attrs = torch.where(alive[:, None], rows, rows.new_zeros(()))
            else:
                alive = torch.ones_like(local, dtype=torch.bool)
            trace_slice(F, I, alive, draws, counts, image, attrs, dtype)
    return counts, image


def _shard_config(config: dict, n: int) -> dict:
    """``config`` with its source's load divided over ``n`` shards: a counted
    source's rays as whole numbers, a Poisson source's rate by its scale."""
    import copy

    config = copy.deepcopy(config)
    for sp in config["sources"].values():
        prior = float(sp.get("intensity_scale", 1.0))
        poisson = sp.get("use_poisson")
        if poisson is None:
            poisson = "Plasma" in str(sp.get("class_name", ""))
        if not poisson and sp.get("intensity") is not None:
            sp["intensity"] = int(float(sp["intensity"]) * prior) // n
            sp["intensity_scale"] = 1.0
        else:
            sp["intensity_scale"] = prior / n
    return config


def trace(config: dict, devices, dtype=torch.float32, slice_rays: int = 1 << 22) -> dict:
    """What ``raytrace`` returns for ``config`` on ``devices[0]`` (one
    device), or what ``raytrace_mp`` returns over one shard a device:
    ``{"counts": {element: int}, "images": {optic: float32 array},
    "expected": photons expected from a plasma, or None}``."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    run = build(_shard_config(config, n) if n > 1 else config)
    gen = run_generator(run["seed"], devices[0])
    if n == 1:
        parts = [_run(run, gen, devices[0], dtype, slice_rays)]
    else:
        word = int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device).item())
        parts = []
        for k, device in enumerate(devices):
            shard_gen = torch.Generator(device=device)
            shard_gen.manual_seed(fold_in(word, k))
            parts.append(_run(run, shard_gen, device, dtype, slice_rays))
    counts = sum(c.cpu() for c, _ in parts)
    flat = sum(im.cpu() for _, im in parts)
    images = {im["name"]: flat[im["offset"]: im["offset"] + im["nx"] * im["ny"]]
              .reshape(im["nx"], im["ny"]).numpy()
              for im in run["images"]}
    expected = run["source"].get("expected")
    return {"counts": dict(zip(run["names"], (int(c) for c in counts))),
            "images": images,
            "expected": None if expected is None else expected * run["num_iter"] * n}
