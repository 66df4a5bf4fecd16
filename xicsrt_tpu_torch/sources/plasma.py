"""Plasma sources: real-units photon emission from bundles
(``xicsrt_tpu/sources/plasma.py``).

A plasma is ``bundle_count`` bundles sampled uniformly in its box. Each
bundle emits Poisson(lambda_b) photons with the reference's real-units rate
(``_XicsrtPlasmaGeneric.py:301-319``): emissivity * time_resolution *
bundle_volume * solid_angle / (4 pi), rescaled by volume / (bundle_count *
bundle_volume). The O(bundle_count) stage (:meth:`PlasmaGeneric.make_bundle_tables`)
gives inclusive cumulative counts ``cum`` and an (B, 8) float32 attribute
table; every ray of the fixed budget ``num_rays`` then finds its bundle by
the interval gather (kernel K4, ``ops/bundle_gather.py``) and samples a
voxel offset, an isotropic cone aimed at ``target``, an exact Voigt
wavelength (Gaussian of the bundle's Doppler width plus a Cauchy of the
natural width) and the bulk-velocity Doppler shift. Rays past the realised
total are dead.

Draws, in order: 3 B uniforms of bundle offsets, B Poisson counts, then per
ray 3 N voxel uniforms (voxel bundles), N + N cone uniforms, N normals and,
with a natural linewidth, N Cauchy uniforms.

The source's ``filters`` cut bundles by their origins before the photon
rates are taken (JAX ``plasma.py:264-267``), so a filtered bundle emits
nothing on either engine.

``bundle_gather``: 'auto' and 'matmul' take kernel K4 on a CUDA device (its
plain twin on the CPU); 'gather' is the plain indexed gather everywhere.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xicsrt_tpu_torch.dispatch import register
from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.ops import voigt as voigt_ops
from xicsrt_tpu_torch.ops.spread import uniform_range
from xicsrt_tpu_torch.ops.voigt import interp
from xicsrt_tpu_torch.ops.bundle_gather import interval_gather_cuda, interval_gather_plain
from xicsrt_tpu_torch.rays import Rays
from xicsrt_tpu_torch.sources.generic import SourceGeneric, poisson_budget

_C_LIGHT = 299792458.0
_EV_J = 1.602176634e-19
_AMU_KG = 1.66053906892e-27


@register("XicsrtPlasmaGeneric", "plasma_generic")
class PlasmaGeneric(SourceGeneric):
    """Bundle-based plasma emitter (uniform profiles unless subclassed)."""

    def default_config(self) -> dict:
        """As ``XicsrtPlasmaGeneric.default_config`` (:44-158): box sizes,
        spread | spread_radius, target, emissivity [ph/m^3/s], temperature
        [eV], velocity, time_resolution [s], bundle_type ('voxel' |
        'point'), bundle_volume, bundle_count, max_rays, max_bundles,
        filters, bundle_gather ('auto' | 'matmul' | 'gather')."""
        config = super().default_config()
        config["spread"] = None
        config["spread_radius"] = None
        config["target"] = None
        config["emissivity"] = 0.0
        config["velocity"] = np.array([0.0, 0.0, 0.0])
        config["time_resolution"] = 1e-3
        config["bundle_type"] = "voxel"
        config["bundle_volume"] = 1e-6
        config["bundle_count"] = None
        config["max_rays"] = int(1e7)
        config["max_bundles"] = int(1e7)
        config["bundle_gather"] = "auto"
        config["use_poisson"] = True
        return config

    def check_config(self):
        super().check_config()
        if self.config.get("angular_dist", "isotropic") != "isotropic":
            raise NotImplementedError(
                "Plasma sources support only isotropic emission "
                "(_XicsrtPlasmaGeneric.py:55-62).")

    def initialize(self):
        # SourceGeneric.initialize does not apply: the plasma sets its own
        # budget from the bundle rates.
        p = self.param
        self.voigt_table = None
        self.filter_fns = []
        p["volume"] = float(p["xsize"]) * float(p["ysize"]) * float(p["zsize"])
        bundle_count = p["bundle_count"]
        if bundle_count is None:
            bundle_count = p["volume"] / float(p["bundle_volume"])
        self.bundle_count = int(round(float(bundle_count)))
        if self.bundle_count < 1:
            raise ValueError("Bundle volume is larger than the plasma volume.")
        if self.bundle_count > int(p["max_bundles"]):
            raise ValueError(
                f"Current settings will produce too many bundles "
                f"({self.bundle_count:0.2e}). Increase bundle_volume, set "
                f"bundle_count, or increase max_bundles.")
        if p["bundle_type"] not in ("voxel", "point"):
            raise ValueError(f'Unknown bundle_type: {p["bundle_type"]}')
        self.voxel_size = (float(p["bundle_volume"]) ** (1.0 / 3.0)
                           if p["bundle_type"] == "voxel" else 0.0)
        if p["target"] is None:
            raise ValueError(f'Plasma "{self.name}": target is required.')
        if (p["spread"] is None) == (p["spread_radius"] is None):
            raise ValueError("Exactly one of spread / spread_radius must be specified.")
        self.gather_mode = str(p.get("bundle_gather") or "auto").lower()
        if self.gather_mode not in ("auto", "matmul", "gather"):
            raise ValueError(f"Unknown bundle_gather: {self.gather_mode}")
        self.gamma = voigt_ops.natural_gamma(float(p["linewidth"]), float(p["wavelength"]))
        self.num_rays = self._estimate_budget()
        if p["max_rays"] and self.num_rays > int(p["max_rays"]):
            raise ValueError(
                f"Current settings predict too many rays "
                f"(budget {self.num_rays:0.2e} > max_rays "
                f"{int(p['max_rays']):0.2e}). Reduce integration "
                f"time or adjust other parameters.")
        self.bundle_tables = self.make_bundle_tables()
        self.rays_from_tables = self.make_rays()

    # --- host-side expected-intensity estimate --------------------------
    def _host_profiles(self, origin_local: np.ndarray) -> tuple:
        """Numpy (emissivity, mask) of bundles at local offsets [B, 3]."""
        B = origin_local.shape[0]
        return np.full(B, float(self.param["emissivity"])), np.ones(B, bool)

    def _estimate_budget(self) -> int:
        """Static ray budget from a host dry run of the rate formula; the
        same numpy computation and seed as the JAX package, so the budgets
        are equal."""
        p = self.param
        rng = np.random.default_rng(12345)
        nb = min(self.bundle_count, 65536)
        sizes = np.array([p["xsize"], p["ysize"], p["zsize"]], dtype=np.float64)
        offsets = rng.uniform(-0.5, 0.5, (nb, 3)) * sizes
        emiss, mask = self._host_profiles(offsets)
        if p["spread_radius"] is not None:
            origin = np.asarray(p["origin"], dtype=np.float64)
            target = np.asarray(p["target"], dtype=np.float64)
            dist = np.linalg.norm((offsets + origin) - target, axis=1)
            spreads = np.arctan(float(p["spread_radius"]) / dist)
        else:
            spreads = np.full(nb, float(p["spread"]))
        omega = 4.0 * np.pi * np.sin(spreads / 2.0) ** 2
        lam = (emiss * float(p["time_resolution"]) * float(p["bundle_volume"])
               * omega / (4.0 * np.pi))
        lam *= p["volume"] / (self.bundle_count * float(p["bundle_volume"]))
        lam *= float(p["intensity_scale"])
        lam = np.where(mask, lam, 0.0)
        predicted = float(lam.mean() * self.bundle_count)
        budget = poisson_budget(predicted * (1.0 + 5.0 / math.sqrt(max(nb, 1))) * 1.15)
        return max(int(budget), 16)

    # --- device-side profiles ------------------------------------------
    def profiles(self, params, origin_global, origin_local) -> dict:
        """Per-bundle emissivity, temperature, velocity [B, 3] and mask.
        Constant profiles read emissivity and temperature from ``params``,
        so autograd reaches the temperature through the Doppler width."""
        B = origin_global.shape[0]
        dtype = origin_global.dtype
        return {
            "emissivity": params["emissivity"].to(dtype).expand(B),
            "temperature": params["temperature"].to(dtype).expand(B),
            "velocity": params["velocity"].expand(B, 3),
            "mask": torch.ones((B,), dtype=torch.bool, device=origin_global.device),
        }

    def build_params(self) -> dict:
        params = super().build_params()
        params["target"] = self.as_tensor(self.param["target"], (3,))
        params["emissivity"] = self.as_tensor(self.param["emissivity"])
        params["temperature"] = self.as_tensor(self.param["temperature"])
        params["time_resolution"] = self.as_tensor(self.param["time_resolution"])
        return params

    # ------------------------------------------------------------------
    def make_bundle_tables(self):
        """``fn(params, draws, filter_params=None) -> (cum, table, total)``:
        bundle origins, profiles, filters, rates and counts (JAX
        ``plasma.py:231-300``). ``cum``
        (B,) int32 inclusive cumulative counts, ``table`` (B, 8) float32
        [origin xyz, spread, temperature, velocity xyz], ``total`` the
        realised count (a 0-d int32 tensor)."""
        p = self.param
        B = self.bundle_count
        dtype, device = self.dtype, self.device
        sizes = torch.tensor([float(p[k] or 0.0) for k in ("xsize", "ysize", "zsize")],
                             dtype=dtype, device=device)
        use_poisson = bool(p["use_poisson"])
        spread_radius = p["spread_radius"]
        bundle_volume = float(p["bundle_volume"])
        time_res = float(p["time_resolution"])
        volume = float(p["volume"])
        intensity_scale = float(p["intensity_scale"])

        def bundle_tables(params, draws, filter_params=None):
            frame = params["frame"]
            offsets = (draws.uniform(3 * B, dtype, device).reshape(B, 3) - 0.5) * sizes
            b_origin = frame.point_to_external(offsets)
            prof = self.profiles(params, b_origin, offsets)
            b_mask = self.apply_filters(filter_params or {}, b_origin, prof["mask"])
            if spread_radius is not None:
                dist = vec.magnitude(b_origin - params["target"][None, :])
                b_spread = torch.arctan(float(spread_radius) / dist)
            else:
                b_spread = torch.full((B,), float(p["spread"]), dtype=dtype, device=device)
            omega = 4.0 * math.pi * torch.sin(b_spread / 2.0) ** 2
            lam = (prof["emissivity"] * time_res * bundle_volume * omega
                   / (4.0 * math.pi)) * (volume / (B * bundle_volume)) * intensity_scale
            lam = torch.where(b_mask, lam, torch.zeros_like(lam))
            if use_poisson:
                counts = draws.poisson_counts(lam)
            else:
                counts = torch.floor(lam.detach()).to(torch.int64)
            # Counts sum in int64; the budget never reaches 2^31 rays, so
            # saturating the cumulative sum changes no ray's bundle.
            cum = torch.cumsum(counts, 0).clamp_max(2**31 - 1).to(torch.int32)
            table = torch.cat([
                b_origin.to(torch.float32),
                b_spread[:, None].to(torch.float32),
                prof["temperature"][:, None].to(torch.float32),
                prof["velocity"].to(torch.float32),
            ], dim=1)
            return cum, table, cum[-1]

        return bundle_tables

    def make_rays(self):
        """``fn(params, cum, table, draws) -> Rays``: the per-ray stage of
        one iteration (JAX ``plasma.py:331-405``)."""
        N = self.num_rays
        dtype, device = self.dtype, self.device
        voxel = self.voxel_size
        w0 = float(self.param["wavelength"])
        gamma = self.gamma
        mc2 = float(self.param["mass_number"]) * _AMU_KG * _C_LIGHT**2
        gather = interval_gather_plain if self.gather_mode == "gather" else interval_gather_cuda

        def rays(params, cum, table, draws):
            frame = params["frame"]
            mask = torch.arange(N, device=device) < torch.clamp_max(cum[-1], N)
            attrs = gather(cum, table, N).to(dtype)
            r_origin, theta = attrs[:, 0:3], attrs[:, 3]
            r_temp, r_vel = attrs[:, 4], attrs[:, 5:8]
            if voxel > 0.0:
                u = draws.uniform(3 * N, dtype, device).reshape(N, 3)
                r_origin = r_origin + frame.vector_to_external(
                    uniform_range(u, -voxel / 2, voxel / 2))

            normal = vec.safe_normalize(params["target"][None, :] - r_origin)
            u = draws.uniform(N, dtype, device)
            phi = uniform_range(draws.uniform(N, dtype, device), 0.0, 2.0 * math.pi)
            z = 1.0 - u * (1.0 - torch.cos(theta))
            rho = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
            local = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], dim=-1)
            basis = vec.orthogonal_basis(normal, frame.xaxis, frame.zaxis)
            direction = vec.rotate_to_frame(local, basis)

            sigma = torch.sqrt(torch.clamp_min(r_temp, 0.0) * _EV_J / mc2) * w0
            w = w0 + sigma * draws.normal(N, dtype, device)
            if gamma > 0.0:
                uc = uniform_range(draws.uniform(N, dtype, device), 1e-7, 1.0 - 1e-7)
                w = w + gamma * torch.tan(math.pi * (uc - 0.5))
            w = w * (1.0 - vec.dot(r_vel, direction) / _C_LIGHT)
            return Rays(origin=r_origin, direction=direction, wavelength=w,
                        weight=torch.ones((N,), dtype=dtype, device=device), mask=mask)

        return rays

    def generate(self, params, draws, filter_params=None) -> Rays:
        """One iteration: fresh bundle tables, then the rays."""
        cum, table, _ = self.bundle_tables(params, draws, filter_params)
        return self.rays_from_tables(params, cum, table, draws)


@register("XicsrtPlasmaCubic", "plasma_cubic")
class PlasmaCubic(PlasmaGeneric):
    """Constant emissivity and temperature through the box
    (``_XicsrtPlasmaCubic.py:23-35``)."""


@register("XicsrtPlasmaCylindrical", "plasma_cylindrical")
class PlasmaCylindrical(PlasmaGeneric):
    """1/r profiles around the local y axis; the radius uses the local
    (z, x) plane (``_XicsrtPlasmaCylindrical.py:44-52``)."""

    def _host_profiles(self, origin_local):
        r = np.sqrt(origin_local[:, 2] ** 2 + origin_local[:, 0] ** 2)
        r = np.maximum(r, 1e-12)
        return float(self.param["emissivity"]) / r, np.ones(len(r), bool)

    def profiles(self, params, origin_global, origin_local) -> dict:
        B = origin_global.shape[0]
        r = torch.sqrt(origin_local[:, 2] ** 2 + origin_local[:, 0] ** 2)
        r = torch.clamp_min(r, 1e-12)
        return {
            "emissivity": float(self.param["emissivity"]) / r,
            "temperature": float(self.param["temperature"]) / r,
            "velocity": params["velocity"].expand(B, 3),
            "mask": torch.ones((B,), dtype=torch.bool, device=r.device),
        }


@register("XicsrtPlasmaToroidal", "plasma_toroidal")
class PlasmaToroidal(PlasmaGeneric):
    """Toroidal flux-coordinate plasma with a circular cross-section:
    rho = (distance from the axis circle of radius ``major_radius`` about
    global z through ``torus_origin``) / ``minor_radius``. Profiles are
    constant inside rho <= 1 unless a subclass overrides the
    ``profile_*`` hooks, which take ``(rho, xp)`` with ``xp`` numpy or
    torch."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["major_radius"] = 0.0
        config["minor_radius"] = 0.0
        config["torus_origin"] = np.array([0.0, 0.0, 0.0])
        config["emissivity_scale"] = 1.0
        config["temperature_scale"] = 1.0
        config["velocity_scale"] = 1.0
        return config

    def profile_emissivity(self, rho, xp):
        return xp.where(rho <= 1.0, float(self.param["emissivity"]), 0.0)

    def profile_temperature(self, rho, xp):
        return xp.where(rho <= 1.0, float(self.param["temperature"]), 1e-6)

    def _rho(self, points_global, xp):
        origin = np.asarray(self.param["torus_origin"], dtype=np.float64)
        if xp is not np:
            origin = torch.as_tensor(origin, dtype=points_global.dtype,
                                     device=points_global.device)
        p = points_global - origin
        r_cyl = xp.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        d = xp.sqrt((r_cyl - float(self.param["major_radius"])) ** 2 + p[..., 2] ** 2)
        return d / float(self.param["minor_radius"])

    def _host_profiles(self, origin_local):
        origin = np.asarray(self.param["origin"], dtype=np.float64)
        rho = self._rho(origin_local + origin, np)
        emiss = self.profile_emissivity(rho, np) * float(self.param["emissivity_scale"])
        return emiss, np.isfinite(emiss)

    # flx = (rho^2, poloidal angle, toroidal angle), host-side numpy
    # (JAX plasma.py:494-523; a self-inverse pair).
    def flx_from_car(self, point_car):
        p = np.asarray(point_car, dtype=np.float64) - np.asarray(
            self.param["torus_origin"], dtype=np.float64)
        r = np.hypot(p[..., 0], p[..., 1])
        d = r - float(self.param["major_radius"])
        rho = np.hypot(d, p[..., 2]) / float(self.param["minor_radius"])
        theta = np.arctan2(p[..., 2], d)
        phi = np.arctan2(p[..., 1], p[..., 0])
        return np.stack([rho**2, theta, phi], axis=-1)

    def rho_from_car(self, point_car):
        return np.sqrt(self.flx_from_car(point_car)[..., 0])

    def car_from_flx(self, point_flx):
        flx = np.asarray(point_flx, dtype=np.float64)
        d = np.sqrt(flx[..., 0]) * float(self.param["minor_radius"])
        r = float(self.param["major_radius"]) + d * np.cos(flx[..., 1])
        z = d * np.sin(flx[..., 1])
        car = np.stack([r * np.cos(flx[..., 2]), r * np.sin(flx[..., 2]), z], axis=-1)
        return car + np.asarray(self.param["torus_origin"], dtype=np.float64)

    def profiles(self, params, origin_global, origin_local) -> dict:
        B = origin_global.shape[0]
        dtype = origin_global.dtype
        rho = self._rho(origin_global, torch)
        emiss = self.profile_emissivity(rho, torch).to(dtype) * float(
            self.param["emissivity_scale"])
        temp = self.profile_temperature(rho, torch).to(dtype) * float(
            self.param["temperature_scale"])
        return {
            "emissivity": emiss,
            "temperature": temp,
            "velocity": params["velocity"].expand(B, 3) * float(self.param["velocity_scale"]),
            "mask": torch.isfinite(temp) & torch.isfinite(emiss),
        }


@register("XicsrtPlasmaToroidalDatafile", "plasma_toroidal_datafile")
class PlasmaToroidalDatafile(PlasmaToroidal):
    """Toroidal plasma with rho profiles interpolated from two-column text
    files (rho, value) (``_XicsrtPlasmaToroidalDatafile.py:21-45``)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["emissivity_file"] = None
        config["temperature_file"] = None
        config["velocity_file"] = None
        return config

    def initialize(self):
        # Tables load before the budget estimate, which reads the profiles.
        self._emiss_table = self._load_table(self.param["emissivity_file"])
        self._temp_table = self._load_table(self.param["temperature_file"])
        super().initialize()

    @staticmethod
    def _load_table(filename):
        if filename is None:
            return None
        data = np.loadtxt(filename, dtype=np.float64)
        order = np.argsort(data[:, 0])
        return data[order, 0], data[order, 1]

    @staticmethod
    def _interp(rho, table, xp):
        x, y = table
        if xp is np:
            return np.interp(rho, x, y, left=0.0, right=0.0)
        return interp(rho, x, y)

    def profile_emissivity(self, rho, xp):
        if self._emiss_table is None:
            return super().profile_emissivity(rho, xp)
        return self._interp(rho, self._emiss_table, xp)

    def profile_temperature(self, rho, xp):
        if self._temp_table is None:
            return super().profile_temperature(rho, xp)
        return self._interp(rho, self._temp_table, xp)
