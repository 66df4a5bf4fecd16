"""Ray sources (``xicsrt_tpu/sources/generic.py``).

A source builds a function ``generate(params, draws, filter_params) ->
Rays`` with a fixed ray budget. Poisson counts (``use_poisson``) are drawn
once per call and realised by masking the fixed-size bundle.

The whole generic matrix of the JAX package: Generic, Directed and Focused
sources; point, uniform-box and gaussian-box origins (the box sizes of a
gaussian box are FWHMs); every angular distribution of ``ops/spread.py``;
monochrome, uniform and tabulated Voigt wavelengths; the first-order
Doppler shift of a bulk ``velocity``; counted and Poisson budgets; and the
named ``filters`` of the config's filters section, applied to the mask
last. The plasma sources, which build on :class:`SourceGeneric`, are in
``sources/plasma.py``.

Draws, in order: 3 rows of box offsets (uniforms, or normals for a
gaussian box; none for a point), the cone's two rows (normals for the
gaussian cone), one uniform row for a uniform or Voigt wavelength, and the
Poisson count.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xicsrt_tpu_torch.dispatch import GeometryElement, register
from xicsrt_tpu_torch.ops import spread as spread_ops
from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.ops import voigt as voigt_ops
from xicsrt_tpu_torch.rays import Rays

_C_LIGHT = 299792458.0
_SIGMA_TO_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


def poisson_budget(expected: float) -> int:
    """Fixed array size comfortably above a Poisson draw of ``expected``
    (6.5 sigma + margin: overflow probability < 1e-10 per draw)."""
    expected = float(expected)
    return int(expected + 6.5 * math.sqrt(max(expected, 1.0)) + 16)


@register("XicsrtSourceGeneric", "source_generic")
class SourceGeneric(GeometryElement):
    """Extended rectangular source emitting along its z-axis."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["xsize"] = 0.0
        config["ysize"] = 0.0
        config["zsize"] = 0.0
        config["intensity"] = 0.0
        config["use_poisson"] = False
        config["spatial_dist"] = "uniform"
        config["angular_dist"] = "isotropic"
        config["spread"] = np.pi
        config["wavelength_dist"] = "voigt"
        config["wavelength"] = 1.0
        config["mass_number"] = 1.0
        config["linewidth"] = 0.0
        config["temperature"] = 0.0
        config["velocity"] = np.array([0.0, 0.0, 0.0])
        config["wavelength_range"] = np.array([0.0, 0.0])
        config["filters"] = []
        config["intensity_scale"] = 1.0
        return config

    def initialize(self):
        super().initialize()
        scale = float(self.param["intensity_scale"])
        intensity = float(self.param["intensity"]) * scale
        if self.param["use_poisson"]:
            self.num_rays = poisson_budget(intensity)
        else:
            n = int(round(intensity))
            if abs(intensity - n) > 1e-9:
                self.log.warning(
                    'Source "%s": intensity*intensity_scale = %g is not an '
                    "integer; using %d rays.", self.name, intensity, n,
                )
            if n < 1:
                raise ValueError(
                    "intensity of less than one encountered (after "
                    "intensity_scale). Turn on poisson statistics."
                )
            self.num_rays = n
        self._scaled_intensity = intensity
        spatial = str(self.param["spatial_dist"]).lower()
        if spatial not in ("uniform", "gaussian"):
            raise NotImplementedError(f"spatial_dist: {spatial} not implemented.")
        wtype = str(self.param["wavelength_dist"]).lower()
        if wtype not in ("monochrome", "uniform", "voigt"):
            raise ValueError(f"Wavelength distribution {wtype} unknown")
        self._setup_wavelength()
        # (name, apply) of the source's filters, wired by the engine.
        self.filter_fns = []

    def _setup_wavelength(self):
        """The Voigt CDF table on the host (float64), or None where the
        line degenerates to one wavelength."""
        self.voigt_table = None
        if str(self.param["wavelength_dist"]).lower() != "voigt":
            return
        w0 = float(self.param["wavelength"])
        gamma = voigt_ops.natural_gamma(float(self.param["linewidth"]), w0)
        sigma = voigt_ops.doppler_sigma(float(self.param["temperature"]),
                                        float(self.param["mass_number"]), w0)
        if gamma > 0.0 or sigma > 0.0:
            self.voigt_table = voigt_ops.voigt_cdf_table(gamma, sigma)

    def build_params(self) -> dict:
        params = super().build_params()
        params["velocity"] = self.as_tensor(self.param["velocity"], (3,))
        params["wavelength"] = self.as_tensor(self.param["wavelength"])
        if self.voigt_table is not None:
            params["voigt_x"] = self.as_tensor(self.voigt_table[0])
            params["voigt_cdf"] = self.as_tensor(self.voigt_table[1])
        return params

    # --- sampling stages ------------------------------------------------
    def sample_origin(self, params, draws) -> torch.Tensor:
        sizes = tuple(float(self.param[k] or 0.0) for k in ("xsize", "ysize", "zsize"))
        n, dtype, device = self.num_rays, self.dtype, self.device
        if all(s == 0.0 for s in sizes):
            local = torch.zeros((n, 3), dtype=dtype, device=device)
        elif str(self.param["spatial_dist"]).lower() == "uniform":
            local = torch.stack(
                [(draws.uniform(n, dtype, device) - 0.5) * s for s in sizes], dim=-1)
        else:  # gaussian: the sizes are FWHMs
            local = torch.stack(
                [draws.normal(n, dtype, device) * (s / _SIGMA_TO_FWHM) for s in sizes],
                dim=-1)
        return params["frame"].point_to_external(local)

    def normal(self, params, origin) -> torch.Tensor:
        """[N,3] emission axis per ray."""
        return params["frame"].zaxis.expand(origin.shape)

    def sample_direction(self, params, draws, origin) -> torch.Tensor:
        n, dtype, device = self.num_rays, self.dtype, self.device
        name = str(self.param["angular_dist"]).lower()
        row = draws.normal if name in spread_ops.NORMAL_INPUTS else draws.uniform
        u = row(n, dtype, device)
        v = row(n, dtype, device)
        local = spread_ops.sample_direction(u, v, self.param["spread"], name)
        frame = params["frame"]
        basis = vec.orthogonal_basis(self.normal(params, origin),
                                     frame.xaxis, frame.zaxis)
        return vec.rotate_to_frame(local, basis)

    def sample_wavelength(self, params, draws, direction) -> torch.Tensor:
        """Base wavelengths, then the first-order Doppler shift of the bulk
        velocity (JAX ``generic.py:197-236``)."""
        n, dtype, device = self.num_rays, self.dtype, self.device
        wtype = str(self.param["wavelength_dist"]).lower()
        if wtype == "uniform":
            lo, hi = np.asarray(self.param["wavelength_range"], dtype=np.float64)[:2]
            w = spread_ops.uniform_range(draws.uniform(n, dtype, device), float(lo),
                                         float(hi))
        elif wtype == "voigt" and self.voigt_table is not None:
            w = params["wavelength"] + voigt_ops.sample_voigt_tabulated(
                draws.uniform(n, dtype, device), params["voigt_x"], params["voigt_cdf"])
        else:
            w = params["wavelength"].expand(n).clone()
        if np.any(np.asarray(self.param["velocity"], dtype=np.float64) != 0.0):
            w = w * (1.0 - vec.dot(direction, params["velocity"]) / _C_LIGHT)
        return w

    def make_mask(self, draws) -> torch.Tensor:
        n = self.num_rays
        if not self.param["use_poisson"]:
            return torch.ones((n,), dtype=torch.bool, device=self.device)
        count = draws.poisson(self._scaled_intensity)
        return torch.arange(n, device=self.device) < count

    def apply_filters(self, filter_params, origin, mask) -> torch.Tensor:
        """The source's filters on origins, in order; ``filter_params``:
        the params dict's ``filters`` section."""
        for name, apply in self.filter_fns:
            mask = apply(filter_params[name], origin, mask)
        return mask

    def generate(self, params, draws, filter_params=None) -> Rays:
        """One bundle (cf. ``generate_rays`` :198-227)."""
        n = self.num_rays
        origin = self.sample_origin(params, draws)
        direction = self.sample_direction(params, draws, origin)
        wavelength = self.sample_wavelength(params, draws, direction)
        mask = self.make_mask(draws)
        return Rays(
            origin=origin,
            direction=direction,
            wavelength=wavelength,
            weight=torch.ones((n,), dtype=self.dtype, device=self.device),
            mask=self.apply_filters(filter_params or {}, origin, mask),
        )


@register("XicsrtSourceDirected", "source_directed")
class SourceDirected(SourceGeneric):
    """Source emitting a cone along a fixed ``direction`` (default zaxis)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["direction"] = None
        return config

    def setup(self):
        super().setup()
        if self.param["direction"] is None:
            self.param["direction"] = np.asarray(self.param["zaxis"], dtype=np.float64)

    def build_params(self) -> dict:
        params = super().build_params()
        d = np.asarray(self.param["direction"], dtype=np.float64)
        params["direction"] = self.as_tensor(d / np.linalg.norm(d), (3,))
        return params

    def normal(self, params, origin) -> torch.Tensor:
        d = params["direction"]
        return (d / torch.linalg.norm(d)).expand(origin.shape)


@register("XicsrtSourceFocused", "source_focused")
class SourceFocused(SourceGeneric):
    """Source aiming each ray's emission cone at a fixed ``target`` point
    (``_XicsrtSourceFocused.py:15-44``)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["target"] = None
        return config

    def check_param(self):
        super().check_param()
        if self.param["target"] is None:
            raise ValueError(f'Source "{self.name}": target is required.')

    def build_params(self) -> dict:
        params = super().build_params()
        params["target"] = self.as_tensor(self.param["target"], (3,))
        return params

    def normal(self, params, origin) -> torch.Tensor:
        return vec.safe_normalize(params["target"][None, :] - origin)
