"""Ray sources (``xicsrt_tpu/sources/generic.py``).

A source builds a function ``generate(params, draws) -> Rays`` with a fixed
ray budget. Poisson counts (``use_poisson``) are drawn once per call and
realised by masking the fixed-size bundle.

Ported: Generic and Directed sources; point and uniform-box origins;
isotropic and isotropic_xy cones; monochrome wavelengths (including a
'voigt' line of zero width, the default); counted and Poisson budgets.
Gaussian boxes, the other angular and wavelength distributions, bulk
velocity, Focused sources and source filters raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from xicsrt_tpu_torch.dispatch import GeometryElement, register
from xicsrt_tpu_torch.ops import spread as spread_ops
from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.rays import Rays


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
        self._check_ported()

    def _check_ported(self):
        p = self.param
        wtype = str(p["wavelength_dist"]).lower()
        zero_width_voigt = (wtype == "voigt" and float(p["linewidth"]) <= 0.0
                            and float(p["temperature"]) <= 0.0)
        if wtype != "monochrome" and not zero_width_voigt:
            raise NotImplementedError(
                f'Source "{self.name}": wavelength_dist {wtype!r} is not '
                "ported to xicsrt_tpu_torch yet (monochrome only)."
            )
        if np.any(np.asarray(p["velocity"], dtype=np.float64) != 0.0):
            raise NotImplementedError(
                f'Source "{self.name}": bulk velocity is not ported yet.')
        filters = p.get("filters")
        if filters is not None and len(filters):
            raise NotImplementedError(
                f'Source "{self.name}": source filters are not ported yet.')
        sizes = [float(p[k] or 0.0) for k in ("xsize", "ysize", "zsize")]
        spatial = str(p["spatial_dist"]).lower()
        if any(sizes) and spatial != "uniform":
            raise NotImplementedError(
                f'Source "{self.name}": spatial_dist {spatial!r} is not '
                "ported yet.")

    def build_params(self) -> dict:
        params = super().build_params()
        params["velocity"] = self.as_tensor(self.param["velocity"], (3,))
        params["wavelength"] = self.as_tensor(self.param["wavelength"])
        return params

    # --- sampling stages ------------------------------------------------
    def sample_origin(self, params, draws) -> torch.Tensor:
        sizes = tuple(float(self.param[k] or 0.0) for k in ("xsize", "ysize", "zsize"))
        n, dtype, device = self.num_rays, self.dtype, self.device
        if all(s == 0.0 for s in sizes):
            local = torch.zeros((n, 3), dtype=dtype, device=device)
        else:
            local = torch.stack(
                [(draws.uniform(n, dtype, device) - 0.5) * s for s in sizes],
                dim=-1)
        return params["frame"].point_to_external(local)

    def normal(self, params, origin) -> torch.Tensor:
        """[N,3] emission axis per ray."""
        return params["frame"].zaxis.expand(origin.shape)

    def sample_direction(self, params, draws, origin) -> torch.Tensor:
        n, dtype, device = self.num_rays, self.dtype, self.device
        u = draws.uniform(n, dtype, device)
        v = draws.uniform(n, dtype, device)
        local = spread_ops.sample_direction(
            u, v, self.param["spread"], str(self.param["angular_dist"]))
        frame = params["frame"]
        basis = vec.orthogonal_basis(self.normal(params, origin),
                                     frame.xaxis, frame.zaxis)
        return vec.rotate_to_frame(local, basis)

    def make_mask(self, draws) -> torch.Tensor:
        n = self.num_rays
        if not self.param["use_poisson"]:
            return torch.ones((n,), dtype=torch.bool, device=self.device)
        count = draws.poisson(self._scaled_intensity)
        return torch.arange(n, device=self.device) < count

    def generate(self, params, draws) -> Rays:
        """One bundle (cf. ``generate_rays`` :198-227)."""
        n = self.num_rays
        origin = self.sample_origin(params, draws)
        direction = self.sample_direction(params, draws, origin)
        wavelength = params["wavelength"].expand(n).clone()
        mask = self.make_mask(draws)
        return Rays(
            origin=origin,
            direction=direction,
            wavelength=wavelength,
            weight=torch.ones((n,), dtype=self.dtype, device=self.device),
            mask=mask,
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
    """Per-ray emission axis towards a ``target``: not ported yet."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["target"] = None
        return config

    def initialize(self):
        raise NotImplementedError(
            "XicsrtSourceFocused is not ported to xicsrt_tpu_torch yet.")
