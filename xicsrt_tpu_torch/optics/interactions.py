"""Interaction mixins (``xicsrt_tpu/optics/interactions.py``).

Ported: pass-through, specular mirror (``_InteractMirror.py:29-42``) and the
Bragg crystal with gaussian, step or tabulated (``file``) rocking curves and
Bernoulli (``mc``) acceptance or ray weighting (``weight``, the
differentiable mode of ``xicsrt_tpu/optics/interactions.py:178-189``)
(``_InteractCrystal.py:90-196``). The Bragg angle is the true ``arcsin``, as
the JAX XLA engine computes it. Mosaic crystals are not ported yet.
"""

from __future__ import annotations

import math

import torch

from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.ops.voigt import interp
from xicsrt_tpu_torch.optics.base import TraceElement
from xicsrt_tpu_torch.rays import Rays
from xicsrt_tpu_torch.utils import bragg_files

_FWHM_TO_SIGMA = 1.0 / (2.0 * math.sqrt(2.0 * math.log(2.0)))


class InteractNone(TraceElement):
    """Pass-through surface (detectors, apertures)."""

    def interact(self, params, rays: Rays, xloc, norm, mask, draws):
        return rays.replace(mask=mask)


class InteractMirror(TraceElement):
    """Perfect specular mirror."""

    def interact(self, params, rays: Rays, xloc, norm, mask, draws):
        reflected = vec.reflect(rays.direction, norm)
        direction = torch.where(mask[:, None], reflected, rays.direction)
        return rays.replace(direction=direction, mask=mask)


class InteractCrystal(InteractMirror):
    """Bragg-reflecting crystal with step, gaussian or file rocking curves."""

    def default_config(self) -> dict:
        """
        crystal_spacing: nominal 'd' plane spacing [Angstrom] (not '2d').
        reflectivity: scalar probability multiplier.
        check_bragg: if False, acts as a perfect mirror.
        rocking_type: 'step' | 'gaussian' | 'file'.
        rocking_fwhm: curve width [rad] for step/gaussian.
        rocking_file / rocking_filetype: tabulated curve ('xop' or 'simple').
        rocking_mix: sigma/pi mixing factor: p = mix*sigma + (1-mix)*pi.
        """
        config = super().default_config()
        config["crystal_spacing"] = 0.0
        config["reflectivity"] = 1.0
        config["check_bragg"] = True
        config["rocking_type"] = "gaussian"
        config["rocking_fwhm"] = None
        config["rocking_file"] = None
        config["rocking_filetype"] = None
        config["rocking_mix"] = 0.5
        return config

    def initialize(self):
        super().initialize()
        self.param["rocking_type"] = str(self.param["rocking_type"]).lower()
        self.rocking_table = None
        if self.param["rocking_type"] == "file":
            self.rocking_table = bragg_files.read(
                self.param["rocking_file"], self.param["rocking_filetype"])
        if not self.param["check_bragg"]:
            return
        if self.param["rocking_type"] not in ("step", "gaussian", "file"):
            raise ValueError(
                f"Rocking curve type not understood: {self.param['rocking_type']}")
        if self.interact_mode not in ("mc", "weight"):
            raise ValueError(f"Unknown interact_mode: {self.interact_mode}")

    def build_params(self) -> dict:
        params = super().build_params()
        params["crystal_spacing"] = self.as_tensor(self.param["crystal_spacing"])
        params["reflectivity"] = self.as_tensor(self.param["reflectivity"])
        if not self.param["check_bragg"]:
            return params
        if self.param["rocking_type"] in ("step", "gaussian"):
            fwhm = self.param["rocking_fwhm"]
            if fwhm is None:
                raise ValueError(
                    f'Optic "{self.name}": rocking_fwhm required for '
                    f'rocking_type={self.param["rocking_type"]}.'
                )
            params["rocking_fwhm"] = self.as_tensor(fwhm)
        if self.rocking_table is not None:
            params["rocking_dtheta"] = self.as_tensor(self.rocking_table["dtheta"])
            params["rocking_sigma"] = self.as_tensor(self.rocking_table["reflect_s"])
            params["rocking_pi"] = self.as_tensor(self.rocking_table["reflect_p"])
            params["rocking_mix"] = self.as_tensor(self.param["rocking_mix"])
        return params

    def reflection_probability(self, params, delta):
        """Probability in [0, 1] at ``delta`` = incident - bragg [rad]."""
        if self.param["rocking_type"] == "step":
            p = torch.where(torch.abs(delta) <= params["rocking_fwhm"] / 2.0,
                            1.0, 0.0).to(delta.dtype)
        elif self.param["rocking_type"] == "file":  # _InteractCrystal.py:151-181
            s = interp(delta, params["rocking_dtheta"], params["rocking_sigma"])
            pi = interp(delta, params["rocking_dtheta"], params["rocking_pi"])
            mix = params["rocking_mix"]
            p = mix * s + (1.0 - mix) * pi
        else:
            sigma = params["rocking_fwhm"] * _FWHM_TO_SIGMA
            p = torch.exp(-0.5 * (delta / sigma) ** 2)
        return p * params["reflectivity"]

    @staticmethod
    def angle_calc(params, rays: Rays, norm):
        """(bragg_angle, incident_angle) per ray; cf. ``angle_calc`` :96-114."""
        bragg = torch.arcsin(torch.clamp(
            rays.wavelength / (2.0 * params["crystal_spacing"]), -1.0, 1.0))
        dot = torch.abs(vec.dot(rays.direction, norm))
        incident = torch.arcsin(torch.clamp(dot, 0.0, 1.0))
        return bragg, incident

    def interact(self, params, rays: Rays, xloc, norm, mask, draws):
        if not self.param["check_bragg"]:
            return super().interact(params, rays, xloc, norm, mask, draws)
        bragg, incident = self.angle_calc(params, rays, norm)
        p = self.reflection_probability(params, incident - bragg)
        if self.interact_mode == "mc":
            u = draws.uniform(rays.n, rays.dtype, rays.device)
            mask = mask & (p >= u)
            weight = rays.weight
        else:  # weight: no draw; the ray carries the probability
            weight = torch.where(mask, rays.weight * p, rays.weight)
        reflected = vec.reflect(rays.direction, norm)
        direction = torch.where(mask[:, None], reflected, rays.direction)
        return rays.replace(direction=direction, mask=mask, weight=weight)
