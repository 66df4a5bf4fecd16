"""Interaction mixins (``xicsrt_tpu/optics/interactions.py``).

Pass-through, specular mirror (``_InteractMirror.py:29-42``), the Bragg
crystal with gaussian, step or tabulated (``file``) rocking curves and
Bernoulli (``mc``) acceptance or ray weighting (``weight``, the
differentiable mode of ``xicsrt_tpu/optics/interactions.py:178-189``)
(``_InteractCrystal.py:90-196``), and the multi-layer mosaic crystal
(``_InteractMosaicCrystal.py:53-139``; JAX ``interactions.py:194-307``) in
both modes. The Bragg angle is the true ``arcsin``, as the JAX XLA engine
computes it.
"""

from __future__ import annotations

import math

import torch

from xicsrt_tpu_torch.ops import vector as vec
from xicsrt_tpu_torch.ops.spread import sample_flat_gaussian
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


class InteractMosaicCrystal(InteractCrystal):
    """Multi-layer mosaic (HOPG) crystal.

    Each of ``mosaic_depth`` layers draws a crystallite normal per ray from
    a flat gaussian about the surface normal (two standard normals, then a
    uniform: the layer's draws in order). In ``mc`` mode the first layer
    whose crystallite accepts the ray (rocking probability against the
    uniform) reflects it; a fixed depth stands in for the reference's early
    break (``_InteractMosaicCrystal.py:83-104``). In ``weight`` mode every
    layer tests the incoming direction: the weight takes the survival
    probability P = 1 - prod(1 - p_i), and the direction is the reflection
    off the layer picked by reservoir sampling of q_i = p_i prod_{j<i}(1 -
    p_j), with the uniform as the pick (JAX ``interactions.py:268-305``).
    """

    def default_config(self) -> dict:
        """
        mosaic_spread: fwhm [rad] of the crystallite normal distribution.
        mosaic_depth: number of crystallite layers to model.
        mosaic_cutoff: optional probability cutoff prefilter.
        """
        config = super().default_config()
        config["mosaic_spread"] = 0.0
        config["mosaic_depth"] = 15
        config["mosaic_cutoff"] = None
        return config

    def mosaic_normals(self, norm, draws, n: int):
        """One layer's crystallite normals [n, 3]: a flat gaussian of
        half width ``mosaic_spread / 2`` in the per-ray basis of
        ``vec.orthogonal_basis(norm, e1, e3)`` (reference
        ``mosaic_normals``, :109-139)."""
        gx = draws.normal(n, norm.dtype, norm.device)
        gy = draws.normal(n, norm.dtype, norm.device)
        local = sample_flat_gaussian(gx, gy, float(self.param["mosaic_spread"]) / 2.0)
        e1 = torch.tensor([1.0, 0.0, 0.0], dtype=norm.dtype, device=norm.device)
        e3 = torch.tensor([0.0, 0.0, 1.0], dtype=norm.dtype, device=norm.device)
        return vec.rotate_to_frame(local, vec.orthogonal_basis(norm, e1, e3))

    def interact(self, params, rays: Rays, xloc, norm, mask, draws):
        if not self.param["check_bragg"]:
            return InteractMirror.interact(self, params, rays, xloc, norm, mask, draws)
        n = rays.n
        depth = int(self.param["mosaic_depth"])
        cutoff = self.param["mosaic_cutoff"]
        if cutoff is not None:  # :236-241
            bragg, incident = self.angle_calc(params, rays, norm)
            sigma = float(self.param["mosaic_spread"]) * _FWHM_TO_SIGMA
            angle_cutoff = math.sqrt(-math.log(cutoff) * 2.0) * sigma
            mask = mask & (torch.abs(bragg - incident) < angle_cutoff)

        if self.interact_mode == "mc":  # :243-266
            direction = rays.direction
            reflected = torch.zeros_like(mask)
            for _ in range(depth):
                norm_m = self.mosaic_normals(norm, draws, n)
                bragg, incident = self.angle_calc(
                    params, rays.replace(direction=direction), norm_m)
                p = self.reflection_probability(params, incident - bragg)
                u = draws.uniform(n, rays.dtype, rays.device)
                accept = mask & ~reflected & (p >= u)
                direction = torch.where(accept[:, None],
                                        vec.reflect(direction, norm_m), direction)
                reflected = reflected | accept
            return rays.replace(direction=direction, mask=mask & reflected)

        chosen = rays.direction  # weight mode, :268-305
        surv = torch.ones(n, dtype=rays.dtype, device=rays.device)
        cum = torch.zeros_like(surv)
        for _ in range(depth):
            norm_m = self.mosaic_normals(norm, draws, n)
            bragg, incident = self.angle_calc(params, rays, norm_m)
            p = self.reflection_probability(params, incident - bragg)
            q = p * surv
            cum = cum + q
            u = draws.uniform(n, rays.dtype, rays.device)
            pick = u * cum < q  # replace with probability q / cum
            chosen = torch.where(pick[:, None], vec.reflect(rays.direction, norm_m), chosen)
            surv = surv * (1.0 - p)
        weight = torch.where(mask, rays.weight * cum, rays.weight)
        reflected = mask & (cum > 0.0)
        direction = torch.where(reflected[:, None], chosen, rays.direction)
        return rays.replace(direction=direction, mask=mask, weight=weight)
