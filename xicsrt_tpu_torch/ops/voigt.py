"""Voigt line-shape helpers (``xicsrt_tpu/ops/voigt.py``).

Host-side float64 functions of the line width, and the tabulated-CDF
sampler of the generic ``voigt`` wavelength distribution: the table is made
once on the host (float64, scipy's Faddeeva function) and the uniforms are
mapped through it by piecewise-linear interpolation on the device. The
plasma sources, and every fused kernel, sample the Voigt line exactly
instead, as a Gaussian of the Doppler width plus a Cauchy of width
``natural_gamma``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_C_LIGHT = 299792458.0
_AMU_KG = 1.66053906892e-27
_EV_J = 1.602176634e-19


def voigt_profile(x, intensity, location, sigma, gamma):
    """Voigt profile via the Faddeeva function (host-side, numpy)."""
    from scipy.special import wofz

    z = (np.asarray(x) - location + 1j * gamma) / math.sqrt(2.0) / sigma
    return wofz(z).real / math.sqrt(2.0 * math.pi) / sigma * intensity


def voigt_cdf_table(gamma, sigma, gridsize: int = 1000, cutoff: float = 1e-5):
    """The Voigt CDF on a sinh-spaced grid, dense near the line centre and
    reaching where the profile falls to ``cutoff`` of its peak (JAX
    ``voigt.py:25-71``). Returns (x, cdf), float64 numpy arrays."""
    if gamma <= 0.0 and sigma <= 0.0:
        raise ValueError("voigt_cdf_table requires gamma > 0 or sigma > 0.")
    if sigma <= 0.0:
        hw = gamma
    elif gamma <= 0.0:
        hw = sigma * math.sqrt(2.0 * math.log(2.0))
    else:
        g_hw = sigma * math.sqrt(2.0 * math.log(2.0))
        hw = 0.5346 * gamma + math.sqrt(0.2166 * gamma**2 + g_hw**2)
    lorentz_cut = gamma * math.sqrt(1.0 / cutoff - 1.0) if gamma > 0 else 0.0
    gauss_cut = (sigma * math.sqrt(max(-2.0 * math.log(cutoff * sigma * math.sqrt(2 * math.pi)),
                                       1.0))
                 if sigma > 0 else 0.0)
    extent = max(lorentz_cut, gauss_cut, 10.0 * hw)
    half = gridsize // 2
    t = np.linspace(0.0, 1.0, half + 1)
    pos = (hw / 2.0) * np.sinh(t * np.arcsinh(extent / (hw / 2.0)))
    bounds = np.concatenate([-pos[::-1], pos[1:]])
    centers = 0.5 * (bounds[:-1] + bounds[1:])
    if sigma <= 0.0:
        pdf = gamma / math.pi / (centers**2 + gamma**2)
    else:
        pdf = voigt_profile(centers, 1.0, 0.0, sigma, max(gamma, 0.0))
    cdf = np.cumsum(pdf * np.diff(bounds))
    if cdf.max() < 0.99:
        raise ValueError("Voigt CDF table domain too small.")
    return bounds[1:], cdf


def interp(x, xp_tab, fp_tab, left=0.0, right=0.0):
    """Piecewise-linear interpolation on tensors, as ``jnp.interp`` does it:
    ``fp[i-1] + (x - xp[i-1]) / (xp[i] - xp[i-1]) * (fp[i] - fp[i-1])`` with
    ``i`` from ``torch.searchsorted``, ``fp[i-1]`` on a flat interval."""
    xt = torch.as_tensor(xp_tab, dtype=x.dtype, device=x.device)
    ft = torch.as_tensor(fp_tab, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xt, x.contiguous(), right=True), 1, len(xt) - 1)
    dx = xt[i] - xt[i - 1]
    flat = torch.abs(dx) <= np.spacing(torch.finfo(x.dtype).eps)
    f = torch.where(flat, ft[i - 1],
                    ft[i - 1] + (x - xt[i - 1]) / torch.where(flat, 1.0, dx) * (ft[i] - ft[i - 1]))
    f = torch.where(x < xt[0], left, f)
    return torch.where(x > xt[-1], right, f)


def sample_voigt_tabulated(u: torch.Tensor, x_tab: torch.Tensor,
                           cdf_tab: torch.Tensor) -> torch.Tensor:
    """Offsets from the line centre by inverse-transform sampling of the
    table (JAX ``voigt.py:74-81``): ``u`` in [0, 1) mapped to [cdf[0],
    cdf[-1]] as ``jax.random.uniform(minval, maxval)`` maps it, then
    interpolated. The table is taken in the uniforms' dtype."""
    x_tab = x_tab.to(u.dtype)
    cdf_tab = cdf_tab.to(u.dtype)
    lo = cdf_tab[0]
    return interp(torch.maximum(u * (cdf_tab[-1] - lo) + lo, lo), cdf_tab, x_tab)


def doppler_sigma(temperature_ev, mass_number, wavelength) -> float:
    """Gaussian sigma [Angstrom] from the ion temperature [eV]:
    sqrt(T / (m c^2)) * wavelength."""
    return math.sqrt(max(temperature_ev, 0.0) * _EV_J
                     / (mass_number * _AMU_KG * _C_LIGHT**2)) * wavelength


def natural_gamma(linewidth_hz, wavelength) -> float:
    """Lorentzian gamma [Angstrom] from the natural linewidth [1/s]."""
    return linewidth_hz * wavelength**2 / (4.0 * math.pi * _C_LIGHT * 1e10)
