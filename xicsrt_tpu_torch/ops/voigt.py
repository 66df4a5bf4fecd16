"""Voigt line-shape helpers (``xicsrt_tpu/ops/voigt.py``).

Host-side float64 functions of the line width. The plasma sources sample
the Voigt line exactly, as a Gaussian of per-ray Doppler width plus a
Cauchy of width ``natural_gamma``; the tabulated-CDF sampler of the
generic ``voigt`` wavelength distribution is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

_C_LIGHT = 299792458.0
_AMU_KG = 1.66053906892e-27
_EV_J = 1.602176634e-19


def voigt_profile(x, intensity, location, sigma, gamma):
    """Voigt profile via the Faddeeva function (host-side, numpy)."""
    from scipy.special import wofz

    z = (np.asarray(x) - location + 1j * gamma) / math.sqrt(2.0) / sigma
    return wofz(z).real / math.sqrt(2.0 * math.pi) / sigma * intensity


def doppler_sigma(temperature_ev, mass_number, wavelength) -> float:
    """Gaussian sigma [Angstrom] from the ion temperature [eV]:
    sqrt(T / (m c^2)) * wavelength."""
    return math.sqrt(max(temperature_ev, 0.0) * _EV_J
                     / (mass_number * _AMU_KG * _C_LIGHT**2)) * wavelength


def natural_gamma(linewidth_hz, wavelength) -> float:
    """Lorentzian gamma [Angstrom] from the natural linewidth [1/s]."""
    return linewidth_hz * wavelength**2 / (4.0 * math.pi * _C_LIGHT * 1e10)
