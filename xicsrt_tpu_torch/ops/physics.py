"""X-ray physics conversions (``xicsrt_tpu/ops/physics.py``)."""

from __future__ import annotations

import torch

# h * c / e in [eV * Angstrom] (CODATA 2018 exact constants).
HC_EV_ANGSTROM = 6.62607015e-34 * 299792458.0 / 1.602176634e-19 * 1e10


def wavelength_from_energy(energy_ev):
    """Photon wavelength [Angstrom] from energy [eV]."""
    return HC_EV_ANGSTROM / energy_ev


def energy_from_wavelength(wavelength_angstrom):
    """Photon energy [eV] from wavelength [Angstrom]."""
    return HC_EV_ANGSTROM / wavelength_angstrom


def bragg_angle(wavelength, crystal_spacing, order: int = 1):
    """Bragg angle [rad]: arcsin(m * lambda / (2 d)), with ``d`` the nominal
    plane spacing (not '2d')."""
    ratio = order * wavelength / (2.0 * crystal_spacing)
    return torch.arcsin(torch.clamp(torch.as_tensor(ratio), -1.0, 1.0))
