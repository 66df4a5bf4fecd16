"""Rocking-curve data file readers (host side).

A copy of ``xicsrt_tpu/utils/bragg_files.py`` (the port imports nothing of
the JAX package). Equivalent of ``xicsrt/tools/xicsrt_bragg.py``: loads tabulated
dynamical-diffraction rocking curves into a standardized dict

    {"dtheta": [M] radians, "reflect_s": [M], "reflect_p": [M]}

ready to be embedded as device arrays for on-device interpolation. Supported
formats: ``xop`` (diff_pat.dat: columns dtheta_in/dtheta_out/phase_p/phase_s/
circular/reflect_p/reflect_s, angles in urad), and ``simple`` (3 columns:
dtheta[rad], reflect_s, reflect_p). A sigma/pi pair of files may be given as
a 2-element list.
"""

from __future__ import annotations

import os

import numpy as np

_UNIT_SCALE = {
    "urad": 1e-6,
    "arcsec": np.pi / (180.0 * 3600.0),
    # The reference accepts the (misspelled) 'arcset' token from old files.
    "arcset": np.pi / (180.0 * 3600.0),
    "rad": 1.0,
    "deg": np.pi / 180.0,
}


def read(filename, filetype=None) -> dict:
    """Read rocking-curve data; returns dtheta [rad] + sigma/pi reflectivity."""
    if isinstance(filename, (list, tuple)):
        if len(filename) != 2:
            raise ValueError("rocking_file list must contain [sigma_file, pi_file].")
        out_s = read(filename[0], filetype)
        out_p = read(filename[1], filetype)
        dtheta = out_s["dtheta"]
        reflect_p = np.interp(
            dtheta, out_p["dtheta"], out_p["reflect_p"], left=0.0, right=0.0
        )
        return {"dtheta": dtheta, "reflect_s": out_s["reflect_s"], "reflect_p": reflect_p}

    if filetype is None:
        filetype = _guess_filetype(filename)
    if filetype is None:
        raise ValueError(
            "Could not guess the rocking-curve filetype; pass rocking_filetype."
        )
    filetype = str(filetype).lower()
    if filetype == "xop":
        return read_xop(filename)
    if filetype == "simple":
        return read_simple(filename)
    raise ValueError(f"Rocking-curve filetype {filetype} not recognized.")


def _guess_filetype(filename):
    root = os.path.splitext(os.path.basename(filename))[0]
    if root == "diff_pat":
        return "xop"
    return None


def read_xop(filename) -> dict:
    """XOP diff_pat.dat: '#'-prefixed header then 7 whitespace columns."""
    data = np.loadtxt(filename, dtype=np.float64, comments="#")
    if data.ndim != 2 or data.shape[1] < 7:
        raise ValueError(f"Unexpected XOP diff_pat format in {filename}.")
    dtheta = data[:, 0] * _UNIT_SCALE["urad"]
    order = np.argsort(dtheta)
    return {
        "dtheta": dtheta[order],
        "reflect_p": data[order, 5],
        "reflect_s": data[order, 6],
    }


def read_simple(filename) -> dict:
    """Plain 3-column text: dtheta [rad], reflect_s, reflect_p."""
    data = np.loadtxt(filename, dtype=np.float64, comments="#")
    if data.ndim != 2 or data.shape[1] < 3:
        raise ValueError(f"Unexpected simple rocking-curve format in {filename}.")
    order = np.argsort(data[:, 0])
    return {
        "dtheta": data[order, 0],
        "reflect_s": data[order, 1],
        "reflect_p": data[order, 2],
    }
