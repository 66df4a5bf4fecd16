"""Whether the window's calls returned the right answers.

A sample of the window's calls, drawn from the run's seed, is worked out
again by the plain reference (``reference/raytrace.py``) from the same
config dict, once the window has closed and the program's state is freed,
and compared with what the timed calls returned:

- ``count_diff``: rays, summed over the sampled calls and elements, by
  which the program's element counts differ from the reference's;
- ``image_diff``: photons, summed over the sampled calls, images and
  pixels, by which the program's images differ from the reference's;
- ``photon_z`` (a plasma): the largest distance, in Poisson standard
  deviations, between a sampled call's emitted photons and the
  real-units expectation of its configuration.

Each is held to its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np


def numbers(program_results: list, reference_results: list) -> dict:
    """The compared numbers of paired program and reference results (each
    reference result as ``reference.raytrace.trace`` gives it)."""
    count_diff, image_diff, photon_z = 0, 0.0, None
    for prog, ref in zip(program_results, reference_results):
        meta = prog["total"]["meta"]
        for name, n in ref["counts"].items():
            count_diff += abs(int(meta[name]["num_out"]) - n) if name in meta else n
        images = prog["total"]["image"]
        for name, im in ref["images"].items():
            if name in images and np.shape(images[name]) == im.shape:
                image_diff += float(np.abs(np.asarray(images[name], np.float64) - im).sum())
            else:
                image_diff += float(np.abs(im).sum()) + 1.0
        if ref["expected"] is not None:
            source = next(iter(ref["counts"]))
            emitted = int(meta[source]["num_out"]) if source in meta else 0
            z = abs(emitted - ref["expected"]) / np.sqrt(ref["expected"])
            photon_z = z if photon_z is None else max(photon_z, z)
    out = {"count_diff": count_diff, "image_diff": image_diff}
    if photon_z is not None:
        out["photon_z"] = float(photon_z)
    return out


def fit_numbers(program: dict, reference: dict, leaves: list) -> dict:
    """The compared numbers of a fit's steps (each side's ``losses``, first
    gradient ``grad`` and ``change`` of the trainable slots, leaf by leaf
    in ``leaves``' order, and where both have it the ``last`` step's
    ``loss`` and ``grad``):

    - ``loss_gap``: the largest of the steps' |loss - reference's| over the
      reference's;
    - ``grad_gap``: the worst leaf's gap between the program's and the
      reference's norms of the first gradient, over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``median_change_gap``: the same of the slots' change over the steps,
      the median over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (a leaf below that moves by rounding
      alone), not the worst: Adam moves each slot by about its learning
      rate whatever its gradient's size, so a slot whose gradient is near
      nought takes a step whose sign the rounding sets, and the worst
      leaf's gap swings from seed to seed in sound runs;
    - ``last_loss_gap``, ``last_grad_gap``: the last step's loss and
      gradient, measured as the first ones are.
    """
    bounds = np.cumsum([0] + [len(slots) for _, slots in leaves])
    parts = list(zip(bounds[:-1], bounds[1:]))

    def norms(v):
        return np.array([np.linalg.norm(np.asarray(v)[a:b]) for a, b in parts])

    def gaps(p, r, keep):
        scale = np.maximum(r, np.median(r))
        return [float(abs(p[k] - r[k]) / scale[k]) for k in keep]

    g_ref = norms(reference["grad"])
    moved = [k for k in range(len(parts)) if g_ref[k] >= 1e-3 * np.median(g_ref)]
    every = range(len(parts))
    out = {"loss_gap": float(max(abs(p - r) / abs(r) for p, r in
                                 zip(program["losses"], reference["losses"]))),
           "grad_gap": max(gaps(norms(program["grad"]), g_ref, every)),
           "median_change_gap": float(np.median(
               gaps(norms(program["change"]), norms(reference["change"]), moved)))}
    if "last" in program and "last" in reference:
        p, r = program["last"], reference["last"]
        out["last_loss_gap"] = abs(p["loss"] - r["loss"]) / abs(r["loss"])
        out["last_grad_gap"] = max(gaps(norms(p["grad"]), norms(r["grad"]), every))
    return out


def judged(values: dict, limits: dict) -> dict:
    """``{number: {"value", "limit"}}`` of every compared number; a number
    without a limit is reported against none and fails."""
    return {k: {"value": v, "limit": limits.get(k)} for k, v in values.items()}


def passes(checks: dict) -> bool:
    return bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                for c in checks.values())
