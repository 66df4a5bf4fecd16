"""The one traffic generator: each call's or step's config and seed from the run's.

A mix (``traffic/<name>.json``) holds parameters only:

- ``entry``: ``"raytrace"`` (one device) or ``"raytrace_mp"`` (the
  multiprocess entry, ``processes`` shards, one a device); ``"fit"`` is a
  fit mix's loop of gradient steps (``harness/fit.py``, its parameters);
- ``reference``: the plain reference the check runs,
  ``reference/<reference>.py`` (``trace`` for a raytrace entry, ``follow``
  and ``pack`` for a fit);
- ``processes``: the shards of ``raytrace_mp``;
- ``intensity_scale``: a factor on the configuration's source load, so
  a mix can ask for more rays a call than the configuration's file;
- ``warmup_calls``: calls made in set-up, on seeds of their own;
- ``check_calls``: calls of the window that the reference checks, drawn
  from the run's seed (``cell.Calls.window``).

Every call is the configuration's dict with its own ``random_seed``,
derived from the run's seed and the call's index, so a run's calls are
the same for one seed and differ from call to call.
"""

from __future__ import annotations

import copy

import numpy as np

WINDOW, WARMUP, SAMPLE, TARGET = 0, 1, 2, 3  # the seed streams


def seed_words(seed: int) -> int:
    """Any whole number as a non-negative entropy word."""
    return int(seed) % (1 << 64)


def stream_seed(seed: int, stream: int, index: int) -> int:
    """A 63-bit seed of call ``index`` of ``stream`` of the run ``seed``."""
    state = np.random.SeedSequence(seed_words(seed), spawn_key=(stream, index))
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def call_config(cell, seed: int, stream: int, index: int) -> dict:
    """The config dict of one call: the configuration's, its load scaled by
    the mix, its ``random_seed`` the call's own."""
    config = copy.deepcopy(cell.config["config"])
    config["general"]["random_seed"] = stream_seed(seed, stream, index)
    scale = float(cell.traffic.get("intensity_scale", 1.0))
    if scale != 1.0:
        for source in config["sources"].values():
            source["intensity_scale"] = float(source.get("intensity_scale", 1.0)) * scale
    return config


def shards(cell) -> int:
    """The shards of a call: ``processes`` for ``raytrace_mp``, else one."""
    return int(cell.traffic["processes"]) if cell.traffic.get("entry") == "raytrace_mp" else 1


def entry(cell, device: str):
    """``call(config) -> results dict`` of the mix's entry point on
    ``device`` ('cuda', or 'cpu' in the tests)."""
    import xicsrt_tpu_torch as program

    kind = cell.traffic.get("entry", "raytrace")
    if kind == "raytrace":
        return lambda config: program.raytrace(config, device=device)
    if kind == "raytrace_mp":
        processes = shards(cell)
        return lambda config: program.raytrace_mp(config, processes=processes, device=device)
    raise ValueError(f"traffic entry {kind!r}")
