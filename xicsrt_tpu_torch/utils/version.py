"""Version compatibility warnings (a copy of ``xicsrt_tpu/utils/version.py``)."""

from __future__ import annotations

import logging

from xicsrt_tpu_torch._version import __version__

log = logging.getLogger("xicsrt_tpu_torch")


def warn_version(version_requested: str) -> None:
    """Warn when a config/script was written for a different release series.

    Mirrors ``util/version.py:16-23``: compares the leading components of the
    requested version string against the current package version.
    """
    current = __version__.split(".")
    requested = str(version_requested).split(".")
    if current[: len(requested)] != requested:
        log.warning(
            "This script was written for version %s but xicsrt_tpu_torch is at %s. "
            "Results may differ.",
            version_requested,
            __version__,
        )
