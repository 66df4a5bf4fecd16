"""The share of the traced window of fit steps in which no kernel, copy or
set runs on a device, in percent, the mean over the cell's devices."""

from harness.devtrace import idle_pct as read  # noqa: F401
