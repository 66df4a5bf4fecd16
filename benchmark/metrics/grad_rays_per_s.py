"""Rays of every fit step completed in the window, over the window's
seconds (host clock). A step traces its rays forward once and back once;
they count once."""

from harness.cell import rays_per_s as read  # noqa: F401
