"""Source rays of every raytrace call completed in the window, over the
window's seconds (host clock)."""

from harness.cell import rays_per_s as read  # noqa: F401
