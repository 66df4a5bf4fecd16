"""Visualization: 2D intersection/image plots and 3D scene rendering
(``xicsrt_tpu/visual``). Elements are built on the CPU: the plots need
only their frames and sizes."""

from xicsrt_tpu_torch.visual import detview, plot2d, plot3d  # noqa: F401
