"""Position-based filters of ray or bundle origins
(``xicsrt_tpu/filters/sightline.py``).

A filter makes ``apply(params, origin, mask) -> mask``. The same objects
cut a generic source's rays (last of its sampling stages) and a plasma's
bundles (before their photon rates), as the reference applies them to
both. The fused kernels test the sightline on each ray's origin in the
kernel instead (``csrc/trace_common.cuh``).
"""

from __future__ import annotations

from xicsrt_tpu_torch.dispatch import GeometryElement, register
from xicsrt_tpu_torch.ops import vector as vec


@register("XicsrtBundleFilter", "filter_none")
class FilterBase(GeometryElement):
    """Passes everything through."""

    def make_filter(self):
        def apply(params, origin, mask):
            return mask

        return apply


@register("XicsrtBundleFilterSightline", "filter_sightline")
class FilterSightline(FilterBase):
    """Keeps origins within ``radius`` of the line through the filter's
    origin along its z axis (``_XicsrtBundleFilterSightline.py:31-56``)."""

    def default_config(self) -> dict:
        config = super().default_config()
        config["radius"] = None
        return config

    def check_param(self):
        super().check_param()
        if self.param["radius"] is None:
            raise ValueError(f'Filter "{self.name}": radius is required.')

    def build_params(self) -> dict:
        params = super().build_params()
        params["radius"] = self.as_tensor(self.param["radius"])
        return params

    def make_filter(self):
        def apply(params, origin, mask):
            frame = params["frame"]
            l0 = frame.origin[None, :] - origin
            proj = vec.dot(l0, frame.zaxis)
            perp = l0 - proj[:, None] * frame.zaxis[None, :]
            return mask & (vec.magnitude(perp) <= params["radius"])

        return apply
