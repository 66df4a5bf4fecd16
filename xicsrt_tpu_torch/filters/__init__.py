"""Bundle and ray filters."""

from xicsrt_tpu_torch.filters.sightline import FilterBase, FilterSightline  # noqa: F401
