"""Ray sources."""

from xicsrt_tpu_torch.sources.generic import (  # noqa: F401
    SourceDirected,
    SourceFocused,
    SourceGeneric,
)
