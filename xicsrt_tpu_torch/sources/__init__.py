"""Ray sources: generic and directed emitters, plasma bundles."""

from xicsrt_tpu_torch.sources.generic import (  # noqa: F401
    SourceDirected,
    SourceFocused,
    SourceGeneric,
)
from xicsrt_tpu_torch.sources.plasma import (  # noqa: F401
    PlasmaCubic,
    PlasmaCylindrical,
    PlasmaGeneric,
    PlasmaToroidal,
    PlasmaToroidalDatafile,
)
