"""Multi-device execution: ray-axis sharding over devices and
``torch.distributed`` ranks (``xicsrt_tpu/parallel``)."""

from xicsrt_tpu_torch.parallel.mesh import (  # noqa: F401
    init_multihost,
    make_sharded_run,
    ray_mesh,
    scaling_efficiency,
)
