"""xicsrt_tpu_torch: the PyTorch/CUDA port of xicsrt_tpu.

It takes the same config dicts as ``xicsrt_tpu`` and returns the same
results dict, on an explicit ``device``: ``raytrace(config, device=None)``
runs on CUDA and raises when CUDA is absent; pass ``device='cpu'`` for the
CPU. It imports PyTorch and never JAX.

``general.engine``: 'xla' is the eager PyTorch engine, 'fused' one
hand-written CUDA kernel for the whole chain (``ops/fused_trace.py``: K1,
or the trace-only K3 behind the eager source where K1 cannot generate the
source), 'auto' the fused kernels where the config is inside their subset.
``general.binning``: 'xla' scatters with ``index_put_``, 'pallas' names the
hand-written CUDA binning kernel (``ops/pallas_binning.py``). On CPU tensors
each kernel wrapper runs its plain PyTorch twin. The kernels build from
``xicsrt_tpu_torch/csrc`` with ``nvcc`` at first use.

Ported so far: Generic, Directed and Focused sources with point, uniform or
gaussian boxes, every angular distribution (isotropic, isotropic_xy, flat,
flat_xy, gaussian), monochrome, uniform and Voigt wavelengths and a bulk
velocity; sightline filters (``filters/``) on generic sources and plasma
bundles; plasma sources (Generic, Cubic, Cylindrical, Toroidal,
ToroidalDatafile; ``sources/plasma.py``) with voxel or point bundles, exact
Voigt lines and Doppler shifts, whose eager bundle gather is the CUDA kernel
of ``ops/bundle_gather.py``; plane, sphere, cylinder and torus optics with
apertures, and triangle meshes (``optics/mesh_shapes.py``: the Mesh,
MeshSpherical, MeshCylindrical and MeshToroidal crystals and the Mesh
mirror; the fused kernels trace a smooth mesh by its Chebyshev surrogate);
no interaction, mirror, the Bragg crystal with gaussian, step or file
(``utils/bragg_files.py``) rocking, and the planar, spherical and mesh
mosaic crystals, in mc and weight mode on every engine; nearest and
bilinear images on every engine; full history on the eager engine, and on
the fused engine the bounded reservoirs ``keep_history='found'`` and
``'sampled'`` (K1e, ``csrc/fused_history.cu``);
gradients (``gradients.py``): ``make_differentiable`` (eager autograd,
reaching a plasma's temperature), ``make_fused_differentiable``
(hand-written CUDA forward and adjoint kernels, ``ops/fused_grad.py``: the
generic source matrix and constant-profile plasmas, whose emissivity and
temperature it differentiates; plane, sphere, cylinder and torus optics;
file rocking curves; planar and spherical mosaic crystals), ``align`` and
``l2_image_loss``; files and the command line: ``io.py`` (configs, results
in hdf5, zip, pickle or json, TIF images), ``python -m xicsrt_tpu_torch``
(``__main__.py``), plugin element paths (``general.pathlist``,
``dispatch.load_plugin_paths``), ``utils/`` (hdf5 dicts, colours, plot
lists, config docs, ``warn_version``) and ``visual/`` (``plot2d``,
``detview``, ``plot3d``), whose optional packages (h5py, PIL, matplotlib,
plotly, ipyvolume) are imported at first use; ray-sharded runs
(``parallel/``: ``init_multihost``, ``ray_mesh``, ``make_sharded_run``,
``scaling_efficiency``): ``general.shard_rays``, ``raytrace_mp(config,
processes=None, device=None)`` and the gradient entry points' ``mesh`` and
``n_devices`` split the photon load over shards on the process's devices
and over the ranks of a ``torch.distributed`` group, summing images and
meta with ``all_reduce``.
"""

from xicsrt_tpu_torch._version import __version__  # noqa: F401

import xicsrt_tpu_torch.filters  # noqa: E402,F401  (registers classes)
import xicsrt_tpu_torch.optics  # noqa: E402,F401
import xicsrt_tpu_torch.parallel  # noqa: E402,F401
import xicsrt_tpu_torch.sources  # noqa: E402,F401
from xicsrt_tpu_torch.convert import params_from_jax  # noqa: E402,F401
from xicsrt_tpu_torch.engine import (  # noqa: E402,F401
    Pipeline,
    combine_raytrace,
    raytrace,
    raytrace_mp,
    raytrace_single,
)
from xicsrt_tpu_torch.gradients import (  # noqa: E402,F401
    align,
    l2_image_loss,
    make_differentiable,
    make_fused_differentiable,
)
from xicsrt_tpu_torch.public import get_element  # noqa: E402,F401
from xicsrt_tpu_torch.utils.version import warn_version  # noqa: E402,F401
