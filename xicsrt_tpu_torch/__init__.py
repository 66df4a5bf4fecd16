"""xicsrt_tpu_torch: the PyTorch/CUDA port of xicsrt_tpu.

It takes the same config dicts as ``xicsrt_tpu`` and returns the same
results dict, on an explicit ``device``: ``raytrace(config, device=None)``
runs on CUDA and raises when CUDA is absent; pass ``device='cpu'`` for the
CPU. It imports PyTorch and never JAX.

``general.engine``: 'xla' is the eager PyTorch engine, 'fused' one
hand-written CUDA kernel for the whole chain (``ops/fused_trace.py``), 'auto'
the fused kernel where the config is inside its subset. ``general.binning``:
'xla' scatters with ``index_put_``, 'pallas' names the hand-written CUDA
binning kernel (``ops/pallas_binning.py``). On CPU tensors each kernel
wrapper runs its plain PyTorch twin. The kernels build from
``xicsrt_tpu_torch/csrc`` with ``nvcc`` at first use.

Ported so far: point and box sources (Generic, Directed) with isotropic and
isotropic_xy cones and one wavelength; plane and sphere optics with
apertures; no interaction, mirror, and the Bragg crystal with gaussian or
step rocking in mc and weight mode; nearest and bilinear images; history;
gradients (``gradients.py``): ``make_differentiable`` (eager autograd),
``make_fused_differentiable`` (hand-written CUDA forward and adjoint
kernels, ``ops/fused_grad.py``), ``align`` and ``l2_image_loss``. The rest
of the JAX package raises ``NotImplementedError``.
"""

from xicsrt_tpu_torch._version import __version__  # noqa: F401

import xicsrt_tpu_torch.optics  # noqa: E402,F401  (registers classes)
import xicsrt_tpu_torch.sources  # noqa: E402,F401
from xicsrt_tpu_torch.convert import params_from_jax  # noqa: E402,F401
from xicsrt_tpu_torch.engine import (  # noqa: E402,F401
    Pipeline,
    combine_raytrace,
    raytrace,
    raytrace_single,
)
from xicsrt_tpu_torch.gradients import (  # noqa: E402,F401
    align,
    l2_image_loss,
    make_differentiable,
    make_fused_differentiable,
)
from xicsrt_tpu_torch.public import get_element  # noqa: E402,F401
