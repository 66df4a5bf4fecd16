"""State carried across from the JAX package.

``params_from_jax`` turns the ``Pipeline.params`` of ``xicsrt_tpu`` into this
package's params dict, so one JAX pipeline and this port compute from
identical geometry. It takes the tree after
``jax.tree_util.tree_map(np.asarray, params)`` (numpy leaves, JAX ``Frame``
objects whose fields are numpy arrays) and needs no JAX itself.
"""

from __future__ import annotations

import numpy as np
import torch

from xicsrt_tpu_torch.geometry import Frame


def params_from_jax(params_np: dict, device="cpu", dtype=None) -> dict:
    """Convert a JAX params tree (numpy leaves) to tensors on ``device``.

    Frames (any object with ``origin`` and ``basis``) become
    :class:`~xicsrt_tpu_torch.geometry.Frame`; dicts recurse; arrays keep
    their values and, unless ``dtype`` is given, their float precision.
    """

    def tensor(value):
        arr = np.array(value)  # a writable copy
        return torch.as_tensor(arr, dtype=dtype, device=device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if hasattr(node, "origin") and hasattr(node, "basis"):
            return Frame(origin=tensor(node.origin), basis=tensor(node.basis))
        return tensor(node)

    return convert(params_np)
