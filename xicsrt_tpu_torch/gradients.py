"""Differentiable raytracing (``xicsrt_tpu/gradients.py``): gradients of
detector images with respect to optic poses and crystal parameters.

Two routes, as in the JAX package:

- :func:`make_differentiable`, eager autograd: the eager engine runs in
  ``interact_mode='weight'`` (a Bragg crystal multiplies the ray weight by
  its reflection probability instead of drawing a uniform) with
  ``image_mode='bilinear'`` (a splat that is piecewise linear in the hit
  position), and ``torch.autograd`` differentiates any tensor of
  ``pipeline.params`` that requires grad. Source sampling does not depend on
  the params (reparameterised Monte Carlo); bounds and aperture masks are
  hard edges with zero gradient.
- :func:`make_fused_differentiable`: one CUDA kernel for the forward images
  (K5f) and one that regenerates the same rays and runs the hand-derived
  adjoint (K5b), over a flat parameter vector (``ops/fused_grad.py``).

:func:`align` fits params to target images by Adam on the eager route.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from xicsrt_tpu_torch.engine import Pipeline, _run_generator, default_device
from xicsrt_tpu_torch.geometry import Frame


def _differentiable_config(config: dict, mesh, n_devices,
                           error=NotImplementedError) -> dict:
    """The config in weight/bilinear mode without history
    (``gradients.py:64-68``); sharded runs are not ported yet and raise
    ``error``."""
    if mesh is not None or (n_devices or 1) > 1:
        raise error("sharded gradient runs (mesh, n_devices) are not ported yet.")
    config = copy.deepcopy(config)
    general = config.setdefault("general", {})
    general["interact_mode"] = "weight"
    general["image_mode"] = "bilinear"
    general["keep_history"] = False
    return config


def make_differentiable(config: dict, num_iter: int | None = None,
                        remat: bool | None = None, mesh=None,
                        n_devices: int | None = None, device=None):
    """Build a differentiable forward ``image_fn(params, rng) -> {name:
    [nx, ny]}``; returns ``(image_fn, pipeline)``.

    ``rng`` is a ``torch.Generator`` on the pipeline's device, or a draws
    object (``draws.ExplicitDraws``). Differentiate with ``torch.autograd``
    over any tensor of ``pipeline.params`` that requires grad (or over
    params built from it). ``remat`` (default True) checkpoints each
    iteration, so the backward pass recomputes the trace instead of keeping
    its per-ray intermediates; the bilinear binning keeps only O(N)
    residuals either way. ``device`` defaults to CUDA and raises without it.
    """
    config = _differentiable_config(config, mesh, n_devices)
    pipeline = Pipeline(config, default_device(device))
    n_iter = num_iter or int(pipeline.general["number_of_iter"])
    run = pipeline.make_run(n_iter, keep_history=False, keep_images=True,
                            remat=True if remat is None else remat)

    def image_fn(params, rng):
        return run(params, rng)["image"]

    return image_fn, pipeline


def l2_image_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((image - target) ** 2)


def make_fused_differentiable(config: dict, num_iter: int | None = None,
                              chunk: int = 32768, mesh=None,
                              n_devices: int | None = None, device=None):
    """The fused-kernel differentiable path; returns
    ``(forward, vjp, pack, pipeline)``:

    - ``pvec = pack(pipeline.params)``: the differentiated parameters as a
      flat float32 vector (24 slots per optic), read by the kernels at run
      time, so a descent loop rebuilds nothing;
    - ``forward(pvec, seed) -> {"image": {name: [nx, ny]}}``: weight-mode
      bilinear images from kernel K5f;
    - ``vjp(pvec, seed, g_images) -> gvec``: the gradient of
      ``sum(g * image)`` with respect to ``pvec``, from kernel K5b, which
      regenerates the rays of ``forward(pvec, seed)``.

    ``seed``: an int or a pair of 32-bit words, keying the kernels' Philox
    stream; ``chunk`` bounds the rays per slice of the CPU twins. Raises
    ``FusedGradUnsupported`` outside the subset of ``ops/fused_grad.py``.
    On CPU tensors both functions run the kernels' plain twins.
    """
    from xicsrt_tpu_torch.ops.fused_grad import (
        FusedGradUnsupported, build_fused_diff, check_config)

    config = _differentiable_config(config, mesh, n_devices, FusedGradUnsupported)
    check_config(config)
    pipeline = Pipeline(config, default_device(device))
    forward, vjp, pack, _spec = build_fused_diff(
        pipeline, num_iter=num_iter, chunk=chunk)
    return forward, vjp, pack, pipeline


def _get(tree: dict, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree: dict, path, value) -> dict:
    """A copy of ``tree`` with ``path`` replaced (dicts copied on the way)."""
    out = dict(tree)
    node = out
    for key in path[:-1]:
        node[key] = dict(node[key])
        node = node[key]
    node[path[-1]] = value
    return out


def align(config: dict, target_images: dict, optimize_paths: list,
          steps: int = 100, learning_rate: float = 1e-3,
          num_iter: int | None = None, seed: int = 0, resample: bool = True,
          loss_fn=l2_image_loss, callback=None, mesh=None,
          n_devices: int | None = None, device=None):
    """Gradient-descent alignment of optic parameters to target images.

    ``optimize_paths``: tuples addressing leaves of the params dict, e.g.
    ``("optics", "crystal", "crystal_spacing")``, or a frame
    (``("optics", "crystal", "frame")`` optimises origin and basis).
    ``torch.optim.Adam(lr=learning_rate)`` takes the place of
    ``optax.adam``, with the same defaults (betas 0.9/0.999, eps 1e-8 added
    after the square root). ``resample``: fresh rays each step (the step
    index folds into the seed, as ``gradients.py:297`` does) or frozen
    rays. ``callback(step, loss, trainable)`` runs after every step.

    Returns ``(optimized_params, losses)``.
    """
    image_fn, pipeline = make_differentiable(
        config, num_iter=num_iter, mesh=mesh, n_devices=n_devices,
        device=device)
    params = pipeline.params
    targets = {k: torch.as_tensor(v).to(device=pipeline.device,
                                        dtype=pipeline.source.dtype)
               for k, v in target_images.items()}

    leaves = []       # tensors Adam updates in place
    trainable = {}    # path -> leaf tensor or (origin, basis) pair
    for path in optimize_paths:
        path = tuple(path)
        value = _get(params, path)
        if isinstance(value, Frame):
            pair = (value.origin.detach().clone().requires_grad_(True),
                    value.basis.detach().clone().requires_grad_(True))
            trainable[path] = pair
            leaves.extend(pair)
        else:
            leaf = value.detach().clone().requires_grad_(True)
            trainable[path] = leaf
            leaves.append(leaf)

    def merged(detach=False):
        out = params
        for path, value in trainable.items():
            value = tuple(value) if isinstance(value, tuple) else (value,)
            if detach:
                value = tuple(v.detach() for v in value)
            out = _set(out, path, Frame(*value) if len(value) == 2 else value[0])
        return out

    opt = torch.optim.Adam(leaves, lr=learning_rate)
    losses = []
    for i in range(steps):
        gen = _run_generator({"random_seed": seed}, i if resample else 0,
                             pipeline.device)
        opt.zero_grad()
        images = image_fn(merged(), gen)
        loss = sum(loss_fn(images[k], targets[k]) for k in targets)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if callback is not None:
            callback(i, losses[-1], trainable)

    return merged(detach=True), np.asarray(losses)
