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
Every route takes ``mesh`` or ``n_devices`` to shard its rays
(``parallel/mesh.py``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from xicsrt_tpu_torch.dispatch import default_device
from xicsrt_tpu_torch.engine import Pipeline, _run_generator
from xicsrt_tpu_torch.geometry import Frame


def _differentiable_config(config: dict) -> dict:
    """The config in weight/bilinear mode without history
    (``gradients.py:64-68``)."""
    config = copy.deepcopy(config)
    general = config.setdefault("general", {})
    general["interact_mode"] = "weight"
    general["image_mode"] = "bilinear"
    general["keep_history"] = False
    return config


def _gradient_mesh(config: dict, mesh, n_devices, device):
    """``(config, mesh, device)``: the mesh of a sharded gradient run,
    ``mesh`` or ``ray_mesh(n_devices, device)`` for ``n_devices`` over one,
    and the config's photon load divided over it (JAX
    ``gradients.py:70-77``); for one shard no mesh, and its device."""
    from xicsrt_tpu_torch.parallel import mesh as pm

    if mesh is None and n_devices is not None and n_devices > 1:
        mesh = pm.ray_mesh(n_devices, default_device(device))
    if mesh is None:
        return config, None, default_device(device)
    if mesh.size == 1:
        return config, None, mesh.devices[0]
    return pm._shard_intensity(config, mesh.size), mesh, None


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

    Sharded: ``mesh`` (``parallel.ray_mesh``) or ``n_devices`` splits the
    photon load over the shards, each drawing from its own generator
    (``parallel.mesh.shard_generators``; ``rng`` must then be a
    ``torch.Generator``). The images are summed over the process's shards
    and over the ranks, and autograd of any loss of them that every rank
    computes alike gives every rank the gradient of the whole mesh, as
    ``jax.grad`` through JAX's ``shard_map`` does: the params' gradients
    are summed over the ranks in the backward pass.
    """
    from xicsrt_tpu_torch.parallel import mesh as pm

    config, mesh, device = _gradient_mesh(_differentiable_config(config), mesh, n_devices,
                                          device)
    remat = True if remat is None else remat
    if mesh is None:
        pipeline = Pipeline(config, device)
        n_iter = num_iter or int(pipeline.general["number_of_iter"])
        run = pipeline.make_run(n_iter, keep_history=False, keep_images=True, remat=remat)

        def image_fn(params, rng):
            with pm.on_device(pipeline.device):
                return run(params, rng)["image"]

        return image_fn, pipeline

    pipelines = pm.shard_pipelines(config, mesh)
    first = mesh.devices[0]
    pipeline = pipelines[first]
    n_iter = num_iter or int(pipeline.general["number_of_iter"])
    runs = {d: p.make_run(n_iter, keep_history=False, keep_images=True, remat=remat)
            for d, p in pipelines.items()}

    def sharded_image_fn(params, rng):
        if not isinstance(rng, torch.Generator):
            raise TypeError("a sharded image_fn draws from a torch.Generator")
        params = pm.replicate_params(params, mesh)
        images = []
        for d, gen in zip(mesh.devices, pm.shard_generators(rng, mesh)):
            p = params if d == first else pm.map_tensors(params, lambda t, d=d: t.to(d))
            with pm.on_device(d):
                images.append(runs[d](p, gen)["image"])
        summed = {k: pm.sum_over_shards([im[k] for im in images], first) for k in images[0]}
        return pm.sum_images_over_ranks(summed, mesh)

    return sharded_image_fn, pipeline


def l2_image_loss(image: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((image - target) ** 2)


def make_fused_differentiable(config: dict, num_iter: int | None = None,
                              chunk: int = 32768, mesh=None,
                              n_devices: int | None = None, device=None):
    """The fused-kernel differentiable path; returns
    ``(forward, vjp, pack, pipeline)``:

    - ``pvec = pack(pipeline.params)``: the differentiated parameters as a
      flat float32 vector (24 slots per optic, then for a plasma source 8
      source slots: emissivity, temperature), read by the kernels at run
      time, so a descent loop rebuilds nothing;
    - ``forward(pvec, seed) -> {"image": {name: [nx, ny]}}``: weight-mode
      bilinear images from kernel K5f;
    - ``vjp(pvec, seed, g_images) -> gvec``: the gradient of
      ``sum(g * image)`` with respect to ``pvec``, from kernel K5b, which
      regenerates the rays of ``forward(pvec, seed)``.

    ``seed``: an int or a pair of 32-bit words, keying the kernels' Philox
    stream; ``chunk`` bounds the rays per slice of the CPU twins. A plasma
    traces ``max(round(expected photons), 1)`` rays per iteration, one
    bundle each. Raises ``FusedGradUnsupported`` outside the subset of
    ``ops/fused_grad.py`` (point sources and constant-profile plasmas;
    plane, sphere, cylinder and torus optics). On CPU tensors both functions
    run the kernels' plain twins; ``ops.fused_grad.unpack_grads(pipeline,
    gvec)`` maps ``gvec`` to the elements' leaves.

    Sharded: ``mesh`` (``parallel.ray_mesh``) or ``n_devices`` splits the
    photon load over the shards; the shard at mesh position ``i`` keys its
    kernels with ``parallel.mesh.shard_seed(seed, i)``. ``forward``'s
    images and ``vjp``'s gradient vectors are summed over the process's
    shards, then over the ranks (JAX ``gradients.py:161-205``).
    """
    from xicsrt_tpu_torch.ops.fused_grad import build_fused_diff, check_config
    from xicsrt_tpu_torch.parallel import mesh as pm

    config = _differentiable_config(config)
    check_config(config)
    config, mesh, device = _gradient_mesh(config, mesh, n_devices, device)
    if mesh is None:
        pipeline = Pipeline(config, device)
        forward, vjp, pack, _spec = build_fused_diff(pipeline, num_iter=num_iter, chunk=chunk)

        def on_device(fn):  # the kernels launch on the current device
            def call(*args, **kwargs):
                with pm.on_device(pipeline.device):
                    return fn(*args, **kwargs)
            return call

        return on_device(forward), on_device(vjp), pack, pipeline

    pipelines = pm.shard_pipelines(config, mesh)
    built = {d: build_fused_diff(p, num_iter=num_iter, chunk=chunk)
             for d, p in pipelines.items()}
    first = mesh.devices[0]
    pack = built[first][2]

    def each_shard(fn, pvec, seed, *rest):  # build_fused_diff moves pvec and g there
        out = []
        for d, pos in zip(mesh.devices, mesh.positions):
            with pm.on_device(d):
                out.append(built[d][fn](pvec, pm.shard_seed(seed, pos), *rest))
        return out

    def sharded_forward(pvec, seed):
        images = [out["image"] for out in each_shard(0, pvec, seed)]
        summed = {k: pm.sum_over_shards([im[k] for im in images], first) for k in images[0]}
        if mesh.world > 1:
            summed = {k: pm.all_reduce_sum(v) for k, v in summed.items()}
        return {"image": summed}

    def sharded_vjp(pvec, seed, g_images):
        gvec = pm.sum_over_shards(each_shard(1, pvec, seed, g_images), first)
        return pm.all_reduce_sum(gvec) if mesh.world > 1 else gvec

    return sharded_forward, sharded_vjp, pack, pipelines[first]


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
