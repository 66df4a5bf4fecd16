"""Ray-sharded runs over devices and ``torch.distributed`` ranks
(``xicsrt_tpu/parallel/mesh.py``).

JAX shards the ray axis of one program over a device mesh with
``shard_map``, folds each device's mesh position into the RNG key and
``psum``s images and meta over the mesh. Here:

- a mesh (:class:`RayMesh`) is a 1-D row of shards: this process's devices,
  a device holding one shard or several, times the ranks of the default
  process group when ``torch.distributed`` is initialised; shard ``i`` of
  rank ``k`` has the global position ``k * len(devices) + i``;
- each shard runs the unsharded runner of its device (K1 or K3 on the fused
  engine, the eager engine with K4 and K2 otherwise) on its share of the
  photon load (:func:`_shard_intensity`), one shard after another, from a
  ``torch.Generator`` seeded from one word of the run's generator (rank
  0's, broadcast) and the shard's position (:func:`fold_in`, JAX's
  ``jax.random.fold_in(key, idx)``); the fused engine draws its two Philox
  key words from it, so every shard traces other rays, and a seed and a
  mesh give the same rays every time;
- meta counts and images are summed over the process's shards, then
  ``all_reduce``d over the ranks;
- history, the only gather-shaped output, is the concatenation of this
  process's shards' rows in mesh order: a rank holds its own shards' rays,
  as a JAX process holds its addressable shards. It takes the place of
  ``pipeline_history_struct``, JAX's partition spec of the sharded rays.

Backends: NCCL where each rank owns a GPU, gloo on the CPU and where ranks
share a GPU (NCCL refuses two ranks on one device); gloo's collectives run
on host copies of CUDA tensors. The kernels launch on the current CUDA
device, so each shard runs with its device current (:func:`on_device`).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging

import numpy as np
import torch

log = logging.getLogger("xicsrt_tpu_torch")


def _group() -> tuple:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the rank's
    GPU under NCCL, the host under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor on ``t``'s device); gloo
    reduces a host copy of a CUDA tensor."""
    import torch.distributed as dist

    via = _collective_device()
    out = t.detach().to(via, copy=True)
    dist.all_reduce(out)
    return out.to(t.device)


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> dict:
    """Initialise the default process group (idempotent).

    With ``coordinator_address`` (``"host:port"``, rank 0's) or
    ``num_processes`` it calls ``torch.distributed.init_process_group``
    with ``tcp://`` that address, the world size and this rank, and a
    failure raises: a silent fall-back would run independent jobs that all
    believe they are rank 0. Without them it leaves a group that exists as
    it is, and otherwise stays one process.

    The backend is NCCL where the host has a GPU for every rank (the world
    size at most the CUDA devices; rank ``r`` then takes
    ``cuda:r % devices``), and gloo on the CPU or where ranks share a GPU:
    NCCL refuses two ranks on one device.

    Returns ``{"process_index", "process_count", "num_devices",
    "is_primary"}``; ``num_devices`` counts the shards of the default mesh
    (:func:`ray_mesh`): a shard on each CUDA device of the process, or one
    on the CPU, over every rank.
    """
    import torch.distributed as dist

    explicit = coordinator_address is not None or num_processes is not None
    if explicit and not dist.is_initialized():
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("init_multihost: give coordinator_address, num_processes "
                             "and process_id together")
        backend = "gloo"
        if torch.cuda.is_available() and torch.cuda.device_count() >= num_processes:
            backend = "nccl"
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    rank, world = _group()
    local = (torch.cuda.device_count() if torch.cuda.is_available() and world == 1
             else 1)
    return {"process_index": rank, "process_count": world,
            "num_devices": local * world, "is_primary": rank == 0}


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of ray shards: ``devices`` are this process's shards'
    devices in mesh order (a device may repeat), ``rank`` and ``world`` the
    process group's; every rank holds as many shards."""

    devices: tuple
    rank: int = 0
    world: int = 1

    @property
    def size(self) -> int:
        """The shards over every rank."""
        return len(self.devices) * self.world

    @property
    def positions(self) -> range:
        """The global mesh positions of this process's shards."""
        first = self.rank * len(self.devices)
        return range(first, first + len(self.devices))


def _cuda_devices() -> list:
    """The CUDA devices a process shards over by default: all of them, or
    under a process group the rank's current device."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices='cpu' to shard on the CPU.")
    if _group()[1] > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def available_shards(device) -> int | None:
    """The most shards a process takes on ``device``: one for each CUDA
    device for ``'cuda'``, any number (None) on one named device
    (``'cpu'``, ``'cuda:0'``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return len(_cuda_devices())
    return None


def ray_mesh(n_devices: int | None = None, devices=None) -> RayMesh:
    """A 1-D mesh of ``n_devices`` shards over every rank (default: one
    shard a device).

    ``devices``: None or ``'cuda'`` takes the process's CUDA devices, first
    ``n_devices / world`` of them, as JAX takes ``jax.devices()[:n]``
    (under a process group, each rank's current device); one named device
    (``'cpu'``, ``'cuda:0'``) holds all of the rank's shards, which on the
    CPU stands in for JAX's virtual CPU mesh; a list takes its first
    entries. A topology that cannot be had raises: ``n_devices`` that is
    not a multiple of the world size, more shards a rank than the devices
    it names (or CUDA devices it has), ranks of unequal shards.
    """
    rank, world = _group()
    if n_devices is not None and (n_devices < 1 or n_devices % world):
        raise ValueError(f"ray_mesh: {n_devices} shards do not divide over {world} ranks")
    local_n = None if n_devices is None else n_devices // world
    if isinstance(devices, (list, tuple)):
        pool = [torch.device(d) for d in devices]
    elif devices is None or available_shards(devices) is not None:
        pool = _cuda_devices()
    else:
        pool = [torch.device(devices)] * (local_n or 1)
    if local_n is not None:
        if local_n > len(pool):
            raise ValueError(f"ray_mesh: {local_n} shards a rank asked, {len(pool)} "
                             f"devices given ({[str(d) for d in pool]})")
        pool = pool[:local_n]
    if world > 1:
        import torch.distributed as dist

        counts = torch.tensor([len(pool), -len(pool)], device=_collective_device())
        dist.all_reduce(counts, op=dist.ReduceOp.MAX)
        if int(counts[0]) != -int(counts[1]):
            raise ValueError("ray_mesh: the ranks hold different numbers of shards")
    return RayMesh(tuple(pool), rank, world)


def fold_in(word: int, position: int) -> int:
    """A 63-bit seed for the shard at ``position`` from a run's seed word
    (``jax.random.fold_in``): deterministic, and another for every
    position."""
    state = np.random.SeedSequence(int(word), spawn_key=(int(position),))
    return int(state.generate_state(1, np.uint64)[0]) & 0x7FFFFFFFFFFFFFFF


def shard_seed(seed, position: int) -> tuple:
    """The two Philox key words of the fused gradient kernels' shard at
    ``position``, from the caller's ``seed`` (an int or a pair of words)."""
    from xicsrt_tpu_torch.ops.fused_grad import seed_words

    w = np.random.SeedSequence(list(seed_words(seed)),
                               spawn_key=(int(position),)).generate_state(2, np.uint32)
    return int(w[0]), int(w[1])


def shard_generators(generator: torch.Generator, mesh: RayMesh) -> list:
    """One generator for each of this process's shards, on its device: a
    word drawn from ``generator`` (rank 0's, broadcast to every rank, so a
    run without a seed still traces one set of rays), folded with the
    shard's position."""
    word = torch.randint(0, 2**62, (1,), generator=generator, device=generator.device)
    if mesh.world > 1:
        import torch.distributed as dist

        word = word.to(_collective_device())
        dist.broadcast(word, src=0)
    word = int(word.item())
    gens = []
    for device, position in zip(mesh.devices, mesh.positions):
        gen = torch.Generator(device=device)
        gen.manual_seed(fold_in(word, position))
        gens.append(gen)
    return gens


def _shard_intensity(config: dict, n_devices: int) -> dict:
    """Divide the photon load across devices, preserving totals.

    Sets ``intensity_scale = 1/n_devices`` on every source; each source
    class applies it to its own rate (generic: Poisson rate or ray count;
    plasma: per-bundle expected photon count lambda — see
    ``sources/plasma.py``). Poisson rates split into independent Poissons,
    so the psum-reduced totals have exactly the single-device photon
    statistics — the equivalent of the reference dividing runs across
    processes (``xicsrt_multiprocessing.py:48-56``).

    Non-Poisson counted sources additionally pre-divide ``intensity`` to an
    integer per-device count (remainder dropped with a warning), so exact
    generated totals stay a multiple of the mesh size.
    """
    config = copy.deepcopy(config)
    for name, source_config in config.get("sources", {}).items():
        prior = float(source_config.get("intensity_scale", 1.0))
        intensity = source_config.get("intensity")
        use_poisson = source_config.get("use_poisson")
        if use_poisson is None:
            # Plasma sources default use_poisson=True and derive counts from
            # physics, not `intensity`; only explicit non-Poisson counted
            # sources need the integer pre-division below.
            use_poisson = "Plasma" in str(source_config.get("class_name", ""))
        if not use_poisson and intensity is not None:
            intensity = float(intensity)
            per_device = int(intensity * prior) // n_devices
            if per_device < 1:
                raise ValueError(
                    f'Source "{name}": non-Poisson intensity {intensity:g} '
                    f"is below the {n_devices}-device mesh size; raise the "
                    f"intensity or set use_poisson=True."
                )
            if per_device * n_devices != int(intensity * prior):
                log.warning(
                    'Source "%s": intensity %g is not a multiple of the '
                    "%d-device mesh; sharded total is %d rays.",
                    name, intensity, n_devices, per_device * n_devices,
                )
            source_config["intensity"] = per_device
            source_config["intensity_scale"] = 1.0
        else:
            source_config["intensity_scale"] = prior / n_devices
    return config


def map_tensors(tree, fn):
    """``tree`` (dicts, lists, tuples and dataclasses such as ``Frame``)
    with ``fn`` applied to every tensor leaf."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def params_match(a, b) -> bool:
    """True when two params trees hold the same structure and values."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and torch.equal(a.detach().cpu(), b.detach().cpu()))
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(params_match(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(params_match(x, y) for x, y in zip(a, b)))
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a) is type(b) and all(
            params_match(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def on_device(device):
    """A context in which ``device`` is the current CUDA device (nothing on
    the CPU): the kernels launch on the current device, so a shard on
    ``cuda:1`` runs inside it."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_pipelines(config: dict, mesh: RayMesh) -> dict:
    """One ``Pipeline`` of ``config`` for each distinct device of the
    process's shards."""
    from xicsrt_tpu_torch.engine import Pipeline

    return {d: Pipeline(config, d) for d in dict.fromkeys(mesh.devices)}


def sum_over_shards(parts: list, device) -> torch.Tensor:
    """The shards' tensors summed on ``device``, in mesh order."""
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def make_sharded_run(config: dict, num_iter: int | None = None,
                     mesh: RayMesh | None = None, n_devices: int | None = None,
                     keep_history: bool | str | None = None,
                     keep_images: bool | None = None,
                     engine: str | None = None, device=None):
    """Build a full multi-iteration run sharded over the ray axis.

    Returns ``(runner, pipeline, mesh)``: ``runner(params, generator)``
    gives what the unsharded runner gives, with the rays split over the
    mesh's shards: meta and images summed over every shard of every rank,
    history the rows of this process's shards, concatenated in mesh order.
    ``pipeline`` is the first shard's. ``mesh`` defaults to
    ``ray_mesh(n_devices, device)``; a mesh of one shard runs unsharded.

    ``engine`` (default ``general.engine``): 'fused' and 'auto' take K1 (or
    K3) on every shard, 'found' and 'sampled' reservoirs kept per shard;
    'auto' falls back to the eager engine outside the fused subset, and
    where full history is kept; 'fused' with full history raises. The
    fused runner holds ``params`` to the build-time values and raises on
    others, as JAX's does: each shard's device holds a pipeline of its own,
    built from them.
    """
    from xicsrt_tpu_torch.dispatch import default_device
    from xicsrt_tpu_torch.engine import local_runner

    if mesh is None:
        mesh = ray_mesh(n_devices, default_device(device))
    sharded = _shard_intensity(config, mesh.size)
    g = sharded.setdefault("general", {})
    for key, value in (("number_of_iter", num_iter), ("keep_history", keep_history),
                       ("keep_images", keep_images), ("engine", engine)):
        if value is not None:
            g[key] = value
    pipelines = shard_pipelines(sharded, mesh)
    runners = {d: local_runner(p) for d, p in pipelines.items()}
    first = mesh.devices[0]
    pipeline = pipelines[first]
    (run_first, kind) = runners[first]
    if mesh.size == 1:
        return run_first, pipeline, mesh
    build_params = pipeline.params

    def runner(params, generator: torch.Generator):
        if kind != "eager" and params is not build_params and not params_match(
                params, build_params):
            raise ValueError(
                "engine='fused' bakes geometry in at build time; the params passed "
                "differ from the build-time values. Rebuild the runner after "
                "changing params, or use the eager engine for parameter sweeps.")
        outs = []
        for d, gen in zip(mesh.devices, shard_generators(generator, mesh)):
            if d == first:
                p = params
            elif kind != "eager":
                p = pipelines[d].params
            else:
                p = map_tensors(params, lambda t, d=d: t.to(d))
            with on_device(d):
                outs.append(runners[d][0](p, gen))
        return combine_shards(outs, mesh, first)

    return runner, pipeline, mesh


def combine_shards(outs: list, mesh: RayMesh, device) -> dict:
    """The shards' ``{"meta", "image", "history"}`` as one run's: meta and
    images summed over the shards and the ranks, history concatenated in
    mesh order (this process's shards)."""
    from xicsrt_tpu_torch.rays import concatenate

    names = list(outs[0]["meta"])
    meta = {n: sum_over_shards([o["meta"][n].to(torch.int64) for o in outs], device)
            for n in names}
    image = {n: sum_over_shards([o["image"][n] for o in outs], device)
             for n in outs[0]["image"]}
    if mesh.world > 1:
        if names:
            counts = all_reduce_sum(torch.stack([meta[n] for n in names]))
            meta = {n: counts[i] for i, n in enumerate(names)}
        image = {n: all_reduce_sum(v) for n, v in image.items()}
    history = {n: concatenate([_rays_to(o["history"][n], device) for o in outs])
               for n in outs[0]["history"]}
    return {"meta": meta, "image": image, "history": history}


def _rays_to(rays, device):
    return map_tensors(rays, lambda t: t.to(device))


class _SumOverRanks(torch.autograd.Function):
    """Forward: the tensor summed over the ranks. Backward: the cotangent
    as it is. With :class:`_ReplicatedParam`, whose backward sums the
    params' cotangents over the ranks, a loss of the summed images that
    every rank computes alike gets the gradient of the whole mesh on every
    rank, as the transpose of JAX's ``psum`` under ``shard_map`` gives it.
    (``torch.distributed.nn.functional.all_reduce`` sums the cotangents in
    its backward instead, which gives each rank the world size times its
    own shards' gradient.)"""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _ReplicatedParam(torch.autograd.Function):
    """Forward: the param as it is (a view). Backward: its cotangent summed
    over the ranks."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad)


def sum_images_over_ranks(images: dict, mesh: RayMesh) -> dict:
    """Images summed over the ranks, differentiably (:class:`_SumOverRanks`)."""
    if mesh.world == 1:
        return images
    return {k: _SumOverRanks.apply(v) for k, v in images.items()}


def replicate_params(params, mesh: RayMesh):
    """``params`` with every tensor that requires grad passed through
    :class:`_ReplicatedParam`, so its gradient is summed over the ranks."""
    if mesh.world == 1 or not torch.is_grad_enabled():
        return params
    return map_tensors(params, lambda t: _ReplicatedParam.apply(t) if t.requires_grad else t)


def scaling_efficiency(throughputs: dict) -> dict:
    """Helper: compute scaling efficiency vs the 1-device throughput."""
    base = throughputs.get(1)
    if base is None or base <= 0:
        return {}
    return {n: (tp / (n * base)) for n, tp in throughputs.items()}
