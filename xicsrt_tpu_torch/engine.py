"""Raytracing engine: config -> pipeline -> results dict (``xicsrt_tpu/engine.py``).

Two engines share one entry point, ``raytrace(config, device)``:

- the eager engine (``general.engine='xla'``): the source and every optic
  are plain PyTorch functions on ``[N, 3]`` tensors, run one iteration
  after another; images bin by scatter, or by the CUDA binning kernel with
  ``general.binning='pallas'``;
- the fused engine (``'fused'``, or ``'auto'`` where the config is inside
  its subset): one CUDA kernel per run (``ops/fused_trace.py``).

Randomness: each run owns one ``torch.Generator`` on the run's device,
seeded from ``general.random_seed`` and the run index; elements draw from
it in a fixed order. The two engines draw different streams, so they agree
statistically, not ray for ray.

The results dict keeps the reference layout: ``config``, ``total`` (meta +
image), ``found``/``lost`` (per-element ray history), with numpy arrays and
Python ints.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch
import torch.utils.checkpoint

from xicsrt_tpu_torch import dispatch
from xicsrt_tpu_torch.config import get_config
from xicsrt_tpu_torch.dispatch import default_device
from xicsrt_tpu_torch.draws import Draws
from xicsrt_tpu_torch.parallel.mesh import on_device
from xicsrt_tpu_torch.ops.binning import bin_images_fused
from xicsrt_tpu_torch.rays import concatenate
from xicsrt_tpu_torch.utils.profiler import profiler

log = logging.getLogger("xicsrt_tpu_torch")


class Pipeline:
    """A config built into elements on one device plus their params dict."""

    def __init__(self, config: dict, device=None):
        self.config = get_config(config)
        general = self.config["general"]
        self.general = general
        self.device = default_device(device)

        profiler.start("pipeline_build")
        dispatch.load_plugin_paths(general.get("pathlist"))
        self.filters = dispatch.build_section(self.config, "filters", self.device)
        self.sources = dispatch.build_section(self.config, "sources", self.device)
        self.optics = dispatch.build_section(self.config, "optics", self.device)
        if len(self.sources) != 1:
            raise NotImplementedError(
                f"Exactly one source is required ({len(self.sources)} given)."
            )
        self.source = self.sources[0]
        # The source's named filters (JAX engine.py:66-73).
        filter_map = {f.name: f for f in self.filters}
        source_filters = self.source.param.get("filters")
        for fname in [] if source_filters is None else list(source_filters):
            if fname not in filter_map:
                raise KeyError(f'Source filter "{fname}" is not defined.')
            self.source.filter_fns.append((fname, filter_map[fname].make_filter()))
        self.params = {
            "sources": {self.source.name: self.source.build_params()},
            "optics": {o.name: o.build_params() for o in self.optics},
            "filters": {f.name: f.build_params() for f in self.filters},
        }
        self.element_names = [self.source.name] + [o.name for o in self.optics]
        profiler.stop("pipeline_build")

    @property
    def num_rays(self) -> int:
        return self.source.num_rays

    def image_specs(self) -> dict:
        return {o.name: (o.image_shape, float(o.pixel_size))
                for o in self.optics if o.enable_image}

    def make_iteration(self, keep_history: bool | None = None,
                       keep_images: bool | None = None):
        """Build ``iteration(params, draws) -> dict`` for one trace pass."""
        g = self.general
        if keep_history is None:
            keep_history = bool(g["keep_history"])
        if keep_images is None:
            keep_images = bool(g["keep_images"])
        keep_meta = bool(g.get("keep_meta", True))
        image_mode = str(g.get("image_mode", "nearest")).lower()
        binning_impl = str(g.get("binning", "xla")).lower()
        # mc transport keeps every ray's weight at its source's 1.0
        unit_weights = str(g.get("interact_mode", "mc")).lower() == "mc"
        image_specs = self.image_specs()
        source = self.source

        def iteration(params, draws):
            rays = source.generate(params["sources"][source.name], draws,
                                   params["filters"])
            meta = {source.name: rays.num_alive()} if keep_meta else {}
            history = {source.name: rays} if keep_history else {}
            image_inputs, image_names = [], []
            for optic in self.optics:
                name = optic.name
                rays, x_local = optic.trace(params["optics"][name], rays, draws)
                if keep_meta:
                    meta[name] = rays.num_alive()
                if keep_history:
                    history[name] = rays
                if keep_images and name in image_specs:
                    (nx, ny), pixel_size = image_specs[name]
                    image_inputs.append(
                        (x_local, rays.mask, rays.weight, nx, ny, pixel_size))
                    image_names.append(name)
            images = dict(zip(image_names, bin_images_fused(
                image_inputs, image_mode, impl=binning_impl, unit_weights=unit_weights)))
            return {"meta": meta, "image": images, "history": history}

        return iteration

    def make_run(self, num_iter: int, keep_history: bool | None = None,
                 keep_images: bool | None = None, remat: bool = False):
        """Build ``run(params, rng) -> dict`` over ``num_iter`` iterations:
        meta and images sum, histories concatenate. ``rng``: a
        ``torch.Generator``, or a draws object (``draws.ExplicitDraws``).

        ``params`` may hold tensors that require grad; autograd then
        differentiates the run. ``remat=True`` checkpoints each iteration
        (``torch.utils.checkpoint``, as ``jax.checkpoint`` in
        ``xicsrt_tpu/engine.py:178-179``): the backward pass recomputes the
        trace instead of keeping its per-ray intermediates. The recompute
        draws from a fork of the iteration's starting draws, so it traces
        the same rays; checkpoint's own RNG handling restores only the
        global generators, not the run's.
        """
        iteration = self.make_iteration(keep_history, keep_images)

        def checkpointed(params, draws):
            start = draws.fork()
            ended = []

            def body():
                fork = start.fork()
                out = iteration(params, fork)
                ended.append(fork)
                return out

            out = torch.utils.checkpoint.checkpoint(
                body, use_reentrant=False, preserve_rng_state=False)
            draws.join(ended[0])
            return out

        step = checkpointed if remat else iteration

        def run(params, rng):
            draws = Draws(rng) if isinstance(rng, torch.Generator) else rng
            acc = step(params, draws)
            hist = {n: [r] for n, r in acc["history"].items()}
            for _ in range(num_iter - 1):
                out = step(params, draws)
                for n in acc["meta"]:
                    acc["meta"][n] = acc["meta"][n] + out["meta"][n]
                for n in acc["image"]:
                    acc["image"][n] = acc["image"][n] + out["image"][n]
                for n in hist:
                    hist[n].append(out["history"][n])
            acc["history"] = {n: concatenate(rs) for n, rs in hist.items()}
            return acc

        return run


def _run_generator(general: dict, run_index: int, device) -> torch.Generator:
    """Generator of one run, seeded from ``random_seed`` and the run index."""
    seed = general.get("random_seed")
    entropy = np.random.SeedSequence().entropy if seed is None else int(seed)
    state = np.random.SeedSequence(entropy, spawn_key=(run_index,)).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & 0x7FFFFFFFFFFFFFFF)
    return gen


def _sort_history(history_dev: dict, names: list, max_lost: int,
                  rng: np.random.Generator) -> tuple:
    """Split history into found/lost, truncating lost rays
    (``_sort_raytrace``, ``xicsrt_raytrace.py:229-278``); rays dead at the
    source (Poisson budget padding) are dropped.

    The split runs where the history lies. The found rays (alive at the
    last element) and the lost candidates (alive at the first, dead at the
    last) are found there; ``max_lost`` of the candidates are drawn as
    ``rng.choice(w_lost, size=max_lost, replace=False)`` draws them, which
    takes ``w_lost[rng.choice(len(w_lost), ...)]``. Every element's fields
    at the found and the drawn rays are gathered into one buffer that
    comes to the host in one copy (:func:`_gather_to_host`); the found and
    lost arrays are numpy views of it."""
    if not history_dev:
        return {}, {}
    final = history_dev[names[-1]].mask
    born = history_dev[names[0]].mask
    w_found = torch.nonzero(final).flatten()
    w_lost = torch.nonzero(born & ~final).flatten()
    if w_lost.numel() > max_lost:
        pick = rng.choice(w_lost.numel(), size=max_lost, replace=False)
        w_lost = w_lost[torch.from_numpy(pick).to(w_lost.device)]
    dicts = [history_dev[name].to_dict() for name in names]
    arrays = iter(_gather_to_host([v for d in dicts for v in d.values()],
                                  torch.cat([w_found, w_lost])))
    n_found = w_found.numel()
    found, lost = {}, {}
    for name, d in zip(names, dicts):
        found[name], lost[name] = {}, {}
        for key in d:
            a = next(arrays)
            found[name][key], lost[name][key] = a[:n_found], a[n_found:]
    return found, lost


def _gather_to_host(columns: list, rows: torch.Tensor) -> list:
    """The rows ``rows`` of each tensor of ``columns`` (on ``rows``'s
    device) as numpy arrays: gathered there into one byte buffer, each at an
    8-byte aligned offset, which comes to the host in one copy into
    pageable memory (a pinned buffer would stay pinned for as long as the
    caller keeps the arrays) and is viewed as each column's dtype and
    shape."""
    n = rows.numel()
    spans, total = [], 0
    for col in columns:
        shape = (n, *col.shape[1:])
        nbytes = int(np.prod(shape)) * col.element_size()
        spans.append((total, nbytes, shape))
        total += -(-nbytes // 8) * 8
    buf = torch.empty(total, dtype=torch.uint8, device=rows.device)
    for col, (off, nbytes, shape) in zip(columns, spans):
        torch.index_select(col, 0, rows, out=buf[off:off + nbytes].view(col.dtype).view(shape))
    raw = buf.cpu().numpy()
    return [raw[off:off + nbytes].view(torch.empty(0, dtype=col.dtype).numpy().dtype)
            .reshape(shape) for col, (off, nbytes, shape) in zip(columns, spans)]


def build_runner(config: dict, pipeline: Pipeline | None = None, device=None):
    """Build the per-run executor ``runner(params, generator) -> dict``:
    the unsharded runner of :func:`local_runner`, or, with
    ``general.shard_rays`` over a mesh of more than one shard
    (``general.devices`` shards, by default one a device;
    ``parallel.ray_mesh``), the ray-sharded runner of
    ``parallel.make_sharded_run`` (JAX ``engine.py:353-370``). On ``'cuda'``
    the shards take the process's CUDA devices, one each; on one named
    device (``'cpu'``, ``'cuda:0'``) that device holds them all.

    Returns (runner, pipeline).
    """
    g = get_config(config)["general"] if pipeline is None else pipeline.general
    if bool(g.get("shard_rays")):
        from xicsrt_tpu_torch.parallel.mesh import make_sharded_run, ray_mesh

        mesh = ray_mesh(g.get("devices"),
                        pipeline.device if pipeline is not None else default_device(device))
        if mesh.size > 1:
            runner, pipeline, _ = make_sharded_run(
                config if pipeline is None else pipeline.config, mesh=mesh)
            return runner, pipeline
    pipeline = pipeline or Pipeline(config, default_device(device))
    return local_runner(pipeline)[0], pipeline


def local_runner(pipeline: Pipeline):
    """The unsharded runner of ``pipeline`` and its kind: ``"fused"`` (K1),
    ``"fused_trace"`` (K3 behind the eager source) or ``"eager"``.

    Returns (runner, kind).
    """
    g = pipeline.general
    num_iter = int(g["number_of_iter"])
    engine_kind = str(g.get("engine", "xla")).lower()
    kh = g["keep_history"]
    # keep_history='found': the bounded reservoir K1e of the chunks with
    # detector hits; 'sampled': a bounded unbiased sample of all rays,
    # honouring history_max_lost. Both on K1; FULL history is the eager
    # engine's.
    kh_mode = kh.lower() if isinstance(kh, str) else None
    fused_history = kh_mode in ("found", "sampled")
    if engine_kind in ("fused", "auto") and (not kh or fused_history):
        from xicsrt_tpu_torch.ops.fused_trace import FusedUnsupported, build_fast_run

        try:
            return build_fast_run(
                pipeline, num_iter=num_iter,
                history_slots=(int(g.get("history_found_slots") or 8)
                               if kh_mode == "found" else None),
                history_mode=kh_mode or "found",
            )
        except FusedUnsupported as err:
            if engine_kind == "fused":
                raise
            if fused_history:
                log.warning(
                    "fused engine unavailable (%s); keep_history=%r "
                    "degrades to FULL per-ray history on the eager engine "
                    "(unbounded memory in num_rays*num_iter)",
                    err, kh,
                )
            else:
                log.info("fused engine unavailable (%s); using eager engine", err)
    elif engine_kind == "fused":
        raise NotImplementedError(
            "engine='fused' does not keep FULL ray history; set "
            "keep_history=False, keep_history='found' (bounded in-kernel "
            "reservoir), or engine='auto' to fall back."
        )
    return pipeline.make_run(num_iter), "eager"


def raytrace_single(config: dict, _pipeline: Pipeline | None = None,
                    _run_index: int = 0, _runner=None, device=None) -> dict:
    """One raytracing run (all iterations), returning a results dict."""
    if _runner is None:
        _runner, _pipeline = build_runner(config, _pipeline, device)
    pipeline = _pipeline
    config = pipeline.config
    g = config["general"]

    generator = _run_generator(g, _run_index, pipeline.device)
    profiler.start("raytrace_run")
    with on_device(pipeline.device):  # the kernels launch on the current device
        out = _runner(pipeline.params, generator)
    if pipeline.device.type == "cuda":
        torch.cuda.synchronize(pipeline.device)
    profiler.stop("raytrace_run")

    rng = np.random.default_rng(
        None if g["random_seed"] is None else int(g["random_seed"]) + _run_index
    )
    with profiler.span("sort_history"):
        found, lost = _sort_history(
            out["history"], pipeline.element_names,
            int(g["history_max_lost"]), rng,
        )

    def _section_meta(history):
        return {name: {"num_out": int(rays["mask"].sum())}
                for name, rays in history.items()}

    return {
        "config": config,
        "total": {
            "meta": {
                name: {"num_out": int(out["meta"][name])}
                for name in pipeline.element_names
                if name in out["meta"]
            },
            "image": {name: img.cpu().numpy() for name, img in out["image"].items()},
        },
        "found": {"meta": _section_meta(found), "history": found},
        "lost": {"meta": _section_meta(lost), "history": lost},
    }


def raytrace(config: dict, device=None) -> dict:
    """Top-level entry: all runs, combined results, optional saving and
    printing (JAX ``engine.py:545-597``).

    ``device`` defaults to CUDA and raises when CUDA is absent; pass
    ``device='cpu'`` to run on the CPU.
    """
    from xicsrt_tpu_torch import io as xio

    t_start = time.time()
    device = default_device(device)
    with profiler.span("build_runner"):
        runner, pipeline = build_runner(config, device=device)
    config = pipeline.config
    g = config["general"]

    outputs = []
    with profiler.device_trace(g.get("profile_dir")):
        for run in range(int(g["number_of_runs"])):
            g["output_run_suffix"] = f"{run:04d}"
            result = raytrace_single(
                config, _pipeline=pipeline, _run_index=run, _runner=runner)
            if g["save_images"]:
                with profiler.span("save_images"):
                    xio.save_images(result)
            outputs.append(result)

    with profiler.span("combine_raytrace"):
        result = combine_raytrace(outputs)
    g["output_run_suffix"] = None
    if g["save_config"]:
        xio.save_config(config)
    if g["save_images"]:
        xio.save_images(result)
    if g["save_results"]:
        with profiler.span("save_results"):
            xio.save_results(result)
    if g["print_results"]:
        print_raytrace(result)
    log.info("raytrace completed in %0.2f s", time.time() - t_start)
    return result


def raytrace_mp(config: dict, processes=None, device=None) -> dict:
    """The reference's multiprocess entry point (JAX
    ``xicsrt_tpu/__init__.py:44-60``): the ray-sharded run over
    ``processes`` shards, by default one for each device. On ``'cuda'``
    that is the process's CUDA devices, and ``processes`` is cut to their
    number, as JAX cuts it; one named device (``'cpu'``, ``'cuda:0'``)
    holds as many shards as asked, and one by default. Over one shard it is
    exactly :func:`raytrace`.
    """
    import copy

    from xicsrt_tpu_torch.parallel.mesh import _group, available_shards

    device = default_device(device)
    world = _group()[1]
    available = available_shards(device)
    most = None if available is None else available * world
    n = int(processes) if processes is not None else (most or world)
    if most is not None:
        n = min(n, most)
    if n > 1:
        config = copy.deepcopy(config)
        general = config.setdefault("general", {})
        general["shard_rays"] = True
        general["devices"] = n
    return raytrace(config, device)


def combine_raytrace(input_list: list) -> dict:
    """Combine results dicts from multiple runs: meta counters sum, images
    sum (with shape checks), histories concatenate."""
    if len(input_list) == 1:
        return input_list[0]
    output = {
        "config": input_list[0]["config"],
        "total": {"meta": {}, "image": {}},
        "found": {"meta": {}, "history": {}},
        "lost": {"meta": {}, "history": {}},
    }
    for name in input_list[0]["total"]["meta"]:
        output["total"]["meta"][name] = {
            "num_out": int(sum(r["total"]["meta"][name]["num_out"] for r in input_list))
        }
    for name, img in input_list[0]["total"]["image"].items():
        for r in input_list[1:]:
            if r["total"]["image"][name].shape != img.shape:
                raise ValueError(f"Image shapes for {name} do not match across runs.")
        output["total"]["image"][name] = sum(
            r["total"]["image"][name] for r in input_list)
    for section in ("found", "lost"):
        for name in input_list[0][section]["history"]:
            keys = input_list[0][section]["history"][name].keys()
            output[section]["history"][name] = {
                k: np.concatenate([r[section]["history"][name][k] for r in input_list])
                for k in keys
            }
        for name in input_list[0][section]["meta"]:
            output[section]["meta"][name] = {
                "num_out": int(sum(r[section]["meta"][name]["num_out"]
                                   for r in input_list))
            }
    return output


def print_raytrace(results: dict) -> None:
    """Generated/detected counts and the Poisson-error efficiency."""
    meta = results["total"]["meta"]
    names = list(meta.keys())
    if not names:
        return
    num_generated = meta[names[0]]["num_out"]
    num_detected = meta[names[-1]]["num_out"]
    efficiency = num_detected / max(num_generated, 1)
    error = np.sqrt(max(num_detected, 1)) / max(num_generated, 1)
    print("")
    print("Rays Generated: {:0.4e}".format(num_generated))
    for name in names[1:]:
        print("Rays on {:12s}: {:0.4e}".format(name, meta[name]["num_out"]))
    print("Efficiency: {:0.4e} +/- {:0.2e} ({:0.2f}%)".format(
        efficiency, error, efficiency * 100))
    print("")
