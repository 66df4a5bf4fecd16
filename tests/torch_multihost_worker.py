"""Worker process of the port's multi-rank ``torch.distributed`` tests.

Launched by :func:`run_ranks` (``tests/test_torch_parallel.py``: two ranks
over localhost, gloo on the CPU, 4 shards each; ``tests/test_torch_cuda.py``:
one rank a GPU, NCCL). Each rank holds its share of the shards of the
port's sharded runs, which sum images and meta over the ranks: a seeded
and a seedless raytrace, the eager and the fused gradient paths.
:func:`check_ranks` holds the ranks' results to one process's run of the
same shards. It imports no JAX.

Usage: python torch_multihost_worker.py <rank> <world> <port> <out_npz>
<config_json> <device>
"""

import copy
import json
import os
import socket
import subprocess
import sys

import numpy as np


def gradient_config(dtype="float64", intensity=4096):
    """A spherical crystal and a detector in weight/bilinear mode
    (``tests/test_parallel_gradients.py``'s chain, fewer rays)."""
    return {
        "general": {"number_of_iter": 1, "random_seed": 0, "print_results": False,
                    "dtype": dtype},
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "angular_dist": "isotropic_xy",
                               "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {"class_name": "XicsrtOpticSphericalCrystal",
                        "origin": [0.0, 0.0, 0.80374151],
                        "zaxis": [0.0, 0.59497864, -0.80374151],
                        "xsize": 0.2, "ysize": 0.2, "radius": 1.0,
                        "crystal_spacing": 2.45676, "rocking_type": "gaussian",
                        "rocking_fwhm": 2e-4},
            "detector": {"class_name": "XicsrtOpticDetector",
                         "origin": [0.0, 0.76871290, 0.56904832],
                         "zaxis": [0.0, -0.95641806, 0.29200084],
                         "xsize": 0.4, "ysize": 0.2, "pixel_size": 0.01}}}


def spacing_loss(image_fn, pipeline):
    """``loss(d, generator)``: the detector image's sum at crystal spacing
    ``d``, and the spacing the pipeline was built with."""
    params = pipeline.params
    d0 = params["optics"]["crystal"]["crystal_spacing"]

    def loss(d, gen):
        p = dict(params)
        p["optics"] = dict(params["optics"])
        p["optics"]["crystal"] = dict(params["optics"]["crystal"])
        p["optics"]["crystal"]["crystal_spacing"] = d
        return image_fn(p, gen)["detector"].sum()

    return loss, d0


def spacing_gradient(mesh, seed=3):
    """The sharded eager forward's detector sum and its autograd gradient
    with respect to the crystal spacing, as floats."""
    from xicsrt_tpu_torch.engine import _run_generator
    from xicsrt_tpu_torch.gradients import make_differentiable

    image_fn, pipeline = make_differentiable(gradient_config(), mesh=mesh)
    loss, d0 = spacing_loss(image_fn, pipeline)
    d = d0.detach().clone().requires_grad_(True)
    value = loss(d, _run_generator({"random_seed": seed}, 0, pipeline.device))
    value.backward()
    return float(value.detach()), float(d.grad)


def cotangents(images: dict) -> dict:
    """A fixed random cotangent for each image."""
    import torch

    rng = np.random.default_rng(4)
    return {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
            for k, v in images.items()}


def run_ranks(world: int, config: dict, device: str, out_dir) -> list:
    """Run ``world`` ranks of this file over localhost on ``config`` (whose
    ``general.devices`` is the mesh's size) and ``device``; each rank's
    saved arrays, in rank order. A rank that fails or outlasts 300 s fails
    the call, and every rank still running is killed."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    outs = [os.path.join(str(out_dir), f"rank{r}.npz") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), out, json.dumps(config), device],
                              env=env, cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r, out in enumerate(outs)]
    try:
        logs = [proc.communicate(timeout=300)[0].decode() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, (proc, text) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r}:\n{text[-3000:]}"
    return [dict(np.load(out)) for out in outs]


def check_ranks(outputs: list, config: dict, device: str) -> None:
    """The ranks' results against one process's run of the same shards on
    ``device``: images and meta equal on every rank and to the one
    process's; the ranks' found sets together the one process's; a run
    without a seed traces one set of rays (rank 0's word); the eager
    gradient and the fused forward and vjp equal the one process's but
    for the order of the ranks' sums."""
    from xicsrt_tpu_torch.engine import raytrace_single
    from xicsrt_tpu_torch.parallel import ray_mesh

    n = config["general"]["devices"]
    budget = (config["sources"]["source"]["intensity"]
              * config["general"]["number_of_iter"])
    ref = raytrace_single(config, device=device)
    ref_found = ref["found"]["history"]["detector"]["origin"].shape[0]
    mesh = ray_mesh(n, device)
    ref_sum, ref_grad = spacing_gradient(mesh)
    ref_forward, ref_vjp = fused_gradients(mesh)
    for out in outputs:
        np.testing.assert_array_equal(out["image"], ref["total"]["image"]["detector"])
        assert out["num_source"] == ref["total"]["meta"]["source"]["num_out"] == budget
        assert out["num_detector"] == ref["total"]["meta"]["detector"]["num_out"]
        assert bool(out["found_final_mask_all"])
        np.testing.assert_allclose(float(out["grad_image_sum"]), ref_sum, rtol=1e-12)
        np.testing.assert_allclose(float(out["grad"]), ref_grad, rtol=1e-10)
        np.testing.assert_allclose(out["fused_forward"], ref_forward, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(out["fused_vjp"], ref_vjp, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(out["seedless_image"], outputs[0]["seedless_image"])
        assert out["seedless_source"] == budget
        assert out["seedless_detector"] == outputs[0]["seedless_detector"] > 0
    assert sum(int(out["found_local"]) for out in outputs) == ref_found
    assert 0 < ref_found < budget


def fused_gradients(mesh, seed=5):
    """The sharded fused forward's detector image and the vjp of
    :func:`cotangents`, as numpy arrays."""
    from xicsrt_tpu_torch.gradients import make_fused_differentiable

    forward, vjp, pack, pipeline = make_fused_differentiable(
        gradient_config("float32", 2048), mesh=mesh)
    pvec = pack(pipeline.params).detach()
    images = forward(pvec, seed)["image"]
    g = {k: v.to(pipeline.device) for k, v in cotangents(images).items()}
    return images["detector"].cpu().numpy(), vjp(pvec, seed, g).cpu().numpy()


def main():
    rank, world, port, out_path = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                   sys.argv[4])
    config = json.loads(sys.argv[5])
    device = sys.argv[6]

    import torch

    from xicsrt_tpu_torch import engine
    from xicsrt_tpu_torch.parallel import init_multihost, ray_mesh

    info = init_multihost(coordinator_address=f"localhost:{port}", num_processes=world,
                          process_id=rank)
    assert info["process_count"] == world, info
    assert info["is_primary"] == (rank == 0), info
    assert torch.distributed.get_backend() == ("gloo" if device == "cpu" else "nccl")

    result = engine.raytrace_single(config, device=device)
    seedless = copy.deepcopy(config)
    seedless["general"]["random_seed"] = None
    seedless["general"]["keep_history"] = False
    free = engine.raytrace_single(seedless, device=device)
    n = config["general"]["devices"]
    mesh = ray_mesh(n, device)
    k = n // world
    assert (mesh.size, len(mesh.devices), tuple(mesh.positions)) == (
        n, k, tuple(range(k * rank, k * rank + k))), mesh
    image_sum, grad = spacing_gradient(mesh)
    forward, vjp = fused_gradients(mesh)

    found = result["found"]["history"]["detector"]
    np.savez(
        out_path,
        image=result["total"]["image"]["detector"],
        num_source=result["total"]["meta"]["source"]["num_out"],
        num_detector=result["total"]["meta"]["detector"]["num_out"],
        found_local=found["origin"].shape[0],
        found_final_mask_all=np.all(found["mask"]),
        seedless_image=free["total"]["image"]["detector"],
        seedless_source=free["total"]["meta"]["source"]["num_out"],
        seedless_detector=free["total"]["meta"]["detector"]["num_out"],
        grad_image_sum=image_sum, grad=grad, fused_forward=forward, fused_vjp=vjp,
    )
    torch.distributed.destroy_process_group()
    print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
    main()
