"""The port's ray-sharded runs (``xicsrt_tpu_torch/parallel``) on the CPU,
held against the JAX package's sharded runs on conftest's 8 virtual CPU
devices.

On the CPU the port's mesh is ``n`` shards on the one CPU device
(``ray_mesh(n, 'cpu')``), each tracing its share of the photon load from a
generator of its own; images and meta sum over the shards and, under
``torch.distributed``, over the ranks. The two packages draw different
streams, so counts agree exactly where they are fixed (counted budgets)
and within binomial bands elsewhere. The two-rank test runs
``tests/torch_multihost_worker.py`` twice over gloo on localhost.
"""

import copy
import math

import jax
import numpy as np
import pytest
import torch

import xicsrt_tpu
import xicsrt_tpu_torch
from torch_multihost_worker import (check_ranks, cotangents, fused_gradients, run_ranks,
                                    spacing_gradient, spacing_loss)
from xicsrt_tpu.parallel import mesh as jmesh
from xicsrt_tpu_torch.engine import Pipeline, _run_generator
from xicsrt_tpu_torch.parallel import (init_multihost, make_sharded_run, ray_mesh,
                                       scaling_efficiency)
from xicsrt_tpu_torch.parallel import mesh as tmesh

def _config(intensity=8000, num_iter=2, **general):
    """``tests/test_parallel.py``'s directed source onto a detector."""
    g = {"number_of_iter": num_iter, "random_seed": 0, "keep_history": False,
         "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "spread": np.radians(5.0)}},
        "optics": {"detector": {"class_name": "XicsrtOpticDetector",
                                "origin": [0.0, 0.0, 1.0], "zaxis": [0.0, 0.0, -1.0],
                                "xsize": 0.2, "ysize": 0.2}},
    }


def _plasma_config(**general):
    """``tests/test_parallel.py``'s cubic plasma under a detector across its
    whole emission cone."""
    g = {"number_of_iter": 1, "random_seed": 0, "keep_history": False,
         "print_results": False}
    g.update(general)
    return {
        "general": g,
        "sources": {"plasma": {
            "class_name": "XicsrtPlasmaCubic", "origin": [0.0, 0.0, 0.0],
            "zaxis": [0.0, 0.0, 1.0], "xsize": 0.1, "ysize": 0.1, "zsize": 0.1,
            "target": [0.0, 0.0, 1.0], "spread": np.pi / 3, "emissivity": 2e10,
            "temperature": 100.0, "wavelength": 3.9492, "time_resolution": 1e-3,
            "bundle_volume": 1e-6, "bundle_count": 1000, "use_poisson": True}},
        "optics": {"detector": {"class_name": "XicsrtOpticDetector",
                                "origin": [0.0, 0.0, 1.0], "zaxis": [0.0, 0.0, -1.0],
                                "xsize": 4.0, "ysize": 4.0, "pixel_size": 0.04}},
    }


def _fused_config(intensity, **general):
    """``TestShardedFused``'s spherical-crystal chain."""
    g = {"number_of_iter": 1, "random_seed": 0, "keep_history": False,
         "print_results": False, "engine": "fused"}
    g.update(general)
    return {
        "general": g,
        "sources": {"source": {"class_name": "XicsrtSourceDirected", "intensity": intensity,
                               "wavelength": 3.9492, "angular_dist": "isotropic_xy",
                               "spread": np.radians(10.0)}},
        "optics": {
            "crystal": {"class_name": "XicsrtOpticSphericalCrystal",
                        "origin": [0.0, 0.0, 0.80374151],
                        "zaxis": [0.0, 0.59497864, -0.80374151], "xsize": 0.2,
                        "ysize": 0.2, "radius": 1.0, "crystal_spacing": 2.45676,
                        "rocking_type": "gaussian", "rocking_fwhm": 150e-6},
            "detector": {"class_name": "XicsrtOpticDetector",
                         "origin": [0.0, 0.76871290, 0.56904832],
                         "zaxis": [0.0, -0.95641806, 0.29200084],
                         "xsize": 0.4, "ysize": 0.2}},
    }


def _run(config, n_devices=8, seed_run=0, **kwargs):
    fn, pipeline, mesh = make_sharded_run(config, n_devices=n_devices, device="cpu", **kwargs)
    out = fn(pipeline.params, _run_generator({"random_seed": seed_run}, 0, pipeline.device))
    return out, pipeline, mesh


def _count(out, name):
    return int(out["meta"][name])


def _binomial_close(k1, n1, k2, n2, n_sigma=5.0):
    p = (k1 + k2) / (n1 + n2)
    sigma = math.sqrt(max(p * (1 - p) * (1 / n1 + 1 / n2), 1e-300))
    return abs(k1 / n1 - k2 / n2) <= n_sigma * sigma


def _meta(result):
    return {k: v["num_out"] for k, v in result["total"]["meta"].items()}


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs JAX's 8 virtual CPU devices")


@pytest.mark.parametrize("case", ["counted", "counted_remainder", "poisson", "plasma",
                                  "scaled"])
def test_shard_intensity_matches_jax(case):
    """The copy of ``_shard_intensity`` divides every source as JAX's does."""
    cfg = _plasma_config() if case == "plasma" else _config(intensity=8003)
    src = next(iter(cfg["sources"].values()))
    if case == "counted":
        src["intensity"] = 8000
    elif case == "poisson":
        src["use_poisson"] = True
    elif case == "scaled":
        src["intensity_scale"] = 0.5
    before = copy.deepcopy(cfg)
    for n in (1, 3, 8):
        assert tmesh._shard_intensity(cfg, n) == jmesh._shard_intensity(cfg, n)
    assert cfg == before


def test_shard_intensity_below_mesh_raises():
    for shard in (tmesh._shard_intensity, jmesh._shard_intensity):
        with pytest.raises(ValueError, match="below the 8-device mesh"):
            shard(_config(intensity=4), 8)
    with pytest.raises(ValueError, match="below the 8-device mesh"):
        make_sharded_run(_config(intensity=4), n_devices=8, device="cpu")


def test_example05_matches_jax_sharded(eight_devices):
    """Example 05's config (``shard_rays``, 80000 rays x 2) over 8 shards:
    the generated totals equal JAX's exactly, the detector within 5
    binomial sigma of JAX's sharded run."""
    import chip_smoke

    cfg = chip_smoke.example_config("example_05_multichip.py")
    cfg["general"]["print_results"] = False
    jr = xicsrt_tpu.raytrace(copy.deepcopy(cfg))
    port_cfg = copy.deepcopy(cfg)
    port_cfg["general"]["devices"] = 8
    tr = xicsrt_tpu_torch.raytrace(port_cfg, device="cpu")
    jm, tm = _meta(jr), _meta(tr)
    assert tm["source"] == jm["source"] == 2 * 80000
    assert _binomial_close(tm["detector"], tm["source"], jm["detector"], jm["source"])
    assert tr["total"]["image"]["detector"].sum() == tm["detector"]


class TestShardedRun:
    def test_total_counts(self):
        out, pipeline, mesh = _run(_config())
        assert mesh.size == 8 and mesh.devices == (torch.device("cpu"),) * 8
        assert pipeline.num_rays == 1000
        assert _count(out, "source") == _count(out, "detector") == 16000
        assert float(out["image"]["detector"].sum()) == 16000

    def test_shards_draw_different_rays(self):
        out, _, _ = _run(_config(num_iter=1, keep_history=True))
        per_shard = out["history"]["detector"].origin.reshape(8, -1, 3)
        for i in range(8):
            for j in range(i + 1, 8):
                assert not torch.allclose(per_shard[i], per_shard[j])

    def test_history_concatenated_on_the_ray_axis(self):
        """The history is the shards' own runs' rows, in mesh order; a seed
        and a mesh give the same rays again."""
        cfg = _config(num_iter=1, keep_history=True)
        out, pipeline, mesh = _run(cfg)
        assert out["history"]["detector"].origin.shape == (8000, 3)
        gens = tmesh.shard_generators(_run_generator({"random_seed": 0}, 0, "cpu"), mesh)
        run = pipeline.make_run(1)
        own = [run(pipeline.params, g)["history"]["detector"].origin for g in gens]
        assert torch.equal(out["history"]["detector"].origin, torch.cat(own))
        again, _, _ = _run(cfg)
        assert torch.equal(again["history"]["detector"].origin,
                           out["history"]["detector"].origin)

    def test_raytrace_api_with_shard_rays(self):
        results = xicsrt_tpu_torch.raytrace(
            _config(num_iter=1, shard_rays=True, devices=8, keep_history=True), device="cpu")
        assert results["total"]["meta"]["source"]["num_out"] == 8000
        assert results["total"]["image"]["detector"].sum() == 8000
        assert results["found"]["history"]["detector"]["origin"].shape[0] == 8000

    def test_mesh_subsets_and_topologies(self, monkeypatch):
        out, _, mesh = _run(_config(num_iter=1), n_devices=4)
        assert mesh.size == 4 and _count(out, "source") == 8000
        assert ray_mesh(3, ["cpu"] * 5).devices == (torch.device("cpu"),) * 3
        with pytest.raises(ValueError, match="3 shards a rank asked"):
            ray_mesh(3, ["cpu", "cpu"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ray_mesh(2)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            xicsrt_tpu_torch.raytrace(_config(shard_rays=True, devices=2))
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 shards a rank asked, 1 devices"):
            ray_mesh(2, "cuda")

    def test_one_shard_is_the_unsharded_run(self):
        cfg = _config(num_iter=1)
        runner, pipeline, mesh = make_sharded_run(cfg, n_devices=1, device="cpu")
        gen = _run_generator({"random_seed": 0}, 0, "cpu")
        plain = Pipeline(cfg, "cpu").make_run(1)(pipeline.params,
                                                 _run_generator({"random_seed": 0}, 0, "cpu"))
        out = runner(pipeline.params, gen)
        assert mesh.size == 1
        assert torch.equal(out["image"]["detector"], plain["image"]["detector"])


class TestShardedPlasma:
    def test_sharded_totals_match_physics(self):
        out, _, _ = _run(_plasma_config())
        n_gen = _count(out, "plasma")
        expected = 2e10 * 1e-3 * 0.1**3 * np.sin((np.pi / 3) / 2) ** 2
        assert expected > 1000
        assert abs(n_gen - expected) < 5 * np.sqrt(expected), (n_gen, expected)
        assert _count(out, "detector") == n_gen
        assert float(out["image"]["detector"].sum()) == n_gen

    def test_budget_shrinks_per_shard(self):
        _, pipeline, _ = _run(_plasma_config())
        single = Pipeline(_plasma_config(), "cpu")
        assert pipeline.num_rays < single.num_rays / 4


class TestShardedFused:
    def test_fused_sharded_totals_and_shards_differ(self):
        n = 8 * 4096
        out, _, _ = _run(_fused_config(n))
        assert _count(out, "source") == n
        assert 0 < _count(out, "detector") == float(out["image"]["detector"].sum())
        again, _, _ = _run(_fused_config(n), seed_run=1)
        assert not torch.equal(out["image"]["detector"], again["image"]["detector"])

    def test_fused_sharded_matches_eager_sharded(self):
        n = 8 * 8192
        fused, _, _ = _run(_fused_config(n))
        eager, _, _ = _run(_fused_config(n, engine="xla"), seed_run=1)
        assert _binomial_close(_count(fused, "detector"), n, _count(eager, "detector"), n)

    def test_fused_sharded_rejects_stale_params(self):
        fn, pipeline, _ = make_sharded_run(_fused_config(8 * 1024), n_devices=8, device="cpu")
        mutated = tmesh.map_tensors(pipeline.params, lambda t: t.clone())
        gen = _run_generator({"random_seed": 0}, 0, "cpu")
        assert _count(fn(mutated, gen), "source") == 8 * 1024  # equal values pass
        mutated["optics"]["crystal"]["crystal_spacing"] = torch.tensor(2.5)
        with pytest.raises(ValueError, match="bakes geometry"):
            fn(mutated, gen)

    def test_auto_falls_back_with_history(self):
        out, _, _ = _run(_fused_config(8 * 1024, engine="auto", keep_history=True))
        assert out["history"]["detector"].origin.shape[0] == 8 * 1024

    def test_fused_with_full_history_raises(self):
        with pytest.raises(NotImplementedError, match="FULL ray history"):
            make_sharded_run(_fused_config(8 * 1024, keep_history=True), n_devices=8,
                             device="cpu")


def test_raytrace_mp_matches_jax(eight_devices):
    """``raytrace_mp(config, processes=4)`` in both packages: 4 shards, the
    generated totals exact, the vignetted detector within 5 binomial
    sigma."""
    cfg = _config(intensity=40000, num_iter=1)
    cfg["optics"]["detector"].update(xsize=0.12, ysize=0.12)
    jm = _meta(xicsrt_tpu.raytrace_mp(copy.deepcopy(cfg), processes=4))
    tm = _meta(xicsrt_tpu_torch.raytrace_mp(cfg, processes=4, device="cpu"))
    assert tm["source"] == jm["source"] == 40000
    assert 0 < tm["detector"] < 40000
    assert _binomial_close(tm["detector"], 40000, jm["detector"], 40000)


class TestShardedGradients:
    def test_sharded_gradient_is_the_sum_of_its_shards(self):
        """The sharded eager forward and its autograd gradient equal the
        sums over the shards' own runs (the same generators)."""
        from torch_multihost_worker import gradient_config
        from xicsrt_tpu_torch.gradients import make_differentiable

        mesh = ray_mesh(4, "cpu")
        value, grad = spacing_gradient(mesh)
        image_fn, pipeline = make_differentiable(
            tmesh._shard_intensity(gradient_config(), 4), device="cpu")
        loss, d0 = spacing_loss(image_fn, pipeline)
        d = d0.detach().clone().requires_grad_(True)
        gens = tmesh.shard_generators(_run_generator({"random_seed": 3}, 0, "cpu"), mesh)
        total = sum(loss(d, g) for g in gens)
        total.backward()
        assert grad != 0.0
        assert value == pytest.approx(float(total.detach()), rel=1e-12)
        assert grad == pytest.approx(float(d.grad), rel=1e-10)

    def test_sharded_gradient_matches_own_finite_difference(self):
        from torch_multihost_worker import gradient_config
        from xicsrt_tpu_torch.gradients import make_differentiable

        image_fn, pipeline = make_differentiable(gradient_config(), n_devices=4, device="cpu")
        loss, d0 = spacing_loss(image_fn, pipeline)

        def at(d):
            return loss(d, _run_generator({"random_seed": 3}, 0, "cpu"))

        d = d0.detach().clone().requires_grad_(True)
        at(d).backward()
        eps = 1e-6
        with torch.no_grad():
            fd = (float(at(d0 + eps)) - float(at(d0 - eps))) / (2 * eps)
        assert float(d.grad) != 0.0
        np.testing.assert_allclose(float(d.grad), fd, rtol=2e-3)

    def test_fused_sharded_forward_and_vjp_are_sums_of_shards(self):
        from torch_multihost_worker import gradient_config
        from xicsrt_tpu_torch.gradients import make_fused_differentiable

        mesh = ray_mesh(4, "cpu")
        image, gvec = fused_gradients(mesh)
        forward, vjp, pack, pipeline = make_fused_differentiable(
            tmesh._shard_intensity(gradient_config("float32", 2048), 4), device="cpu")
        pvec = pack(pipeline.params).detach()
        seeds = [tmesh.shard_seed(5, i) for i in range(4)]
        shard_images = [forward(pvec, s)["image"] for s in seeds]
        g = cotangents(shard_images[0])
        assert len(set(seeds)) == 4
        det = [im["detector"] for im in shard_images]
        assert not torch.equal(det[0], det[1])
        assert np.array_equal(image, (det[0] + det[1] + det[2] + det[3]).numpy())
        want_g = sum(vjp(pvec, s, g) for s in seeds)
        np.testing.assert_allclose(gvec, want_g.numpy(), rtol=1e-6, atol=1e-6)
        assert np.abs(gvec).max() > 0


    def test_one_shard_mesh_is_the_unsharded_path(self):
        """A mesh of one shard on the CPU takes the unsharded path on its
        device, as ``n_devices=1`` does: the same images, no CUDA asked."""
        from torch_multihost_worker import gradient_config
        from xicsrt_tpu_torch.gradients import make_differentiable, make_fused_differentiable

        images = []
        for kwargs in ({"mesh": ray_mesh(1, "cpu")}, {"device": "cpu"}):
            image_fn, pipeline = make_differentiable(gradient_config(intensity=512), **kwargs)
            assert pipeline.device == torch.device("cpu")
            images.append(image_fn(pipeline.params,
                                   _run_generator({"random_seed": 2}, 0, "cpu"))["detector"])
            forward, _, pack, pipe = make_fused_differentiable(
                gradient_config("float32", 512), **kwargs)
            images.append(forward(pack(pipe.params), 9)["image"]["detector"])
        assert torch.equal(images[0], images[2]) and torch.equal(images[1], images[3])


def test_init_multihost_single_process():
    info = init_multihost()
    assert info == {"process_index": 0, "process_count": 1, "num_devices": 1,
                    "is_primary": True}
    assert init_multihost() == info
    eff = scaling_efficiency({1: 100.0, 8: 720.0})
    assert eff[1] == pytest.approx(1.0) and eff[8] == pytest.approx(0.9)
    assert scaling_efficiency({2: 5.0}) == {}
    with pytest.raises(ValueError, match="together"):
        init_multihost(num_processes=2)


def test_two_ranks_match_one_process(tmp_path):
    """Two gloo ranks of 4 shards each (``tests/torch_multihost_worker.py``)
    against one process of 8 shards (``check_ranks``): images and meta
    equal on both ranks and equal to the one process's; history kept per
    rank, the two found sets together the one process's; a run without a
    seed traces one set of rays (rank 0's word); the eager gradient and
    the fused forward and vjp equal the one process's but for the order of
    the ranks' sums."""
    config = _config(intensity=4096, num_iter=2, random_seed=7, keep_history=True,
                     shard_rays=True, devices=8)
    config["optics"]["detector"].update(xsize=0.12, ysize=0.12)
    check_ranks(run_ranks(2, config, "cpu", tmp_path), config, "cpu")
