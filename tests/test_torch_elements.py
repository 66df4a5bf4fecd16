"""The port's elements against the JAX package on identical inputs.

- ``params_from_jax`` turns the JAX ``Pipeline.params`` of the flagship
  spectrometer into exactly the port's own params.
- The source draws the uniforms the JAX source drew (its key splits
  reproduced) and gives the same rays.
- Each optic traces the same float32 rays: positions within 1e-6 m,
  directions within 1e-6, masks exactly equal. The crystal takes the JAX
  interaction's own uniform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _spectrometer_config
from xicsrt_tpu.engine import Pipeline as JaxPipeline
from xicsrt_tpu_torch import params_from_jax
from xicsrt_tpu_torch.draws import ExplicitDraws
from xicsrt_tpu_torch.engine import Pipeline as TorchPipeline
from xicsrt_tpu_torch.rays import Rays as TorchRays

ATOL = 1e-6  # metres for positions, unit vectors for directions


def _config(n=4096, **general):
    return _spectrometer_config(intensity=n, **general)


@pytest.fixture(scope="module")
def pipelines():
    cfg = _config()
    return JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_params_equal(a[k], b[k])
    elif hasattr(a, "basis"):
        assert torch.equal(a.origin, b.origin) and torch.equal(a.basis, b.basis)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_params_from_jax_round_trip(pipelines):
    jp, tp = pipelines
    converted = params_from_jax(_np_tree(jp.params))
    _assert_params_equal(converted, tp.params)  # exact: same float32 values
    assert tp.params["optics"]["crystal"]["radius"].dtype == torch.float32


def test_pipeline_structure_matches(pipelines):
    jp, tp = pipelines
    assert jp.element_names == tp.element_names
    assert jp.num_rays == tp.num_rays
    assert jp.image_specs() == tp.image_specs()


def _to_torch(rays):
    r = _np_tree(rays)
    return TorchRays(origin=torch.tensor(r.origin), direction=torch.tensor(r.direction),
                     wavelength=torch.tensor(r.wavelength),
                     weight=torch.tensor(r.weight), mask=torch.tensor(r.mask))


def _assert_rays_close(j, t):
    j = _np_tree(j)
    np.testing.assert_allclose(t.origin.numpy(), j.origin, rtol=0, atol=ATOL)
    np.testing.assert_allclose(t.direction.numpy(), j.direction, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(t.wavelength.numpy(), j.wavelength)
    np.testing.assert_array_equal(t.mask.numpy(), j.mask)


def _source_draws(key):
    """The uniforms ``SourceGeneric.make_generate`` draws for a point source
    with an isotropic_xy cone: split(key, 4)[1] -> split -> u, v."""
    _, k_dir, _, _ = jax.random.split(key, 4)
    ku, kv = jax.random.split(k_dir)
    n = 4096
    return [np.asarray(jax.random.uniform(ku, (n,), dtype=jnp.float32)),
            np.asarray(jax.random.uniform(kv, (n,), dtype=jnp.float32))]


def test_source_generate(pipelines):
    jp, tp = pipelines
    key = jax.random.key(42)
    jrays = jp.generate(jp.params["sources"]["source"], jp.params["filters"], key)
    trays = tp.source.generate(tp.params["sources"]["source"],
                               ExplicitDraws(_source_draws(key)))
    _assert_rays_close(jrays, trays)
    assert trays.dtype == torch.float32


def test_optic_chain_traces(pipelines):
    """Aperture (plane + circle AND NOT circle), crystal (sphere + gaussian
    Bragg acceptance, given u), detector: each from the same input rays."""
    jp, tp = pipelines
    key = jax.random.key(7)
    rays = jp.generate(jp.params["sources"]["source"], jp.params["filters"], key)
    alive = []
    for idx, (name, jtrace) in enumerate(jp.optic_traces):
        k = jax.random.fold_in(key, idx)
        jout, jx = jtrace(jp.params["optics"][name], rays, k)
        optic = tp.optics[idx]
        # The JAX crystal draws uniform(k, (n,)) for its Bernoulli test.
        u = np.asarray(jax.random.uniform(k, (rays.n,), dtype=jnp.float32))
        tout, tx = optic.trace(tp.params["optics"][name], _to_torch(rays),
                               ExplicitDraws([u]))
        _assert_rays_close(jout, tout)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
        alive.append(int(np.asarray(jout.mask).sum()))
        rays = jout
    assert alive[0] > 0.5 * 4096 and alive[1] > 0 and alive[2] > 0


def test_crystal_step_rocking_and_convex_sphere():
    """A step rocking curve on a convex sphere, and a planar crystal."""
    cfg = _config()
    crystal = cfg["optics"]["crystal"]
    crystal.update(rocking_type="step", rocking_fwhm=4e-4, convex=True, radius=5.0)
    cfg["optics"]["flat"] = {
        "class_name": "XicsrtOpticPlanarCrystal",
        "origin": [0.0, 0.76871290, 0.56904832],
        "zaxis": [0.0, -0.95641806, 0.29200084],
        "crystal_spacing": 2.45676, "rocking_type": "gaussian",
        "rocking_fwhm": 1e-3, "xsize": 0.4, "ysize": 0.2,
    }
    del cfg["optics"]["detector"]
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    key = jax.random.key(3)
    rays = jp.generate(jp.params["sources"]["source"], jp.params["filters"], key)
    for idx, (name, jtrace) in enumerate(jp.optic_traces):
        k = jax.random.fold_in(key, idx)
        jout, _ = jtrace(jp.params["optics"][name], rays, k)
        u = np.asarray(jax.random.uniform(k, (rays.n,), dtype=jnp.float32))
        tout, _ = tp.optics[idx].trace(tp.params["optics"][name], _to_torch(rays),
                                       ExplicitDraws([u]))
        _assert_rays_close(jout, tout)
        rays = jout


def test_poisson_source_budget_and_mask():
    cfg = _config(n=5000)
    cfg["sources"]["source"]["use_poisson"] = True
    jp, tp = JaxPipeline(cfg), TorchPipeline(cfg, device="cpu")
    assert tp.num_rays == jp.num_rays > 5000
    draws = ExplicitDraws([np.full(tp.num_rays, 0.5, np.float32)] * 2, counts=[4980])
    rays = tp.source.generate(tp.params["sources"]["source"], draws)
    assert int(rays.num_alive()) == 4980
    assert bool(rays.mask[:4980].all()) and not bool(rays.mask[4980:].any())


def test_not_ported_elements_raise():
    cfg = _config()
    cfg["sources"]["source"]["wavelength_dist"] = "uniform"
    with pytest.raises(NotImplementedError):
        TorchPipeline(cfg, device="cpu")
    cfg = _config()
    cfg["optics"]["crystal"]["class_name"] = "XicsrtOpticToroidalCrystal"
    with pytest.raises(KeyError):
        TorchPipeline(cfg, device="cpu")
    cfg = _config()
    cfg["optics"]["crystal"]["rocking_type"] = "file"
    with pytest.raises(NotImplementedError):
        TorchPipeline(cfg, device="cpu")


def test_strict_config_rejects_typos():
    cfg = _config()
    cfg["optics"]["crystal"]["radiuss"] = 1.0
    with pytest.raises(KeyError, match="radiuss"):
        TorchPipeline(cfg, device="cpu")
