"""The unfused MC estimators of the PyTorch port (``energy_mc``,
``energy_mc_scan``) vs the JAX package.

The random bits of the two packages differ, so the estimators are held in
distribution: the mean over many draws against the JAX package's closed-form
``energy_expected`` on the same curve, rtol 0.08 as the JAX suite holds its
own MC kernels (tests/test_energy_mc_pallas.py:55-71).  Inputs: the first 5
seed-42 production decoders and seed-42 init curves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu_torch.geometry import energy as tenergy
from vae_latent_geometry_tpu_torch.models import evae as tevae

from torch_parity_inputs import MODEL, init_curves, members

T, B, M = 48, 6, 5
ESTIMATORS = {"mc": tenergy.energy_mc, "mc_scan": tenergy.energy_mc_scan}


@pytest.fixture(scope="module")
def setup():
    tp = tevae.load_npz(MODEL, "cpu")
    tdec, jdec = members(tp, M)
    return tdec, jdec, init_curves(T, B).copy()


@pytest.mark.parametrize("active", [False, True], ids=["all", "num_active"])
@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_mean_over_draws_matches_jax_expected_energy(setup, name, active):
    tdec, jdec, gamma = setup
    num_active = np.array([1, 2, 3, 4, 5, 5]) if active else None
    exp = np.asarray(jenergy.energy_expected(
        jdec, jnp.asarray(gamma),
        None if num_active is None else jnp.asarray(num_active)))
    gen = torch.Generator().manual_seed(100)
    g = torch.from_numpy(gamma)
    with torch.no_grad():
        draws = [ESTIMATORS[name](tdec, g, gen, 1, num_active).numpy()
                 for _ in range(60)]
    np.testing.assert_allclose(np.mean(draws, axis=0), exp, rtol=0.08)
    assert np.std(draws, axis=0)[-1] > 0          # it does draw
    if active:                                    # one decoder: no noise
        np.testing.assert_allclose(draws[0][0], exp[0], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_same_generator_seed_same_energy_and_gradient(setup, name):
    tdec, _, gamma = setup
    outs = []
    for seed in (4, 4, 5):
        g = torch.from_numpy(gamma).requires_grad_(True)
        e = ESTIMATORS[name](tdec, g, torch.Generator().manual_seed(seed))
        (dg,) = torch.autograd.grad(e.sum(), g)
        assert torch.isfinite(dg).all() and dg.abs().max() > 0
        outs.append((e.detach(), dg))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][0], outs[2][0])


def test_scan_streams_in_chunks_with_the_same_gradient(setup):
    """With one decoder every draw is decoder 0, so the chunked estimator
    (48 = 4 chunks of 12, rematerialized in the backward) must give the
    energy and gradient of the unchunked one."""
    tdec, _, gamma = setup
    one = {"layers": [{"w": l["w"][:1], "b": l["b"][:1]}
                      for l in tdec["layers"]]}
    outs = []
    for fn, kw in ((tenergy.energy_mc, {}),
                   (tenergy.energy_mc_scan, {"chunk": 12})):
        g = torch.from_numpy(gamma).requires_grad_(True)
        e = fn(one, g, torch.Generator().manual_seed(0), **kw)
        (dg,) = torch.autograd.grad((torch.linspace(0.5, 2.0, B) * e).sum(), g)
        outs.append((e.detach().numpy(), dg.numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-4,
                               atol=1e-5 * np.abs(outs[0][1]).max())


def test_scan_falls_back_when_no_chunk_divides_T(setup):
    """T = 127, a prime above the chunk: the largest divisor <= chunk is 1,
    and ``energy_mc_scan`` is ``energy_mc`` on the same generator (as the
    JAX package's, geometry/energy.py:124-128)."""
    tdec, _, _ = setup
    g = torch.from_numpy(init_curves(127, 3).copy())
    a = tenergy.energy_mc_scan(tdec, g, torch.Generator().manual_seed(9))
    b = tenergy.energy_mc(tdec, g, torch.Generator().manual_seed(9))
    assert torch.equal(a, b)
