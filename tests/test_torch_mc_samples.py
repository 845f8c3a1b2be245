"""The MC backward at any number of samples S: the port's plain K6/K8
(``ops/energy_mc_fused``) against the JAX package's Pallas MC kernels, run
in interpret mode on the CPU, on IDENTICAL index planes made with numpy, at
S in {1, 3, 9, 12} (the port's kernels once refused S > 8 on the card).

Inputs as tests/test_torch_mc_fused.py: the seed-42 production decoders
(first 5 of 10) and init curves at T=64, B=8, where the JAX package's fused
kernels hold their working set up to S=16 (``fused_fits``); the tolerances
are that file's: energies rtol 1e-5; dgamma at float32 rtol 1e-3, atol 1e-4
* max|dgamma|, at the reduced rungs median 1e-4 and 99th percentile 1e-3 of
the error relative to max|dgamma|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
from vae_latent_geometry_tpu.ops.energy_pallas import fused_fits
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as tmc

from torch_parity_inputs import MODEL, init_curves, members

T, B, M = 64, 8, 5
SAMPLES = (1, 3, 9, 12)


@pytest.fixture(scope="module")
def setup():
    tp = tevae.load_npz(MODEL, "cpu")
    return tp, init_curves(T, B).copy()


def _planes(S, seed):
    """(d1, d2) int32 (S, T-1, B), U[0, k_b) with mixed per-spline counts
    k_b in [1, M]."""
    rng = np.random.default_rng([S, seed])
    k = rng.integers(1, M + 1, size=B)
    d = rng.integers(0, k[None, None, :], size=(2 * S, T - 1, B))
    return d[:S].astype(np.int32), d[S:].astype(np.int32)


def _assert_dgamma(out, ref, precision):
    scale = np.abs(ref).max()
    assert scale > 0
    if precision == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4 * scale)
    else:
        err = np.abs(out - ref) / scale
        assert np.median(err) < 1e-4, np.median(err)
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)


def _jax_energy_and_grad(jdec, gamma, d1, d2, ct, precision):
    jd1, jd2 = jnp.asarray(d1), jnp.asarray(d2)

    def loss(g):
        return jnp.sum(jnp.asarray(ct) * jmc.energy_mc_fused(
            jdec, g, jd1, jd2, precision))

    jg = jnp.asarray(gamma)
    e = np.asarray(jmc.energy_mc_fused(jdec, jg, jd1, jd2, precision))
    return e, np.asarray(jax.grad(loss)(jg))


def _port_energy_and_grad(tdec, gamma, d1, d2, ct, precision):
    g = torch.from_numpy(gamma).requires_grad_(True)
    e = tmc.energy_mc_fused(tdec, g, torch.from_numpy(d1),
                            torch.from_numpy(d2), precision)
    (dg,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
    return e.detach().numpy(), dg.numpy()


def test_jax_kernels_hold_these_sample_counts():
    """The comparison below runs the JAX package's fused kernels, not its
    plain fallback: their working set fits at every S tested."""
    assert all(fused_fits(T, B, 2, 50, M, mc=True, mc_samples=S)
               for S in SAMPLES + (16,))


@pytest.mark.parametrize("precision", ["float32", "f32x3", "bfloat16"])
@pytest.mark.parametrize("S", SAMPLES)
def test_energy_and_dgamma_match_jax_kernels(setup, S, precision):
    """K5 and K6's plain versions through ``energy_mc_fused`` and its
    gradient, non-uniform per-spline cotangent."""
    tp, gamma = setup
    tdec, jdec = members(tp, M)
    d1, d2 = _planes(S, 0)
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)
    e_ref, g_ref = _jax_energy_and_grad(jdec, gamma, d1, d2, ct, precision)
    e, g = _port_energy_and_grad(tdec, gamma, d1, d2, ct, precision)
    np.testing.assert_allclose(e, e_ref, rtol=1e-5)
    _assert_dgamma(g, g_ref, precision)


@pytest.mark.parametrize("precision", ["float32", "f32x3", "bfloat16"])
def test_rng_backward_at_twelve_samples_matches_jax_kernels(setup,
                                                            precision):
    """K8's plain version at S=12 (``energy_mc_fused_rng``'s gradient) is
    K6 on the planes of ``philox_draws``, so it matches the JAX package's
    K6 kernel fed those planes."""
    tp, gamma = setup
    tdec, jdec = members(tp, M)
    S, seed = 12, (1 << 40) + 12
    kmax = torch.tensor([5, 1, 3, 5, 2, 4, 5, 1])
    d1, d2 = (d.numpy() for d in tmc.philox_draws(seed, S, T, B, kmax))
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)
    _, g_ref = _jax_energy_and_grad(jdec, gamma, d1, d2, ct, precision)
    g = torch.from_numpy(gamma).requires_grad_(True)
    e = tmc.energy_mc_fused_rng_grad(tdec, g, seed, kmax, S, precision)
    (dg,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
    _assert_dgamma(dg.numpy(), g_ref, precision)


def test_philox_draws_follow_the_draw_rule_at_twelve_samples():
    """At S=12 the 24 planes take six Philox counters: plane j at (t, b) is
    output word j % 4 of counter (t, b, j // 4, 0), mapped to
    floor(((bits >> 8) * 2^-24) * kmax_b) in float32; d1 planes first."""
    S, T_, B_ = 12, 9, 5
    seed = (1 << 33) + 5
    kmax = torch.tensor([1, 2, 3, 7, 10])
    d1, d2 = tmc.philox_draws(seed, S, T_, B_, kmax)
    assert d1.shape == d2.shape == (S, T_ - 1, B_)
    planes = torch.cat([d1, d2]).numpy()
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for t in range(T_ - 1):
        for b in range(B_):
            for group in range(2 * S // 4):
                ctr = [torch.tensor([v], dtype=torch.int64)
                       for v in (t, b, group, 0)]
                words = tmc.philox4x32_10(key, ctr)
                for w in range(4):
                    j = 4 * group + w
                    u = np.float32(int(words[w]) >> 8) * np.float32(2.0 ** -24)
                    want = min(int(np.floor(u * np.float32(int(kmax[b])))),
                               int(kmax[b]) - 1)
                    assert planes[j, t, b] == want, (j, t, b)
    assert int(planes[:, :, 0].max()) == 0
