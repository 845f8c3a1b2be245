"""``ops/energy_fused`` gradients (plain version of K2 through the
autograd Function) vs ``jax.grad`` through the JAX package's Pallas
kernels, run in interpret mode on the CPU.

Inputs: the seed-42 production decoders (first M of 10) and seed-42 init
curves at T=64, B=8.  Energies at the JAX suite's rtol 1e-5
(tests/test_energy_pallas.py:36); dgamma against ``jax.grad`` through the
same function at rtol 1e-3, atol 1e-4 * max|dgamma| (:45).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

from torch_parity_inputs import MODEL, init_curves, members, weight_planes

T, B = 64, 8


@pytest.fixture(scope="module")
def setup():
    tp = tevae.load_npz(MODEL, "cpu")
    num_active = np.random.default_rng(3).integers(1, 11, size=B)
    return tp, init_curves(T, B), num_active


def _weights(num_active, M):
    return weight_planes(num_active, M, B)


def _grads(tdec, jdec, gamma, tw, jw, precision, ct):
    def jloss(g):
        return jnp.sum(jnp.asarray(ct) * jep.energy_expected_fused(
            jdec, g, jw, precision))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(gamma)))
    g = torch.from_numpy(gamma).requires_grad_(True)
    e = ef.energy_expected_fused(tdec, g, tw, precision)
    (out,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
    return out.numpy(), ref


@pytest.mark.parametrize("M", [1, 3, 10])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_dgamma_matches_jax_kernel(setup, precision, M):
    """At float32 every element within rtol 1e-3 / atol 1e-4*max.  The
    reduced rungs round activations to bf16, so a one-ulp fp32 difference
    from another summation order can flip a bf16 rounding or a ReLU branch
    at an isolated element: they are judged on the median and the 99th
    percentile of the error relative to max|dgamma| instead of the max."""
    tp, gamma, num_active = setup
    tdec, jdec = members(tp, M)
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)
    out, ref = _grads(tdec, jdec, gamma, None, None, precision, ct)
    scale = np.abs(ref).max()
    if precision == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4 * scale)
    else:
        err = np.abs(out - ref) / scale
        assert np.median(err) < 1e-4, np.median(err)
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)


@pytest.mark.parametrize("precision", ["float32", "f32x2"])
def test_dgamma_active_weights_match_jax_kernel(setup, precision):
    tp, gamma, num_active = setup
    tdec, jdec = members(tp, 10)
    tw, jw = _weights(num_active, 10)
    ct = np.ones(B, np.float32)
    out, ref = _grads(tdec, jdec, gamma, tw, jw, precision, ct)
    err = np.abs(out - ref) / np.abs(ref).max()
    if precision == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-3,
                                   atol=1e-4 * np.abs(ref).max())
    else:
        assert np.median(err) < 1e-4 and np.quantile(err, 0.99) < 1e-3


@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_grad_only_variant_same_dgamma(setup, precision):
    tp, gamma, _ = setup
    tdec, _ = members(tp, 10)
    g1 = torch.from_numpy(gamma).requires_grad_(True)
    g2 = torch.from_numpy(gamma).requires_grad_(True)
    e = ef.energy_expected_fused(tdec, g1, None, precision)
    z = ef.energy_expected_fused_grad(tdec, g2, None, precision)
    assert torch.count_nonzero(z) == 0
    (d1,) = torch.autograd.grad(e.sum(), g1)
    (d2,) = torch.autograd.grad(z.sum(), g2)
    assert torch.equal(d1, d2)
