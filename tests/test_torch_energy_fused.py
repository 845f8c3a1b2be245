"""``ops/energy_fused`` (plain versions of K1 and K2) vs the JAX package's
Pallas kernels, run in interpret mode on the CPU.

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

from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu_torch.geometry import energy as tenergy
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


@pytest.mark.parametrize("weighted", [False, True], ids=["uniform", "active"])
@pytest.mark.parametrize("M", [1, 3, 10])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_energy_matches_jax_kernel(setup, precision, M, weighted):
    tp, gamma, num_active = setup
    tdec, jdec = members(tp, M)
    tw, jw = _weights(num_active if weighted else None, M)
    ref = np.asarray(jep.energy_expected_fused(jdec, jnp.asarray(gamma), jw,
                                               precision))
    out = ef.energy_expected_fused(tdec, torch.from_numpy(gamma), tw,
                                   precision).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_plain_oracle_matches_unfused_energy(setup):
    tp, gamma, num_active = setup
    tdec, jdec = members(tp, 10)
    ref = np.asarray(jenergy.energy_expected(jdec, jnp.asarray(gamma),
                                             jnp.asarray(num_active)))
    out = tenergy.energy_expected(tdec, torch.from_numpy(gamma),
                                  torch.from_numpy(num_active)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    # and the fused oracle with the matching weight plane
    w = ef.active_weights(torch.from_numpy(num_active), 10, B)
    fused = ef.energy_expected_fused(tdec, torch.from_numpy(gamma), w).numpy()
    np.testing.assert_allclose(fused, ref, rtol=1e-5)


def test_single_energy_matches_jax(setup):
    tp, gamma, _ = setup
    tdec, jdec = members(tp, 1)
    one_t = {"layers": [{"w": l["w"][0], "b": l["b"][0]}
                        for l in tdec["layers"]]}
    one_j = jax.tree_util.tree_map(lambda x: x[0], jdec)
    ref = np.asarray(jenergy.energy_single(one_j, jnp.asarray(gamma)))
    out = tenergy.energy_single(one_t, torch.from_numpy(gamma)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    fused = ef.energy_expected_fused(tdec, torch.from_numpy(gamma)).numpy()
    np.testing.assert_allclose(fused, ref, rtol=1e-5)


def test_weight_planes_match_jax():
    k = np.array([1, 3, 10, 4, 7, 2, 9, 5])
    np.testing.assert_array_equal(
        ef.active_weights(torch.from_numpy(k), 10, 8).numpy(),
        np.asarray(jep.active_weights(jnp.asarray(k), 10, 8)))
    np.testing.assert_array_equal(ef.uniform_weights(10, 8).numpy(),
                                  np.asarray(jep.uniform_weights(10, 8)))


def test_unknown_precision_raises(setup):
    tp, gamma, _ = setup
    tdec, _ = members(tp, 3)
    with pytest.raises(ValueError, match="precision"):
        ef.energy_expected_fused(tdec, torch.from_numpy(gamma), None, "fp8")


def test_kernel_shape_checks_raise(setup):
    """The CUDA wrappers' checks (pure Python, exercised here on CPU
    tensors): unsupported widths and mismatched planes raise."""
    tp, gamma, _ = setup
    ws, bs = ef.stack_weights(members(tp, 3)[0])
    g = torch.from_numpy(gamma)
    wmb = ef.uniform_weights(3, B)
    assert ef._check_cuda(ws, bs, g, wmb) == (T, B, 2, 3, 50)
    with pytest.raises(ValueError, match="wmb"):
        ef._check_cuda(ws, bs, g, ef.uniform_weights(3, B + 1))
    with pytest.raises(ValueError, match="float32"):
        ef._check_cuda(ws, bs, g.double(), wmb)
    # the kernels take X up to 128 in one launch and wider outputs in column
    # slices, and any latent width
    assert ef._check_cuda([ws[0], ws[1], torch.zeros(3, 128, 80)],
                          [bs[0], bs[1], torch.zeros(3, 80)], g, wmb)[4] == 80
    assert ef._check_cuda([ws[0], ws[1], torch.zeros(3, 128, 129)],
                          [bs[0], bs[1], torch.zeros(3, 129)], g, wmb)[4] == 129
    ws5 = [torch.zeros(3, 5, ws[0].shape[2]), *ws[1:]]
    assert ef._check_cuda(ws5, bs, torch.zeros(T, B, 5), wmb)[2] == 5
    with pytest.raises(ValueError, match="D=5"):
        ef._check_cuda(ws, bs, torch.zeros(T, B, 5), wmb)
