"""``ops/energy_mc_fused`` (plain versions of K5-K8) vs the JAX package's
Pallas MC kernels, run in interpret mode on the CPU, on IDENTICAL index
planes made with numpy.

Inputs: the seed-42 production decoders (first M of 10) and seed-42 init
curves at T=64, B=8, S=2.  Tolerances are those the expected-energy kernels
are held to (tests/test_torch_energy_fused.py, test_torch_energy_grad.py):
energies rtol 1e-5; dgamma against ``jax.grad`` at rtol 1e-3, atol 1e-4 *
max|dgamma| at float32, and on the median (1e-4) and 99th percentile (1e-3)
of the error relative to max|dgamma| at the reduced rungs, where a one-ulp
difference can flip a bf16 rounding or a ReLU branch at single elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
from vae_latent_geometry_tpu_torch.geometry import energy as tenergy
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as tmc

from torch_parity_inputs import MODEL, init_curves, members

T, B, S = 64, 8, 2


@pytest.fixture(scope="module")
def setup():
    tp = tevae.load_npz(MODEL, "cpu")
    return tp, init_curves(T, B).copy()


def _planes(M, active, seed=0):
    """(d1, d2) int32 (S, T-1, B), U[0, k_b): k_b = M, or mixed per-spline
    counts in [1, M] when ``active``."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, M + 1, size=B) if active else np.full(B, M)
    d = rng.integers(0, k[None, None, :], size=(2 * S, T - 1, B))
    return d[:S].astype(np.int32), d[S:].astype(np.int32)


@pytest.mark.parametrize("active", [False, True], ids=["all", "num_active"])
@pytest.mark.parametrize("M", [5, 1])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_energy_matches_jax_kernel(setup, precision, M, active):
    tp, gamma = setup
    tdec, jdec = members(tp, M)
    d1, d2 = _planes(M, active)
    ref = np.asarray(jmc.energy_mc_fused(jdec, jnp.asarray(gamma),
                                         jnp.asarray(d1), jnp.asarray(d2),
                                         precision))
    out = tmc.energy_mc_fused(tdec, torch.from_numpy(gamma),
                              torch.from_numpy(d1), torch.from_numpy(d2),
                              precision).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def _grads(tdec, jdec, gamma, d1, d2, precision, ct):
    jd1, jd2 = jnp.asarray(d1), jnp.asarray(d2)

    def jloss(g):
        return jnp.sum(jnp.asarray(ct) * jmc.energy_mc_fused(
            jdec, g, jd1, jd2, precision))

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(gamma)))
    g = torch.from_numpy(gamma).requires_grad_(True)
    e = tmc.energy_mc_fused(tdec, g, torch.from_numpy(d1),
                            torch.from_numpy(d2), precision)
    (out,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
    return out.numpy(), ref


def _assert_dgamma(out, ref, precision):
    scale = np.abs(ref).max()
    if precision == "float32":
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4 * scale)
    else:
        err = np.abs(out - ref) / scale
        assert np.median(err) < 1e-4, np.median(err)
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)


@pytest.mark.parametrize("M", [5, 1])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_dgamma_matches_jax_kernel(setup, precision, M):
    """Non-uniform per-spline cotangent, mixed per-spline decoder counts."""
    tp, gamma = setup
    tdec, jdec = members(tp, M)
    d1, d2 = _planes(M, True, seed=1)
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)
    out, ref = _grads(tdec, jdec, gamma, d1, d2, precision, ct)
    assert np.abs(ref).max() > 0
    _assert_dgamma(out, ref, precision)


@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_grad_only_variant_same_dgamma(setup, precision):
    tp, gamma = setup
    tdec, _ = members(tp, 5)
    d1, d2 = (torch.from_numpy(d) for d in _planes(5, False))
    g1 = torch.from_numpy(gamma).requires_grad_(True)
    g2 = torch.from_numpy(gamma).requires_grad_(True)
    e = tmc.energy_mc_fused(tdec, g1, d1, d2, precision)
    z = tmc.energy_mc_fused_grad(tdec, g2, d1, d2, precision)
    assert torch.count_nonzero(z) == 0 and torch.count_nonzero(e) == B
    (a,) = torch.autograd.grad(e.sum(), g1)
    (b,) = torch.autograd.grad(z.sum(), g2)
    assert torch.equal(a, b)


def test_from_indices_matches_direct_and_fused(setup):
    """The unfused estimator on given planes vs a direct numpy evaluation
    (as tests/test_energy_mc_pallas.py:34-45, rtol 1e-4) and vs the fused
    plain version (rtol 1e-5)."""
    tp, gamma = setup
    tdec, jdec = members(tp, 5)
    d1, d2 = _planes(5, True, seed=2)
    decoded = np.asarray(tevae.decode_all(tdec, torch.from_numpy(gamma)))
    ref = np.zeros(B)
    for s in range(S):
        for t in range(T - 1):
            for b in range(B):
                x1 = decoded[d1[s, t, b], t, b].astype(np.float64)
                x2 = decoded[d2[s, t, b], t + 1, b].astype(np.float64)
                ref[b] += np.sum((x2 - x1) ** 2)
    ref /= S
    out = tenergy.energy_mc_from_indices(
        tdec, torch.from_numpy(gamma), torch.from_numpy(d1),
        torch.from_numpy(d2)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4)
    fused = tmc.energy_mc_fused(tdec, torch.from_numpy(gamma),
                                torch.from_numpy(d1),
                                torch.from_numpy(d2)).numpy()
    np.testing.assert_allclose(fused, out, rtol=1e-5)


def test_from_indices_gradient_matches_fused(setup):
    """Autograd through the unfused estimator vs the fused backward's plain
    version, same planes, float32."""
    tp, gamma = setup
    tdec, _ = members(tp, 5)
    d1, d2 = (torch.from_numpy(d) for d in _planes(5, False, seed=3))
    ct = torch.linspace(0.5, 2.0, B)
    g1 = torch.from_numpy(gamma).requires_grad_(True)
    g2 = torch.from_numpy(gamma).requires_grad_(True)
    (a,) = torch.autograd.grad(
        (ct * tenergy.energy_mc_from_indices(tdec, g1, d1, d2)).sum(), g1)
    (b,) = torch.autograd.grad(
        (ct * tmc.energy_mc_fused(tdec, g2, d1, d2)).sum(), g2)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-3,
                               atol=1e-4 * float(a.abs().max()))


def test_rng_kernels_match_jax_on_zero_draws(setup):
    """Off the TPU the JAX in-kernel PRNG yields zero bits, so every draw of
    ``energy_mc_fused_rng`` selects decoder 0; the port's plain version on
    all-zero planes must give the same energy and dgamma."""
    tp, gamma = setup
    tdec, jdec = members(tp, 5)
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)
    kmax = jnp.full((1, B), 5.0)
    seed = jnp.asarray([7], jnp.int32)
    jg = jnp.asarray(gamma)
    ref_e = np.asarray(jmc.energy_mc_fused_rng(jdec, jg, seed, kmax, S,
                                               "float32"))
    ref_g = np.asarray(jax.grad(lambda g: jnp.sum(
        jnp.asarray(ct) * jmc.energy_mc_fused_rng(jdec, g, seed, kmax, S,
                                                  "float32")))(jg))
    zeros = torch.zeros((S, T - 1, B), dtype=torch.int32)
    g = torch.from_numpy(gamma).requires_grad_(True)
    e = tmc.energy_mc_fused(tdec, g, zeros, zeros, "float32")
    (dg,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
    np.testing.assert_allclose(e.detach().numpy(), ref_e, rtol=1e-5)
    np.testing.assert_allclose(dg.numpy(), ref_g, rtol=1e-3,
                               atol=1e-4 * np.abs(ref_g).max())
    # and both are the single-decoder-0 energy
    dec0 = jax.tree_util.tree_map(lambda x: x[0], jdec)
    np.testing.assert_allclose(
        ref_e, np.asarray(jenergy.energy_single(dec0, jg)), rtol=1e-5)


@pytest.mark.parametrize("precision", ["float32", "f32x2"])
def test_rng_entry_points_are_the_fused_ones_on_philox_planes(setup,
                                                              precision):
    """K7 = K5 and K8 = K6 on the planes of ``philox_draws``: exact, with
    mixed per-spline counts; the gradient-only variant gives zeros and the
    same dgamma."""
    tp, gamma = setup
    tdec, _ = members(tp, 5)
    kmax = torch.tensor([5, 1, 3, 5, 2, 4, 5, 1])
    seed = (1 << 40) + 17
    d1, d2 = tmc.philox_draws(seed, S, T, B, kmax)
    ct = torch.linspace(0.5, 2.0, B)
    outs = []
    for fn, args in ((tmc.energy_mc_fused_rng, (seed, kmax, S, precision)),
                     (tmc.energy_mc_fused_rng_grad, (seed, kmax, S,
                                                     precision)),
                     (tmc.energy_mc_fused, (d1, d2, precision))):
        g = torch.from_numpy(gamma).requires_grad_(True)
        e = fn(tdec, g, *args)
        (dg,) = torch.autograd.grad((ct * e).sum(), g)
        outs.append((e.detach(), dg))
    assert torch.equal(outs[0][0], outs[2][0])
    assert torch.count_nonzero(outs[1][0]) == 0
    assert torch.equal(outs[0][1], outs[2][1])
    assert torch.equal(outs[1][1], outs[2][1])


def test_wrapper_checks_raise(setup):
    """The CUDA wrappers' checks (pure Python, exercised here on CPU
    tensors): planes and counts of the wrong shape or type raise."""
    tp, gamma = setup
    g = torch.from_numpy(gamma)
    ok = torch.zeros((S, T - 1, B), dtype=torch.int32)
    assert tmc._check_planes(ok, ok, g) == S
    with pytest.raises(ValueError, match="int32"):
        tmc._check_planes(ok.long(), ok.long(), g)
    with pytest.raises(ValueError, match=r"\(S, T-1, B\)"):
        tmc._check_planes(ok[:, :-1].contiguous(), ok[:, :-1].contiguous(), g)
    with pytest.raises(ValueError, match="kmax"):
        tmc._check_kmax(torch.ones(B + 1), g, S)
    with pytest.raises(ValueError, match="mc_samples"):
        tmc._check_kmax(torch.ones(B), g, 0)
    with pytest.raises(ValueError, match="precision"):
        tmc.energy_mc_fused(members(tp, 2)[0], g, ok, ok, "fp8")
    with pytest.raises(ValueError, match="no kernel for device"):
        tmc._launch("energy_mc_fwd", False, [], [], g, "float32", S, ok, ok,
                    None, 0, None)


@pytest.mark.parametrize("case", ["index_high", "index_negative", "kmax_high",
                                  "kmax_zero", "num_active_high"])
def test_draws_out_of_range_raise(setup, case):
    """A decoder index outside [0, M) or an active count outside [1, M]
    would select no decoder and silently zero that endpoint: the entry
    points raise instead, forward and gradient-only alike."""
    from vae_latent_geometry_tpu_torch.optim.geodesic import _energy_fn

    tp, gamma = setup
    M = 3
    tdec = members(tp, M)[0]
    g = torch.from_numpy(gamma).requires_grad_(True)
    planes = torch.zeros((S, T - 1, B), dtype=torch.int32)
    if case.startswith("index"):
        bad = planes.clone()
        bad[1, 3, 2] = M if case == "index_high" else -1
        with pytest.raises(ValueError, match="decoder indices"):
            tmc.energy_mc_fused(tdec, g, planes, bad)
        with pytest.raises(ValueError, match="decoder indices"):
            tmc.energy_mc_fused_grad(tdec, g, bad, planes)
    elif case.startswith("kmax"):
        kmax = torch.full((B,), float(M))
        kmax[1] = M + 1 if case == "kmax_high" else 0
        with pytest.raises(ValueError, match="kmax"):
            tmc.energy_mc_fused_rng(tdec, g, 3, kmax, S)
        with pytest.raises(ValueError, match="kmax"):
            tmc.energy_mc_fused_rng_grad(tdec, g, 3, kmax.numpy(), S)
        with pytest.raises(ValueError, match="kmax"):
            tmc.energy_mc_fused_rng(tdec, g, 3, kmax[1].item(), S)
    else:
        num_active = np.full(B, M + 2)
        with pytest.raises(ValueError, match="kmax"):
            _energy_fn("mc_fused", tdec, g, 1, S, num_active, "float32", True)
        with pytest.raises(ValueError, match="num_active"):
            _energy_fn("mc_fused", tdec, g, 1, S, num_active, "float32",
                       False)
        with pytest.raises(ValueError, match="num_active"):
            _energy_fn("mc", tdec, g, 1, S, np.zeros(B, np.int64))


def test_one_count_for_all_splines(setup):
    """``kmax`` as one number is that count for every spline."""
    tp, gamma = setup
    tdec = members(tp, 3)[0]
    g = torch.from_numpy(gamma)
    e = tmc.energy_mc_fused_rng(tdec, g, 9, 2, S)
    assert torch.equal(e, tmc.energy_mc_fused_rng(
        tdec, g, 9, torch.full((B,), 2.0), S))
    assert torch.equal(e, tmc.energy_mc_fused_rng(tdec, g, 9, np.array([2]),
                                                  S))
