"""Decoder draws of the PyTorch port's MC modes: the counter-based
generator behind the in-kernel draws (``philox_draws``), the external index
planes (``sample_decoder_indices``) and the seed stream of the optimizer
(``fold_seed``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as tmc
from vae_latent_geometry_tpu_torch.optim.geodesic import fold_seed, root_seed

from torch_parity_inputs import MODEL, init_curves, members

# Known-answer vectors of Philox4x32-10 (Random123, kat_vectors):
# counter, key -> output.
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_known_answers(counter, key, expected):
    ctr = [torch.tensor([c], dtype=torch.int64) for c in counter]
    out = tmc.philox4x32_10(key, ctr)
    assert tuple(int(c) for c in out) == expected


def _chi2(counts):
    exp = counts.sum() / len(counts)
    return float(((counts - exp) ** 2 / exp).sum())


def test_philox_draws_shape_range_and_counter_layout():
    S, T, B = 3, 40, 6
    kmax = torch.tensor([1, 2, 10, 10, 3, 7])
    d1, d2 = tmc.philox_draws(99, S, T, B, kmax)
    for d in (d1, d2):
        assert d.shape == (S, T - 1, B) and d.dtype == torch.int32
        assert int(d.min()) >= 0
        assert bool((d < kmax[None, None, :]).all())
    assert int(d1[:, :, 0].max()) == 0      # one active decoder: always 0
    # plane j at (t, b) is word j % 4 of counter (t, b, j // 4, 0)
    planes = torch.cat([d1, d2])
    t, b = 17, 3
    for j in (0, 3, 4, 5):
        ctr = [torch.tensor([v], dtype=torch.int64)
               for v in (t, b, j // 4, 0)]
        bits = int(tmc.philox4x32_10((99, 0), ctr)[j % 4])
        u = np.float32(bits >> 8) * np.float32(2.0 ** -24)
        assert int(planes[j, t, b]) == int(np.floor(u * np.float32(10)))


def test_philox_draws_uniform_and_independent():
    """Chi-square of 2 * 2 * 1999 * 50 = 399,800 draws over 10 decoders
    (9 degrees of freedom: 27.9 is the 99.9th percentile) and of the joint
    (d1, d2) table (99 degrees: 148.2)."""
    S, T, B, k = 2, 2000, 50, 10
    d1, d2 = tmc.philox_draws(12345, S, T, B, torch.full((B,), k))
    both = torch.cat([d1, d2]).flatten().numpy()
    assert _chi2(np.bincount(both, minlength=k).astype(float)) < 27.9
    joint = (d1.flatten() * k + d2.flatten()).numpy()
    assert _chi2(np.bincount(joint, minlength=k * k).astype(float)) < 148.2
    # neighbouring segments and the two samples are independent too
    lag = (d1[0, :-1].flatten() * k + d1[0, 1:].flatten()).numpy()
    assert _chi2(np.bincount(lag, minlength=k * k).astype(float)) < 148.2
    pair = (d1[0].flatten() * k + d1[1].flatten()).numpy()
    assert _chi2(np.bincount(pair, minlength=k * k).astype(float)) < 148.2


def test_philox_draws_depend_on_the_seed_alone():
    kmax = torch.full((5,), 10)
    a = tmc.philox_draws(7, 2, 30, 5, kmax)
    b = tmc.philox_draws(7, 2, 30, 5, kmax)
    c = tmc.philox_draws(8, 2, 30, 5, kmax)
    hi = tmc.philox_draws(7 + (1 << 32), 2, 30, 5, kmax)   # upper key word
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert not torch.equal(a[0], hi[0])
    # a draw depends on its coordinates, not on the plane's extent
    wide = tmc.philox_draws(7, 2, 50, 9, torch.full((9,), 10))
    assert torch.equal(wide[0][:, :29, :5], a[0])


def test_sample_decoder_indices_shape_bounds_uniformity():
    gen = torch.Generator().manual_seed(3)
    num_active = np.array([1, 2, 4, 10])
    d1, d2 = tmc.sample_decoder_indices(gen, 2000, 4, 10, mc_samples=2,
                                        num_active=num_active)
    for d in (d1, d2):
        assert d.shape == (2, 1999, 4) and d.dtype == torch.int32
        assert int(d.min()) >= 0
        assert bool((d < torch.from_numpy(num_active)[None, None, :]).all())
    assert int(d1[:, :, 0].max()) == 0 and int(d1[:, :, 1].max()) == 1
    counts = np.bincount(torch.cat([d1, d2])[:, :, 3].flatten().numpy(),
                         minlength=10).astype(float)
    assert _chi2(counts) < 27.9
    assert not torch.equal(d1, d2)
    # the same generator seed gives the same planes
    again = tmc.sample_decoder_indices(torch.Generator().manual_seed(3), 2000,
                                       4, 10, 2, num_active)
    assert torch.equal(again[0], d1) and torch.equal(again[1], d2)
    full = tmc.sample_decoder_indices(gen, 50, 4, 10)
    assert int(full[0].max()) == 9


def test_num_active_one_is_the_single_decoder_energy():
    """A spline with one active decoder only ever draws decoder 0, so its
    sampled energy is ``energy_single`` of decoder 0 (the JAX package's, as
    tests/test_energy_mc_pallas.py:100-117, rtol 1e-4), through both draw
    sources."""
    T, B = 48, 3
    tp = tevae.load_npz(MODEL, "cpu")
    tdec, jdec = members(tp, 4)
    gamma = init_curves(T, B).copy()
    dec0 = jax.tree_util.tree_map(lambda x: x[0], jdec)
    e0 = np.asarray(jenergy.energy_single(dec0, jnp.asarray(gamma)))[0]
    num_active = np.array([1, 2, 4])
    d1, d2 = tmc.sample_decoder_indices(torch.Generator().manual_seed(0), T,
                                        B, 4, num_active=num_active)
    e = tmc.energy_mc_fused(tdec, torch.from_numpy(gamma), d1, d2).numpy()
    np.testing.assert_allclose(e[0], e0, rtol=1e-4)
    e = tmc.energy_mc_fused_rng(tdec, torch.from_numpy(gamma), 5,
                                torch.from_numpy(num_active)).numpy()
    np.testing.assert_allclose(e[0], e0, rtol=1e-4)


@pytest.mark.parametrize("source", ["philox", "folded", "planes"])
def test_mean_over_seeds_is_unbiased_and_seeds_are_independent(source):
    """The sampled energy's mean over 64 seeds against the closed-form
    expected energy, as z-scores per spline, for 16 groups of seeds x 80
    splines = 1280 scores: an unbiased estimator on independent draws gives
    Student-t scores (63 degrees): mean 0 +- 0.028, spread 1.016 +- 0.02.
    ``philox``: consecutive raw seeds, a counter-based generator's worst
    case; ``folded``: the seeds the optimizer uses (``fold_seed`` of a phase
    seed and the step); ``torch.randint`` planes are the yardstick."""
    T, B, S, M, n, groups = 50, 80, 2, 10, 64, 16
    tp = tevae.load_npz(MODEL, "cpu")
    tdec, _ = members(tp, M)
    g = torch.from_numpy(init_curves(T, B).copy())
    with torch.no_grad():
        x = tevae.decode_all(tdec, g).double()           # (M, T, B, X)
        xbar = x.mean(0)
        var = ((x - xbar) ** 2).sum(-1).mean(0)
        expected = (((xbar[1:] - xbar[:-1]) ** 2).sum(-1)
                    + var[1:] + var[:-1]).sum(0)
    lo = x[:, :-1].permute(1, 2, 0, 3)[None]
    hi = x[:, 1:].permute(1, 2, 0, 3)[None]
    kmax = torch.full((B,), float(M))
    gen = torch.Generator().manual_seed(0)
    seeds = (range(n * groups) if source != "folded" else
             [fold_seed(fold_seed(0, 1 + grp), step)
              for grp in range(groups) for step in range(n)])
    draws = []
    for seed in seeds:
        d1, d2 = (tmc.sample_decoder_indices(gen, T, B, M, S)
                  if source == "planes"
                  else tmc.philox_draws(seed, S, T, B, kmax))
        x1 = torch.take_along_dim(lo, d1.long()[..., None, None], 3)
        x2 = torch.take_along_dim(hi, d2.long()[..., None, None], 3)
        draws.append(((x2 - x1) ** 2).sum((1, 3, 4)).mean(0))
    d = torch.stack(draws).reshape(groups, n, B)
    z = (d.mean(1) - expected) / (d.std(1) / n ** 0.5)
    assert abs(float(z.mean())) < 0.12, float(z.mean())
    assert 0.94 < float(z.std()) < 1.10, float(z.std())
    assert float(z.abs().max()) < 5.0, float(z.abs().max())


def test_seed_stream():
    """``fold_seed`` gives distinct 63-bit seeds (what ``manual_seed``
    takes); ``root_seed`` reads a generator without advancing it."""
    seeds = {fold_seed(r, d) for r in (0, 1, 2**40) for d in range(200)}
    assert len(seeds) == 600
    assert all(0 <= s < 2**63 for s in seeds)
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state().clone()
    assert root_seed(gen) == 11 and root_seed(None) == 0
    assert torch.equal(gen.get_state(), state)
