"""The plain reference against the port's plain modes on the CPU at toy
sizes: the same streams and draws bit for bit, the same energies, curves
and optimization to float32 rounding, and the gradient of the kernels'
reduced rungs.  (The reference imports nothing
of the port; only this test holds the two side by side.)"""

import numpy as np
import pytest
import torch

from geobench import inputs, reference
from vae_latent_geometry_tpu_torch.geometry import energy as port_energy
from vae_latent_geometry_tpu_torch.geometry import spline as port_spline
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused
from vae_latent_geometry_tpu_torch.optim import geodesic as port_opt

CPU = torch.device("cpu")
MODEL = {"input_dim": 50, "latent_dim": 2, "decoder_hidden": [32, 32],
         "num_decoders": 4, "heteroscedastic": False}


def _layers(seed=5):
    return inputs.decoders(MODEL, seed, CPU)


def _port(layers):
    return {"layers": [{"w": w, "b": b} for w, b in layers]}


def _curves(T=48, P=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    basis = reference.nullspace_basis(4)
    a, b = torch.randn(P, 2, generator=g), torch.randn(P, 2, generator=g)
    omega = 0.3 * torch.randn(P, 5, 2, generator=g)
    return basis, a, b, omega


@pytest.mark.parametrize("seed,data", [(0, 0), (2**31 + 5, 7),
                                       (2**63 - 1, 2**40)])
def test_fold_seed_is_the_ports(seed, data):
    assert reference.fold_seed(seed, data) == port_opt.fold_seed(seed, data)


@pytest.mark.parametrize("S", [1, 2, 3])
def test_mc_draws_are_the_kernels(S):
    seed, T, B, M = reference.fold_seed(99, 3), 40, 6, 10
    d1, d2 = energy_mc_fused.philox_draws(seed, S, T, B, torch.tensor(M))
    seeds = torch.full((1, B), seed, dtype=torch.int64)
    r1, r2 = reference.mc_draws(seeds, torch.arange(B), T, S, M)
    assert torch.equal(r1[0], d1.long()) and torch.equal(r2[0], d2.long())


def test_grid_and_design():
    T = 2000
    t = reference.t_grid(T)
    assert torch.equal(t.float(), port_spline.t_grid(T))
    basis = reference.nullspace_basis(4)
    ours = reference.design(t, basis)
    theirs = port_spline.design_matrix(port_spline.t_grid(T),
                                       basis.astype(np.float32))
    assert torch.allclose(ours.float(), theirs, atol=1e-6)
    # the same subspace as the port's basis
    pb = nullspace_basis(4)[0].astype(np.float64)
    assert np.allclose(basis @ basis.T, pb @ pb.T, atol=1e-6)


def test_energies_and_lengths():
    layers = _layers()
    basis, a, b, omega = _curves()
    t = reference.t_grid(48)
    g64 = reference.curve(omega.double(), a.double(), b.double(),
                          reference.design(t, basis), t)
    g32 = g64.float()
    ref = reference.expected_energy(layers, g64, "float64")
    port = port_energy.energy_expected(_port(layers), g32)
    assert torch.allclose(port.double(), ref, rtol=2e-5)
    one = [(w[:1], bb[:1]) for w, bb in layers]
    dec0 = {"layers": [{"w": w[0], "b": bb[0]} for w, bb in layers]}
    assert torch.allclose(port_energy.geodesic_lengths(dec0, g32).double(),
                          reference.arc_length(one, g64, "float64"),
                          rtol=2e-5)
    assert torch.allclose(port_energy.energy_single(dec0, g32).double(),
                          reference.expected_energy(one, g64, "float64"),
                          rtol=2e-5)
    seed = 1234567
    port_mc = energy_mc_fused.energy_mc_fused_rng(
        _port(layers), g32, seed, 4, 2, "float32")
    d1, d2 = reference.mc_draws(torch.full((1, 3), seed), torch.arange(3),
                                48, 2, 4)
    ref_mc = reference.mc_energy(layers, g64, d1[0], d2[0], "float64")
    assert torch.allclose(port_mc.double(), ref_mc, rtol=2e-5)


@pytest.mark.parametrize("mode", ["expected", "single", "mc_fused"])
def test_optimization(mode):
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)

    layers = _layers()
    basis, a, b, omega = _curves(T=40, P=3)
    cfg = GeodesicConfig(steps=6, lr=0.01, energy=EnergyConfig(
        num_t=40, mode=mode, kernel_precision="float32", mc_samples=2))
    dec = (_port(layers) if mode != "single" else
           {"layers": [{"w": w[0], "b": bb[0]} for w, bb in layers]})
    gen = torch.Generator().manual_seed(77)
    res = port_opt.optimize_splines(dec, omega, a, b, basis.astype(np.float32),
                                    cfg, device="cpu", generator=gen)
    draws = None
    if mode == "mc_fused":
        phase = reference.fold_seed(77, 1)
        seeds = torch.tensor([[reference.fold_seed(phase, i)] * 3
                              for i in range(6)])

        def draws(i):
            d1, d2 = reference.mc_draws(seeds[i:i + 1], torch.arange(3), 40,
                                        2, 4)
            return d1[0], d2[0]
    energy = {"expected": "expected", "single": "single",
              "mc_fused": "mc"}[mode]
    om = reference.optimize(layers, omega.double(), a.double(), b.double(),
                            basis, 40, 6, 0.01, energy, draws)
    assert torch.allclose(res.omega.double(), om, atol=2e-5)


def _first_gradients(layers, mode, T=64, P=4, seed=3):
    """The port's first-step gradient at each rung, and the reference's at
    float64 and at the f32x2 rung; mode "expected_fused" or "mc_fused"."""
    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)

    basis, a, b, omega = _curves(T=T, P=P, seed=seed)
    dec = _port(layers)
    step_seed = 2**40 + 17
    draws = None
    if mode == "mc_fused":
        d1, d2 = reference.mc_draws(torch.full((1, P), step_seed),
                                    torch.arange(P), T, 2, 4)
        draws = (d1[0], d2[0])
    port = {}
    for rung in ("float32", "f32x2", "bfloat16"):
        cfg = GeodesicConfig(energy=EnergyConfig(num_t=T, mode=mode,
                                                 kernel_precision=rung))
        loss = port_opt.make_loss_fn(dec, basis.astype(np.float32), cfg,
                                     "cpu", grad_only=True)
        om = omega.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(om, a, b, step_seed)[0], om)
        port[rung] = g.double()
    energy = "mc" if mode == "mc_fused" else "expected"
    ref = {r: reference.Loss(layers, a.double(), b.double(), basis, T,
                             energy, rung=r).grad(omega, draws)
           for r in (None, "f32x2")}
    return port, ref


def _gap(got, want):
    n = want.flatten(1).norm(dim=1)
    return float(((got - want).flatten(1).norm(dim=1)
                  / torch.clamp(n, min=n.median())).max())


@pytest.mark.parametrize("mode", ["expected_fused", "mc_fused"])
def test_rung_gradient(mode):
    """The reference at the f32x2 rung gives the port's f32x2 gradient, and
    tells it from the bfloat16 rung's, which float64 does not."""
    port, ref = _first_gradients(_layers(), mode)
    assert _gap(port["float32"], ref[None]) < 1e-5
    at_rung = _gap(port["f32x2"], ref["f32x2"])
    assert at_rung < 1e-4
    assert _gap(port["bfloat16"], ref["f32x2"]) > 10 * at_rung
    # against float64 the two reduced rungs read alike
    assert _gap(port["f32x2"], ref[None]) > 10 * at_rung


def test_tf32_rounds():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10 + 2 ** -11])
    assert reference._tf32(x).tolist() == [1.0, 1.0 + 2 ** -9]
