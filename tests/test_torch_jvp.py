"""The JVP energy modes of the PyTorch port (``jvp``, ``jvp_ensemble``,
``expected_rescaled``, ``target_num_t``) vs the JAX package on the CPU.

Inputs: the seed-42 production decoders and init blob, and t grids made
with numpy from a seed.  Tolerances: design matrices and velocities 1e-6
(relative to their scale); energies rtol 1e-5, their gradients rtol 1e-4
(the two packages sum in other orders); 25 optimizer steps: final energies
and lengths rtol 1e-4, as the other optimizer parity tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu.geometry import spline as jspline
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu.optim import geodesic as jgeo
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.geometry import energy as tenergy
from vae_latent_geometry_tpu_torch.geometry import spline as tspline
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.optim import geodesic as tgeo

from torch_parity_inputs import INIT, MODEL, members

T, B = 64, 6


@pytest.fixture(scope="module")
def setup():
    tp = tevae.load_npz(MODEL, "cpu")
    art = load_spline_batch(INIT)
    tdec, jdec = members(tp, 10)
    t = tspline.t_grid(T)
    phi = tspline.design_matrix(t, art.basis, art.n_poly)
    dphi = tspline.design_matrix_derivative(t, art.basis, art.n_poly)
    om, a, b = (torch.from_numpy(x[:B]) for x in
                (art.omega_init, art.a, art.b))
    gamma = tspline.eval_spline_design(om, a, b, phi, t)
    gamma_dot = tspline.eval_spline_velocity(om, a, b, dphi)
    num_active = np.random.default_rng(3).integers(1, 11, size=B)
    return tp, tdec, jdec, art, gamma, gamma_dot, num_active


@pytest.mark.parametrize("order", [1, 2])
def test_design_matrix_derivative_matches_jax(order):
    art = load_spline_batch(INIT)
    t = np.concatenate([np.linspace(0, 1, 50),
                        np.random.default_rng(0).uniform(0, 1, 50)])
    t = t.astype(np.float32)
    ref = np.asarray(jspline.design_matrix_derivative(
        jnp.asarray(t), jnp.asarray(art.basis), art.n_poly, order))
    out = tspline.design_matrix_derivative(torch.from_numpy(t), art.basis,
                                           art.n_poly, order).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    with pytest.raises(ValueError):
        tspline.design_matrix_derivative(torch.from_numpy(t), art.basis,
                                         art.n_poly, 3)


def test_velocity_matches_jax(setup):
    *_, art, _, gamma_dot, _ = setup
    jt = jnp.linspace(0.0, 1.0, T)
    dphi = jspline.design_matrix_derivative(jt, jnp.asarray(art.basis),
                                            art.n_poly)
    ref = np.asarray(jspline.eval_spline_velocity(
        jnp.asarray(art.omega_init[:B]), jnp.asarray(art.a[:B]),
        jnp.asarray(art.b[:B]), dphi))
    np.testing.assert_allclose(gamma_dot.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def _cases():
    # (mode, target_num_t, with num_active)
    out = [("jvp", None, False)]
    for target in (None, 2000):
        for na in (False, True):
            out.append(("jvp_ensemble", target, na))
    for na in (False, True):
        out.append(("expected_rescaled", 2000, na))
    return out


@pytest.mark.parametrize("name,target,with_na", _cases(),
                         ids=lambda v: str(v))
def test_energy_and_gradient_match_jax(setup, name, target, with_na):
    tp, tdec, jdec, _, gamma, gamma_dot, num_active = setup
    na_t = torch.from_numpy(num_active) if with_na else None
    na_j = jnp.asarray(num_active) if with_na else None
    w = np.linspace(0.5, 2.0, B).astype(np.float32)
    if name == "jvp":
        t0 = tevae.decoder_member(tdec, 0)
        j0 = jax.tree_util.tree_map(lambda x: x[0], jdec)

        def fn_t(g, gd):
            return tenergy.energy_jvp(t0, g, gd)

        def fn_j(g, gd):
            return jenergy.energy_jvp(j0, g, gd)
    elif name == "jvp_ensemble":
        def fn_t(g, gd):
            return tenergy.energy_jvp_ensemble(tdec, g, gd, target, na_t)

        def fn_j(g, gd):
            return jenergy.energy_jvp_ensemble(jdec, g, gd, target, na_j)
    else:
        def fn_t(g, gd):
            return tenergy.energy_expected_rescaled(tdec, g, target, na_t)

        def fn_j(g, gd):
            return jenergy.energy_expected_rescaled(jdec, g, target, na_j)
    g_np, gd_np = gamma.numpy(), gamma_dot.numpy()
    e_ref = np.asarray(fn_j(jnp.asarray(g_np), jnp.asarray(gd_np)))
    grads_ref = jax.grad(
        lambda g, gd: jnp.sum(jnp.asarray(w) * fn_j(g, gd)),
        argnums=(0, 1))(jnp.asarray(g_np), jnp.asarray(gd_np))
    g = gamma.clone().requires_grad_(True)
    gd = gamma_dot.clone().requires_grad_(True)
    e = fn_t(g, gd)
    grads = torch.autograd.grad((e * torch.from_numpy(w)).sum(), (g, gd),
                                allow_unused=True)
    np.testing.assert_allclose(e.detach().numpy(), e_ref, rtol=1e-5)
    for got, ref in zip(grads, grads_ref):
        ref = np.asarray(ref)
        got = np.zeros_like(ref) if got is None else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("plan_mode,target", [
    ("jvp_ensemble", 128), ("jvp_ensemble", None),
    ("expected_rescaled", 128), ("jvp", None)])
def test_optimizer_steps_match_jax(setup, plan_mode, target):
    """25 Adam steps of a phase plan in a JVP or rescaled mode, final
    energies by ``expected_fused`` at float32 (``single_fused`` for the
    one-decoder ``jvp``), as ``chip_smoke.py``'s phase jvp runs them."""
    tp, _, jdec, art, *_ = setup
    single = plan_mode == "jvp"
    final = "single_fused" if single else "expected_fused"
    kw = dict(steps=25, phase_plan=((25, 32, "constant", 1e-3, plan_mode),))
    tcfg = GeodesicConfig(**kw, energy=EnergyConfig(
        num_t=T, mode=final, target_num_t=target, kernel_precision="float32"))
    jcfg = JGeo(**kw, energy=JEnergy(
        num_t=T, mode=final, target_num_t=target, kernel_precision="float32"))
    tdec = (tevae.decoder_member(tp.decoders, 0) if single else tp.decoders)
    jd = jax.tree_util.tree_map(lambda x: x[0], jdec) if single else jdec
    n = 8
    om, a, b = art.omega_init[:n], art.a[:n], art.b[:n]
    ref = jgeo.optimize_splines(jd, jnp.asarray(om), jnp.asarray(a),
                                jnp.asarray(b), art.basis, jcfg)
    out = tgeo.optimize_splines(tdec, om, a, b, art.basis, tcfg,
                                device="cpu")
    assert not np.allclose(out.omega.numpy(), om)
    np.testing.assert_allclose(out.energy.numpy(), np.asarray(ref.energy),
                               rtol=1e-4)
    np.testing.assert_allclose(out.lengths.numpy(), np.asarray(ref.lengths),
                               rtol=1e-4)


def test_exact_cfg_clears_the_rescaling():
    cfg = GeodesicConfig(energy=EnergyConfig(mode="expected_rescaled",
                                             target_num_t=2000,
                                             kernel_precision="f32x2"))
    ex = tgeo._exact_cfg(cfg)
    assert (ex.energy.mode, ex.energy.target_num_t,
            ex.energy.kernel_precision) == ("expected", None, "float32")
    jex = jgeo._exact_cfg(JGeo(energy=JEnergy(mode="expected_rescaled",
                                              target_num_t=2000)))
    assert (jex.energy.mode, jex.energy.target_num_t) == ("expected", None)
    ph = tgeo._phase_cfgs(dataclasses.replace(
        cfg, phase_plan=((3, 64, "constant", 1e-3, "jvp_ensemble"),)))
    assert ph[0].energy.mode == "jvp_ensemble" and ph[0].energy.num_t == 64


@pytest.mark.parametrize("mode", ["jvp", "jvp_ensemble"])
def test_optimize_stage_matches_jax(mode):
    """``optimize_spline_batch`` in a JVP mode, 6 pairs in chunks of 4
    (edge-padded): ``jvp`` optimizes decoder 0 and reports its data-space
    arc length, ``jvp_ensemble`` sqrt of its own energy, as the JAX
    package's stage does."""
    import dataclasses as dc

    from vae_latent_geometry_tpu.config import ModelConfig
    from vae_latent_geometry_tpu.io.checkpoint import load_pytree
    from vae_latent_geometry_tpu.models.evae import evae_init
    from vae_latent_geometry_tpu.pipeline import optimize_stage as jstage
    from vae_latent_geometry_tpu_torch.io import artifacts as tart
    from vae_latent_geometry_tpu_torch.pipeline import optimize_stage as tstage

    def first(art, n):
        return dc.replace(art, a=art.a[:n], b=art.b[:n],
                          omega_init=art.omega_init[:n],
                          pair_indices=art.pair_indices[:n],
                          valid=art.valid[:n], pair_labels=art.pair_labels[:n])

    kw = dict(steps=5, lr=1e-3, batch_size=4)
    jp, _ = load_pytree(MODEL, evae_init(jax.random.PRNGKey(0), ModelConfig()))
    ref = jstage.optimize_spline_batch(
        jp, first(load_spline_batch(INIT), 6),
        cfg=JGeo(**kw, energy=JEnergy(num_t=32, mode=mode)),
        log_every_chunk=False)
    out = tstage.optimize_spline_batch(
        tevae.load_npz(MODEL, "cpu"), first(tart.load_spline_batch(INIT), 6),
        cfg=GeodesicConfig(**kw, energy=EnergyConfig(num_t=32, mode=mode)),
        device="cpu", log_every_chunk=False)
    np.testing.assert_allclose(out.geodesic_length, ref.geodesic_length,
                               rtol=1e-4)
    assert out.metadata == ref.metadata


def test_cli_optimize_jvp_ensemble(tmp_path):
    import os
    import subprocess
    import sys

    from vae_latent_geometry_tpu_torch.io import artifacts as tart
    from torch_parity_inputs import REPO

    art = tart.load_spline_batch(INIT)
    init = tmp_path / "init.npz"
    tart.save_spline_batch(dataclasses.replace(
        art, a=art.a[:3], b=art.b[:3], omega_init=art.omega_init[:3],
        pair_indices=art.pair_indices[:3], valid=art.valid[:3],
        pair_labels=art.pair_labels[:3]), str(init))
    opt = tmp_path / "opt.npz"
    r = subprocess.run(
        [sys.executable, "-m", "vae_latent_geometry_tpu_torch", "optimize",
         "--device", "cpu", "--model", MODEL, "--splines", str(init),
         "--steps", "3", "--num-t", "32", "--no-euclidean", "--energy-mode",
         "jvp_ensemble", "--output", str(opt)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = load_spline_batch(str(opt))      # the JAX package reads it
    assert out.metadata["energy_mode"] == "jvp_ensemble"
    assert np.isfinite(out.geodesic_length).all()
