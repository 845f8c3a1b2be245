"""The MC energy modes in the PyTorch port's optimizer vs the JAX package's.

The small problem of tests/test_energy_mc_pallas.py:120-140: 3 decoders
2 -> 16 -> 10, 3 splines from zero parameters, T=24, 25 Adam steps at lr
1e-2.  The two packages draw different random bits, so trajectories are
compared through the closed-form ``expected`` energy of the optimized curves
(``final_energy_mode="expected"``): over five seeds the port's mean must lie
within 3x, and each single run within 6x, the largest deviation of the JAX
mode's own five keys from their mean (per spline; the JAX spread is 0.1-0.3%
of the energy here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu.models import nets
from vae_latent_geometry_tpu.models.evae import stack_decoders
from vae_latent_geometry_tpu.optim import geodesic as jgeo
from vae_latent_geometry_tpu_torch import cli as tcli
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.io import artifacts as tart
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.optim import geodesic as tgeo
from vae_latent_geometry_tpu_torch.pipeline import optimize_stage as tstage

import torch_parity_inputs as inputs

MC_MODES = ("mc", "mc_scan", "mc_fused", "mc_fused_bf16")
B, T = 3, 24
RECIPE = dict(steps=25, lr=1e-2)


@pytest.fixture(scope="module")
def problem():
    jdec = stack_decoders([
        nets.decoder_init(k, 2, 10, (16,))
        for k in jax.random.split(jax.random.PRNGKey(9), 3)])
    tdec = {"layers": [{"w": torch.from_numpy(np.array(l["w"])),
                        "b": torch.from_numpy(np.array(l["b"]))}
                       for l in jdec["layers"]]}
    rng = np.random.default_rng(12)
    a = rng.normal(size=(B, 2)).astype(np.float32)
    b = rng.normal(size=(B, 2)).astype(np.float32)
    basis, _ = nullspace_basis(4)
    return jdec, tdec, a, b, basis


def _run(problem, mode, seed, **kw):
    _, tdec, a, b, basis = problem
    energy = EnergyConfig(num_t=T, mode=mode,
                          mc_inkernel_rng=kw.pop("inkernel", True))
    opts = {k: kw.pop(k) for k in ("record_history",) if k in kw}
    cfg = GeodesicConfig(**{**RECIPE, **kw}, energy=energy)
    return tgeo.optimize_splines(
        tdec, np.zeros((B, 5, 2), np.float32), a, b, basis, cfg, device="cpu",
        generator=torch.Generator().manual_seed(seed), **opts)


@pytest.mark.parametrize("inkernel", [True, False], ids=["philox", "planes"])
@pytest.mark.parametrize("mode", MC_MODES)
def test_history_falls_and_runs_are_reproducible(problem, mode, inkernel):
    res = _run(problem, mode, 1, inkernel=inkernel, record_history=True)
    hist = res.energy_history.numpy()
    assert hist.shape == (25, B) and np.isfinite(hist).all()
    assert hist[-1].mean() < hist[0].mean()
    assert torch.isfinite(res.energy).all()
    again = _run(problem, mode, 1, inkernel=inkernel, record_history=True)
    assert torch.equal(again.omega, res.omega)            # bit for bit
    assert torch.equal(again.energy_history, res.energy_history)
    other = _run(problem, mode, 2, inkernel=inkernel)
    assert not torch.equal(other.omega, res.omega)
    # the gradient-only trajectory (no history) is the same trajectory
    quiet = _run(problem, mode, 1, inkernel=inkernel)
    assert torch.equal(quiet.omega, res.omega)


def test_default_generator_is_seed_zero(problem):
    _, tdec, a, b, basis = problem
    cfg = GeodesicConfig(**RECIPE, energy=EnergyConfig(num_t=T,
                                                       mode="mc_fused"))
    none = tgeo.optimize_splines(tdec, np.zeros((B, 5, 2), np.float32), a, b,
                                 basis, cfg, device="cpu")
    assert torch.equal(none.omega, _run(problem, "mc_fused", 0).omega)


def test_phases_and_final_evaluation_draw_from_their_own_streams(problem,
                                                                 monkeypatch):
    """One draw per step, another stream per phase, one more draw for the
    final re-evaluation: all the seeds the energy sees are distinct."""
    seen = []
    real = tgeo._energy_fn

    def spy(mode, decoders, gamma, seed, *args, **kw):
        seen.append(seed)
        return real(mode, decoders, gamma, seed, *args, **kw)

    monkeypatch.setattr(tgeo, "_energy_fn", spy)
    _run(problem, "mc_fused", 3,
         phase_plan=((4, 12, "constant", 1e-2),
                     (3, T, "constant", 1e-2, "mc")))
    assert len(seen) == 8 and len(set(seen)) == 8
    first = list(seen)
    seen.clear()
    _run(problem, "mc_fused", 3, steps=4)
    # a single phase sees the first phase's draws, then the final one
    assert seen[:4] == first[:4] and seen[4] == first[7]


@pytest.mark.parametrize("mode", MC_MODES)
def test_optimized_curves_match_jax_within_its_own_spread(problem, mode):
    jdec, _, a, b, basis = problem
    kw = dict(RECIPE, final_energy_mode="expected")
    jcfg = JGeo(**kw, energy=JEnergy(num_t=T, mode=mode))
    ref = np.stack([np.asarray(jgeo.optimize_splines(
        jdec, jnp.zeros((B, 5, 2)), jnp.asarray(a), jnp.asarray(b), basis,
        jcfg, key=jax.random.PRNGKey(k)).energy) for k in range(5)])
    out = np.stack([_run(problem, mode, k, final_energy_mode="expected")
                    .energy.numpy() for k in range(5)])
    mean = ref.mean(axis=0)
    spread = np.abs(ref - mean).max(axis=0)
    assert np.all(spread > 0) and np.all(spread < 0.01 * mean)
    assert np.all(np.abs(out.mean(axis=0) - mean) <= 3 * spread)
    assert np.all(np.abs(out - mean) <= 6 * spread)
    # the runs did move the curves: the initial straight lines are far off
    e0 = np.asarray(jgeo.make_loss_fn(jdec, basis, jgeo._exact_cfg(jcfg))(
        jnp.zeros((B, 5, 2)), jnp.asarray(a), jnp.asarray(b),
        jax.random.PRNGKey(0))[1])
    assert np.all(np.abs(e0 - mean) > 20 * spread)


def test_stage_gives_every_chunk_its_own_stream():
    """Four copies of one pair in chunks of two: within a chunk the splines
    see different draws, and the two chunks (same inputs, another start)
    draw from different streams; the same generator seed reproduces all."""
    art = tart.load_spline_batch(inputs.INIT)
    four = dataclasses.replace(
        art, **{f: np.repeat(getattr(art, f)[:1], 4, axis=0)
                for f in ("a", "b", "omega_init", "pair_indices", "valid")},
        pair_labels=art.pair_labels[:1] * 4)
    params = tevae.load_npz(inputs.MODEL, "cpu")
    cfg = GeodesicConfig(steps=3, lr=1e-2, batch_size=2, energy=EnergyConfig(
        num_t=16, mode="mc_fused", kernel_precision="f32x2"))
    runs = [tstage.optimize_spline_batch(
        params, four, cfg=cfg, device="cpu", log_every_chunk=False,
        generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    om = runs[0].omega_optimized
    assert np.isfinite(runs[0].geodesic_length).all()
    assert not np.array_equal(om[0], om[1])
    assert not np.array_equal(om[:2], om[2:])
    np.testing.assert_array_equal(runs[1].omega_optimized, om)
    assert not np.array_equal(runs[2].omega_optimized, om)
    assert runs[0].metadata["energy_mode"] == "mc_fused"
    assert runs[0].metadata["mc_samples"] == 2


@pytest.mark.parametrize("mode,coarse", [
    ("mc", "mc_fused_bf16"), ("mc_fused", "mc_fused_bf16"),
    ("expected", "expected_fused_bf16"),
    ("expected_fused", "expected_fused_bf16")])
def test_coarse_bf16_plan_matches_jax_cli(mode, coarse):
    """``--turbo --coarse-bf16``: the coarse phase runs the estimator's fused
    bf16 mode, the polish phase is untouched (the JAX CLI's mapping,
    vae_latent_geometry_tpu/cli.py:347-357)."""
    plan = tcli.coarse_bf16_plan(mode, tcli.TURBO_PHASES)
    assert plan == ((*tcli.TURBO_PHASES[0], coarse), tcli.TURBO_PHASES[1])
    cfg = GeodesicConfig(phase_plan=plan, energy=EnergyConfig(mode=mode))
    phases = tgeo._phase_cfgs(cfg)
    assert [p.energy.mode for p in phases] == [coarse, mode]


def test_coarse_bf16_refuses_what_has_no_fused_bf16_rung():
    with pytest.raises(SystemExit, match="--turbo"):
        tcli.coarse_bf16_plan("mc", None)
    with pytest.raises(SystemExit, match="fused bf16"):
        tcli.coarse_bf16_plan("single", tcli.TURBO_PHASES)


def test_cli_defaults_follow_the_jax_cli():
    from vae_latent_geometry_tpu import cli as jcli

    targs = tcli.build_parser().parse_args(["optimize", "--model", "m.npz"])
    jargs = jcli.build_parser().parse_args(["optimize", "--model", "m.npz"])
    for flag in ("energy_mode", "mc_samples", "num_t", "kernel_precision",
                 "coarse_bf16"):
        assert getattr(targs, flag) == getattr(jargs, flag), flag
    assert targs.energy_mode == "mc" and targs.seed == 0
    for mode in MC_MODES:
        tcli.build_parser().parse_args(["optimize", "--model", "m.npz",
                                        "--energy-mode", mode])
