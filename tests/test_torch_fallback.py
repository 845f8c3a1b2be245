"""The port's two repairs against the JAX package, on the CPU:

- mode ``single_fused_bf16`` (the expected kernels at M=1 and the bfloat16
  rung): ``make_loss_fn``, 25 optimizer steps, ``_exact_cfg``, decoder 0 in
  ``optimize_spline_batch`` and the CLI;
- a model whose hidden widths the CUDA kernels do not take, (64, 64), carried
  across with ``from_jax_params``: on the CPU the kernels' plain versions
  run ``expected_fused``, ``mc_fused`` and ``single_fused`` (and their
  ``_bf16`` modes) at the rung the JAX package's kernels run, with no
  fallback on either side.

Tolerances are stated at each test.
"""

import dataclasses
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.config import ModelConfig
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu.models.evae import evae_init
from vae_latent_geometry_tpu.optim import geodesic as jgeo
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.geometry import energy as energy_lib
from vae_latent_geometry_tpu_torch.geometry.spline import (
    design_matrix, eval_spline_design, t_grid)
from vae_latent_geometry_tpu_torch.io import artifacts as tart
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.optim import geodesic as tgeo
from vae_latent_geometry_tpu_torch.pipeline import optimize_stage as tstage

from torch_parity_inputs import REPO, MODEL, INIT

NP = 8
NARROW = ModelConfig(input_dim=8, num_decoders=3, encoder_hidden=(16,),
                     decoder_hidden=(64, 64))


def _single_decoders(tp):
    """Decoder 0 of the seed-42 EVAE for both packages."""
    t = tevae.decoder_member(tp.decoders, 0)
    j = {"layers": [{"w": jnp.asarray(l["w"].numpy()),
                     "b": jnp.asarray(l["b"].numpy())} for l in t["layers"]]}
    return t, j


def _losses(jdec, tdec, art, e_kw, num_active=None, steps_kw=None):
    """(JAX, port) per-spline energies and omega-gradients of ``make_loss_fn``
    on the first NP init splines, one config for both."""
    jcfg = JGeo(**(steps_kw or {}), energy=JEnergy(**e_kw))
    tcfg = GeodesicConfig(**(steps_kw or {}), energy=EnergyConfig(**e_kw))
    om, a, b = art.omega_init[:NP], art.a[:NP], art.b[:NP]
    jloss = jgeo.make_loss_fn(jdec, art.basis, jcfg)
    na_j = None if num_active is None else jnp.asarray(num_active)
    (_, e_j), g_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(om), jnp.asarray(a), jnp.asarray(b),
        jax.random.PRNGKey(0), na_j)
    tloss = tgeo.make_loss_fn(tdec, art.basis, tcfg, "cpu")
    omt = torch.from_numpy(om).requires_grad_(True)
    na_t = None if num_active is None else torch.as_tensor(num_active)
    total, e_t = tloss(omt, torch.from_numpy(a), torch.from_numpy(b), 3, na_t)
    (g_t,) = torch.autograd.grad(total, omt)
    return ((np.asarray(e_j), np.asarray(g_j)),
            (e_t.detach().numpy(), g_t.numpy()))


@pytest.fixture(scope="module")
def problem():
    tp = tevae.load_npz(MODEL, "cpu")
    return tp, load_spline_batch(INIT)


@pytest.fixture(scope="module")
def narrow():
    """A (64, 64)-hidden EVAE whose members differ (the initializer copies
    one decoder to every member), for both packages."""
    m = evae_init(jax.random.PRNGKey(5), NARROW)
    rng = np.random.default_rng(5)
    dec = jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.normal(size=x.shape).astype(np.float32),
        m.decoders)
    m = m._replace(decoders=dec)
    return m.decoders, tevae.from_jax_params(m, "cpu").decoders


# ---------------------------------------------------------------------------
# single_fused_bf16
# ---------------------------------------------------------------------------

def test_single_fused_bf16_loss_matches_jax(problem):
    """The value and gradient of one step at the bfloat16 rung: both run
    bf16 x bf16 products with fp32 sums in another order, so a bf16
    rounding of a hidden unit can flip; energies within 1e-4, gradients
    within 2e-3 of their largest element (checked at T = 64)."""
    tp, art = problem
    tdec, jdec = _single_decoders(tp)
    (e_j, g_j), (e_t, g_t) = _losses(jdec, tdec, art, dict(
        num_t=64, mode="single_fused_bf16"))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
    assert np.abs(g_t - g_j).max() <= 2e-3 * np.abs(g_j).max()
    # and it is the bfloat16 rung, not the default f32x3
    (_, _), (e_f, _) = _losses(jdec, tdec, art, dict(
        num_t=64, mode="single_fused"))
    assert not np.array_equal(e_f, e_t)


def test_single_fused_bf16_optimizer_matches_jax(problem):
    """25 Adam steps at the bfloat16 rung in both packages; final energies
    are re-evaluated at float32 (``single_fused``).  The bf16 gradients of
    the two packages differ by rounding flips (previous test), and 25 steps
    carry that into the curves: their energies settle within 1.6e-4 of each
    other here, so rtol 5e-4 (the float32 and f32x2 optimizer tests hold
    1e-4)."""
    tp, art = problem
    tdec, jdec = _single_decoders(tp)
    kw = dict(steps=25, lr=1e-3, lr_schedule="constant")
    jcfg = JGeo(**kw, energy=JEnergy(num_t=64, mode="single_fused_bf16"))
    tcfg = GeodesicConfig(**kw, energy=EnergyConfig(
        num_t=64, mode="single_fused_bf16"))
    om, a, b = art.omega_init[:NP], art.a[:NP], art.b[:NP]
    ref = jgeo.optimize_splines(jdec, jnp.asarray(om), jnp.asarray(a),
                                jnp.asarray(b), art.basis, jcfg)
    out = tgeo.optimize_splines(tdec, om, a, b, art.basis, tcfg, device="cpu")
    e0 = tgeo.make_loss_fn(tdec, art.basis, tgeo._exact_cfg(tcfg), "cpu")(
        torch.from_numpy(om), torch.from_numpy(a), torch.from_numpy(b)
    )[1].detach().numpy()
    e_ref = np.asarray(ref.energy)
    assert np.all(np.abs(e_ref / e0 - 1) > 1e-4)      # the curves moved
    np.testing.assert_allclose(out.energy.numpy(), e_ref, rtol=5e-4)


def test_exact_cfg_maps_single_fused_bf16_to_float32():
    for mode in ("single_fused_bf16", "single_fused"):
        t = tgeo._exact_cfg(GeodesicConfig(energy=EnergyConfig(
            mode=mode, kernel_precision="f32x2")))
        j = jgeo._exact_cfg(JGeo(energy=JEnergy(mode=mode,
                                                kernel_precision="f32x2")))
        assert t.energy.mode == j.energy.mode == "single_fused"
        assert t.energy.kernel_precision == j.energy.kernel_precision \
            == "float32"
    assert "single_fused_bf16" in tgeo.ENERGY_MODES


def test_optimize_spline_batch_uses_decoder_0_for_single_fused_bf16(problem):
    """The stage optimizes through decoder 0 alone and reports its arc
    length, as for ``single`` and ``single_fused``."""
    tp, _ = problem
    art = tart.load_spline_batch(INIT)
    art = dataclasses.replace(
        art, a=art.a[:3], b=art.b[:3], omega_init=art.omega_init[:3],
        pair_indices=art.pair_indices[:3], valid=art.valid[:3],
        pair_labels=art.pair_labels[:3])
    cfg = GeodesicConfig(steps=3, batch_size=3, energy=EnergyConfig(
        num_t=32, mode="single_fused_bf16"))
    out = tstage.optimize_spline_batch(tp, art, cfg=cfg, device="cpu",
                                       log_every_chunk=False)
    dec0 = tevae.decoder_member(tp.decoders, 0)
    direct = tgeo.optimize_splines(
        dec0, art.omega_init, art.a, art.b, art.basis, cfg, device="cpu",
        generator=torch.Generator().manual_seed(tgeo.fold_seed(0, 0)))
    np.testing.assert_array_equal(out.omega_optimized, direct.omega.numpy())
    t = t_grid(32, "cpu")
    gamma = eval_spline_design(direct.omega, torch.from_numpy(art.a),
                               torch.from_numpy(art.b),
                               design_matrix(t, art.basis, art.n_poly), t)
    np.testing.assert_allclose(
        out.geodesic_length,
        energy_lib.geodesic_lengths(dec0, gamma).numpy(), rtol=1e-6)


def test_cli_optimize_single_fused_bf16(tmp_path):
    init = tmp_path / "init.npz"
    full = tart.load_spline_batch(INIT)
    tart.save_spline_batch(dataclasses.replace(
        full, a=full.a[:3], b=full.b[:3], omega_init=full.omega_init[:3],
        pair_indices=full.pair_indices[:3], valid=full.valid[:3],
        pair_labels=full.pair_labels[:3]), str(init))
    opt = tmp_path / "opt.npz"
    r = subprocess.run(
        [sys.executable, "-m", "vae_latent_geometry_tpu_torch", "optimize",
         "--device", "cpu", "--model", MODEL, "--splines", str(init),
         "--steps", "3", "--num-t", "32", "--no-euclidean", "--energy-mode",
         "single_fused_bf16", "--output", str(opt)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    art = load_spline_batch(str(opt))            # the JAX package reads it
    assert art.metadata["energy_mode"] == "single_fused_bf16"
    assert np.isfinite(art.geodesic_length).all()
    assert not np.array_equal(art.omega_optimized, art.omega_init)


# ---------------------------------------------------------------------------
# a model the kernels do not take: (64, 64) hidden units
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,precision", [
    (m, p) for m in ("expected_fused", "mc_fused", "single_fused")
    for p in ("float32", "f32x3")] + [
    (m, "f32x3") for m in ("expected_fused_bf16", "mc_fused_bf16",
                            "single_fused_bf16")])
def test_narrow_model_runs_the_fused_modes_as_the_jax_package(
        narrow, problem, mode, precision):
    """A (64, 64)-hidden model on the CPU: the JAX package's fused kernels
    take it (in interpret mode here) and the port's kernels' plain versions
    take any width, so both run the fused mode at its rung and neither
    warns of a fallback (on the card the port's kernels refuse it: the
    ``gpu`` test ``test_fused_modes_raise_on_a_narrow_model_on_gpu``).
    Energies rtol 1e-5 at float32 and f32x3; gradients rtol 1e-4 at float32,
    and at f32x3 the reduced rungs' rule of tests/test_torch_mc_fused.py
    (error over the largest element: median 1e-4, 99th percentile 1e-3),
    since a one-ulp difference can flip a bf16 rounding of the chain.  At
    the bfloat16 rung the two packages sum bf16 products in another order:
    energies rtol 1e-4, gradients within 2e-3 of their largest element.  ``mc_fused*`` run with one active
    decoder, so that both packages' draws name decoder 0 and the estimator
    is deterministic."""
    jdec, tdec = narrow
    _, art = problem
    if mode.startswith("single"):
        jdec = jax.tree_util.tree_map(lambda x: x[0], jdec)
        tdec = tevae.decoder_member(tdec, 0)
    num_active = np.ones(NP, np.int32) if mode.startswith("mc") else None
    e_kw = dict(num_t=32, mode=mode, kernel_precision=precision)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        (e_j, g_j), (e_t, g_t) = _losses(jdec, tdec, art, e_kw, num_active)
    assert not [w for w in rec if "falling back" in str(w.message)]
    err = np.abs(g_t - g_j) / np.abs(g_j).max()
    if mode.endswith("bf16"):
        np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
        assert err.max() <= 2e-3, err.max()
    elif precision == "f32x3":
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
        assert np.median(err) < 1e-4, np.median(err)
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)
    else:
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(g_j).max())


def test_narrow_model_rungs_differ(narrow, problem):
    """The narrow model's fused energies are the rung's, not one float32
    plain path under every name: f32x3 and bfloat16 give other energies
    than float32 (in both packages)."""
    jdec, tdec = narrow
    _, art = problem
    e = {}
    for mode, precision in (("expected_fused", "float32"),
                            ("expected_fused", "f32x3"),
                            ("expected_fused_bf16", "f32x3")):
        (e_j, _), (e_t, _) = _losses(jdec, tdec, art, dict(
            num_t=32, mode=mode, kernel_precision=precision))
        e[mode, precision] = e_t, e_j
    for rung in (("expected_fused", "f32x3"), ("expected_fused_bf16", "f32x3")):
        for side in (0, 1):
            assert not np.array_equal(e[rung][side],
                                      e["expected_fused", "float32"][side])


def test_ep_axis_on_a_narrow_model_runs_the_stats_path(narrow, problem):
    """With the decoders sharded (``ep_axis``) on a one-rank mesh the stats
    path runs the narrow model on the CPU (their plain versions take any
    shape) and gives the unfused ``expected`` energies."""
    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

    _, tdec = narrow
    _, art = problem
    cfg = GeodesicConfig(energy=EnergyConfig(num_t=32, mode="expected_fused",
                                             ep_axis="ep",
                                             kernel_precision="float32"))
    om, a, b = (torch.from_numpy(x[:NP]) for x in
                (art.omega_init, art.a, art.b))
    loss = tgeo.make_loss_fn(tdec, art.basis, cfg, "cpu", mesh=make_mesh(1, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, e = loss(om, a, b)
    t = t_grid(32, "cpu")
    gamma = eval_spline_design(om, a, b, design_matrix(t, art.basis, 4), t)
    torch.testing.assert_close(e, energy_lib.energy_expected(tdec, gamma),
                               rtol=1e-5, atol=0)


def test_fitting_shapes_do_not_warn(problem):
    tp, art = problem
    cfg = GeodesicConfig(energy=EnergyConfig(num_t=16, mode="expected_fused"))
    om, a, b = (torch.from_numpy(x[:2]) for x in
                (art.omega_init, art.a, art.b))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tgeo.make_loss_fn(tp.decoders, art.basis, cfg, "cpu")(om, a, b)
