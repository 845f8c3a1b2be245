"""Checkpoints, resume, early stop and backstop in the PyTorch port.

- Files cross the packages both ways: a port training state or model loads
  in the JAX package's ``load_train_state`` / ``load_pytree`` with equal
  leaves, a JAX one loads (and resumes) in the port, and a port-trained
  model encodes identically after the round trip.
- ``sharded_train_step`` on two gloo ranks (dp=2, and ep=2) against one
  process's neg-ELBO + Adam steps (losses rtol 1e-5, parameters rtol 1e-5 /
  atol 1e-6; the ranks bit-identical), the multiseed trainer with its seeds
  over dp=2 against the unsharded run (bit for bit), and the optimize stage
  resumed on a dp=2 mesh (rank 0 reads, every rank runs the same chunks).
- The ported contracts of ``tests/test_single_decoder_pipeline.py:109-370``
  (per-chunk resume, the background writer, foreign, partial and absent
  stamps ignored, invalid pairs done, stored distances kept),
  ``tests/test_optimize.py:190-766`` (early stop, merge, backstop) and
  ``tests/test_sharding.py:301,365`` (early stop refused on a mesh).
- Early stop against the JAX package at float32 in the deterministic
  ``single`` mode: the step it stops at (JAX's, from its energy history and
  the 50-step block rule) equal, the restored omega within atol 1e-4.
- The CLI: ``train`` / ``train-single --device cpu`` and their resume,
  ``optimize --early-stop``, ``--backstop-fixed`` and a resume by re-running.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.config import ModelConfig as JModel
from vae_latent_geometry_tpu.config import TrainConfig as JTrain
from vae_latent_geometry_tpu.io import checkpoint as jckpt
from vae_latent_geometry_tpu.models import evae as jevae
from vae_latent_geometry_tpu.models import nets as jnets
from vae_latent_geometry_tpu.models import vae as jvae
from vae_latent_geometry_tpu.optim import geodesic as jgeo
from vae_latent_geometry_tpu.pipeline import train as jtrain
from vae_latent_geometry_tpu_torch.config import (
    EnergyConfig,
    GeodesicConfig,
    ModelConfig,
    TrainConfig,
)
from vae_latent_geometry_tpu_torch.geometry import energy as E
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.geometry.spline import (
    design_matrix,
    eval_spline_design,
    t_grid,
)
from vae_latent_geometry_tpu_torch.io import checkpoint as ckpt
from vae_latent_geometry_tpu_torch.io.artifacts import (
    SplineBatchArtifact,
    load_spline_batch,
    save_spline_batch,
)
from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves, tree_map
from vae_latent_geometry_tpu_torch.models import evae, nets, vae
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    Adam,
    _optimize_early_stop,
    optimize_spline_early_stopping,
    optimize_splines,
)
from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
from vae_latent_geometry_tpu_torch.parallel.shard import (
    sharded_optimize_splines,
)
from vae_latent_geometry_tpu_torch.pipeline import optimize_stage as stage
from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
    _AsyncCheckpointer,
    _recipe_stamp,
    merge_spline_batches,
    optimize_spline_batch,
    optimize_spline_batch_backstop,
)
from vae_latent_geometry_tpu_torch.pipeline.train import (
    train_evae,
    train_evae_multiseed,
    train_single_vae,
)

from torch_parity_inputs import INIT, MODEL, REPO
from torch_train_worker import (
    OPT_CFG,
    SEEDS,
    STEP_CFG,
    TRAIN_CFG,
    TRAIN_MODEL,
    opt_inputs,
    run_ranks,
    step_inputs,
    train_data,
)

torch.set_num_threads(1)

TINY = dict(input_dim=10, latent_dim=2, num_decoders=2,
            encoder_hidden=(16,), decoder_hidden=(16,), decoder_sigma=1.0)
LEGACY = dict(input_dim=10, latent_dim=2, heteroscedastic=True,
              encoder_hidden=(16,), decoder_hidden=(16,))


def _small_cfg(**kw):
    energy = EnergyConfig(**kw.pop("energy", {}))
    return GeodesicConfig(steps=kw.pop("steps", 100), lr=kw.pop("lr", 1e-2),
                          energy=energy, **kw)


@pytest.fixture(scope="module")
def toy_problem():
    """A narrow decoder with a strong nonlinearity, four pairs from zero
    spline parameters (``tests/test_optimize.py``'s problem, drawn from the
    JAX key so the early-stop parity test shares it)."""
    rng = np.random.default_rng(1234)
    jdec = jnets.decoder_init(jax.random.PRNGKey(7), 2, 16, (32, 32))
    dec = tree_map(lambda x: torch.tensor(np.asarray(x)), jdec)
    B = 4
    a = (rng.normal(size=(B, 2)) * 2).astype(np.float32)
    b = (rng.normal(size=(B, 2)) * 2).astype(np.float32)
    basis, _ = nullspace_basis(4)
    omega0 = np.zeros((B, basis.shape[1], 2), np.float32)
    return dec, a, b, basis, omega0, jdec


def _toy_artifact(toy_problem):
    _, a, b, basis, omega0, _ = toy_problem
    return SplineBatchArtifact(
        a=a, b=b, omega_init=omega0, basis=basis, n_poly=4,
        pair_indices=np.stack([np.arange(len(a)), np.arange(len(a)) + len(a)],
                              1),
        valid=np.ones(len(a), bool), pair_labels=[["x", "y"]] * len(a),
        representatives=[])


def _vae_art(P, valid=None, seed=0):
    rng = np.random.default_rng(seed)
    basis, _ = nullspace_basis(4)
    return SplineBatchArtifact(
        a=rng.normal(size=(P, 2)).astype(np.float32),
        b=rng.normal(size=(P, 2)).astype(np.float32),
        omega_init=np.zeros((P, 5, 2), np.float32), basis=basis, n_poly=4,
        pair_indices=np.arange(2 * P).reshape(P, 2),
        valid=np.ones(P, bool) if valid is None else np.asarray(valid, bool),
        pair_labels=[["a", "b"]] * P, representatives=[])


@pytest.fixture(scope="module")
def legacy_vae():
    """The legacy single VAE at its full width (LEGACY_CONFIG)."""
    return vae.vae_init(torch.Generator().manual_seed(4), device="cpu")


SINGLE = _small_cfg(steps=15, batch_size=3, energy={"mode": "single",
                                                    "num_t": 48})


# ------------------------------------------------- files across packages ---

def _tiny_data():
    return train_data()


def test_port_train_state_loads_in_jax(tmp_path):
    """A port training state (ensemble at a step schedule, multiseed, and
    the single VAE with its best pair) in the JAX package's loader: every
    leaf equal, optax's count and schedule count int32."""
    x = _tiny_data()
    cfg = TrainConfig(epochs=2, batch_size=64, seed=3, lr_step_size=1)
    path = str(tmp_path / "evae.npz")
    res = train_evae(x, cfg, ModelConfig(**TINY), log_every=0,
                     checkpoint_path=path, device="cpu")
    jcfg = JModel(**TINY)
    like = jevae.evae_init(jax.random.PRNGKey(0), jcfg)
    opt = optax.adam(jtrain._lr_schedule(JTrain(**dataclasses.asdict(cfg)),
                                         7))
    p, o, meta = jckpt.load_train_state(path, like, opt.init(like))
    assert meta["epoch"] == 2 and meta["cfg_stamp"]["cfg"]
    stored = jckpt._flatten_with_paths(p)[0]
    for path_, a in ckpt.flatten_with_paths(res.params):
        np.testing.assert_array_equal(a.numpy(), stored[path_], path_)
    steps = 2 * ((len(x) - int(0.1 * len(x))) // 64)
    assert o[0].count.dtype == np.int32 and int(o[0].count) == steps
    assert int(o[1].count) == steps
    assert np.abs(np.asarray(o[0].nu.encoder["layers"][0]["w"])).max() > 0

    path = str(tmp_path / "multi.npz")
    train_evae_multiseed(x, [3, 7], TrainConfig(epochs=1, batch_size=64),
                         ModelConfig(**TINY), log_every=0,
                         checkpoint_path=path, device="cpu")
    stack = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.stack([a, a]), t)
    o1 = optax.adam(1e-3)
    p, o, _ = jckpt.load_train_state(path, stack(like),
                                     stack(o1.init(like)))
    assert o[0].count.shape == (2,)

    path = str(tmp_path / "svae.npz")
    lcfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
    res = train_single_vae(x, TrainConfig(epochs=2, batch_size=64, seed=1),
                           lcfg, log_every=0, checkpoint_path=path,
                           device="cpu")
    jlike = jvae.vae_init(jax.random.PRNGKey(0),
                          dataclasses.replace(jvae.LEGACY_CONFIG, **LEGACY))
    p, o, extra, _ = jckpt.load_train_state(
        path, jlike, o1.init(jlike),
        extra_state_like={"best_val": jnp.asarray(jnp.inf),
                          "best_params": jlike})
    assert float(extra["best_val"]) == res.best_val_loss
    stored = jckpt._flatten_with_paths(extra["best_params"])[0]
    for path_, a in ckpt.flatten_with_paths(res.best_params):
        np.testing.assert_array_equal(a.numpy(), stored[path_], path_)


def test_jax_files_load_and_resume_in_the_port(tmp_path):
    """A JAX training state resumes in the port (the stamps are one JSON),
    continuing its loss history; a JAX model loads and encodes as in JAX."""
    x = _tiny_data()
    path = str(tmp_path / "jax_state.npz")
    jtrain.train_evae(x, JTrain(epochs=2, batch_size=64, seed=3),
                      JModel(**TINY), log_every=0, block_epochs=2,
                      checkpoint_path=path)
    jmeta = jckpt.read_meta(path)
    res = train_evae(x, TrainConfig(epochs=3, batch_size=64, seed=3),
                     ModelConfig(**TINY), log_every=0, checkpoint_path=path,
                     device="cpu")
    assert len(res.train_losses) == 3
    np.testing.assert_array_equal(res.train_losses[:2],
                                  jmeta["train_losses"])
    assert np.isfinite(res.train_losses[2])
    # a JAX model file through the port's EVAE loader
    jp = jevae.evae_init(jax.random.PRNGKey(3), JModel(**TINY))
    mpath = str(tmp_path / "model_seed3.npz")
    jckpt.save_pytree(jp, mpath, extra_meta={
        "model_config": dataclasses.asdict(JModel(**TINY))})
    tp = evae.load_npz(mpath, "cpu")
    np.testing.assert_allclose(
        evae.encode(tp, torch.tensor(x))[0].numpy(),
        np.asarray(jevae.encode(jp, jnp.asarray(x))[0]), rtol=1e-5,
        atol=1e-6)


def test_port_trained_model_round_trip_encodes_identically(tmp_path):
    x = _tiny_data()
    mcfg = ModelConfig(**TINY)
    res = train_evae(x, TrainConfig(epochs=1, batch_size=64, seed=2), mcfg,
                     log_every=0, device="cpu")
    path = str(tmp_path / "model_seed2.npz")
    ckpt.save_pytree(res.params, path, extra_meta={
        "seed": 2, "model_config": dataclasses.asdict(mcfg)})
    back = evae.load_npz(path, "cpu")
    tx = torch.tensor(x)
    assert torch.equal(evae.encode(back, tx)[0], evae.encode(res.params,
                                                             tx)[0])
    jp, _ = jckpt.load_pytree(path, jevae.evae_init(jax.random.PRNGKey(0),
                                                    JModel(**TINY)))
    np.testing.assert_allclose(np.asarray(jevae.encode(jp, jnp.asarray(x))[0]),
                               evae.encode(back, tx)[0].numpy(), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------- over gloo ranks -----

def _one_process_steps():
    params, steps = step_inputs()
    leaves = tree_leaves(params)
    opt = Adam(lambda count: 1e-2)
    state = opt.init(leaves)
    losses = []
    for xb, eps, idx in steps:
        for w in leaves:
            w.requires_grad_(True)
        loss = evae.neg_elbo(params, torch.tensor(xb), torch.tensor(eps), idx,
                             STEP_CFG)
        opt.step(leaves, list(torch.autograd.grad(loss, leaves)), state)
        losses.append(float(loss.detach()))
    return [w.detach().numpy() for w in leaves], losses


@pytest.mark.parametrize("dp,ep", [(2, 1), (1, 2)], ids=["dp2", "ep2"])
def test_sharded_train_step_and_multiseed_over_processes(tmp_path, dp, ep):
    checkpoint = None
    if dp == 2:
        # a checkpoint interrupted after its first chunk
        dec, art = opt_inputs()
        checkpoint = str(tmp_path / "opt.npz")
        full = optimize_spline_batch(dec, art, cfg=OPT_CFG, device="cpu",
                                     checkpoint_path=checkpoint,
                                     log_every_chunk=False)
        part = load_spline_batch(checkpoint)
        omega = np.array(part.omega_optimized)
        omega[4:] = art.omega_init[4:]
        glen = np.array(part.geodesic_length)
        glen[4:] = np.nan
        save_spline_batch(dataclasses.replace(
            part, omega_optimized=omega, geodesic_length=glen), checkpoint)
    ranks = run_ranks(dp, ep, tmp_path, checkpoint)
    ref_leaves, ref_losses = _one_process_steps()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=1e-5)
        for i, ref in enumerate(ref_leaves):
            np.testing.assert_allclose(r[f"leaf{i}"], ref, rtol=1e-5,
                                       atol=1e-6)
        for k in r:
            np.testing.assert_array_equal(r[k], ranks[0][k], k)
    if dp == 2:
        plain = train_evae_multiseed(train_data(), SEEDS, TRAIN_CFG,
                                     TRAIN_MODEL, log_every=0,
                                     block_epochs=2, device="cpu")
        for s in SEEDS:
            np.testing.assert_array_equal(ranks[0][f"tl{s}"],
                                          plain[s].train_losses)
            np.testing.assert_array_equal(ranks[0][f"vl{s}"],
                                          plain[s].val_losses)
            for i, x in enumerate(tree_leaves(plain[s].params)):
                np.testing.assert_array_equal(ranks[0][f"p{s}_{i}"],
                                              x.numpy())
        # the resumed first chunk is the checkpoint's; the rest recomputed
        np.testing.assert_array_equal(ranks[0]["opt_omega"][:4],
                                      full.omega_optimized[:4])
        np.testing.assert_allclose(ranks[0]["opt_len"], full.geodesic_length,
                                   rtol=1e-5)


def test_multiseed_mesh_needs_whole_seeds_per_rank():
    with pytest.raises(ValueError, match="do not divide over dp"):
        train_evae_multiseed(train_data(), [3, 7, 11], TRAIN_CFG,
                             TRAIN_MODEL, log_every=0, device="cpu",
                             mesh=dataclasses.replace(make_mesh(1, 1), dp=2))


# ------------------------------------------------ optimize-stage resume ---

def test_optimize_stage_resume(tmp_path, legacy_vae):
    """Interrupted after its first chunk (the rest at omega_init, lengths
    NaN, as the snapshot after chunk 1 holds them), a re-run resumes: the
    finished chunk untouched, the artifact equal to the uninterrupted one
    bit for bit."""
    art = _vae_art(6)
    path = str(tmp_path / "opt.npz")
    cfg = _small_cfg(steps=20, batch_size=3,
                     energy={"mode": "single", "num_t": 48})
    full = optimize_spline_batch(legacy_vae, art, cfg=cfg, device="cpu",
                                 checkpoint_path=path, log_every_chunk=False)
    part = load_spline_batch(path)
    omega = np.array(part.omega_optimized)
    omega[3:] = art.omega_init[3:]
    glen = np.array(part.geodesic_length)
    glen[3:] = np.nan
    save_spline_batch(dataclasses.replace(part, omega_optimized=omega,
                                          geodesic_length=glen), path)
    resumed = optimize_spline_batch(legacy_vae, art, cfg=cfg, device="cpu",
                                    checkpoint_path=path,
                                    log_every_chunk=False)
    np.testing.assert_array_equal(resumed.omega_optimized,
                                  full.omega_optimized)
    np.testing.assert_array_equal(resumed.geodesic_length,
                                  full.geodesic_length)
    np.testing.assert_array_equal(load_spline_batch(path).geodesic_length,
                                  full.geodesic_length)


def test_mc_resume_repeats_the_uninterrupted_run(tmp_path, toy_problem):
    """Each chunk draws from a stream of its own (the run's seed and the
    chunk's first pair), so a resumed MC run equals the uninterrupted
    one."""
    dec = nets.stack_params([nets.decoder_init(
        torch.Generator().manual_seed(k), 2, 12, (24,)) for k in range(3)])

    class P:
        decoders = dec

    art = _toy_artifact(toy_problem)
    cfg = _small_cfg(steps=15, batch_size=2, energy={"mode": "mc",
                                                     "num_t": 32})
    path = str(tmp_path / "mc.npz")
    gen = torch.Generator().manual_seed(5)
    full = optimize_spline_batch(P, art, cfg=cfg, device="cpu",
                                 checkpoint_path=path, generator=gen,
                                 log_every_chunk=False)
    part = load_spline_batch(path)
    glen = np.array(part.geodesic_length)
    glen[2:] = np.nan
    save_spline_batch(dataclasses.replace(part, geodesic_length=glen), path)
    resumed = optimize_spline_batch(P, art, cfg=cfg, device="cpu",
                                    checkpoint_path=path, generator=gen,
                                    log_every_chunk=False)
    np.testing.assert_array_equal(resumed.omega_optimized,
                                  full.omega_optimized)


def test_async_checkpointer_survives_transient_write_failure():
    calls = []

    def flaky(item):
        calls.append(item)
        if item == "bad":
            raise OSError("disk momentarily full")

    s = _AsyncCheckpointer(flaky)
    s.submit("bad")
    assert isinstance(s.close(), OSError)
    s2 = _AsyncCheckpointer(flaky)
    s2.submit("bad")
    import time
    time.sleep(0.2)          # let the failing write land first
    s2.submit("good")
    assert s2.close() is None


def test_resume_ignores_checkpoint_from_different_config(tmp_path, capsys,
                                                         legacy_vae):
    art = _vae_art(6, seed=1)
    path = str(tmp_path / "opt.npz")
    optimize_spline_batch(legacy_vae, art, cfg=_small_cfg(
        steps=20, batch_size=3, energy={"mode": "single", "num_t": 48}),
        device="cpu", checkpoint_path=path, log_every_chunk=False)
    cfg_b = _small_cfg(steps=40, batch_size=3,
                       energy={"mode": "single", "num_t": 48})
    res_b = optimize_spline_batch(legacy_vae, art, cfg=cfg_b, device="cpu",
                                  checkpoint_path=path, log_every_chunk=True)
    assert "different config" in capsys.readouterr().err
    fresh = optimize_spline_batch(legacy_vae, art, cfg=cfg_b, device="cpu")
    np.testing.assert_array_equal(res_b.geodesic_length,
                                  fresh.geodesic_length)


def test_resume_counts_invalid_pairs_as_done(tmp_path, capsys, legacy_vae):
    valid = np.ones(6, bool)
    valid[4] = False
    art = _vae_art(6, valid=valid, seed=2)
    path = str(tmp_path / "opt.npz")
    optimize_spline_batch(legacy_vae, art, cfg=SINGLE, device="cpu",
                          checkpoint_path=path, log_every_chunk=False)
    res = optimize_spline_batch(legacy_vae, art, cfg=SINGLE, device="cpu",
                                checkpoint_path=path, log_every_chunk=True)
    out = capsys.readouterr().out
    assert "[resume] 6/6 splines already optimized" in out
    assert "[chunk" not in out
    assert np.isnan(res.geodesic_length[4])


def test_resume_without_data_keeps_stored_euclidean(tmp_path, legacy_vae):
    art = _vae_art(6, seed=3)
    path = str(tmp_path / "opt.npz")
    optimize_spline_batch(legacy_vae, art, cfg=SINGLE, device="cpu",
                          checkpoint_path=path, log_every_chunk=False)
    prev = load_spline_batch(path)
    eucl = np.arange(6, dtype=np.float32)
    glen = np.array(prev.geodesic_length)
    glen[3:] = np.nan
    save_spline_batch(dataclasses.replace(prev, euclidean_distance=eucl,
                                          geodesic_length=glen), path)
    res = optimize_spline_batch(legacy_vae, art, cfg=SINGLE, device="cpu",
                                checkpoint_path=path, data=None,
                                log_every_chunk=False)
    np.testing.assert_array_equal(res.euclidean_distance, eucl)


def test_resume_ignores_same_steps_different_recipe(tmp_path, capsys,
                                                    legacy_vae):
    art = _vae_art(6, seed=4)
    path = str(tmp_path / "opt.npz")
    plain = _small_cfg(steps=12, batch_size=3,
                       energy={"mode": "single", "num_t": 48})
    optimize_spline_batch(legacy_vae, art, cfg=plain, device="cpu",
                          checkpoint_path=path, log_every_chunk=False)
    ladder = dataclasses.replace(plain, phase_plan=(
        (8, 32, "cosine", 1e-2), (4, 48, "constant", 1e-3)))
    optimize_spline_batch(legacy_vae, art, cfg=ladder, device="cpu",
                          checkpoint_path=path, log_every_chunk=True)
    assert "different config" in capsys.readouterr().err


def test_optimize_stage_ignores_unstamped_checkpoint(tmp_path, capsys,
                                                     legacy_vae):
    art = _vae_art(4, seed=5)
    path = str(tmp_path / "opt.npz")
    cfg = _small_cfg(steps=15, batch_size=4,
                     energy={"mode": "single", "num_t": 48})
    full = optimize_spline_batch(legacy_vae, art, cfg=cfg, device="cpu",
                                 checkpoint_path=path, log_every_chunk=False)
    loaded = load_spline_batch(path)
    meta = {k: v for k, v in loaded.metadata.items()
            if k not in ("steps", "energy_mode", "num_t", "mc_samples",
                         "recipe")}
    save_spline_batch(dataclasses.replace(
        loaded, omega_optimized=np.full_like(loaded.omega_optimized, 7.0),
        geodesic_length=np.full_like(loaded.geodesic_length, 99.0),
        metadata=meta), path)
    res = optimize_spline_batch(legacy_vae, art, cfg=cfg, device="cpu",
                                checkpoint_path=path, log_every_chunk=False)
    assert "cannot be validated" in capsys.readouterr().err
    np.testing.assert_array_equal(res.geodesic_length, full.geodesic_length)


def test_resume_ignores_checkpoint_from_different_inputs(tmp_path, capsys,
                                                         toy_problem):
    dec = toy_problem[0]
    art = _toy_artifact(toy_problem)
    cfg = _small_cfg(steps=25, energy={"mode": "single", "num_t": 64})
    path = str(tmp_path / "resume.npz")
    optimize_spline_batch(dec, art, cfg=cfg, device="cpu",
                          checkpoint_path=path, log_every_chunk=False)
    art2 = dataclasses.replace(art, a=np.asarray(art.a) + 0.37)
    res2 = optimize_spline_batch(dec, art2, cfg=cfg, device="cpu",
                                 checkpoint_path=path, log_every_chunk=False)
    assert "different config" in capsys.readouterr().err
    fresh = optimize_spline_batch(dec, art2, cfg=cfg, device="cpu",
                                  log_every_chunk=False)
    np.testing.assert_array_equal(res2.geodesic_length, fresh.geodesic_length)


def test_resume_stamp_ignores_result_neutral_fields(tmp_path, capsys,
                                                    toy_problem):
    dec = toy_problem[0]
    art = _toy_artifact(toy_problem)
    cfg_on = _small_cfg(steps=25, energy={"mode": "single", "num_t": 64})
    cfg_off = dataclasses.replace(cfg_on, energy=dataclasses.replace(
        cfg_on.energy, gradonly_traj=False))
    assert _recipe_stamp(cfg_on) == _recipe_stamp(cfg_off)
    assert "gradonly_traj" not in _recipe_stamp(cfg_on)
    path = str(tmp_path / "resume.npz")
    res1 = optimize_spline_batch(dec, art, cfg=cfg_on, device="cpu",
                                 checkpoint_path=path, log_every_chunk=False)
    capsys.readouterr()
    res2 = optimize_spline_batch(dec, art, cfg=cfg_off, device="cpu",
                                 checkpoint_path=path, log_every_chunk=True)
    err = capsys.readouterr().err
    assert "different config" not in err and "cannot be validated" not in err
    np.testing.assert_array_equal(res1.geodesic_length, res2.geodesic_length)


# ---------------------------------------------------------- early stop ---

def test_early_stopping_not_worse_than_fixed(toy_problem):
    dec, a, b, basis, omega0, _ = toy_problem
    cfg = _small_cfg(steps=150, patience=30, delta=1e-6,
                     energy={"mode": "single", "num_t": 128})
    res_es = optimize_spline_early_stopping(dec, omega0, a, b, basis, cfg,
                                            device="cpu")
    res_fix = optimize_splines(dec, omega0, a, b, basis, cfg, device="cpu")
    assert (res_es.energy <= res_fix.energy * 1.05 + 1e-6).all()


@pytest.mark.parametrize("recipe", [
    {"traj_num_t": 32, "polish_steps": 5},
    {"phase_plan": ((10, 32, "constant", 1e-2),)}], ids=["two_phase", "plan"])
def test_early_stop_and_fast_recipes_mutually_exclusive(toy_problem, recipe):
    dec, a, b, basis, omega0, _ = toy_problem
    cfg = _small_cfg(steps=10, early_stop=True,
                     energy={"mode": "single", "num_t": 64}, **recipe)
    with pytest.raises(ValueError, match="mutually exclusive"):
        optimize_spline_batch(dec, _toy_artifact(toy_problem), cfg=cfg,
                              device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        optimize_spline_early_stopping(dec, omega0, a, b, basis, cfg,
                                       device="cpu")


def test_early_stop_restores_the_params_that_achieved_best_energy(
        toy_problem):
    """Two steps: step 1 evaluates omega_1 (the only possible improvement
    event) and moves to omega_2; the restored energy is E(omega_1)."""
    dec, a, b, basis, omega0, _ = toy_problem
    kw = dict(lr=2e-2, patience=100, energy={"mode": "single", "num_t": 64})
    e1 = optimize_splines(dec, omega0, a, b, basis, _small_cfg(steps=1, **kw),
                          device="cpu").energy.numpy()
    e2 = optimize_splines(dec, omega0, a, b, basis, _small_cfg(steps=2, **kw),
                          device="cpu").energy.numpy()
    t = t_grid(64)
    e0 = E.energy_single(dec, eval_spline_design(
        torch.tensor(omega0), torch.tensor(a), torch.tensor(b),
        design_matrix(t, basis, 4), t)).numpy()
    improved = e1 < e0 * (1.0 - 1e-6)
    assert improved.any()
    assert (np.abs(e2 - e1)[improved] > 20e-5 * e1[improved]).all()
    res = _optimize_early_stop(dec, omega0, a, b, basis,
                               _small_cfg(steps=2, **kw), block=2,
                               device="cpu")
    np.testing.assert_allclose(res.energy.numpy(), np.where(improved, e1, e0),
                               rtol=1e-5)
    assert res.steps_run == 2


def test_early_stop_step_budget_is_exact(toy_problem):
    dec, a, b, basis, omega0, _ = toy_problem
    kw = dict(lr=1e-2, patience=10_000, delta=1e-12,
              energy={"mode": "single", "num_t": 64})
    cfg = _small_cfg(steps=120, **kw)
    r50 = _optimize_early_stop(dec, omega0, a, b, basis, cfg, block=50,
                               device="cpu")
    r40 = _optimize_early_stop(dec, omega0, a, b, basis, cfg, block=40,
                               device="cpu")
    assert r50.steps_run == r40.steps_run == 120
    assert torch.equal(r50.omega, r40.omega)
    assert torch.equal(r50.energy, r40.energy)
    r150 = _optimize_early_stop(dec, omega0, a, b, basis,
                                _small_cfg(steps=150, **kw), block=50,
                                device="cpu")
    assert not torch.allclose(r150.energy, r50.energy, rtol=1e-7)


def _jax_stop_step(energies, steps, patience, delta, block=50):
    """The step JAX's early stop ends at, from its per-step energies (the
    value at each step's omega before its update) and e0."""
    best = energies[0].astype(np.float32)
    pat = np.zeros(len(best), np.int64)
    step = 0
    while step < steps and pat.min() <= patience:
        for i in range(step, min(step + block, steps)):
            e = energies[i]
            improved = (best - e) / best > np.float32(delta)
            best = np.where(improved, e, best)
            pat = np.where(improved, 0, pat + 1)
        step = min(step + block, steps)
    return step


def test_early_stop_matches_jax_in_a_deterministic_mode(toy_problem):
    dec, a, b, basis, omega0, jdec = toy_problem
    kw = dict(steps=400, lr=1e-2, patience=40, delta=1e-4)
    cfg = _small_cfg(**kw, energy={"mode": "single", "num_t": 64,
                                   "kernel_precision": "float32"})
    jcfg = JGeo(**kw, energy=JEnergy(mode="single", num_t=64,
                                     kernel_precision="float32"))
    port = optimize_spline_early_stopping(dec, omega0, a, b, basis, cfg,
                                          device="cpu")
    ref = jgeo.optimize_spline_early_stopping(
        jdec, jnp.asarray(omega0), jnp.asarray(a), jnp.asarray(b), basis,
        jcfg)
    hist = np.asarray(jgeo.optimize_splines(
        jdec, jnp.asarray(omega0), jnp.asarray(a), jnp.asarray(b), basis,
        jcfg, record_history=True).energy_history)
    stop = _jax_stop_step(hist, kw["steps"], kw["patience"], kw["delta"])
    assert 0 < stop < kw["steps"]        # it does stop early
    assert port.steps_run == stop
    np.testing.assert_allclose(port.omega.numpy(), np.asarray(ref.omega),
                               atol=1e-4)
    np.testing.assert_allclose(port.energy.numpy(), np.asarray(ref.energy),
                               rtol=1e-4)


@pytest.mark.parametrize("direct", [False, True],
                         ids=["optimize_spline_batch", "sharded"])
def test_early_stop_rejected_on_mesh(toy_problem, direct):
    dec, a, b, basis, omega0, _ = toy_problem
    cfg = _small_cfg(steps=5, early_stop=True,
                     energy={"mode": "single", "num_t": 32})
    with pytest.raises(ValueError, match="not supported on a sharded"):
        if direct:
            sharded_optimize_splines(dec, omega0, a, b, basis, cfg,
                                     make_mesh(1, 1), device="cpu")
        else:
            optimize_spline_batch(dec, _toy_artifact(toy_problem), cfg=cfg,
                                  device="cpu", mesh=make_mesh(1, 1))


def test_early_stop_through_the_stage(toy_problem):
    """``cfg.early_stop`` in the stage: the restored curves, their exact
    single-decoder lengths."""
    dec = toy_problem[0]
    art = _toy_artifact(toy_problem)
    cfg = _small_cfg(steps=100, patience=20, delta=1e-5, early_stop=True,
                     batch_size=4, energy={"mode": "single", "num_t": 64})
    res = optimize_spline_batch(dec, art, cfg=cfg, device="cpu",
                                log_every_chunk=False)
    direct = optimize_spline_early_stopping(
        dec, art.omega_init, art.a, art.b, art.basis, cfg, device="cpu",
        generator=torch.Generator().manual_seed(
            stage.fold_seed(0, 0)))
    np.testing.assert_array_equal(res.omega_optimized, direct.omega.numpy())


# ----------------------------------------------------- merge, backstop ---

def test_merge_spline_batches_takes_per_pair_best(toy_problem):
    art = _toy_artifact(toy_problem)
    B = len(art.a)
    l1 = np.array([1.0, 2.0, np.nan, 4.0])
    l2 = np.array([1.5, 1.0, 3.0, np.nan])
    om1 = np.full((B, art.basis.shape[1], 2), 1.0, np.float32)
    om2 = np.full((B, art.basis.shape[1], 2), 2.0, np.float32)
    m = merge_spline_batches(
        dataclasses.replace(art, omega_optimized=om1, geodesic_length=l1),
        dataclasses.replace(art, omega_optimized=om2, geodesic_length=l2))
    np.testing.assert_array_equal(m.geodesic_length, [1.0, 1.0, 3.0, 4.0])
    np.testing.assert_array_equal(m.omega_optimized[:, 0, 0],
                                  [1.0, 2.0, 2.0, 1.0])
    assert m.metadata["backstop_selected"] == 2


def test_merge_spline_batches_rejects_mismatched_or_unoptimized(toy_problem):
    art = _toy_artifact(toy_problem)
    B = len(art.a)
    opt = dataclasses.replace(
        art, omega_optimized=np.zeros((B, art.basis.shape[1], 2), np.float32),
        geodesic_length=np.ones(B))
    with pytest.raises(ValueError, match="OPTIMIZED"):
        merge_spline_batches(opt, art)
    with pytest.raises(ValueError, match="same pair set"):
        merge_spline_batches(opt, dataclasses.replace(
            opt, pair_indices=opt.pair_indices + 1))
    with pytest.raises(ValueError, match="'a'"):
        merge_spline_batches(opt, dataclasses.replace(
            opt, a=np.asarray(opt.a) + 0.1, geodesic_length=np.full(B, 0.5)))
    with pytest.raises(ValueError, match="'basis'"):
        merge_spline_batches(opt, dataclasses.replace(
            opt, basis=np.asarray(opt.basis) * 2.0))


def test_backstop_dominates_both_arms(toy_problem):
    dec, a, b, basis, _, _ = toy_problem
    art = _toy_artifact(toy_problem)
    primary = _small_cfg(steps=60, energy={"mode": "single", "num_t": 128},
                         phase_plan=((60, 32, "cosine", 3e-2),
                                     (10, 128, "constant", 1e-2)))
    backstop = _small_cfg(steps=80, lr=1e-2,
                          energy={"mode": "single", "num_t": 128})
    r1 = optimize_spline_batch(dec, art, cfg=primary, device="cpu",
                               log_every_chunk=False)
    r2 = optimize_spline_batch(dec, art, cfg=backstop, device="cpu",
                               log_every_chunk=False)
    merged = optimize_spline_batch_backstop(dec, art, cfg=primary,
                                            backstop_cfg=backstop,
                                            device="cpu",
                                            log_every_chunk=False)
    lm = merged.geodesic_length
    np.testing.assert_array_equal(lm, np.minimum(r1.geodesic_length,
                                                 r2.geodesic_length))
    t = t_grid(128)
    gamma = eval_spline_design(torch.tensor(merged.omega_optimized),
                               torch.tensor(a), torch.tensor(b),
                               design_matrix(t, basis, 4), t)
    np.testing.assert_allclose(lm, E.geodesic_lengths(dec, gamma).numpy(),
                               rtol=1e-5)


def test_backstop_checkpoints_three_artifacts(toy_problem, tmp_path):
    dec = toy_problem[0]
    art = _toy_artifact(toy_problem)
    ck = tmp_path / "opt.npz"
    merged = optimize_spline_batch_backstop(
        dec, art, cfg=_small_cfg(steps=20,
                                 energy={"mode": "single", "num_t": 64}),
        backstop_cfg=_small_cfg(steps=30, lr=1e-2,
                                energy={"mode": "single", "num_t": 64}),
        device="cpu", checkpoint_path=str(ck), log_every_chunk=False)
    assert ck.exists()
    assert (tmp_path / "opt.primary.npz").exists()
    assert (tmp_path / "opt.backstop.npz").exists()
    np.testing.assert_array_equal(load_spline_batch(str(ck)).geodesic_length,
                                  merged.geodesic_length)


def test_backstop_identical_configs_runs_one_arm(toy_problem, monkeypatch):
    dec = toy_problem[0]
    art = _toy_artifact(toy_problem)
    calls = []
    real = stage.optimize_spline_batch

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(stage, "optimize_spline_batch", counting)
    cfg = _small_cfg(steps=20, energy={"mode": "single", "num_t": 64})
    merged = stage.optimize_spline_batch_backstop(
        dec, art, cfg=cfg, backstop_cfg=cfg, device="cpu",
        log_every_chunk=False)
    assert len(calls) == 1
    assert merged.metadata["backstop_selected"] == 0
    assert np.isfinite(merged.geodesic_length).all()


def test_backstop_mc_modes_compare_noise_free(toy_problem):
    dec = nets.stack_params([nets.decoder_init(
        torch.Generator().manual_seed(k), 2, 12, (24,)) for k in range(3)])

    class P:
        decoders = dec

    art = _toy_artifact(toy_problem)
    primary = _small_cfg(steps=25, lr=2e-2,
                         energy={"mode": "mc", "num_t": 64})
    backstop = _small_cfg(steps=40, lr=5e-3,
                          energy={"mode": "mc", "num_t": 64})
    merged = optimize_spline_batch_backstop(
        P, art, cfg=primary, backstop_cfg=backstop, device="cpu",
        log_every_chunk=False)
    assert '"final_energy_mode": "expected_fused"' in merged.metadata["recipe"]
    r1, r2 = (optimize_spline_batch(
        P, art, cfg=dataclasses.replace(c, final_energy_mode="expected_fused"),
        device="cpu", log_every_chunk=False) for c in (primary, backstop))
    np.testing.assert_array_equal(merged.geodesic_length,
                                  np.minimum(r1.geodesic_length,
                                             r2.geodesic_length))
    with pytest.warns(UserWarning, match="noise scale"):
        optimize_spline_batch_backstop(
            P, art, cfg=dataclasses.replace(primary, final_energy_mode="mc"),
            backstop_cfg=backstop, device="cpu", log_every_chunk=False)


# ------------------------------------------------------------------ CLI ---

def _cli(*args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "vae_latent_geometry_tpu_torch",
                        *args], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_cli_train_and_train_single_resume(tmp_path):
    data = ["--data-dir", str(tmp_path / "no_data"), "--device", "cpu"]
    common = [*data, "--batch-size", "4096", "--num-decoders", "2",
              "--save-dir", str(tmp_path / "out"),
              "--train-state", str(tmp_path / "state.npz")]
    _cli("train", *common, "--epochs", "1", "--seeds", "1", "2",
         cwd=tmp_path)
    out = _cli("train", *common, "--epochs", "2", "--seeds", "1", "2",
               cwd=tmp_path)
    assert "[resume]" in out and "restored at epoch 1" in out
    for s in (1, 2):
        assert np.load(tmp_path / "out" / f"train_losses_seed{s}.npy"
                       ).shape == (2,)
        p = evae.load_npz(str(tmp_path / "out" / f"model_seed{s}.npz"), "cpu")
        assert evae.num_members(p.decoders) == 2
        meta = ckpt.read_meta(str(tmp_path / "out" / f"model_seed{s}.npz"))
        assert meta["seed"] == s and meta["epochs"] == 2
    _cli("train-single", *data, "--batch-size", "4096", "--epochs", "2",
         "--save-dir", str(tmp_path / "single"), cwd=tmp_path)
    best = tmp_path / "single" / "vae_best_seed12.npz"
    tree, meta = ckpt.load_tree(str(best))
    assert meta["model_config"]["heteroscedastic"] is True
    assert tree["decoder"]["layers"][-1]["w"].shape == (128, 100)


def test_cli_optimize_early_stop_backstop_and_resume(tmp_path):
    art = load_spline_batch(INIT)
    keep = np.arange(6)
    small = dataclasses.replace(
        art, a=art.a[keep], b=art.b[keep], omega_init=art.omega_init[keep],
        pair_indices=art.pair_indices[keep], valid=art.valid[keep],
        pair_labels=[art.pair_labels[i] for i in keep])
    splines = str(tmp_path / "init.npz")
    save_spline_batch(small, splines)
    common = ["optimize", "--model", MODEL, "--splines", splines,
              "--device", "cpu", "--no-euclidean", "--num-t", "32",
              "--batch-size", "3", "--energy-mode", "expected"]
    es = str(tmp_path / "es.npz")
    out = _cli(*common, "--early-stop", "--steps", "60", "--output", es,
               cwd=tmp_path)
    assert "[chunk 2/2]" in out
    res = load_spline_batch(es)
    assert json.loads(res.metadata["recipe"])["early_stop"] is True
    assert np.isfinite(res.geodesic_length).all()
    out = _cli(*common, "--early-stop", "--steps", "60", "--output", es,
               cwd=tmp_path)
    assert "[resume] 6/6 splines already optimized" in out
    assert "[chunk" not in out
    np.testing.assert_array_equal(load_spline_batch(es).geodesic_length,
                                  res.geodesic_length)
    bk = str(tmp_path / "bk.npz")
    out = _cli(*common, "--steps", "30", "--lr", "3e-3", "--lr-schedule",
               "cosine", "--backstop-fixed", "--output", bk, cwd=tmp_path)
    assert "fixed-recipe arm won on" in out
    merged = load_spline_batch(bk)
    for arm in ("primary", "backstop"):
        other = load_spline_batch(str(tmp_path / f"bk.{arm}.npz"))
        assert (merged.geodesic_length <= other.geodesic_length).all()
