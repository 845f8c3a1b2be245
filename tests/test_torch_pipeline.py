"""Pipeline of the PyTorch port vs the JAX package: artifacts in both
directions, ``optimize_spline_batch`` + ``distance_matrix``, and the CLI
``optimize`` -> ``eval --mode matrix`` on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.config import ModelConfig
from vae_latent_geometry_tpu.io import artifacts as jart
from vae_latent_geometry_tpu.io.checkpoint import load_pytree
from vae_latent_geometry_tpu.models.evae import evae_init
from vae_latent_geometry_tpu.pipeline import evaluate as jeval
from vae_latent_geometry_tpu.pipeline import optimize_stage as jstage
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
from vae_latent_geometry_tpu_torch.io import artifacts as tart
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.pipeline import evaluate as teval
from vae_latent_geometry_tpu_torch.pipeline import optimize_stage as tstage

from torch_parity_inputs import REPO, MODEL, INIT, OPT


def _first(art, n):
    return dataclasses.replace(
        art, a=art.a[:n], b=art.b[:n], omega_init=art.omega_init[:n],
        pair_indices=art.pair_indices[:n], valid=art.valid[:n],
        pair_labels=art.pair_labels[:n])


def _same(x, y):
    for f in ("a", "b", "omega_init", "basis", "pair_indices", "valid",
              "omega_optimized", "geodesic_length", "euclidean_distance"):
        u, v = getattr(x, f), getattr(y, f)
        assert (u is None) == (v is None), f
        if u is not None:
            np.testing.assert_array_equal(u, v, err_msg=f)
    assert x.n_poly == y.n_poly and x.pair_labels == y.pair_labels
    assert x.representatives == y.representatives
    assert x.metadata == y.metadata


@pytest.mark.parametrize("path", [INIT, OPT], ids=["init", "opt"])
def test_artifacts_cross_load(tmp_path, path):
    j = jart.load_spline_batch(path)
    t = tart.load_spline_batch(path)
    _same(t, j)
    tart.save_spline_batch(t, str(tmp_path / "from_torch.npz"))
    _same(jart.load_spline_batch(str(tmp_path / "from_torch.npz")), j)
    jart.save_spline_batch(j, str(tmp_path / "from_jax.npz"))
    _same(tart.load_spline_batch(str(tmp_path / "from_jax.npz")), t)


def test_optimize_stage_and_matrix_match_jax():
    """10 pairs in chunks of 8: the second chunk is edge-padded."""
    art_j = _first(jart.load_spline_batch(INIT), 10)
    art_t = _first(tart.load_spline_batch(INIT), 10)
    kw = dict(steps=5, lr=1e-3, batch_size=8)
    jcfg = JGeo(**kw, energy=JEnergy(num_t=32, mode="expected_fused",
                                     kernel_precision="f32x2"))
    tcfg = GeodesicConfig(**kw, energy=EnergyConfig(
        num_t=32, mode="expected_fused", kernel_precision="f32x2"))
    data = load_tasic().x
    jp, _ = load_pytree(MODEL, evae_init(jax.random.PRNGKey(0),
                                         ModelConfig()))
    ref = jstage.optimize_spline_batch(jp, art_j, data=data, cfg=jcfg,
                                       log_every_chunk=False)
    out = tstage.optimize_spline_batch(tevae.load_npz(MODEL, "cpu"), art_t,
                                       data=data, cfg=tcfg, device="cpu",
                                       log_every_chunk=False)
    np.testing.assert_allclose(out.geodesic_length, ref.geodesic_length,
                               rtol=1e-4)
    np.testing.assert_allclose(out.euclidean_distance, ref.euclidean_distance,
                               rtol=1e-4)
    np.testing.assert_allclose(out.omega_optimized, ref.omega_optimized,
                               rtol=1e-3, atol=1e-5)
    # the result carries the same config stamp as the JAX package's
    assert out.metadata == ref.metadata
    m_t, l_t = teval.distance_matrix(out)
    m_j, l_j = jeval.distance_matrix(ref)
    assert l_t == l_j
    np.testing.assert_allclose(m_t, m_j, rtol=1e-4)
    m_t, _ = teval.distance_matrix(out, "euclidean")
    m_j, _ = jeval.distance_matrix(ref, "euclidean")
    np.testing.assert_allclose(m_t, m_j, rtol=1e-4)


def test_distance_matrix_matches_jax_on_committed_artifact():
    m_t, l_t = teval.distance_matrix(tart.load_spline_batch(OPT))
    m_j, l_j = jeval.distance_matrix(jart.load_spline_batch(OPT))
    assert l_t == l_j
    np.testing.assert_array_equal(m_t, m_j)


def test_cli_optimize_then_eval_matrix(tmp_path):
    init = tmp_path / "init.npz"
    tart.save_spline_batch(_first(tart.load_spline_batch(INIT), 3), str(init))
    opt = tmp_path / "opt.npz"
    mat = tmp_path / "matrix.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "vae_latent_geometry_tpu_torch"]
    r = subprocess.run(base + [
        "optimize", "--device", "cpu", "--model", MODEL, "--splines",
        str(init), "--steps", "3", "--num-t", "32", "--no-euclidean",
        "--energy-mode", "expected_fused", "--output", str(opt)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    r = subprocess.run(base + ["eval", "--mode", "matrix", "--splines",
                               str(opt), "--output", str(mat)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(mat.read_text())
    n = len(out["cluster_ids"])
    assert n == 20 and len(out["distance_matrix"]) == n
    vals = [v for row in out["distance_matrix"] for v in row if v]
    assert len(vals) == 6 and all(np.isfinite(vals))
    art = jart.load_spline_batch(str(opt))   # the JAX package reads it
    assert art.metadata["energy_mode"] == "expected_fused"
    assert np.isfinite(art.geodesic_length).all()


def test_cli_optimize_mc_fused_then_eval_matrix(tmp_path):
    """The MC path end to end on the CPU: ``optimize --energy-mode mc_fused``
    (draws made as the kernels make them), ``eval --mode matrix``, and the
    JAX package reads the artifact; the same ``--seed`` reproduces it."""
    init = tmp_path / "init.npz"
    tart.save_spline_batch(_first(tart.load_spline_batch(INIT), 3), str(init))
    mat = tmp_path / "matrix.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "vae_latent_geometry_tpu_torch"]
    arts = []
    for name in ("opt.npz", "again.npz"):
        r = subprocess.run(base + [
            "optimize", "--device", "cpu", "--model", MODEL, "--splines",
            str(init), "--steps", "3", "--num-t", "32", "--no-euclidean",
            "--energy-mode", "mc_fused", "--seed", "7", "--output",
            str(tmp_path / name)],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        arts.append(jart.load_spline_batch(str(tmp_path / name)))
    r = subprocess.run(base + ["eval", "--mode", "matrix", "--splines",
                               str(tmp_path / "opt.npz"), "--output",
                               str(mat)],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(mat.read_text())
    vals = [v for row in out["distance_matrix"] for v in row if v]
    assert len(vals) == 6 and all(np.isfinite(vals))
    art = arts[0]                             # the JAX package reads it
    assert art.metadata["energy_mode"] == "mc_fused"
    assert art.metadata["mc_samples"] == 2
    assert np.isfinite(art.geodesic_length).all()
    assert not np.array_equal(art.omega_optimized, art.omega_init)
    np.testing.assert_array_equal(arts[1].omega_optimized,
                                  art.omega_optimized)
    np.testing.assert_array_equal(arts[1].geodesic_length,
                                  art.geodesic_length)
