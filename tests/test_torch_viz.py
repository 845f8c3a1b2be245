"""The port's figures (``viz/plotting.py``): every plot function writes its
PNG, the device functions ``kde_density`` and ``pullback_metrics`` match
the JAX package's at rtol 1e-5, and the CLI's ``plot`` refuses
``uncertainty`` on a single-decoder model."""

import numpy as np
import pytest
import torch

import tests.torch_parity_inputs  # noqa: F401  (one torch thread)
from vae_latent_geometry_tpu.viz import plotting as jplot
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
from vae_latent_geometry_tpu_torch.viz import plotting

RTOL = 1e-5


@pytest.fixture(scope="module")
def art():
    rng = np.random.default_rng(0)
    basis, _ = nullspace_basis(4)
    P = 5
    return SplineBatchArtifact(
        a=rng.normal(size=(P, 2)).astype(np.float32),
        b=rng.normal(size=(P, 2)).astype(np.float32),
        omega_init=(rng.normal(size=(P, 5, 2)) * 0.1).astype(np.float32),
        basis=basis, n_poly=4,
        pair_indices=np.arange(2 * P).reshape(P, 2),
        valid=np.array([True] * 4 + [False]),
        pair_labels=[["a", "b"]] * P,
        representatives=[{"index": i, "label": f"c{i}"} for i in range(4)],
        omega_optimized=(rng.normal(size=(P, 5, 2)) * 0.1).astype(np.float32),
        geodesic_length=np.ones(P, np.float32))


@pytest.fixture(scope="module")
def latents():
    return np.random.default_rng(1).normal(size=(300, 2)).astype(np.float32)


def _check(path):
    assert path.exists() and path.stat().st_size > 1000


def _small_evae(members=3):
    from vae_latent_geometry_tpu_torch.config import ModelConfig
    from vae_latent_geometry_tpu_torch.models.evae import evae_init

    p = evae_init(torch.Generator().manual_seed(0),
                  ModelConfig(input_dim=8, num_decoders=members,
                              encoder_hidden=(8,), decoder_hidden=(8,)),
                  device="cpu")
    g = torch.Generator().manual_seed(1)
    for lyr in p.decoders["layers"]:       # members start as copies
        lyr["w"] += 0.1 * torch.randn(lyr["w"].shape, generator=g)
    return p


def test_density_with_splines(tmp_path, art, latents):
    labels = np.array([f"c{i % 5}" for i in range(len(latents))])
    out = tmp_path / "density.png"
    plotting.plot_latent_density_with_splines(latents, labels, art, str(out),
                                              res=40, seed=3, device="cpu")
    _check(out)


def test_latents_with_selected(tmp_path, art, latents):
    out = tmp_path / "latents.png"
    plotting.plot_latents_with_selected(latents, art.representatives,
                                        str(out))
    _check(out)


def test_init_and_both_splines(tmp_path, art, latents):
    out1, out2 = tmp_path / "init.png", tmp_path / "both.png"
    plotting.plot_initialized_splines(latents, art, str(out1))
    plotting.plot_initial_and_optimized_splines(latents, art, str(out2))
    _check(out1)
    _check(out2)


def test_uncertainty_map(tmp_path, latents):
    out = tmp_path / "unc.png"
    plotting.plot_uncertainty_map(_small_evae(), latents, str(out),
                                  resolution=20)
    _check(out)


def test_metric_ellipses(tmp_path):
    from vae_latent_geometry_tpu_torch.models import nets

    dec = nets.decoder_init(torch.Generator().manual_seed(1), 2, 6, (8,))
    path = np.random.default_rng(2).normal(size=(60, 2)).astype(np.float32)
    G = plotting.pullback_metrics(dec, path)
    assert G.shape == (60, 2, 2)
    assert (np.linalg.eigvalsh(G) > -1e-5).all()
    plt = plotting._plt()
    fig, ax = plt.subplots()
    plotting.plot_metric_ellipses(ax, path, G, every=10)
    out = tmp_path / "ell.png"
    fig.savefig(out)
    plt.close(fig)
    _check(out)


def test_loss_cov_curves_and_hist(tmp_path):
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import CovResult

    out = tmp_path / "loss.png"
    plotting.plot_loss_curves(np.linspace(3, 1, 10),
                              np.linspace(3.2, 1.2, 10), str(out))
    _check(out)
    cov = CovResult(
        avg_cov_geodesic={1: 0.2, 2: 0.1}, avg_cov_euclidean=0.25,
        raw_cov_geodesic={1: np.array([0.2]), 2: np.array([0.1])},
        raw_cov_euclidean=np.array([0.25]),
        lengths=np.ones((2, 1, 2)), euclidean=np.ones((2, 1)),
        seeds=[1, 2], decoder_counts=[1, 2])
    out2 = tmp_path / "cov.png"
    plotting.plot_cov_curves(cov, str(out2))
    _check(out2)
    out3 = tmp_path / "cov_hist.png"
    plotting.plot_cov_hist(np.random.default_rng(1).normal(0.1, 0.05, 45)
                           .clip(0.001), str(out3))
    _check(out3)


def test_distance_heatmap(tmp_path):
    out = tmp_path / "mat.png"
    plotting.plot_distance_matrix(np.random.default_rng(0).random((6, 6)),
                                  [f"c{i}" for i in range(6)], str(out),
                                  "test")
    _check(out)


def test_density_illustration(tmp_path, art, latents):
    out = tmp_path / "illustration.png"
    colors = np.array(["#ff0000", "#00ff00"] * (len(latents) // 2))
    plotting.plot_density_illustration(latents, art, str(out),
                                       point_colors=colors, res=40, seed=12,
                                       device="cpu")
    _check(out)


def test_kde_density_matches_jax(latents):
    xlim, ylim = plotting._square_limits(latents)
    xi, yi = np.mgrid[xlim[0]:xlim[1]:60j, ylim[0]:ylim[1]:60j]
    grid = np.stack([xi.ravel(), yi.ravel()], axis=-1).astype(np.float32)
    got = plotting.kde_density(latents, grid, chunk=1000, device="cpu")
    want = jplot.kde_density(latents, grid)
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_pullback_metrics_match_jax():
    import jax.numpy as jnp

    from vae_latent_geometry_tpu_torch.models import nets

    dec = nets.decoder_init(torch.Generator().manual_seed(4), 2, 50,
                            (128, 128))
    z = np.random.default_rng(3).normal(size=(300, 2)).astype(np.float32)
    got = plotting.pullback_metrics(dec, z)
    want = jplot.pullback_metrics(
        {"layers": [{k: jnp.asarray(v.numpy()) for k, v in l.items()}
                    for l in dec["layers"]]}, z)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    assert float((np.abs(got - want) / scale).max()) <= RTOL
    np.testing.assert_allclose(np.diagonal(got, axis1=1, axis2=2),
                               np.diagonal(want, axis1=1, axis2=2), rtol=RTOL)


def test_plot_cli_refuses_uncertainty_on_single_vae(tmp_path):
    from vae_latent_geometry_tpu_torch.cli import main
    from vae_latent_geometry_tpu_torch.config import to_dict
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree
    from vae_latent_geometry_tpu_torch.models.vae import LEGACY_CONFIG, vae_init

    path = str(tmp_path / "vae_best_seed5.npz")
    save_pytree(vae_init(torch.Generator().manual_seed(0), device="cpu"),
                path, extra_meta={"model_config": to_dict(LEGACY_CONFIG)})
    with pytest.raises(SystemExit, match="needs an EVAE checkpoint"):
        main(["plot", "uncertainty", "--device", "cpu", "--model", path,
              "--output", str(tmp_path / "u.png")])
    with pytest.raises(SystemExit, match="requires --splines"):
        main(["plot", "density", "--device", "cpu", "--model", path])


def test_eval_matrix_cli_writes_its_heatmap(tmp_path):
    from tests.torch_parity_inputs import OPT
    from vae_latent_geometry_tpu_torch.cli import main

    out = tmp_path / "m.json"
    main(["eval", "--mode", "matrix", "--splines", OPT, "--output", str(out)])
    assert out.exists()
    _check(tmp_path / "m.png")
