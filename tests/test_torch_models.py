"""PyTorch port vs the JAX package: checkpoint reading, models, spline
geometry (CPU, seed-42 production weights and init blob)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.geometry import basis as jbasis
from vae_latent_geometry_tpu.geometry import spline as jspline
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch as jload
from vae_latent_geometry_tpu.io.checkpoint import load_pytree
from vae_latent_geometry_tpu.models import evae as jevae
from vae_latent_geometry_tpu.config import ModelConfig
from vae_latent_geometry_tpu_torch.geometry import basis as tbasis
from vae_latent_geometry_tpu_torch.geometry import spline as tspline
from vae_latent_geometry_tpu_torch.io.checkpoint import load_tree
from vae_latent_geometry_tpu_torch.models import evae as tevae

from torch_parity_inputs import MODEL, INIT


@pytest.fixture(scope="module")
def models():
    jp, _ = load_pytree(MODEL, jevae.evae_init(jax.random.PRNGKey(0),
                                               ModelConfig()))
    return jp, tevae.load_npz(MODEL, "cpu")


def test_checkpoint_tree_matches_jax_layout(models):
    jp, _ = models
    tree, meta = load_tree(MODEL)
    assert meta["model_config"]["num_decoders"] == 10
    for i in range(3):
        np.testing.assert_array_equal(tree["decoders"]["layers"][i]["w"],
                                      np.asarray(jp.decoders["layers"][i]["w"]))
    assert tree["decoders"]["layers"][1]["w"].shape == (10, 128, 128)
    assert len(tree["encoder"]["norms"]) == 2


def test_from_jax_params_takes_the_jax_tree(models):
    jp, tp = models
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    again = tevae.from_jax_params(np_tree, "cpu")
    for a, b in zip(again.decoders["layers"], tp.decoders["layers"]):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_decode_all_matches_jax(models):
    jp, tp = models
    z = np.random.default_rng(0).normal(size=(16, 5, 2)).astype(np.float32) * 2
    ref = np.asarray(jevae.decode_all(jp.decoders, jnp.asarray(z)))
    out = tevae.decode_all(tp.decoders, torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (10, 16, 5, 50)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_encode_matches_jax(models):
    jp, tp = models
    x = np.random.default_rng(1).normal(size=(64, 50)).astype(np.float32) * 20
    rm, rs = (np.asarray(v) for v in jevae.encode(jp, jnp.asarray(x)))
    tm, ts = (v.numpy() for v in tevae.encode(tp, torch.from_numpy(x)))
    np.testing.assert_allclose(tm, rm, rtol=1e-5, atol=1e-5 * np.abs(rm).max())
    np.testing.assert_allclose(ts, rs, rtol=1e-5, atol=1e-5 * np.abs(rs).max())


@pytest.mark.parametrize("n_poly", [2, 4, 6])
def test_nullspace_basis_matches_jax(n_poly):
    tb, tc = tbasis.nullspace_basis(n_poly)
    jb, jc = jbasis.nullspace_basis(n_poly)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tc, jc)


def test_nullspace_basis_matches_blob():
    art = jload(INIT)
    tb, _ = tbasis.nullspace_basis(art.n_poly)
    np.testing.assert_allclose(tb, art.basis, atol=1e-6)


@pytest.mark.parametrize("T", [2, 64, 256, 2000])
def test_t_grid_is_jnp_linspace(T):
    np.testing.assert_array_equal(tspline.t_grid(T).numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, T)))


def test_design_matrix_and_eval_match_jax():
    art = jload(INIT)
    T, B = 2000, 8
    t = tspline.t_grid(T)
    phi = tspline.design_matrix(t, art.basis, art.n_poly)
    jt = jnp.linspace(0.0, 1.0, T)
    jphi = jspline.design_matrix(jt, jnp.asarray(art.basis), art.n_poly)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), rtol=1e-6,
                               atol=1e-6)
    om, a, b = art.omega_init[:B], art.a[:B], art.b[:B]
    g = tspline.eval_spline_design(torch.from_numpy(om), torch.from_numpy(a),
                                   torch.from_numpy(b), phi, t).numpy()
    jg = np.asarray(jspline.eval_spline_design(
        jnp.asarray(om), jnp.asarray(a), jnp.asarray(b), jphi, jt))
    np.testing.assert_allclose(g, jg, rtol=1e-6, atol=1e-6 * np.abs(jg).max())
    # endpoints are exact: the basis enforces offset(0) = offset(1) = 0
    np.testing.assert_allclose(g[0], a, atol=1e-5)
    np.testing.assert_allclose(g[-1], b, atol=1e-5)
