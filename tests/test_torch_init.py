"""The port's init stages vs the JAX package, both on the CPU: grid, kNN
graph, Dijkstra and path extraction, entropy weights, the closed-form spline
fit, representative selection, ``initialize_splines`` and
``run_distance_pipeline``.

Inputs: the package's seeded surrogate cut to 3,000 rows and 12 classes,
the seed-42 production EVAE, a 30 x 30 grid for the graph stages and 60 x 60
for the fits.  Host-side integer and float64 work (grid, graph,
representatives, pairs, Euclidean paths) is held exactly.  Device-side
float32 work is held to a tolerance: entropy weights atol 2e-6 of their
[0, 1] range (another summation order in the decode), fitted omega rtol
1e-4 / atol 1e-5 on paths of the 60 x 60 grid.  The fit solves 5 x 5 normal
equations in float32: a path of fewer nodes than unknowns leaves omega
undetermined up to the ridge (condition 4e6), and the two packages' solvers
then agree only on the curve at the path's nodes, which is why the fits are
not compared on the 30 x 30 grid's short paths.  Entropy edge weights differ in
their last bits between the packages, so a near-tie between two paths may
break the other way: the entropy init is held on the pairs whose path is the
same (at least 80% of them), the rest only to be valid curves between the
same endpoints.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.config import InitConfig as JInit
from vae_latent_geometry_tpu.config import ModelConfig
from vae_latent_geometry_tpu.geometry import spline as jspline
from vae_latent_geometry_tpu.graph import grid as jgrid
from vae_latent_geometry_tpu.graph import shortest_path as jsp
from vae_latent_geometry_tpu.io import artifacts as jart
from vae_latent_geometry_tpu.io.checkpoint import load_pytree
from vae_latent_geometry_tpu.models import evae as jevae
from vae_latent_geometry_tpu.pipeline import full_run as jfull
from vae_latent_geometry_tpu.pipeline import init_splines as jinit
from vae_latent_geometry_tpu.pipeline import select_pairs as jselect
from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                   GeodesicConfig, InitConfig)
from vae_latent_geometry_tpu_torch.data.tasic import synthesize_tasic_like
from vae_latent_geometry_tpu_torch.geometry import spline as tspline
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.graph import grid as tgrid
from vae_latent_geometry_tpu_torch.graph import shortest_path as tsp
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.pipeline import full_run as tfull
from vae_latent_geometry_tpu_torch.pipeline import init_splines as tinit
from vae_latent_geometry_tpu_torch.pipeline import select_pairs as tselect

from torch_parity_inputs import MODEL, REPO

N_ROWS, N_CLASSES, GRID, FIT_GRID = 3000, 12, 30, 60


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    labels = np.array([f"class_{i:03d}"
                       for i in rng.integers(0, N_CLASSES, N_ROWS)])
    x = synthesize_tasic_like(labels, seed=0)
    tp = tevae.load_npz(MODEL, "cpu")
    jp, _ = load_pytree(MODEL, jevae.evae_init(jax.random.PRNGKey(0),
                                               ModelConfig()))
    with torch.no_grad():
        z_t = tevae.encode(tp, torch.from_numpy(x))[0].numpy()
    z_j = np.asarray(jevae.encode(jp, jnp.asarray(x))[0])
    return {"x": x, "labels": labels, "tp": tp, "jp": jp, "z_t": z_t,
            "z_j": z_j}


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


def test_latents_agree(setup):
    np.testing.assert_allclose(setup["z_t"], setup["z_j"], rtol=1e-4,
                               atol=1e-5)


def test_grid_and_knn_graph_match_jax(setup):
    g_t, shape_t = tgrid.create_latent_grid(setup["z_j"], GRID)
    g_j, shape_j = jgrid.create_latent_grid(setup["z_j"], GRID)
    assert shape_t == shape_j == (GRID, GRID)
    np.testing.assert_array_equal(g_t, g_j)
    assert tsp.backend() == ("native" if jsp.native_available() else "scipy")
    _same_csr(tgrid.grid_knn_graph(g_t, shape_t, k=8),
              jgrid.grid_knn_graph(g_j, shape_j, k=8))
    # the cKDTree route (no grid layout given)
    _same_csr(tgrid.grid_knn_graph(g_t, None, k=8),
              jgrid.grid_knn_graph(g_j, None, k=8))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "scipy"])
def test_dijkstra_and_paths_match_jax(setup, use_native):
    grid, shape = tgrid.create_latent_grid(setup["z_j"], GRID)
    graph = tgrid.grid_knn_graph(grid, shape, k=8)
    sources = np.array([0, 17, 450, 899], np.int32)
    d_t, p_t = tsp.dijkstra_multi(graph, sources, use_native=use_native)
    d_j, p_j = jsp.dijkstra_multi(graph, sources, use_native=use_native)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(p_t, p_j)
    assert d_t.dtype == np.float32 and p_t.dtype == np.int32
    rows = np.array([0, 1, 2, 3, 3, 0], np.int32)
    targets = np.array([899, 3, 450, 0, 31, 0], np.int32)
    for max_len in (64, 8):        # 8: the long paths are capped to length 0
        paths_t, len_t = tsp.extract_paths(p_t, rows, sources, targets,
                                           max_len=max_len)
        paths_j, len_j = jsp.extract_paths(p_j, rows, sources, targets,
                                           max_len=max_len)
        np.testing.assert_array_equal(len_t, len_j)
        np.testing.assert_array_equal(paths_t, paths_j)
    assert len_t[-1] == 1 and (len_t == 0).any()


def test_entropy_weights_match_jax(setup):
    grid, _ = tgrid.create_latent_grid(setup["z_j"], GRID)
    w_t = tgrid.entropy_weights(setup["tp"].decoders, grid, chunk=256)
    w_j = jgrid.entropy_weights(setup["jp"].decoders, grid)
    assert w_t.dtype == np.float32 and w_t.min() == 0.0 and w_t.max() <= 1.0
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=2e-6)
    graph = tgrid.grid_knn_graph(grid, (GRID, GRID))
    _same_csr(tgrid.reweight_graph_by_entropy(graph, w_j),
              jgrid.reweight_graph_by_entropy(graph, w_j))


def test_decoder_std_matches_jax(setup):
    z = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    s_t = tevae.decoder_std(setup["tp"].decoders, torch.from_numpy(z)).numpy()
    s_j = np.asarray(jevae.decoder_std(setup["jp"].decoders, jnp.asarray(z)))
    np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=1e-6)
    one = tevae.decoder_member(setup["tp"].decoders, 0)
    one = {"layers": [{k: v[None] for k, v in l.items()}
                      for l in one["layers"]]}
    assert not tevae.decoder_std(one, torch.from_numpy(z)).any()


def test_fit_spline_lstsq_matches_jax():
    rng = np.random.default_rng(2)
    B, P, D = 7, 23, 2
    basis, _ = nullspace_basis(4)
    lengths = rng.integers(8, P + 1, size=B)
    lengths[0] = 2                 # degenerate: two points, omega = 0
    lengths[1] = 4                 # fewer points than unknowns
    pos = np.arange(P)[None, :]
    mask = (pos < lengths[:, None]).astype(np.float32)
    t = np.minimum(pos / np.maximum(lengths - 1, 1)[:, None], 1.0).astype(
        np.float32)
    paths = np.cumsum(rng.normal(size=(B, P, D)), axis=1).astype(np.float32)
    a = paths[:, 0]
    b = paths[np.arange(B), lengths - 1]
    phi_j = jax.vmap(lambda tt: jspline.design_matrix(
        tt, jnp.asarray(basis), 4))(jnp.asarray(t))
    ref = np.asarray(jspline.fit_spline_lstsq(
        jnp.asarray(paths), jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b),
        phi_j, jnp.asarray(t)))
    tt = torch.from_numpy(t)
    phi_t = tspline.design_matrix(tt, basis, 4)
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-6,
                               atol=1e-7)
    out = tspline.fit_spline_lstsq(
        torch.from_numpy(paths), torch.from_numpy(mask), torch.from_numpy(a),
        torch.from_numpy(b), phi_t, tt).numpy()
    assert not out[0].any() and not ref[0].any()
    # well-posed rows (condition ~5e2 at float32: each package lies ~2e-4
    # from the float64 solution)
    np.testing.assert_allclose(out[2:], ref[2:], rtol=1e-3, atol=5e-4)
    # every row, the underdetermined one included: the same curve at the
    # path's own sample points
    at_nodes = lambda om: np.einsum("bpk,bkd->bpd",
                                    np.asarray(phi_j) * mask[..., None], om)
    np.testing.assert_allclose(at_nodes(out), at_nodes(ref), atol=5e-5)
    # a shared (P,) grid and (P, K) design matrix broadcast over the batch
    t1 = torch.linspace(0, 1, P)
    full = torch.ones(B, P)
    o1 = tspline.fit_spline_lstsq(torch.from_numpy(paths), full,
                                  torch.from_numpy(a), torch.from_numpy(paths[:, -1]),
                                  tspline.design_matrix(t1, basis, 4), t1)
    o2 = tspline.fit_spline_lstsq(
        torch.from_numpy(paths), full, torch.from_numpy(a),
        torch.from_numpy(paths[:, -1]),
        tspline.design_matrix(t1[None].expand(B, P), basis, 4),
        t1[None].expand(B, P))
    torch.testing.assert_close(o1, o2)


@pytest.mark.parametrize("max_labels", [5, 12, 20])
def test_select_representatives_and_pairs_match_jax(setup, max_labels,
                                                    tmp_path):
    reps_t = tselect.select_representatives(setup["z_j"], setup["labels"],
                                            max_labels)
    reps_j = jselect.select_representatives(setup["z_j"], setup["labels"],
                                            max_labels)
    assert reps_t == reps_j and len(reps_t) == min(max_labels, N_CLASSES)
    assert tselect.make_pairs(reps_t) == jselect.make_pairs(reps_j)
    tselect.save_pairs(reps_t, tmp_path / "t" / "pairs.json")
    jselect.save_pairs(reps_j, tmp_path / "j.json")
    assert (tmp_path / "t" / "pairs.json").read_text() == (
        tmp_path / "j.json").read_text()
    assert tselect.load_pairs(tmp_path / "j.json") == jselect.load_pairs(
        tmp_path / "t" / "pairs.json")


def _inits(setup, use_entropy):
    reps = jselect.select_representatives(setup["z_j"], setup["labels"], 8)
    pairs = jselect.make_pairs(reps)
    pairs.append((reps[0]["index"], reps[0]["index"]))   # a skipped pair
    out = tinit.initialize_splines(
        setup["z_j"], pairs, decoders=setup["tp"].decoders,
        cfg=InitConfig(grid_points_per_axis=FIT_GRID,
                       use_entropy=use_entropy),
        device="cpu")
    ref = jinit.initialize_splines(
        setup["z_j"], pairs, decoders=setup["jp"].decoders,
        cfg=JInit(grid_points_per_axis=FIT_GRID, use_entropy=use_entropy))
    return out, ref


def test_initialize_splines_euclidean_matches_jax(setup):
    out, ref = _inits(setup, use_entropy=False)
    assert out.init_type == ref.init_type == "euclidean"
    assert out.n_poly == ref.n_poly
    np.testing.assert_array_equal(out.valid, ref.valid)
    assert not out.valid[-1] and out.valid[:-1].all()
    np.testing.assert_array_equal(out.pair_indices, ref.pair_indices)
    np.testing.assert_array_equal(out.basis, ref.basis)
    np.testing.assert_array_equal(out.a, ref.a)
    np.testing.assert_array_equal(out.b, ref.b)
    np.testing.assert_allclose(out.omega, ref.omega, rtol=1e-4, atol=1e-5)
    assert not out.omega[-1].any()


def test_initialize_splines_entropy_matches_jax(setup):
    out, ref = _inits(setup, use_entropy=True)
    assert out.init_type == ref.init_type == "entropy"
    np.testing.assert_array_equal(out.valid, ref.valid)
    np.testing.assert_array_equal(out.a, ref.a)       # endpoints: grid nodes
    np.testing.assert_array_equal(out.b, ref.b)
    same = np.all(np.isclose(out.omega, ref.omega, rtol=1e-4, atol=1e-5),
                  axis=(1, 2))
    assert same.mean() >= 0.8, same
    assert np.isfinite(out.omega).all()
    with pytest.raises(ValueError, match="requires ensemble decoders"):
        tinit.initialize_splines(setup["z_j"], [(0, 1)], decoders=None,
                                 cfg=InitConfig(use_entropy=True),
                                 device="cpu")
    with pytest.raises(ValueError, match="grid_shape"):
        tinit.initialize_splines(setup["z_j"], [(0, 1)],
                                 grid=np.zeros((4, 2), np.float32),
                                 device="cpu")


def test_run_distance_pipeline_matches_jax(setup):
    """Data to matrix in both packages: 6 classes (15 pairs), Euclidean
    init on a 60 x 60 grid, 5 ``expected_fused`` steps at T=32.  Lengths
    and matrix at rtol 1e-4, the suite's tolerance on energies."""
    kw = dict(steps=5, lr=1e-3, batch_size=8)
    out = tfull.run_distance_pipeline(
        setup["tp"], setup["x"], setup["labels"], max_labels=6,
        init_cfg=InitConfig(grid_points_per_axis=FIT_GRID),
        geo_cfg=GeodesicConfig(**kw, energy=EnergyConfig(
            num_t=32, mode="expected_fused", kernel_precision="f32x2")),
        verbose=False, device="cpu")
    ref = jfull.run_distance_pipeline(
        setup["jp"], setup["x"], setup["labels"], max_labels=6,
        init_cfg=JInit(grid_points_per_axis=FIT_GRID),
        geo_cfg=JGeo(**kw, energy=JEnergy(
            num_t=32, mode="expected_fused", kernel_precision="f32x2")),
        verbose=False)
    assert out.labels == ref.labels and len(out.labels) == 6
    assert out.graph_backend in ("native", "scipy")
    assert set(out.timings) == set(ref.timings)
    a_t, a_j = out.artifact, ref.artifact
    assert a_t.representatives == a_j.representatives
    assert a_t.pair_labels == a_j.pair_labels
    np.testing.assert_array_equal(a_t.pair_indices, a_j.pair_indices)
    np.testing.assert_array_equal(a_t.valid, a_j.valid)
    np.testing.assert_allclose(a_t.omega_init, a_j.omega_init, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(a_t.geodesic_length, a_j.geodesic_length,
                               rtol=1e-4)
    np.testing.assert_allclose(a_t.euclidean_distance,
                               a_j.euclidean_distance, rtol=1e-4)
    np.testing.assert_allclose(out.matrix, ref.matrix, rtol=1e-4)
    assert out.matrix.shape == (6, 6) and np.isfinite(out.matrix).all()
    np.testing.assert_array_equal(out.matrix, out.matrix.T)


def test_cli_select_pairs_then_init_splines(tmp_path):
    """``select-pairs`` -> ``init-splines`` on the CPU, on the package's
    full seeded surrogate; the JAX package's CLI writes the same pair file
    and reads the init artifact."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    pairs_t, pairs_j = tmp_path / "pairs_6.json", tmp_path / "jax_6.json"
    for pkg, out, extra in (
            ("vae_latent_geometry_tpu_torch", pairs_t, ["--device", "cpu"]),
            ("vae_latent_geometry_tpu", pairs_j, [])):
        r = subprocess.run(
            [sys.executable, "-m", pkg, "select-pairs", "--model", MODEL,
             "--max-labels", "6", "--output", str(out), *extra],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    assert pairs_t.read_text() == pairs_j.read_text()
    init = tmp_path / "init.npz"
    r = subprocess.run(
        [sys.executable, "-m", "vae_latent_geometry_tpu_torch",
         "init-splines", "--device", "cpu", "--model", MODEL, "--pairfile",
         str(pairs_t), "--grid", "40", "--use-entropy", "--output",
         str(init)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "graph stages:" in r.stdout
    art = jart.load_spline_batch(str(init))      # the JAX package reads it
    assert len(art) == 15 and art.valid.all()
    assert art.metadata == {"init_type": "entropy", "pair_count": "6"}
    assert len(art.representatives) == 6
    assert np.isfinite(art.omega_init).all() and art.omega_init.any()
