"""Reference interop of the PyTorch port against the JAX package: ``.pt``/
``.pth`` state dicts and spline blobs built here (as
``tests/test_io.py`` builds them) and loaded by both packages, the
reference blob writer and reader across packages, the reference-semantics
helpers ``rebase_omega``, ``eval_spline`` and ``arc_lengths``, and the CLI
on a legacy single-VAE checkpoint (``train-single``'s ``.npz``), which the
port once refused."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_parity_inputs  # noqa: F401  (one torch thread)
from vae_latent_geometry_tpu.geometry import basis as jbasis
from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu.geometry import spline as jspline
from vae_latent_geometry_tpu.io import artifacts as jart
from vae_latent_geometry_tpu.models import torch_import as jti
from vae_latent_geometry_tpu_torch.geometry import basis as tbasis
from vae_latent_geometry_tpu_torch.geometry import energy as tenergy
from vae_latent_geometry_tpu_torch.geometry import spline as tspline
from vae_latent_geometry_tpu_torch.io import artifacts as tart
from vae_latent_geometry_tpu_torch.models import torch_import as tti

RTOL = 1e-6


def _linear(rng, fan_in, fan_out):
    bound = 1.0 / np.sqrt(fan_in)
    return (torch.from_numpy(rng.uniform(-bound, bound, (fan_out, fan_in))
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(-bound, bound, fan_out)
                             .astype(np.float32)))


def _sequential(rng, prefix, dims, norms=False):
    """nn.Sequential keys: Linear at 0, 3, 6 with activation + LayerNorm
    between (``norms``), else Linear at 0, 2, 4 with an activation."""
    sd, idx = {}, 0
    for i in range(len(dims) - 1):
        sd[f"{prefix}.{idx}.weight"], sd[f"{prefix}.{idx}.bias"] = _linear(
            rng, dims[i], dims[i + 1])
        idx += 1
        if i < len(dims) - 2:
            idx += 1                                     # activation
            if norms:
                sd[f"{prefix}.{idx}.weight"] = torch.from_numpy(
                    rng.uniform(0.5, 1.5, dims[i + 1]).astype(np.float32))
                sd[f"{prefix}.{idx}.bias"] = torch.from_numpy(
                    rng.normal(size=dims[i + 1]).astype(np.float32))
                idx += 1
    return sd


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree.cpu() if isinstance(tree, torch.Tensor)
                                 else tree)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("interop")
    evae = {**_sequential(rng, "encoder.encoder_net", (7, 8, 6, 4), True)}
    for m in range(3):
        evae.update(_sequential(rng, f"decoder.{m}.decoder_net", (2, 8, 8, 7)))
    single = {**_sequential(rng, "encoder.encoder_net", (7, 8, 6, 4)),
              **_sequential(rng, "decoder.decoder_net", (2, 8, 8, 14))}
    bare = _sequential(rng, "decoder_net", (2, 8, 8, 7))
    paths = {}
    for name, sd in (("evae", evae), ("single", single), ("bare", bare)):
        paths[name] = str(d / f"{name}.pth")
        torch.save(sd, paths[name])
    return paths


def test_evae_checkpoint_loads_alike(files):
    jp = jti.load_evae_checkpoint(files["evae"])
    tp = tti.load_evae_checkpoint(files["evae"], "cpu")
    _same_tree(jp.encoder, tp.encoder)
    _same_tree(jp.decoders, tp.decoders)
    assert tp.decoders["layers"][0]["w"].shape == (3, 2, 8)
    assert len(tp.encoder["norms"]) == 2


def test_single_vae_checkpoint_and_mean_head_load_alike(files):
    jraw = jti.load_single_vae_checkpoint(files["single"])
    tp = tti.load_single_vae_checkpoint(files["single"], "cpu")
    _same_tree(jraw["encoder"], tp.encoder)
    _same_tree(jraw["decoder"], tp.decoder)
    jm = jti.load_single_vae_mean_decoder(files["single"])
    tm = tti.load_single_vae_mean_decoder(files["single"], "cpu")
    _same_tree(jm, tm)
    _same_tree(jti.mean_head(jraw["decoder"]), tti.mean_head(tp.decoder))
    assert tm["layers"][-1]["w"].shape == (8, 7)


def test_bare_decoder_loads_alike(files):
    _same_tree(jti.load_decoder_checkpoint(files["bare"]),
               tti.load_decoder_checkpoint(files["bare"], "cpu"))


def test_ensemble_loader_refuses_a_single_vae(files):
    with pytest.raises(KeyError):
        tti.load_evae_checkpoint(files["single"], "cpu")


def test_full_module_pickle_is_refused(tmp_path):
    p = str(tmp_path / "module.pt")
    torch.save(torch.nn.Linear(2, 2), p)
    with pytest.raises(RuntimeError, match="state_dict"):
        tti._torch_load(p)


def _blob_entries(rng, P=3):
    basis, _ = jbasis.nullspace_basis(4)
    return [{"a": torch.from_numpy(rng.normal(size=2).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=2).astype(np.float32)),
             "basis": torch.from_numpy(basis), "n_poly": 4,
             "omega_init": torch.from_numpy(
                 rng.normal(size=(5, 2)).astype(np.float32)),
             "omega_optimized": torch.from_numpy(
                 rng.normal(size=(5, 2)).astype(np.float32)),
             "a_index": 2 * p, "b_index": 2 * p + 1,
             "cluster_pair": (f"c{p}", f"d{p}"),
             "length_geodesic": float(p + 1)} for p in range(P)]


@pytest.mark.parametrize("form", ["list", "dict_numpy_metadata"])
def test_spline_blob_loads_alike(tmp_path, form):
    rng = np.random.default_rng(3)
    entries = _blob_entries(rng)
    blob = entries if form == "list" else {
        "spline_data": entries,
        "representatives": [{"index": 0, "label": "c0"}],
        "pairs": [[0, 1]],
        "metadata": {"steps": np.int64(100), "curve": np.arange(3.0)}}
    p = str(tmp_path / "blob.pt")
    torch.save(blob, p)
    jb, tb = jti.load_spline_blob(p), tti.load_spline_blob(p)
    assert len(jb["spline_data"]) == len(tb["spline_data"]) == 3
    for dj, dt in zip(jb["spline_data"], tb["spline_data"]):
        assert dj.keys() == dt.keys()
        for k in dj:
            np.testing.assert_array_equal(np.asarray(dj[k]),
                                          np.asarray(dt[k]))
    if form != "list":
        assert tb["metadata"]["steps"] == 100
    ja, ta = jart.load_spline_batch(p), tart.load_spline_batch(p)
    for name in ("a", "b", "omega_init", "basis", "pair_indices",
                 "omega_optimized", "geodesic_length"):
        np.testing.assert_array_equal(getattr(ja, name), getattr(ta, name))
    assert ja.pair_labels == ta.pair_labels == [["c0", "d0"], ["c1", "d1"],
                                                ["c2", "d2"]]


def _artifact(mod, rng):
    basis, _ = jbasis.nullspace_basis(4)
    return mod.SplineBatchArtifact(
        a=rng.normal(size=(3, 2)).astype(np.float32),
        b=rng.normal(size=(3, 2)).astype(np.float32),
        omega_init=rng.normal(size=(3, 5, 2)).astype(np.float32),
        basis=basis, n_poly=4,
        pair_indices=np.array([[0, 1], [0, 2], [1, 2]]),
        valid=np.ones(3, bool),
        pair_labels=[["a", "b"], ["a", "c"], ["b", "c"]],
        representatives=[{"index": np.int64(i), "label": l}
                         for i, l in enumerate("abc")],
        omega_optimized=rng.normal(size=(3, 5, 2)).astype(np.float32),
        geodesic_length=np.array([1.0, 2.0, 3.0], np.float32),
        euclidean_distance=np.array([0.1, 0.2, 0.3], np.float32),
        metadata={"steps": np.int32(7), "scale": np.float64(0.5)})


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_reference_blob_round_trip_across_packages(tmp_path, writer):
    rng = np.random.default_rng(11)
    w, r = (tart, jart) if writer == "port" else (jart, tart)
    art = _artifact(w, rng)
    p = str(tmp_path / "blob.pt")
    blob = w.to_reference_blob(art, p)
    other = (jart if writer == "port" else tart).to_reference_blob(art)
    assert blob["pairs"] == other["pairs"]
    assert blob["metadata"] == other["metadata"] == {"steps": 7,
                                                     "scale": 0.5}
    for back in (r.load_spline_batch(p), w.load_spline_batch(p)):
        for name in ("a", "b", "omega_init", "omega_optimized",
                     "geodesic_length", "euclidean_distance", "basis",
                     "pair_indices"):
            np.testing.assert_allclose(getattr(back, name),
                                       getattr(art, name), rtol=1e-7)
        assert back.pair_labels == art.pair_labels
        assert back.metadata == {"steps": 7, "scale": 0.5}
        assert [r_["index"] for r_ in back.representatives] == [0, 1, 2]


def test_empty_reference_blob_is_refused():
    with pytest.raises(ValueError, match="empty"):
        tart.from_reference_blob({"spline_data": []})


def test_rebase_omega_matches_jax():
    rng = np.random.default_rng(5)
    basis, _ = jbasis.nullspace_basis(4)
    q, _ = np.linalg.qr(rng.normal(size=(5, 5)))
    other = (basis @ q).astype(np.float32)      # same subspace, rotated
    omega = rng.normal(size=(6, 5, 2)).astype(np.float32)
    got = tbasis.rebase_omega(omega, other, basis)
    np.testing.assert_allclose(got, jbasis.rebase_omega(omega, other, basis),
                               rtol=RTOL)
    # the raw coefficients, hence the curves, are unchanged
    np.testing.assert_allclose(np.einsum("nk,bkd->bnd", basis, got),
                               np.einsum("nk,bkd->bnd", other, omega),
                               atol=1e-5)


def test_eval_spline_matches_jax():
    rng = np.random.default_rng(6)
    basis, _ = jbasis.nullspace_basis(4)
    omega = rng.normal(size=(5, 5, 2)).astype(np.float32)
    a = rng.normal(size=(5, 2)).astype(np.float32)
    b = rng.normal(size=(5, 2)).astype(np.float32)
    jt = jnp.linspace(0.0, 1.0, 513)
    want = np.asarray(jspline.eval_spline(jnp.asarray(omega), jnp.asarray(a),
                                          jnp.asarray(b), jnp.asarray(basis),
                                          jt, 4))
    t = tspline.t_grid(513)
    got = tspline.eval_spline(torch.as_tensor(omega), torch.as_tensor(a),
                              torch.as_tensor(b), basis, t, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    # the design-matrix form is the same curve
    design = tspline.eval_spline_design(
        torch.as_tensor(omega), torch.as_tensor(a), torch.as_tensor(b),
        tspline.design_matrix(t, basis, 4), t).numpy()
    np.testing.assert_allclose(got, design, atol=1e-5)


def test_arc_lengths_match_jax():
    rng = np.random.default_rng(8)
    gamma = np.cumsum(rng.normal(size=(200, 6, 2)), axis=0).astype(np.float32)
    np.testing.assert_allclose(
        tenergy.arc_lengths(torch.as_tensor(gamma)).numpy(),
        np.asarray(jenergy.arc_lengths(jnp.asarray(gamma))), rtol=RTOL)
    # a straight line's length is its endpoints' distance
    t = torch.linspace(0, 1, 101)[:, None, None]
    a = torch.tensor([[0.0, 0.0], [1.0, 2.0]])
    b = torch.tensor([[3.0, 4.0], [1.0, 2.0]])
    np.testing.assert_allclose(
        tenergy.arc_lengths((1 - t) * a[None] + t * b[None]).numpy(),
        [5.0, 0.0], atol=1e-5)


@pytest.fixture(scope="module")
def legacy_run(tmp_path_factory):
    """A legacy single VAE trained by the port's CLI on a tiny data set,
    then ``select-pairs``, ``init-splines`` and ``optimize --energy-mode
    single`` on its ``.npz`` through both packages' CLIs."""
    from vae_latent_geometry_tpu.cli import main as jmain
    from vae_latent_geometry_tpu_torch.cli import main as tmain

    wd = tmp_path_factory.mktemp("legacy")
    dd = wd / "data"
    dd.mkdir()
    rng = np.random.default_rng(2)
    n = 400
    x = rng.normal(size=(n, 50)).astype(np.float32)
    cls = np.arange(n) % 4
    x[:, :2] += 4.0 * np.stack([np.cos(np.pi * cls / 2),
                                np.sin(np.pi * cls / 2)], axis=1)
    np.save(dd / "tasic-pca50.npy", x)
    np.save(dd / "tasic-ttypes.npy", np.array([f"c{c}" for c in cls]))
    old = os.environ.get("VLG_NO_COMPILE_CACHE")
    os.environ["VLG_NO_COMPILE_CACHE"] = "1"
    try:
        common = ["--data-dir", str(dd)]
        tmain(["train-single", *common, "--device", "cpu", "--epochs", "2",
               "--seed", "3", "--save-dir", str(wd)])
        model = str(wd / "vae_best_seed3.npz")
        out = {}
        for tag, main, dev in (("port", tmain, ["--device", "cpu"]),
                               ("jax", jmain, [])):
            pairs = str(wd / f"pairs_{tag}.json")
            init = str(wd / f"init_{tag}.npz")
            opt = str(wd / f"opt_{tag}.npz")
            main(["select-pairs", *common, *dev, "--model", model,
                  "--max-labels", "3", "--output", pairs])
            main(["init-splines", *common, *dev, "--model", model,
                  "--pairfile", pairs, "--grid", "60", "--output", init])
            main(["optimize", *common, *dev, "--model", model, "--splines",
                  init, "--energy-mode", "single", "--steps", "20",
                  "--num-t", "64", "--batch-size", "3", "--output", opt])
            out[tag] = (pairs, init, opt)
    finally:
        if old is None:
            os.environ.pop("VLG_NO_COMPILE_CACHE")
        else:
            os.environ["VLG_NO_COMPILE_CACHE"] = old
    return model, out


def test_cli_loads_legacy_single_vae_npz(legacy_run):
    """The port's CLI takes train-single's checkpoint (it raised in
    ``load_npz`` before) and gives the JAX CLI's result on it."""
    model, out = legacy_run
    (tp, ti, to), (jp, ji, jo) = out["port"], out["jax"]
    with open(tp) as f, open(jp) as g:
        assert json.load(f) == json.load(g)
    t_init, j_init = tart.load_spline_batch(ti), jart.load_spline_batch(ji)
    assert t_init.metadata["init_type"] == "euclidean"
    np.testing.assert_allclose(t_init.a, j_init.a, atol=1e-5)
    np.testing.assert_allclose(t_init.omega_init, j_init.omega_init,
                               atol=5e-4)
    t_opt, j_opt = tart.load_spline_batch(to), jart.load_spline_batch(jo)
    np.testing.assert_allclose(t_opt.geodesic_length, j_opt.geodesic_length,
                               rtol=1e-4)
    np.testing.assert_allclose(t_opt.euclidean_distance,
                               j_opt.euclidean_distance, rtol=1e-5)


def test_cli_refuses_ensemble_mode_on_single_vae(legacy_run):
    from vae_latent_geometry_tpu_torch.cli import main as tmain

    model, out = legacy_run
    with pytest.raises(SystemExit, match="single-decoder model"):
        tmain(["optimize", "--device", "cpu", "--model", model, "--splines",
               out["port"][1], "--energy-mode", "expected", "--no-euclidean",
               "--output", out["port"][2] + ".x.npz"])


def test_cli_loads_reference_pth_of_either_family(files):
    from vae_latent_geometry_tpu_torch.cli import _load_model
    from vae_latent_geometry_tpu_torch.models.evae import EVAEParams
    from vae_latent_geometry_tpu_torch.models.vae import VAEParams

    assert isinstance(_load_model(files["evae"], "cpu"), EVAEParams)
    assert isinstance(_load_model(files["single"], "cpu"), VAEParams)
