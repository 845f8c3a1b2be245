"""The CoV analysis of the PyTorch port (``pipeline/evaluate.cov_analysis``,
``eval --mode cov``) vs the JAX package on the CPU.

Inputs: two small random EVAEs made by the JAX package's initializer from
seeds and carried across with ``from_jax_params``, data and pairs made with
numpy from a seed.  Tolerances: lengths rtol 1e-4 (the optimizer parity
tests'), CoV values atol 1e-4 (a CoV over two seeds moves by about the
lengths' relative error); ``compute_cov`` and the JSON exactly.
"""

import json
import os
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import ModelConfig
from vae_latent_geometry_tpu.models.evae import evae_init
from vae_latent_geometry_tpu.pipeline import evaluate as jev
from vae_latent_geometry_tpu_torch.models.evae import from_jax_params
from vae_latent_geometry_tpu_torch.pipeline import evaluate as tev

import torch_parity_inputs  # noqa: F401  (one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MCFG = ModelConfig(input_dim=8, num_decoders=3, encoder_hidden=(16,),
                   decoder_hidden=(16, 16))


def _model(seed):
    """A small EVAE whose members differ: the initializer copies one
    decoder to every member (as the reference does), so numpy noise from
    the seed tells them apart."""
    m = evae_init(jax.random.PRNGKey(seed), MCFG)
    rng = np.random.default_rng(seed)
    dec = jax.tree_util.tree_map(
        lambda x: x + 0.3 * rng.normal(size=x.shape).astype(np.float32),
        m.decoders)
    return m._replace(decoders=dec)


@pytest.fixture(scope="module")
def small():
    jmodels = [_model(i) for i in (1, 2)]
    tmodels = [from_jax_params(m, "cpu") for m in jmodels]
    rng = np.random.default_rng(0)
    data = rng.normal(size=(30, 8)).astype(np.float32)
    pairs = [(0, 1), (2, 5), (7, 11)]
    return jmodels, tmodels, data, pairs


def test_compute_cov_matches_jax():
    v = np.random.default_rng(1).uniform(0.5, 2.0, size=(3, 7, 4))
    for axis in (None, 0, 1):
        np.testing.assert_array_equal(tev.compute_cov(v, axis),
                                      jev.compute_cov(v, axis))
    v[:, 0] = 0.0
    np.testing.assert_array_equal(tev.compute_cov(v, 0), jev.compute_cov(v, 0))
    assert tev.compute_cov(np.zeros(3)) == 0.0


def _result(mod, rng):
    lengths = rng.uniform(1, 2, size=(2, 3, 2))
    eucl = rng.uniform(1, 2, size=(2, 3))
    raw = {k: mod.compute_cov(lengths[:, :, i], axis=0)
           for i, k in enumerate((1, 3))}
    return mod.CovResult(
        avg_cov_geodesic={k: float(np.mean(v)) for k, v in raw.items()},
        avg_cov_euclidean=float(np.mean(mod.compute_cov(eucl, axis=0))),
        raw_cov_geodesic=raw, raw_cov_euclidean=mod.compute_cov(eucl, axis=0),
        lengths=lengths, euclidean=eucl, seeds=[12, 123],
        decoder_counts=[1, 3])


def test_json_is_the_same_file_in_both_packages(tmp_path):
    """The same result saved by either package gives the same bytes, so
    each package reads the other's file."""
    tres = _result(tev, np.random.default_rng(5))
    jres = _result(jev, np.random.default_rng(5))
    tres.save(tmp_path / "t" / "cov.json")
    jres.save(tmp_path / "j" / "cov.json")
    t_bytes = (tmp_path / "t" / "cov.json").read_bytes()
    assert t_bytes == (tmp_path / "j" / "cov.json").read_bytes()
    back = json.loads(t_bytes)
    assert back["decoder_counts"] == [1, 3] and back["num_pairs"] == 3
    assert back["avg_cov_geodesic"] == {
        str(k): v for k, v in jres.avg_cov_geodesic.items()}


@pytest.mark.parametrize("batch_size", [None, 4])
def test_cov_analysis_matches_jax(small, batch_size):
    """Mode ``expected`` (deterministic), 10 steps at T=32, counts 1..3,
    chunks of 4 (edge-padded) or one chunk."""
    jmodels, tmodels, data, pairs = small
    kw = dict(seeds=[1, 2], data=data, pairs=pairs, decoder_counts=(1, 2, 3),
              steps=10, num_t=32, mode="expected", batch_size=batch_size)
    ref = jev.cov_analysis(jmodels, **kw)
    out = tev.cov_analysis(tmodels, device="cpu", **kw)
    np.testing.assert_allclose(out.euclidean, ref.euclidean, rtol=1e-5)
    np.testing.assert_allclose(out.lengths, ref.lengths, rtol=1e-4)
    for k in (1, 2, 3):
        np.testing.assert_allclose(out.raw_cov_geodesic[k],
                                   ref.raw_cov_geodesic[k], atol=1e-4)
        assert out.avg_cov_geodesic[k] == pytest.approx(
            ref.avg_cov_geodesic[k], abs=1e-4)
    assert out.avg_cov_euclidean == pytest.approx(ref.avg_cov_euclidean,
                                                  abs=1e-5)
    assert out.decoder_counts == ref.decoder_counts == [1, 2, 3]


def test_one_model_twice_gives_zero_cov_and_mc_repeats(small):
    _, tmodels, data, pairs = small
    m = tmodels[0]
    res = tev.cov_analysis([m, m], [0, 0], data, pairs, decoder_counts=(1, 3),
                           steps=4, num_t=16, mode="expected", device="cpu")
    assert np.array_equal(res.lengths[0], res.lengths[1])
    assert all(v == 0.0 for v in res.avg_cov_geodesic.values())
    # MC draws: a stream per (model, chunk): two seeds differ, a rerun
    # with the same generator is bit-identical
    kw = dict(decoder_counts=(1, 3), steps=4, num_t=16, mode="mc",
              device="cpu")
    r1 = tev.cov_analysis([m, m], [0, 0], data, pairs,
                          generator=torch.Generator().manual_seed(3), **kw)
    r2 = tev.cov_analysis([m, m], [0, 0], data, pairs,
                          generator=torch.Generator().manual_seed(3), **kw)
    assert np.array_equal(r1.lengths, r2.lengths)
    assert not np.array_equal(r1.lengths[0, :, 1], r1.lengths[1, :, 1])


def test_counts_above_the_ensemble_are_dropped(small):
    _, tmodels, data, pairs = small
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = tev.cov_analysis(tmodels, [1, 2], data, pairs[:1],
                               decoder_counts=(1, 3, 5, 7), steps=2,
                               num_t=16, mode="expected", device="cpu")
    assert res.decoder_counts == [1, 3]
    assert any("[5, 7]" in str(w.message) for w in caught)
    with pytest.raises(ValueError, match="no decoder_counts"):
        tev.cov_analysis(tmodels, [1, 2], data, pairs[:1],
                         decoder_counts=(7,), steps=2, num_t=16,
                         mode="expected", device="cpu")


def test_rep_latents_replace_encoding(small):
    _, tmodels, data, pairs = small
    kw = dict(decoder_counts=(1, 2), steps=3, num_t=16, mode="expected",
              device="cpu")
    res = tev.cov_analysis(tmodels, [1, 2], data, pairs, **kw)
    lat = []
    for m in tmodels:
        from vae_latent_geometry_tpu_torch.models.evae import encode

        with torch.no_grad():
            lat.append(encode(m, torch.from_numpy(data))[0].numpy())
    res_lat = tev.cov_analysis(tmodels, [1, 2], None, pairs, rep_latents=lat,
                               **kw)
    np.testing.assert_array_equal(res.lengths, res_lat.lengths)
    with pytest.raises(ValueError, match="one latent array per model"):
        tev.cov_analysis(tmodels, [1, 2], None, pairs, rep_latents=lat[:1],
                         **kw)


def test_cli_eval_cov_on_cpu(tmp_path):
    """``eval --mode cov --device cpu`` end to end: two seeds' checkpoints
    (both the committed seed-42 model), the seeded surrogate data, a pair
    file of three pairs; the JSON the JAX package writes."""
    model = os.path.join(REPO, "experiment", "model_seed42.npz")
    for seed in (1, 2):
        os.symlink(model, tmp_path / f"model_seed{seed}.npz")
    pairfile = tmp_path / "pairs.json"
    pairfile.write_text(json.dumps({
        "representatives": [{"index": i, "label": str(i)} for i in range(4)],
        "pairs": [[0, 1], [2, 3], [1, 3]]}))
    out = tmp_path / "cov.json"
    r = subprocess.run(
        [sys.executable, "-m", "vae_latent_geometry_tpu_torch", "eval",
         "--mode", "cov", "--device", "cpu", "--seeds", "1", "2", "3",
         "--model-dir", str(tmp_path), "--pairfile", str(pairfile),
         "--steps", "2", "--num-t", "16", "--energy-mode", "expected_fused",
         "--kernel-precision", "float32", "--output", str(out)],
        cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "no checkpoint" in r.stdout and "seed 3" in r.stdout
    res = json.loads(out.read_text())
    assert res["seeds"] == [1, 2] and res["num_pairs"] == 3
    assert res["decoder_counts"] == list(range(1, 11))
    assert all(v == 0.0 for v in res["avg_cov_geodesic"].values())


def test_mesh_path_equals_unsharded(small):
    """``mesh`` sends each chunk through ``sharded_optimize_splines``; on a
    1 x 1 mesh that is the unsharded optimization."""
    from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

    _, tmodels, data, pairs = small
    kw = dict(decoder_counts=(1, 3), steps=3, num_t=16, mode="expected",
              device="cpu", batch_size=4)
    ref = tev.cov_analysis(tmodels, [1, 2], data, pairs, **kw)
    out = tev.cov_analysis(tmodels, [1, 2], data, pairs,
                           mesh=make_mesh(1, 1), **kw)
    np.testing.assert_array_equal(out.lengths, ref.lengths)
