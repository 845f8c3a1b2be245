"""The port's golden reproduction and stability helpers against the JAX
package: the statistics on the committed golden-reproduction matrices and
blobs (numpy on both sides: 1e-12), ``encoder_agreement``, and
``run_golden`` and the ``golden`` / ``stability`` CLIs on a small seeded
reference-shaped tree (``tools/golden_tree.py``)."""

import json
import os

import numpy as np
import pytest
import torch

import tests.torch_parity_inputs as tpi
from tools.golden_tree import write_tree
from vae_latent_geometry_tpu.pipeline import golden as JG
from vae_latent_geometry_tpu.pipeline import stability as JS
from vae_latent_geometry_tpu_torch.pipeline import golden as TG
from vae_latent_geometry_tpu_torch.pipeline import stability as TS

EXP = os.path.join(tpi.REPO, "experiment")
ATOL = 1e-12
# the small tree's recipe: single_fused at f32x3 on 15 pairs
SMALL = {"steps": 20, "num_t": 64, "batch_size": 15, "mode": "single_fused"}


def _matrix(name):
    with open(os.path.join(EXP, name)) as f:
        d = json.load(f)
    return (np.array([[np.nan if v is None else v for v in row]
                      for row in d["distance_matrix"]], float),
            d["cluster_ids"])


def _close(a, b, rtol=0.0, atol=ATOL):
    """Equal nested reports: numbers within the tolerance, the rest
    exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], rtol, atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, rtol, atol)
    elif isinstance(a, (float, np.ndarray)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    else:
        assert a == b


@pytest.fixture(scope="module")
def golden_mats():
    return [_matrix(f"golden133_seed{s}_matrix.json") for s in (12, 123)]


def test_align_and_matrix_stats_match_jax(golden_mats):
    (m12, l12), (m123, l123) = golden_mats
    ja, jb, jc = JG.align_by_labels(m12, l12, m123, l123[::-1])
    ta, tb, tc = TG.align_by_labels(m12, l12, m123, l123[::-1])
    assert jc == tc and len(tc) == 133
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jb, tb)
    _close(TG.matrix_stats(ta, tb), JG.matrix_stats(ja, jb))


def test_compare_to_golden_matches_jax(tmp_path, golden_mats):
    """Committed matrices stand in for the golden JSONs of both seeds."""
    art = tmp_path / "src" / "artifacts"
    art.mkdir(parents=True)
    for seed, name in ((12, "plots/geodesic_matrix_seed12_euclidean_133.json"),
                       (123, "plots/geodesic_matrix_seed12_entropy_133.json")
                       ):
        m, labels = _matrix(name)
        (art / f"geodesic_distances_seed{seed}_p133.json").write_text(
            json.dumps({"cluster_ids": labels,
                        "distance_matrix": m.tolist()}))
    (m12, l12) = golden_mats[0]
    want = JG.compare_to_golden(m12, l12, 12, str(tmp_path))
    got = TG.compare_to_golden(m12, l12, 12, str(tmp_path))
    _close(got, want)
    assert got["golden_cross_seed_scale"]["n_common"] > 8000
    _close(TG.golden_matrix(123, str(tmp_path)),
           JG.golden_matrix(123, str(tmp_path)))


def test_cross_seed_spread_matches_jax(golden_mats):
    (m12, l12), (m123, l123) = golden_mats
    e, le = _matrix("plots/geodesic_matrix_seed12_entropy_133.json")
    u, lu = _matrix("plots/geodesic_matrix_seed12_euclidean_133.json")
    args = ((m12, m123), (l12, l123), (e, u), (le, lu))
    got = TS.cross_seed_spread_comparison(*args)
    _close(got, JS.cross_seed_spread_comparison(*args))
    assert got["n_entries"] > 8000


def test_frobenius_matches_jax(tmp_path, golden_mats):
    (m12, l12), (m123, l123) = golden_mats
    _close(vars(TS.frobenius_comparison(m12, l12, m123, l123[:100])),
           vars(JS.frobenius_comparison(m12, l12, m123, l123[:100])))
    pa = os.path.join(EXP, "golden133_seed12_matrix.json")
    pb = os.path.join(EXP, "plots", "geodesic_matrix_seed12_mc_133.json")
    with open(pb) as f:
        db = json.load(f)
    for b in (pb, db):      # a path or a parsed dict
        _close(vars(TS.frobenius_from_json(pa, b)),
               vars(JS.frobenius_from_json(pa, b)))


def test_pair_determinism_matches_jax(tmp_path):
    reps = [{"index": i, "label": f"c{i}"} for i in range(4)]
    pairs = [[0, 1], [0, 2], [1, 2]]
    docs = [{"representatives": reps, "pairs": pairs},
            {"representatives": reps, "pairs": pairs},
            {"representatives": reps, "pairs": pairs[::-1]}]
    paths = []
    for i, d in enumerate(docs):
        paths.append(str(tmp_path / f"p{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(d, f)
    for a, b, same in ((0, 1, True), (0, 2, False)):
        for x, y in ((paths[a], paths[b]), (docs[a], docs[b])):
            assert TS.check_pair_determinism(x, y) is same
            assert JS.check_pair_determinism(x, y) is same


def test_encoder_agreement_matches_jax():
    import jax
    import jax.numpy as jnp

    from vae_latent_geometry_tpu.config import ModelConfig
    from vae_latent_geometry_tpu.io.checkpoint import load_pytree
    from vae_latent_geometry_tpu.models.evae import evae_init
    from vae_latent_geometry_tpu_torch.models.evae import from_jax_params

    jp, _ = load_pytree(tpi.MODEL,
                        evae_init(jax.random.PRNGKey(0), ModelConfig()))
    rng = np.random.default_rng(4)
    jq = jax.tree_util.tree_map(
        lambda x: x + 1e-2 * jnp.asarray(rng.normal(size=x.shape),
                                         x.dtype), jp)
    data = rng.normal(size=(300, 50)).astype(np.float32)
    want = JS.encoder_agreement(jp, jq, data)
    got = TS.encoder_agreement(from_jax_params(jp, "cpu"),
                               from_jax_params(jq, "cpu"), data)
    assert want > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("seed", [12, 123])
def test_distance_matrix_of_committed_blob_is_committed_matrix(seed):
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import (
        distance_matrix,
    )

    mat, labels = distance_matrix(load_spline_batch(
        os.path.join(EXP, f"golden133_seed{seed}_blob.npz")))
    want, want_labels = _matrix(f"golden133_seed{seed}_matrix.json")
    assert labels == want_labels
    np.testing.assert_array_equal(mat, want)


@pytest.fixture(scope="module")
def small_tree(tmp_path_factory):
    """Both packages' ``golden`` CLI on a 6-class tree (15 pairs)."""
    from vae_latent_geometry_tpu.cli import main as jmain
    from vae_latent_geometry_tpu_torch.cli import main as tmain

    d = tmp_path_factory.mktemp("golden_tree")
    root = write_tree(str(d / "reference"), n_classes=6, n_points=600)
    flags = ["--reference-root", root, "--steps", str(SMALL["steps"]),
             "--num-t", str(SMALL["num_t"]), "--batch-size",
             str(SMALL["batch_size"]), "--energy-mode", SMALL["mode"]]
    old = os.environ.get("VLG_NO_COMPILE_CACHE")
    os.environ["VLG_NO_COMPILE_CACHE"] = "1"
    out = {}
    try:
        import contextlib
        import io

        for tag, main, extra in (("jax", jmain, []),
                                 ("port", tmain, ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["golden", "--output", str(d / tag), *flags, *extra])
            text = buf.getvalue()
            out[tag] = (str(d / tag), json.loads(text[text.index("{"):]))
    finally:
        if old is None:
            os.environ.pop("VLG_NO_COMPILE_CACHE")
        else:
            os.environ["VLG_NO_COMPILE_CACHE"] = old
    return root, out


def _outputs(out_dir):
    with open(os.path.join(out_dir, "golden133_seed12_matrix.json")) as f:
        m = json.load(f)
    with open(os.path.join(out_dir, "golden133_seed12_compare.json")) as f:
        c = json.load(f)
    return np.asarray(m["distance_matrix"], float), m["cluster_ids"], c


def test_golden_cli_matches_jax(small_tree):
    _, out = small_tree
    (jdir, jrep), (tdir, trep) = out["jax"], out["port"]
    assert set(trep) == set(jrep) | {"seconds"}
    assert set(trep["seconds"]) == {"init", "optimize", "matrix"}
    _close({k: trep[k] for k in jrep}, jrep, rtol=1e-4, atol=1e-7)
    jm, jl, jc = _outputs(jdir)
    tm, tl, tc = _outputs(tdir)
    assert tl == jl
    np.testing.assert_allclose(tm, jm, rtol=1e-4)
    _close(tc, jc, rtol=1e-4, atol=1e-7)
    blobs = sorted(f for f in os.listdir(tdir) if f.endswith(".npz"))
    assert blobs == sorted(f for f in os.listdir(jdir)
                           if f.endswith(".npz"))
    assert blobs == [TG.checkpoint_name(12, **SMALL)]
    assert blobs == ["golden133_seed12_blob_single_fused_s20_t64_bs15.npz"]


def test_run_golden_matches_jax_and_resumes(small_tree, tmp_path):
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    root, out = small_tree
    rep = TG.run_golden(12, str(tmp_path), root=root, device="cpu", **SMALL)
    jm, _, jc = _outputs(out["jax"][0])
    tm, _, tc = _outputs(str(tmp_path))
    np.testing.assert_allclose(tm, jm, rtol=1e-4)
    assert rep["vs_golden"]["n_common"] == 15
    # a second call serves the stamped checkpoint: no optimizer step
    calls = []
    orig = ef.energy_bwd_plain
    ef.energy_bwd_plain = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        TG.run_golden(12, str(tmp_path), root=root, device="cpu", **SMALL)
    finally:
        ef.energy_bwd_plain = orig
    assert calls == []
    np.testing.assert_array_equal(_outputs(str(tmp_path))[0], tm)


def test_reference_inputs_read_alike(small_tree):
    root, _ = small_tree
    np.testing.assert_array_equal(TG.reference_latents(123, root),
                                  JG.reference_latents(123, root))
    (jr, jp), (tr, tp) = JG.reference_pairs(root=root), TG.reference_pairs(
        root=root)
    assert jr == tr and len(tr) == 6
    np.testing.assert_array_equal(jp, tp)
    # the tree's state dict in the reference's layout, both loaders
    from vae_latent_geometry_tpu.models.torch_import import (
        load_single_vae_mean_decoder as jload,
    )
    from vae_latent_geometry_tpu_torch.models.torch_import import (
        load_single_vae_mean_decoder as tload,
    )

    path = os.path.join(root, "src", "artifacts", "vae_best_seed12.pth")
    jd, td = jload(path), tload(path, "cpu")
    assert [l["w"].shape for l in td["layers"]] == [(2, 128), (128, 128),
                                                    (128, 50)]
    for jl, tl in zip(jd["layers"], td["layers"]):
        np.testing.assert_array_equal(np.asarray(jl["w"]), tl["w"].numpy())


def _run(main, argv, capsys):
    code = 0
    try:
        main(argv)
    except SystemExit as ex:
        code = ex.code
    return code, capsys.readouterr().out


def test_stability_cli_matches_jax(tmp_path, capsys):
    from vae_latent_geometry_tpu.cli import main as jmain
    from vae_latent_geometry_tpu_torch.cli import main as tmain

    a = os.path.join(EXP, "golden133_seed12_matrix.json")
    b = os.path.join(EXP, "golden133_seed123_matrix.json")
    outs = [_run(m, ["stability", "frobenius", "--a", a, "--b", b], capsys)
            for m in (jmain, tmain)]
    assert outs[0][0] == outs[1][0] == 0
    assert json.loads(outs[0][1]) == json.loads(outs[1][1])
    reps = [{"index": i, "label": f"c{i}"} for i in range(3)]
    for name, pairs in (("p0", [[0, 1]]), ("p1", [[0, 1]]), ("p2", [[1, 2]])):
        (tmp_path / f"{name}.json").write_text(json.dumps(
            {"representatives": reps, "pairs": pairs}))
    for other, code in (("p1", 0), ("p2", 1)):
        argv = ["stability", "pairs", "--a", str(tmp_path / "p0.json"),
                "--b", str(tmp_path / f"{other}.json")]
        assert _run(jmain, argv, capsys) == _run(tmain, argv, capsys)
        assert _run(tmain, argv, capsys)[0] == code
    # a binary artifact is refused with the kinds' explanation
    with pytest.raises(SystemExit, match="not readable as JSON"):
        tmain(["stability", "frobenius", "--a",
               os.path.join(EXP, "golden133_seed12_blob.npz"), "--b", b])
