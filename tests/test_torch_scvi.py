"""scVI's decoder in the port (``models/nets.py``: Linear, eval-mode
BatchNorm1d, ReLU, Linear, softmax times the library size) against the
benchmark's plain reference ``geobench/reference_scvi.py``, which decodes it
as published (explicit BatchNorm, nothing folded).

CPU, seeded, small: D 10, hidden 16, G 300 (three of the linear kernels'
128-column slices), M 3, T 64, B 5.  Tolerances are relative to the largest
reference value unless said otherwise; each carries its reason.  Tests
marked ``gpu`` hold the softmax route's kernels to their plain
versions on the card and skip elsewhere (``python -m pytest --noconftest
tests/test_torch_scvi.py -m gpu``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from geobench import reference_scvi as ref
from vae_latent_geometry_tpu_torch.config import (
    GeodesicConfig,
    ModelConfig,
    from_dict,
    to_dict,
)
from vae_latent_geometry_tpu_torch.geometry import energy as energy_lib
from vae_latent_geometry_tpu_torch.models import evae, nets
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

M, D, H, G, T, B = 3, 10, 16, 300, 64, 5
LIB = 1e4
EPS = 1e-3
RUNGS = ("float32", "f32x3", "f32x2", "bfloat16")


def _reference(seed=0):
    """A seeded ensemble in reference_scvi's layout (float64 numbers)."""
    rng = np.random.default_rng(seed)

    def lin(i, o):
        bd = i ** -0.5
        return (torch.as_tensor(rng.uniform(-bd, bd, (M, i, o))),
                torch.as_tensor(rng.uniform(-bd, bd, (M, o))))

    norm = {"mean": rng.normal(0, 0.1, (M, H)),
            "var": rng.uniform(0.5, 2.0, (M, H)),
            "scale": 1 + rng.uniform(-0.1, 0.1, (M, H)),
            "bias": rng.uniform(-0.1, 0.1, (M, H))}
    return {"layers": [lin(D, H), lin(H, G)],
            "norm": {k: torch.as_tensor(v) for k, v in norm.items()},
            "eps": EPS, "library": LIB}


def _port(dec, dtype=torch.float32):
    """The same ensemble as the port's decoder tree."""
    f = lambda x: x.to(dtype)
    return {"layers": [{"w": f(w), "b": f(b)} for w, b in dec["layers"]],
            "norms": [{**{k: f(v) for k, v in dec["norm"].items()},
                       "eps": torch.full((M,), EPS, dtype=dtype)}],
            "softmax": {"library": torch.full((M,), LIB, dtype=dtype)}}


def _curves(seed=1, T=T, B=B):
    """Smooth curves between prior endpoints, float64."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, T)[:, None, None]
    a, b = rng.normal(size=(1, B, D)), rng.normal(size=(1, B, D))
    bend = rng.normal(size=(1, B, D))
    return torch.as_tensor((1 - t) * a + t * b
                           + 0.3 * np.sin(np.pi * t) * bend)


def _rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _grad_rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.fixture(scope="module")
def dec():
    return _reference()


# --------------------------------------------------------------- decoding

@pytest.mark.parametrize("path", ["decode_all", "decode_one",
                                  "decoder_apply", "folded"])
def test_decode_matches_reference(dec, path):
    """Every decode of the port against the published decoder in float64:
    float32 logits of |u| ~ 1 carry ~1e-7 absolute error, which the softmax
    turns into ~1e-7 relative error of each output; 2e-6 leaves room for the
    sums of 16-wide and 10-wide products."""
    z = _curves().reshape(-1, D)
    want = ref.decode(dec, z, "float64")
    tree = _port(dec)
    zf = z.float()
    if path == "decode_all":
        got = evae.decode_all(tree, zf)
    elif path == "folded":
        got = evae.decode_all(nets.fold_batchnorm(tree), zf)
    else:
        fn = (evae.decode_one if path == "decode_one"
              else lambda t, m, x: nets.decoder_apply(
                  evae.decoder_member(t, m), x))
        got = torch.stack([fn(tree, m, zf) for m in range(M)])
    assert got.shape == (M, T * B, G)
    assert _rel(got, want) < 2e-6


def test_batchnorm_fold_equals_explicit_batchnorm(dec):
    """The fold (w k, (b - mean) k + bias) is the same affine map: in
    float64 the hidden layer agrees to rounding (1e-13), and the folded
    tree carries no BatchNorm."""
    tree = _port(dec, torch.float64)
    folded = nets.fold_batchnorm(tree)
    assert "norms" not in folded and "softmax" in folded
    z = _curves().reshape(-1, D)
    l0 = tree["layers"][0]
    explicit = nets.batchnorm_eval(
        tree["norms"][0],
        torch.baddbmm(l0["b"][:, None], z.expand(M, -1, -1), l0["w"]))
    f0 = folded["layers"][0]
    fold = torch.baddbmm(f0["b"][:, None], z.expand(M, -1, -1), f0["w"])
    assert _rel(fold, explicit) < 1e-13
    assert _rel(evae.decode_all(folded, z), evae.decode_all(tree, z)) < 1e-13


def test_jvp_decode_carries_the_tangent_through_the_head(dec):
    """decode_all_jvp's tangent (BatchNorm scale, softmax Jacobian) is the
    JVP of decode_all, both in float64."""
    tree = _port(dec, torch.float64)
    z = _curves().reshape(-1, D)
    v = torch.as_tensor(np.random.default_rng(3).normal(size=z.shape))
    x, x_dot = energy_lib.decode_all_jvp(tree, z, v)
    want_x, want_dot = torch.func.jvp(lambda q: evae.decode_all(tree, q),
                                      (z,), (v,))
    assert _rel(x, want_x) < 1e-13
    assert _rel(x_dot, want_dot) < 1e-10


# --------------------------------------------------------------- energies

@pytest.mark.parametrize("mode", ["expected", "expected_fused"])
def test_expected_energy_and_gradient_match_reference(dec, mode):
    """The plain ``expected`` mode and ``expected_fused`` (on the CPU: K1/K2's
    plain versions at float32) against the reference's float64 energy and
    its autograd gradient.  The energy is dominated by the ensemble variance
    (each term a float32 sum of 300 squares: ~1e-7); the gradient is a
    float32 difference of neighbouring decodes, 1e-5 of its norm."""
    g64 = _curves().requires_grad_(True)
    want = ref.expected_energy(dec, g64, "float64")
    ct = torch.linspace(0.5, 2.0, B, dtype=torch.float64)
    (want_g,) = torch.autograd.grad((want * ct).sum(), g64)
    from vae_latent_geometry_tpu_torch.optim.geodesic import _energy_fn

    g = _curves().float().requires_grad_(True)
    tree = _port(dec)
    if mode == "expected_fused":  # folded once a chunk by make_loss_fn
        tree = nets.fold_batchnorm(tree)
    got = _energy_fn(mode, tree, g, kernel_precision="float32")
    (got_g,) = torch.autograd.grad((got * ct.float()).sum(), g)
    assert _rel(got, want) < 1e-6
    assert _grad_rel(got_g, want_g) < 1e-5


@pytest.mark.parametrize("rung", RUNGS)
def test_plain_kernels_follow_the_reference_rung_arithmetic(dec, rung):
    """K1's and K2's plain versions with the head at each rung against the
    reference in that rung's arithmetic with exact sums (float64).  K1
    differs from it by float32 sums (~1e-7 of the energy: 1e-6).  K2 by
    float32 sums (2e-7 of the norm at float32: 1e-5) and at the reduced
    rungs by cotangents that fall on the other side of a bf16 rounding
    boundary (~5e-6: 3e-5, ten times below the gap to the next rung)."""
    tree = _port(dec)
    ws, bs, wmb, lib = ef._prepare_expected(nets.fold_batchnorm(tree),
                                            _curves().float(), None)
    g = _curves().float()
    ct = torch.linspace(0.5, 2.0, B)
    e = ef.energy_fwd_plain(ws, bs, g, wmb, rung, lib)
    d = ef.energy_bwd_plain(ws, bs, g, wmb, ct, rung, lib)
    r = None if rung == "float32" else rung
    g64 = _curves().requires_grad_(True)
    want = ref.expected_energy(dec, g64, "float64", r)
    (want_g,) = torch.autograd.grad((want * ct.double()).sum(), g64)
    e_tol, g_tol = (1e-6, 1e-5 if rung == "float32" else 3e-5)
    assert _rel(e, want) < e_tol
    assert _grad_rel(d, want_g) < g_tol


@pytest.mark.parametrize("stated,lower", [("f32x3", "f32x2"),
                                          ("f32x2", "bfloat16")])
def test_one_rung_lower_fails_the_rung_check(dec, stated, lower):
    """The tolerances of the check above see one rung of difference: K2's
    plain version one rung below the stated one misses the reference at the
    stated rung by more than the stated rung's tolerance (3e-5), at least
    three times over."""
    tree = _port(dec)
    g = _curves().float()
    ws, bs, wmb, lib = ef._prepare_expected(nets.fold_batchnorm(tree), g,
                                            None)
    ct = torch.linspace(0.5, 2.0, B)
    d = ef.energy_bwd_plain(ws, bs, g, wmb, ct, lower, lib)
    g64 = _curves().requires_grad_(True)
    want = ref.expected_energy(dec, g64, "float64", stated)
    (want_g,) = torch.autograd.grad((want * ct.double()).sum(), g64)
    assert _grad_rel(d, want_g) > 1e-4


def test_column_slices_without_row_reductions_read_wrong(dec):
    """The linear kernels' column slices (``sum_slices``, 128 columns each)
    are independent only for a linear head: cut the softmax head the same
    way, each slice normalised on its own, and the energy is another
    number, while the whole row's matches the reference.  The test sees
    the coupling."""
    tree = _port(dec)
    g = _curves().float()
    ws, bs, wmb, lib = ef._prepare_expected(nets.fold_batchnorm(tree), g,
                                            None)
    assert len(ef.x_slices(ws, bs)) == 3
    whole = ef.energy_fwd_plain(ws, bs, g, wmb, "float32", lib)
    sliced = ef.sum_slices(ws, bs, lambda wsx, bsx, c0, c1:
                           ef.energy_fwd_plain(wsx, bsx, g, wmb, "float32",
                                               lib))
    want = ref.expected_energy(dec, _curves(), "float64")
    assert _rel(whole, want) < 1e-6
    assert _rel(sliced, want) > 0.1


# ------------------------------------------------------------ entry points

def _artifact(P=4, seed=5):
    from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
    from geobench.reference import nullspace_basis

    rng = np.random.default_rng(seed)
    a = rng.normal(size=(P, D)).astype(np.float32)
    b = rng.normal(size=(P, D)).astype(np.float32)
    return SplineBatchArtifact(
        a=a, b=b, omega_init=(0.01 * rng.normal(size=(P, 5, D))).astype(
            np.float32), basis=nullspace_basis(4).astype(np.float32),
        n_poly=4, pair_indices=np.stack([np.arange(P), np.arange(P) + P], 1),
        valid=np.ones(P, bool), pair_labels=[["a", "b"]] * P,
        representatives=[])


SCVI = ModelConfig(input_dim=G, latent_dim=D, num_decoders=M,
                   decoder_hidden=(H,), decoder_head="softmax",
                   decoder_batchnorm=True, library_size=LIB)


def test_config_keeps_the_jax_packages_json_for_other_models():
    """The head's fields are port-only: at their defaults ``to_dict`` (the
    sidecar and the training stamp) leaves them out; scVI's config keeps
    them and reads back."""
    assert "decoder_head" not in to_dict(ModelConfig())
    d = to_dict(SCVI)
    assert d["decoder_head"] == "softmax" and d["library_size"] == LIB
    assert from_dict(ModelConfig, d) == SCVI


def test_optimize_cli_on_an_scvi_artifact(dec, tmp_path):
    """An scVI ensemble saved as a model artifact (decoders only, the config
    in the sidecar) goes through CLI ``optimize`` in ``expected_fused``
    mode as any ensemble does; its lengths are the reference's float64
    lengths of the optimized curves (float32 K1: 1e-6), and equal what
    ``optimize_spline_batch`` gives from the loaded tree."""
    from vae_latent_geometry_tpu_torch import cli
    from vae_latent_geometry_tpu_torch.io.artifacts import (
        load_spline_batch,
        save_spline_batch,
    )
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch,
    )

    model = str(tmp_path / "scvi.npz")
    save_pytree({"decoders": _port(dec)}, model,
                {"model_config": to_dict(SCVI)})
    loaded = evae.load_npz(model, "cpu")
    assert loaded.encoder is None
    assert nets.decoder_head(loaded.decoders) == "softmax"
    art = _artifact()
    splines = str(tmp_path / "init.npz")
    save_spline_batch(art, splines)
    out = str(tmp_path / "opt.npz")
    cli.main(["optimize", "--model", model, "--splines", splines,
              "--energy-mode", "expected_fused", "--kernel-precision",
              "f32x2", "--steps", "3", "--num-t", "32", "--batch-size", "3",
              "--device", "cpu", "--no-euclidean", "--output", out])
    got = load_spline_batch(out)
    cfg = from_dict(GeodesicConfig, {
        "steps": 3, "batch_size": 3, "energy": {
            "num_t": 32, "mode": "expected_fused",
            "kernel_precision": "f32x2"}})
    direct = optimize_spline_batch(loaded, art, None, cfg, "cpu")
    np.testing.assert_array_equal(got.geodesic_length, direct.geodesic_length)
    want = ref.final_lengths(
        dec, torch.as_tensor(got.omega_optimized).double(),
        torch.as_tensor(art.a).double(), torch.as_tensor(art.b).double(),
        art.basis, 32, "float64").numpy()
    assert np.max(np.abs(got.geodesic_length - want) / want) < 1e-6
    moved = np.abs(got.omega_optimized - art.omega_init).max()
    assert moved > 0


def _mc_rng(tree, g):
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused

    return energy_mc_fused.energy_mc_fused_rng(tree, g, 3, M, 2, "f32x2")


def _mc_planes(tree, g):
    from vae_latent_geometry_tpu_torch.ops import energy_mc_fused

    d = torch.zeros((2, T - 1, B), dtype=torch.int32)
    return energy_mc_fused.energy_mc_fused(tree, g, d, d, "f32x2")


def _stats(tree, g):
    return ef.ensemble_stats_fused(tree, g, ef.uniform_weights(M, B))


def _sharded(tree, g):
    return ef.energy_expected_sharded(tree, g, ef.uniform_weights(M, B))


def _transposed(tree, g):
    from vae_latent_geometry_tpu_torch.ops._research import energy_fused_t

    return energy_fused_t.energy_expected_fused_t(tree, g, "f32x2")


def _optimizer_mc_fused(tree, g):
    from vae_latent_geometry_tpu_torch.optim.geodesic import _energy_fn

    return _energy_fn("mc_fused", tree, g, seed=1)


@pytest.mark.parametrize("path", [_mc_rng, _mc_planes, _stats, _sharded,
                                  _transposed, _optimizer_mc_fused],
                         ids=["mc_fused_rng", "mc_fused_planes", "stats",
                              "sharded", "transposed", "optimizer_mc_fused"])
def test_fused_paths_without_the_head_refuse_it(dec, path):
    """Every fused path whose kernels compute a linear head's energy raises,
    naming the head, instead of returning that other function's value."""
    with pytest.raises(ValueError, match="'softmax' head"):
        path(_port(dec), _curves().float())


def test_fused_energy_takes_the_batchnorms_folded(dec):
    """``expected_fused`` refuses a tree whose BatchNorms are not folded
    (the ops never fold on a step); the optimizer's loss folds them once
    and gives the folded tree's energy."""
    from vae_latent_geometry_tpu_torch.optim.geodesic import make_loss_fn
    from geobench.reference import nullspace_basis

    g = _curves().float()
    with pytest.raises(ValueError, match="fold_batchnorm"):
        ef.energy_expected_fused(_port(dec), g)
    cfg = GeodesicConfig(energy=dataclasses.replace(
        GeodesicConfig().energy, mode="expected_fused", num_t=T,
        kernel_precision="float32"))
    basis = torch.as_tensor(nullspace_basis(4), dtype=torch.float32)
    loss = make_loss_fn(_port(dec), basis, cfg, "cpu")
    rng = np.random.default_rng(2)
    a, b = (torch.as_tensor(rng.normal(size=(B, D)), dtype=torch.float32)
            for _ in range(2))
    omega = torch.as_tensor(0.01 * rng.normal(size=(B, 5, D)),
                            dtype=torch.float32)
    _, e = loss(omega, a, b)
    folded = make_loss_fn(nets.fold_batchnorm(_port(dec)), basis, cfg,
                          "cpu")(omega, a, b)[1]
    assert torch.equal(e, folded)


@pytest.mark.parametrize("rung", RUNGS)
def test_softmax_weights_are_prepared_once(dec, rung):
    """The route's padded weights (hidden width 128, G to a multiple of
    128, b2 -inf past G, W2 as the rung's bf16 planes) are made once for a
    set of weights and made again after an in-place change."""
    from vae_latent_geometry_tpu_torch.ops import energy_softmax as es

    ws, bs, _, _ = ef._prepare_expected(nets.fold_batchnorm(_port(dec)),
                                        _curves().float(), None)
    first = es.prepared(ws, bs, rung)
    assert es.prepared(ws, bs, rung) is first
    w1, b1, w2a, w2b, b2, Gp = first
    assert Gp == 384 and w1.shape == (M, D, 128) and b1.shape == (M, 128)
    assert w2a.shape == w2b.shape == (M, 128, Gp)
    assert w2a.dtype == (torch.float32 if rung == "float32"
                         else torch.bfloat16)
    assert torch.isinf(b2[:, G:]).all() and (b2[:, G:] < 0).all()
    assert torch.equal(b2[:, :G], bs[1])
    assert not w2a[:, H:].any() and not w2a[:, :, G:].any()
    shipped = ef.ship_weights(ws, rung)[1]
    assert torch.equal(w2a[:, :H, :G].float(),
                       shipped if rung == "float32"
                       else shipped.to(torch.bfloat16).float())
    if rung == "f32x3":
        assert torch.equal(w2b[:, :H, :G], (shipped - w2a[:, :H, :G].float()
                                            ).to(torch.bfloat16))
    ws[1].mul_(1.0)
    assert es.prepared(ws, bs, rung) is not first


@pytest.mark.parametrize("precision,route", [("float32", "fma"),
                                             ("f32x3", "one_decode"),
                                             ("f32x2", "one_decode"),
                                             ("bfloat16", "one_decode")])
def test_production_shape_keeps_its_routes(precision, route):
    """evae10's decoders (2-128-128-50) keep K2's one-decode / fma routes
    and K1's; only a softmax head takes the new route."""
    widths = (2, 128, 128, 50)
    assert ef.k2_route(precision, widths) == route
    assert ef.k1_route(precision, widths) == (
        "fma" if precision == "float32" else "tiles_mma")
    assert ef.k2_route(precision, widths, "softmax") == "softmax"
    assert ef.k1_route(precision, (D, H, G), "softmax") == "softmax"
    assert ef.k2_route(precision, (D, 128, 128, 64)) == "any"


def test_single_fused_carries_the_head(dec):
    """``single_fused`` stacks decoder 0 with its head (the expected kernel
    at M = 1): its energy is decoder 0's first-difference energy."""
    from vae_latent_geometry_tpu_torch.optim.geodesic import _energy_fn

    one = evae.decoder_member(_port(dec), 0)
    g = _curves().float()
    got = _energy_fn("single_fused", nets.fold_batchnorm(one), g,
                     kernel_precision="float32")
    want = energy_lib.energy_single(one, g)
    assert _rel(got, want) < 1e-6


# ------------------------------------------------------------------ card

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(33, 5, 3, 10, 16, 300),
                                   (65, 3, 10, 10, 128, 2000),
                                   (2000, 16, 10, 10, 128, 2000)])
@pytest.mark.parametrize("precision", RUNGS)
def test_softmax_route_kernels_on_gpu(precision, shape):
    """K1's and K2's softmax-route kernels against their plain versions on
    the card: K1 to 1e-5 of each energy (float32 sums in another order, the
    card's exp); K2 under K2's limits (``test_torch_k2_onepass.py``: median
    and p99 of |error| / max |dgamma| below 1e-4 and 1e-3; float32 sums,
    and bf16 cotangents on the other side of a rounding boundary, up to
    2.6e-4 in a few elements at B=16); a repeat bit for bit; every launch
    counted on the route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from chip_smoke import softmax_inputs

    ws, bs, lib, g, wmb, ct = softmax_inputs(*shape, seed=7, dev="cuda")
    ef.reset_launch_counts()
    e = ef.energy_fwd(ws, bs, g, wmb, precision, lib)
    d = ef.energy_bwd(ws, bs, g, wmb, ct, precision, lib)
    assert torch.equal(e, ef.energy_fwd(ws, bs, g, wmb, precision, lib))
    assert torch.equal(d, ef.energy_bwd(ws, bs, g, wmb, ct, precision, lib))
    assert ef.K1_ROUTES["softmax"] == 2 and ef.K2_ROUTES["softmax"] == 2
    assert ef.SOFTMAX_PASSES == {"energy_fwd": 4, "energy_bwd": 8}
    e_p = ef.energy_fwd_plain(ws, bs, g, wmb, precision, lib)
    d_p = ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision, lib)
    assert float(((e - e_p).abs() / e_p.abs()).max()) < 1e-5
    err = ((d - d_p).abs() / d_p.abs().max()).flatten()
    assert float(err.median()) < 1e-4
    assert float(torch.quantile(err, 0.99)) < 1e-3


def test_scvi_tree_refuses_a_mismatched_sidecar(dec, tmp_path):
    """A model artifact whose decoders carry the softmax head but whose
    sidecar says linear is refused at load."""
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree

    path = str(tmp_path / "m.npz")
    save_pytree({"decoders": _port(dec)}, path,
                {"model_config": to_dict(dataclasses.replace(
                    SCVI, decoder_head="linear"))})
    with pytest.raises(ValueError, match="decoder_head"):
        evae.load_npz(path, "cpu")
