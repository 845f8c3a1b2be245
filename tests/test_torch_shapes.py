"""The kernels' plain versions against the JAX package's kernels (interpret
mode, as the JAX suite runs them) on decoders of other depths and widths
than the production model's, and the CUDA wrappers' shape check.

The decoders are ``tools/jax_reference_shapes.py``'s S1-S4 (seeded numpy
weights, members that differ): 2 -> 16 -> 10, 2 -> 64 -> 64 -> 50,
2 -> 256 -> 128 -> 128 and 2 -> 96 -> 160 -> 48 -> 100.  Every kernel family
is held: K1/K2 (the expected energy, mixed per-spline decoder counts),
K3/K4 (the shard statistics), K5-K8 (the sampled energy on identical index
planes: random ones for K5/K6, the planes ``philox_draws`` makes for K7/K8)
and K9/K10 (the transposed layout, 3-layer shapes S2 and S3), at float32,
f32x3 and bfloat16.

Tolerances (those of tests/test_torch_fallback.py's narrow model): energies
rtol 1e-5, 1e-4 at bfloat16; dgamma rtol 1e-4 (atol 1e-4 of its largest
element) at float32; at f32x3 the error over the largest element has median
<= 1e-4 and 99th percentile <= 1e-3 (a one-ulp fp32 difference can flip a
bf16 rounding of the chain); at bfloat16 it is <= 2e-3 everywhere (the two
packages sum bf16 products in another order).  The statistics x0, yb, sq
at rtol 1e-5 with an atol of 1e-5 of their largest element
(tests/test_torch_stats.py); at bfloat16 within 2e-3 of the outputs' scale
(x0, yb) or of their largest element (sq), as dgamma.  T = 32, B = 4.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu.ops._research import energy_pallas_t as jt
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc
from vae_latent_geometry_tpu_torch.ops._research import energy_fused_t as eft

from torch_parity_inputs import REPO

T, B, S = 32, 4, 2
RUNGS = ("float32", "f32x3", "bfloat16")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load(os.path.join(REPO, "tools", "jax_reference_shapes.py"),
            "jax_reference_shapes")


def _problem(name):
    layers = REF.shape_layers(name)
    tw = [torch.from_numpy(w) for w, _ in layers]
    tb = [torch.from_numpy(b) for _, b in layers]
    jdec = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                       for w, b in layers]}
    gamma = REF.shape_curves(T, B)
    return tw, tb, jdec, gamma, REF.cotangent(B), layers[0][0].shape[0]


def _jax(fn, gamma, ct):
    e, vjp = jax.vjp(fn, jnp.asarray(gamma))
    (dg,) = vjp(jnp.asarray(ct))
    return np.asarray(e), np.asarray(dg)


def _close(e_t, e_j, d_t, d_j, precision):
    e_t, d_t = (np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)
                for x in (e_t, d_t))
    scale = np.abs(d_j).max()
    err = np.abs(d_t - d_j) / scale
    if precision == "bfloat16":
        np.testing.assert_allclose(e_t, e_j, rtol=1e-4)
        assert err.max() <= 2e-3, err.max()
    elif precision == "f32x3":
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
        assert np.median(err) <= 1e-4, np.median(err)
        assert np.quantile(err, 0.99) <= 1e-3, np.quantile(err, 0.99)
    else:
        np.testing.assert_allclose(e_t, e_j, rtol=1e-5)
        np.testing.assert_allclose(d_t, d_j, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("name", ["S1", "S2", "S3", "S4"])
def test_expected_kernels_match_jax(name, precision):
    """K1 and K2 (their plain versions) against ``_fwd_kernel`` and
    ``_bwd_kernel``, mixed per-spline decoder counts."""
    tw, tb, jdec, gamma, ct, M = _problem(name)
    counts = np.minimum(np.array([1, 2, 3, M]), M)
    e_j, d_j = _jax(lambda g: jep.energy_expected_fused(
        jdec, g, jep.active_weights(jnp.asarray(counts), M, B), precision),
        gamma, ct)
    wmb = ef.active_weights(torch.as_tensor(counts), M, B)
    g = torch.from_numpy(gamma)
    e_t = ef.energy_fwd(tw, tb, g, wmb, precision)
    d_t = ef.energy_bwd(tw, tb, g, wmb, torch.from_numpy(ct), precision)
    _close(e_t, e_j, d_t, d_j, precision)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("name", ["S1", "S2", "S3", "S4"])
def test_stats_kernels_match_jax(name, precision):
    """K3 and K4 against ``_stats_fwd_kernel`` and ``_stats_bwd_kernel`` on
    the second of two shards."""
    tw, tb, jdec, gamma, _, M = _problem(name)
    lo = M // 2
    tw, tb = [w[lo:].contiguous() for w in tw], [b[lo:].contiguous()
                                                 for b in tb]
    jdec = jax.tree_util.tree_map(lambda x: x[lo:], jdec)
    m_loc = M - lo
    wmb = ef.uniform_weights_local(M, m_loc, B)
    rng = np.random.default_rng(3)
    X = tw[-1].shape[-1]
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((T, B, X), (T, B, X), (T, B))]
    ref, vjp = jax.vjp(lambda g: jep.ensemble_stats_fused(
        jdec, g, jnp.asarray(wmb.numpy()), precision), jnp.asarray(gamma))
    (d_j,) = vjp(tuple(jnp.asarray(c) for c in cts))
    g = torch.from_numpy(gamma)
    out = ef.stats_fwd(tw, tb, g, wmb, precision)
    x_scale = np.abs(np.asarray(ref[0])).max()
    for what, o, r in zip(("x0", "yb", "sq"), out, ref):
        r = np.asarray(r)
        if precision == "bfloat16":
            # a one-ulp fp32 difference can flip a hidden unit's bf16
            # rounding (2^-8 of it): x0 and yb at 2e-3 of the outputs'
            # scale, sq at 2e-3 of its own
            scale = max(np.abs(r).max(), 1e-30) if what == "sq" else x_scale
            assert np.abs(o.numpy() - r).max() <= 2e-3 * scale, what
        else:
            np.testing.assert_allclose(
                o.numpy(), r, rtol=1e-5,
                atol=1e-5 * max(np.abs(r).max(), 1e-30), err_msg=what)
    d_t = ef.stats_bwd(tw, tb, g, wmb, *(torch.from_numpy(c) for c in cts),
                       precision)
    d_j = np.asarray(d_j)
    err = np.abs(d_t.numpy() - d_j) / np.abs(d_j).max()
    if precision == "float32":
        np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-4,
                                   atol=1e-4 * np.abs(d_j).max())
    else:
        limit = 2e-3 if precision == "bfloat16" else 1e-3
        assert np.median(err) <= 1e-4, np.median(err)
        assert np.quantile(err, 0.99) <= limit, np.quantile(err, 0.99)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("name", ["S1", "S2", "S3", "S4"])
def test_mc_kernels_match_jax(name, precision):
    """K5/K6 against ``_fwd_kernel`` / ``_bwd_kernel`` of the MC op on the
    same random planes, and K7/K8 (draws made by Philox) against them on
    the planes ``philox_draws`` reproduces."""
    tw, tb, jdec, gamma, ct, M = _problem(name)
    rng = np.random.default_rng(4)
    planes = rng.integers(0, M, size=(2, S, T - 1, B)).astype(np.int32)
    g, c = torch.from_numpy(gamma), torch.from_numpy(ct)
    e_j, d_j = _jax(lambda x: jmc.energy_mc_fused(
        jdec, x, jnp.asarray(planes[0]), jnp.asarray(planes[1]), precision),
        gamma, ct)
    d1, d2 = (torch.from_numpy(p) for p in planes)
    _close(mc.energy_mc_fwd(tw, tb, g, d1, d2, precision), e_j,
           mc.energy_mc_bwd(tw, tb, g, d1, d2, c, precision), d_j, precision)
    seed, kmax = (1 << 33) + 7, torch.full((B,), float(M))
    p1, p2 = mc.philox_draws(seed, S, T, B, kmax)
    e_j, d_j = _jax(lambda x: jmc.energy_mc_fused(
        jdec, x, jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy()),
        precision), gamma, ct)
    _close(mc.energy_mc_fwd_rng(tw, tb, g, seed, kmax, S, precision), e_j,
           mc.energy_mc_bwd_rng(tw, tb, g, seed, kmax, S, c, precision), d_j,
           precision)


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("name", ["S2", "S3"])
def test_transposed_kernels_match_jax(name, precision):
    """K9 and K10 against ``_fwd_kernel_T`` and ``_bwd_kernel_T`` on the
    3-layer shapes (the op takes 3-layer decoders only)."""
    tw, tb, jdec, gamma, ct, _ = _problem(name)
    e_j, d_j = _jax(lambda g: jt.energy_expected_fused_t(jdec, g, precision),
                    gamma, ct)
    g = torch.from_numpy(gamma)
    _close(eft.energy_t_fwd(tw, tb, g, precision), e_j,
           eft.energy_t_bwd(tw, tb, g, torch.from_numpy(ct), precision), d_j,
           precision)


def test_chip_smoke_keeps_the_same_seed_code():
    """``chip_smoke.py`` builds the same decoders and curves as the JAX
    reference's generator, bit for bit."""
    smoke = _load(os.path.join(REPO, "chip_smoke.py"), "chip_smoke_copy")
    assert smoke.SHAPES == REF.SHAPES
    for name in REF.SHAPES:
        for (w, b), (w2, b2) in zip(REF.shape_layers(name),
                                    smoke.shape_layers(name)):
            assert np.array_equal(w, w2) and np.array_equal(b, b2)
    assert np.array_equal(REF.shape_curves(T, B), smoke.shape_curves(T, B))
    assert np.array_equal(REF.cotangent(B), smoke.cotangent(B))


# ---------------------------------------------------------------------------
# the CUDA wrappers' shape check (pure Python, on CPU or meta tensors)
# ---------------------------------------------------------------------------

def _decoder(dims, M=2, device="cpu"):
    ws = [torch.zeros((M, i, o), device=device)
          for i, o in zip(dims[:-1], dims[1:])]
    bs = [torch.zeros((M, o), device=device) for o in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("name", ["S1", "S2", "S3", "S4", "S5"])
def test_shape_check_accepts_every_shape_in_the_table(name):
    dims, M = REF.SHAPES[name]
    ws, bs = _decoder(dims, M, "meta")
    g = torch.empty((T, B, dims[0]), device="meta")
    assert ef._check_cuda(ws, bs, g, ef.uniform_weights(M, B, "meta")) == (
        T, B, dims[0], M, dims[-1])


def test_shape_check_accepts_the_cap_edge():
    """The former cap's edge (6 layers, hidden layers of 512 units, X = 128,
    D = 4) still passes, and so does everything past it: X = 128 is the
    widest output of one launch, wider ones run in column slices."""
    dims = (4,) + (512,) * 5 + (ef.MAX_X,)
    ws, bs = _decoder(dims, 1, "meta")
    g = torch.empty((T, B, 4), device="meta")
    assert ef._check_cuda(ws, bs, g) == (T, B, 4, 1, ef.MAX_X)
    assert ef.MAX_X == 128
    assert [c1 - c0 for *_, c0, c1 in ef.x_slices(ws, bs)] == [128]


@pytest.mark.parametrize("case", ["x129", "d5", "bias", "width", "depth",
                                  "int32"])
def test_shape_check_refuses_naming_the_plain_modes(case):
    """A malformed decoder (a bias that does not match its weight) raises
    before any launch and the message names the plain modes; the shapes past
    the former cap (X > 128, D > 4, a hidden layer wider than 512, more than
    6 layers, T * B * width >= 2^31) pass: the kernels take them."""
    dims = {"x129": (2, 64, 129), "d5": (5, 64, 10), "bias": (2, 64, 10),
            "width": (2, 513, 10), "depth": (2,) + (16,) * 6 + (10,),
            "int32": (2, 512, 10)}[case]
    ws, bs = _decoder(dims, 2, "meta")
    if case == "bias":
        bs[0] = torch.zeros((2, 63), device="meta")
    # int32: a batch past the 32-bit index at this T
    n_b = 2**31 // (512 * T) + 1 if case == "int32" else 1
    g = torch.empty((T, n_b, dims[0]), device="meta")
    if case == "bias":
        with pytest.raises(ValueError, match="run the plain mode instead"):
            ef._check_cuda(ws, bs, g)
    else:
        assert ef._check_cuda(ws, bs, g) == (*g.shape, 2, dims[-1])
    if case == "int32":
        ranges = ef.spline_ranges(T, g.shape[1], dims)
        assert len(ranges) == 2 and ranges[-1][1] == g.shape[1]
        assert all(T * (b1 - b0) * 512 < ef.INDEX_LIMIT for b0, b1 in ranges)
    assert not any(ef.LAUNCHES.values())
