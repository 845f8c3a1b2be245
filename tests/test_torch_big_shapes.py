"""The shapes past the kernels' former cap, where no card is needed: X = 200,
D = 5, a 1024-unit hidden layer and 7 layers, and batches past the kernels'
32-bit index.

- The plain K1/K2 (expected energy, dgamma) and K5/K6 (sampled energy on
  index planes, dgamma) at that decoder against the JAX package's result at
  the same shape.  There the JAX fused modes run the plain XLA energy
  (``geometry/energy.energy_expected``; its ``fused_fits`` is False past X =
  128 or D = 4), so that is the reference, with its gradient by
  ``jax.vjp``; the sampled energy is the same decode through JAX's
  ``decode_all`` on the same numpy planes.  float32, energies rtol 1e-5,
  dgamma rtol 1e-4 (atol 1e-4 of its largest element), as
  ``tests/test_torch_shapes.py`` holds float32.
- The identities that the CUDA wrappers rest on.  X slices: every energy
  and dgamma at X = 200 equals the sum of those of the decoder's output
  columns in slices of 128 (K3's x0 and yb concatenate, its sq sums), within
  1e-6 of the largest element at float32 and for the energies and
  statistics at every rung.  A reduced rung's chain rounds each slice's
  cotangents to bf16 apart, so the kernels' dgamma past X = 128 (the
  slices' sum) lies within 2^-7 of the largest element of the whole-X
  chain's (the plain versions', measured up to 3.1e-3 on this problem), and
  is as close to the float32 dgamma as the whole-X chain is (within 25%, at
  the median and the 99th percentile of the error over the largest
  element; the JAX package has no reduced rung there: its fused modes fall
  back to the float32 XLA energy).  Spline ranges: with the index limit
  lowered so that the batch runs in several launches, the joined outputs
  equal the whole batch's within 1e-6 of the largest element.

The kernels themselves run only on the card: ``tests/test_torch_isolation.py
-m gpu -k big`` holds them against their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.geometry import energy as jenergy
from vae_latent_geometry_tpu.models import evae as jevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as mc

from torch_small_inputs import smooth_curves

# D = 5, a 1024-unit layer, 7 layers, X = 200
BIG = (5, 1024, 24, 24, 24, 24, 24, 200)
M, T, B, S = 3, 6, 3, 2
RUNGS = ("float32", "f32x3", "bfloat16")


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(11)
    layers = [((rng.normal(size=(M, i, o)) / np.sqrt(i)).astype(np.float32),
               (0.1 * rng.normal(size=(M, o))).astype(np.float32))
              for i, o in zip(BIG[:-1], BIG[1:])]
    gamma = smooth_curves(T, B, seed=3, D=BIG[0])
    ct = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
    d = rng.integers(0, M, size=(2 * S, T - 1, B)).astype(np.int32)
    return layers, gamma, ct, d[:S], d[S:]


def _torch(layers):
    return ([torch.from_numpy(w) for w, _ in layers],
            [torch.from_numpy(b) for _, b in layers])


def _jdec(layers):
    return {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                       for w, b in layers]}


def _jax(fn, gamma, ct):
    e, vjp = jax.vjp(fn, jnp.asarray(gamma))
    (dg,) = vjp(jnp.asarray(ct))
    return np.asarray(e), np.asarray(dg)


def _held(e_t, e_j, d_t, d_j):
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=1e-5)
    scale = np.abs(d_j).max()
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=1e-4, atol=1e-4 * scale)


def test_plain_expected_matches_jax_at_big_shape(problem):
    layers, gamma, ct, _, _ = problem
    ws, bs = _torch(layers)
    e_j, d_j = _jax(lambda g: jenergy.energy_expected(_jdec(layers), g),
                    gamma, ct)
    g, wmb = torch.from_numpy(gamma), ef.uniform_weights(M, B)
    _held(ef.energy_fwd(ws, bs, g, wmb, "float32"), e_j,
          ef.energy_bwd(ws, bs, g, wmb, torch.from_numpy(ct), "float32"), d_j)


def test_plain_mc_matches_jax_at_big_shape(problem):
    layers, gamma, ct, d1, d2 = problem

    def jax_mc(g):
        dec = jevae.decode_all(_jdec(layers), g)          # (M, T, B, X)
        oh1 = jax.nn.one_hot(jnp.asarray(d1), M, dtype=dec.dtype)
        oh2 = jax.nn.one_hot(jnp.asarray(d2), M, dtype=dec.dtype)
        x1 = jnp.einsum("stbm,mtbx->stbx", oh1, dec[:, :-1])
        x2 = jnp.einsum("stbm,mtbx->stbx", oh2, dec[:, 1:])
        return jnp.mean(jnp.sum((x2 - x1) ** 2, axis=(1, 3)), axis=0)

    e_j, d_j = _jax(jax_mc, gamma, ct)
    ws, bs = _torch(layers)
    g, p1, p2 = (torch.from_numpy(x) for x in (gamma, d1, d2))
    _held(mc.energy_mc_fwd(ws, bs, g, p1, p2, "float32"), e_j,
          mc.energy_mc_bwd(ws, bs, g, p1, p2, torch.from_numpy(ct),
                           "float32"), d_j)


def _ops(problem, precision):
    """Each kernel's plain function at the big decoder as fn(ws, bs, c0,
    c1, b0, b1) (output columns c0..c1 of the cotangents of K4, splines
    b0..b1), with how its outputs over X slices combine."""
    layers, gamma, ct, d1, d2 = problem
    g, cts = torch.from_numpy(gamma), torch.from_numpy(ct)
    p1, p2 = torch.from_numpy(d1), torch.from_numpy(d2)
    wmb = ef.uniform_weights(M, B)
    rng = np.random.default_rng(5)
    X = BIG[-1]
    dx0, dyb = (torch.from_numpy(rng.normal(size=(T, B, X)).astype(np.float32))
                for _ in range(2))
    dsq = torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))

    def sl(x, b0, b1):
        return x[:, b0:b1].contiguous()

    return {
        "K1": (lambda ws, bs, c0, c1, b0, b1: ef.energy_fwd(
            ws, bs, sl(g, b0, b1), sl(wmb, b0, b1), precision), "sum"),
        "K2": (lambda ws, bs, c0, c1, b0, b1: ef.energy_bwd(
            ws, bs, sl(g, b0, b1), sl(wmb, b0, b1), cts[b0:b1], precision),
            "sum"),
        "K3": (lambda ws, bs, c0, c1, b0, b1: ef.stats_fwd(
            ws, bs, sl(g, b0, b1), sl(wmb, b0, b1), precision), "stats"),
        "K4": (lambda ws, bs, c0, c1, b0, b1: ef.stats_bwd(
            ws, bs, sl(g, b0, b1), sl(wmb, b0, b1),
            sl(dx0[..., c0:c1], b0, b1), sl(dyb[..., c0:c1], b0, b1),
            sl(dsq, b0, b1), precision), "sum"),
        "K5": (lambda ws, bs, c0, c1, b0, b1: mc.energy_mc_fwd(
            ws, bs, sl(g, b0, b1), p1[:, :, b0:b1].contiguous(),
            p2[:, :, b0:b1].contiguous(), precision), "sum"),
        "K6": (lambda ws, bs, c0, c1, b0, b1: mc.energy_mc_bwd(
            ws, bs, sl(g, b0, b1), p1[:, :, b0:b1].contiguous(),
            p2[:, :, b0:b1].contiguous(), cts[b0:b1], precision), "sum"),
    }


def _flat(out):
    return torch.cat([x.reshape(-1) for x in (
        out if isinstance(out, tuple) else (out,))])


@pytest.mark.parametrize("precision", RUNGS)
@pytest.mark.parametrize("op", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_x_slices_sum_to_the_whole(problem, op, precision):
    fn, how = _ops(problem, precision)[op]
    ws, bs = _torch(problem[0])
    whole = fn(ws, bs, 0, BIG[-1], 0, B)
    if how == "stats":
        parts = [fn(wsx, bsx, c0, c1, 0, B)
                 for wsx, bsx, c0, c1 in ef.x_slices(ws, bs)]
        sliced = (torch.cat([p[0] for p in parts], -1),
                  torch.cat([p[1] for p in parts], -1),
                  sum(p[2] for p in parts[1:]) + parts[0][2])
    else:
        sliced = ef.sum_slices(ws, bs, lambda wsx, bsx, c0, c1: fn(
            wsx, bsx, c0, c1, 0, B))
    assert [c1 - c0 for *_, c0, c1 in ef.x_slices(ws, bs)] == [128, 72]
    a, b = _flat(whole), _flat(sliced)
    err = ((a - b).abs() / a.abs().max()).numpy()
    # a reduced rung's chain rounds each slice's cotangents to bf16 apart
    tol = 2.0**-7 if how == "sum" and op in ("K2", "K4", "K6") \
        and precision != "float32" else 1e-6
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
@pytest.mark.parametrize("op", ["K2", "K4", "K6"])
def test_sliced_reduced_chains_are_as_accurate_as_the_whole_chain(
        problem, op, precision):
    """At a reduced rung the kernels' dgamma past X = 128 is the slices'
    sum; its error against the float32 dgamma (over the largest element) is
    the whole-X chain's, within 25% at the median and the 99th percentile
    (measured: ratios 0.56-1.11 on this problem)."""
    ws, bs = _torch(problem[0])
    ref = _flat(_ops(problem, "float32")[op][0](ws, bs, 0, BIG[-1], 0, B))
    fn = _ops(problem, precision)[op][0]
    sliced = _flat(ef.sum_slices(ws, bs, lambda wsx, bsx, c0, c1: fn(
        wsx, bsx, c0, c1, 0, B)))
    whole = _flat(fn(ws, bs, 0, BIG[-1], 0, B))
    scale = ref.abs().max()
    e_s, e_w = (((x - ref).abs() / scale).numpy() for x in (sliced, whole))
    assert np.median(e_s) <= 1.25 * np.median(e_w)
    assert np.quantile(e_s, 0.99) <= 1.25 * np.quantile(e_w, 0.99)


@pytest.mark.parametrize("op", ["K1", "K2", "K3", "K4", "K5", "K6"])
def test_spline_ranges_join_to_the_whole(problem, op, monkeypatch):
    fn, _ = _ops(problem, "float32")[op]
    ws, bs = _torch(problem[0])
    whole = fn(ws, bs, 0, BIG[-1], 0, B)
    # one spline per launch: T * 1 * 1024 fits, T * 2 * 1024 does not
    monkeypatch.setattr(ef, "INDEX_LIMIT", T * 1024 + 1)
    assert ef.spline_ranges(T, B, BIG) == [(0, 1), (1, 2), (2, 3)]
    joined = ef.by_splines(T, B, ws, lambda b0, b1: fn(
        ws, bs, 0, BIG[-1], b0, b1))
    a, b = _flat(whole), _flat(joined)
    assert (a - b).abs().max() <= 1e-6 * a.abs().max()
