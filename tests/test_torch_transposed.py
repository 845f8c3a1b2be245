"""``ops/_research/energy_fused_t`` (plain versions of K9 and K10) vs the
JAX package's transposed-layout Pallas kernels, run in interpret mode on the
CPU as ``tests/test_energy_pallas.py:325-357`` runs them.

Inputs: the first four seed-42 production decoders and random curves made
with numpy from a seed, at (T, B) = (32, 6) (one chunk) and (64, 300)
(several T-chunks and B-blocks on the TPU side).  Tolerances, each rung
against the JAX op at the same rung:
- energies: rtol 1e-5 (the JAX suite's) at float32, f32x3 and f32x2; 1e-4
  at bfloat16, where a one-ulp float32 difference between the two
  packages' summation orders flips the bf16 rounding of an activation
  (~4e-3 of that value; measured 2.6e-5 on the energy at 64 x 300);
- dgamma at float32: rtol 5e-3, atol 1e-5 (the JAX suite's own for this
  op) on every point away from a ReLU kink.  A point where some unit's
  pre-activation lies within 1e-6 of the magnitude of its terms (float64)
  takes its ReLU branch by rounding, in either package's order; such
  points (0.3% here) are left out and counted (< 1%).  Under the reduced
  rungs the chain is single-pass bf16 in both packages and a one-ulp
  difference can flip a bf16 rounding, so dgamma is held on the median
  (1e-4) and the 99th percentile (1e-3) of the error relative to
  max|dgamma|, as the K2 tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops._research import energy_pallas_t as jt
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops._research import energy_fused_t as eft

from torch_parity_inputs import MODEL, members

M = 4
SHAPES = [(32, 6), (64, 300)]


@pytest.fixture(scope="module")
def decoders():
    return members(tevae.load_npz(MODEL, "cpu"), M)


def _curves(T, B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, B, 2)) * 1.5).astype(np.float32)


def _kink_margin(tdec, g):
    """(T, B): per point, the smallest |pre-activation| of any hidden unit
    of any decoder relative to the sum of its terms' magnitudes, in
    float64."""
    z = torch.from_numpy(g).double().reshape(-1, g.shape[-1])
    margin = torch.full((z.shape[0],), float("inf"), dtype=torch.float64)
    for m in range(M):
        h = z
        for lyr in tdec["layers"][:-1]:
            w, b = lyr["w"][m].double(), lyr["b"][m].double()
            pre = h @ w + b
            scale = h.abs() @ w.abs() + b.abs()
            margin = torch.minimum(margin, (pre.abs() / scale).min(1).values)
            h = torch.relu(pre)
    return margin.reshape(g.shape[:2]).numpy()


@pytest.mark.parametrize("T,B", SHAPES, ids=["32x6", "64x300"])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_value_and_gradient_match_jax(decoders, precision, T, B):
    tdec, jdec = decoders
    g = _curves(T, B)
    w = np.linspace(0.5, 2.0, B).astype(np.float32)
    e_ref, vjp = jax.vjp(
        lambda x: jt.energy_expected_fused_t(jdec, x, precision),
        jnp.asarray(g))
    (gr_ref,) = vjp(jnp.asarray(w))
    gt = torch.from_numpy(g).requires_grad_(True)
    e = eft.energy_expected_fused_t(tdec, gt, precision)
    (gr,) = torch.autograd.grad((e * torch.from_numpy(w)).sum(), gt)
    np.testing.assert_allclose(e.detach().numpy(), np.asarray(e_ref),
                               rtol=1e-4 if precision == "bfloat16" else 1e-5)
    gr, gr_ref = gr.numpy(), np.asarray(gr_ref)
    if precision == "float32":
        smooth = _kink_margin(tdec, g) > 1e-6
        assert smooth.mean() > 0.99
        np.testing.assert_allclose(gr[smooth], gr_ref[smooth], rtol=5e-3,
                                   atol=1e-5)
    else:
        err = np.abs(gr - gr_ref) / np.abs(gr_ref).max()
        assert np.median(err) < 1e-4 and np.quantile(err, 0.99) < 1e-3, (
            np.median(err), np.quantile(err, 0.99))


def test_forward_is_k1_with_uniform_weights(decoders):
    """K9 computes K1's function on the uniform weight plane (the same
    shipping of W1 at the bfloat16 rung); checked against the JAX K1."""
    tdec, jdec = decoders
    from vae_latent_geometry_tpu.ops import energy_pallas as jep

    g = _curves(32, 6, seed=1)
    for precision in ef.PRECISIONS:
        e = eft.energy_expected_fused_t(tdec, torch.from_numpy(g), precision)
        ref = np.asarray(jep.energy_expected_fused(jdec, jnp.asarray(g), None,
                                                   precision))
        np.testing.assert_allclose(e.numpy(), ref, rtol=1e-5)


def test_bfloat16_gradient_uses_float32_first_layer(decoders):
    """At the bfloat16 rung K10's dgamma product takes float32 W1 while the
    decode takes it rounded to bf16: the plain version differs from K2's
    plain version there and only there."""
    tdec, _ = decoders
    ws, bs = ef.stack_weights(tdec)
    g = torch.from_numpy(_curves(32, 6, seed=2))
    ct = torch.linspace(0.5, 2.0, 6)
    wmb = ef.uniform_weights(M, 6)
    for precision in ("float32", "f32x2"):
        torch.testing.assert_close(
            eft.energy_t_bwd_plain(ws, bs, g, ct, precision),
            ef.energy_bwd_plain(ws, bs, g, wmb, ct, precision),
            rtol=1e-5, atol=1e-6)
    d_t = eft.energy_t_bwd_plain(ws, bs, g, ct, "bfloat16")
    d_2 = ef.energy_bwd_plain(ws, bs, g, wmb, ct, "bfloat16")
    assert not torch.allclose(d_t, d_2, rtol=1e-6, atol=0)
    assert torch.allclose(d_t, d_2, rtol=2e-2, atol=1e-3 * d_2.abs().max())


@pytest.mark.parametrize("T", [8, 16, 30, 32, 40, 64, 100, 128, 2000, 2001])
def test_fits_agrees_with_jax(T):
    for B, D, X, M_, kw in ((200, 2, 50, 10, {}), (6, 3, 50, 4, {}),
                            (6, 2, 129, 4, {}), (6, 2, 50, 17, {}),
                            (6, 2, 50, 4, {"n_layers": 2}),
                            (6, 2, 50, 4, {"num_active": np.array([1])}),
                            (6, 2, 50, 4, {"wmb": np.ones((4, 6))})):
        assert eft.fused_t_fits(T, B, D, X, M_, **kw) == \
            jt.fused_t_fits(T, B, D, X, M_, **kw), (T, B, D, X, M_, kw)


def test_refused_shapes_raise(decoders):
    tdec, _ = decoders
    with pytest.raises(ValueError, match="8-aligned"):
        eft.energy_expected_fused_t(tdec, torch.zeros(30, 3, 2))
    two_layer = {"layers": tdec["layers"][1:]}
    with pytest.raises(ValueError, match="3-layer"):
        eft.energy_expected_fused_t(two_layer, torch.zeros(32, 3, 128))


def test_spans_cover_the_curve():
    """Every (spline group, span) item is inside [0, T), the spans tile T,
    and the production shape splits T into 13 spans on 132 SMs."""
    assert ef.pick_spans(2000, 200, 132, 1) == (154, 13)
    for T, B, n_sm in ((32, 6, 132), (64, 300, 132), (2000, 200, 7),
                       (40, 1, 1)):
        for halo in (1, 2):
            span, G = ef.pick_spans(T, B, n_sm, halo)
            assert (G - 1) * span < T <= G * span
