"""``ops/energy_fused`` stats path (plain versions of K3 and K4 through the
autograd Function) vs the JAX package's Pallas stats kernels, run in
interpret mode on the CPU.

Inputs from a numpy seed: narrow decoders 2 -> 16 -> 16 -> 10, M_loc of 4
local decoders, smooth curves T=48, B=6; and the committed model's
decoders at the production widths on a cut chunk (T=24, B=13), whose
x0 and yb are judged at max|x0| (rtol 1e-5, 1e-4 at bfloat16) and sq at its
own max, as chip_smoke.py judges the kernels.  float32: x0/yb/sq and dgamma at
rtol 1e-5 (atol 1e-5 of the array's max: the statistics cross zero); the
reduced rungs as ``tests/test_torch_energy_fused.py`` /
``test_torch_energy_grad.py``: values at rtol 1e-5 of the max, dgamma on the
median (1e-4) and the 99th percentile (1e-3) of the error relative to
max|dgamma|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

from torch_small_inputs import small_decoders_np, smooth_curves, torch_decoders

T, B, M_TOTAL = 48, 6, 8
NUM_ACTIVE = np.array([1, 2, 3, 5, 8, 4])


def _decoders(m_loc, shard):
    layers = small_decoders_np(M_TOTAL, seed=11)
    lo = shard * m_loc
    tdec = torch_decoders(layers, lo, lo + m_loc)
    jdec = {"layers": [{"w": jnp.asarray(w[lo:lo + m_loc]),
                        "b": jnp.asarray(b[lo:lo + m_loc])}
                       for w, b in layers]}
    return tdec, jdec


def _planes(weights, m_loc, shard):
    """Local weight rows of shard ``shard`` for both packages; the JAX rows
    are cut from its global plane (its local helper reads the shard index
    from a mesh axis)."""
    if weights == "uniform":
        return (ef.uniform_weights_local(M_TOTAL, m_loc, B),
                jep.uniform_weights_local(M_TOTAL, m_loc, B))
    lo = shard * m_loc
    jw = jep.active_weights(jnp.asarray(NUM_ACTIVE), M_TOTAL, B)[lo:lo + m_loc]
    tw = ef.active_weights_local(torch.from_numpy(NUM_ACTIVE), M_TOTAL, m_loc,
                                 B, shard)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    return tw, jw


@pytest.mark.parametrize("weights", ["uniform", "active"])
@pytest.mark.parametrize("m_loc", [1, 2, 4])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_stats_and_gradient_match_jax_kernels(precision, m_loc, weights):
    shard = 1                      # not the first shard: offset arithmetic
    tdec, jdec = _decoders(m_loc, shard)
    tw, jw = _planes(weights, m_loc, shard)
    gamma = smooth_curves(T, B, seed=5)
    rng = np.random.default_rng(9)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((T, B, 10), (T, B, 10), (T, B))]

    ref, vjp = jax.vjp(
        lambda g: jep.ensemble_stats_fused(jdec, g, jw, precision),
        jnp.asarray(gamma))
    (dref,) = vjp(tuple(jnp.asarray(c) for c in cts))
    dref = np.asarray(dref)

    g = torch.from_numpy(gamma).requires_grad_(True)
    out = ef.ensemble_stats_fused(tdec, g, tw, precision)
    (dout,) = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cts)), g)
    dout = dout.numpy()

    for name, o, r in zip(("x0", "yb", "sq"), out, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(r).max(), 1e-30),
                                   err_msg=name)
    if m_loc == 1:                 # no centered moments on a one-decoder shard
        assert not out[1].any() and not out[2].any()
    scale = np.abs(dref).max()
    if precision == "float32":
        np.testing.assert_allclose(dout, dref, rtol=1e-5, atol=1e-5 * scale)
    else:
        err = np.abs(dout - dref) / scale
        assert np.median(err) < 1e-4, np.median(err)
        assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)


@pytest.mark.parametrize("weights", ["uniform", "active"])
@pytest.mark.parametrize("precision", ef.PRECISIONS)
def test_one_shard_sharded_energy_is_the_fused_energy(precision, weights):
    """``energy_expected_sharded`` on one shard of all decoders against
    ``energy_expected_fused``, value and gradient, in both packages."""
    tdec, jdec = _decoders(M_TOTAL, 0)
    tw, jw = _planes(weights, M_TOTAL, 0)
    gamma = smooth_curves(T, B, seed=6)
    ct = np.linspace(0.5, 2.0, B).astype(np.float32)

    def run_t(fn):
        g = torch.from_numpy(gamma).requires_grad_(True)
        e = fn(g)
        (d,) = torch.autograd.grad((torch.from_numpy(ct) * e).sum(), g)
        return e.detach().numpy(), d.numpy()

    e_sh, d_sh = run_t(lambda g: ef.energy_expected_sharded(
        tdec, g, tw, None, precision))
    e_fu, d_fu = run_t(lambda g: ef.energy_expected_fused(
        tdec, g, tw, precision))
    e_j, vjp = jax.vjp(lambda g: jep.energy_expected_sharded(
        jdec, g, jw, None, precision), jnp.asarray(gamma))
    (d_j,) = vjp(jnp.asarray(ct))
    e_jf = jep.energy_expected_fused(jdec, jnp.asarray(gamma), jw, precision)

    np.testing.assert_allclose(e_sh, e_fu, rtol=1e-5)
    np.testing.assert_allclose(e_sh, np.asarray(e_j), rtol=1e-5)
    np.testing.assert_allclose(e_sh, np.asarray(e_jf), rtol=1e-5)
    scale = np.abs(d_fu).max()
    for other in (d_fu, np.asarray(d_j)):
        if precision == "float32":
            np.testing.assert_allclose(d_sh, other, rtol=1e-3,
                                       atol=1e-4 * scale)
        else:
            err = np.abs(d_sh - other) / scale
            assert np.median(err) < 1e-4 and np.quantile(err, 0.99) < 1e-3


def test_shards_cover_the_global_energy():
    """Two shards' statistics, summed by hand as the all-reduces would,
    assemble the energy of the whole ensemble (float32)."""
    gamma = torch.from_numpy(smooth_curves(T, B, seed=7))
    tdec, _ = _decoders(M_TOTAL, 0)
    tw, _ = _planes("active", M_TOTAL, 0)
    want = ef.energy_expected_fused(tdec, gamma, tw).numpy()
    s1, parts = 0.0, []
    for shard in (0, 1):
        dec, _ = _decoders(4, shard)
        w, _ = _planes("active", 4, shard)
        x0, yb, sq = ef.ensemble_stats_fused(dec, gamma, w)
        s1 = s1 + w.sum(0)[None, :, None] * x0 + yb
        parts.append((x0, yb, sq, w.sum(0)))
    var = 0.0
    for x0, yb, sq, w_sum in parts:
        d0 = x0 - s1
        var = var + sq + 2.0 * (yb * d0).sum(-1) \
            + w_sum[None, :] * (d0 * d0).sum(-1)
    diff = s1[1:] - s1[:-1]
    got = ((diff * diff).sum(-1) + var[1:] + var[:-1]).sum(0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "experiment", "model_seed42.npz")
# the production chunk's 2000 x 200 points cut to 24 x 13 = 312, not a
# multiple of the kernels' 128-point tile
T_PROD, B_PROD = 24, 13


@pytest.mark.parametrize("m_loc,shard", [(10, 0), (5, 1)])
@pytest.mark.parametrize("precision", ["f32x3", "f32x2", "bfloat16"])
def test_stats_at_production_widths_match_jax_kernels(precision, m_loc,
                                                      shard):
    """The plain K3/K4 on the committed model's decoders (2 -> 128 -> 128 ->
    50, the widths the tensor-core kernels run at the reduced rungs), local
    rows of mixed per-spline decoder counts, against the JAX stats kernels
    in interpret mode under this file's tolerances: the function the
    kernels are held to on the card."""
    z = np.load(MODEL)
    lo = shard * m_loc
    layers = [(z[f"decoders/layers/{i}/w"][lo:lo + m_loc],
               z[f"decoders/layers/{i}/b"][lo:lo + m_loc]) for i in range(3)]
    tdec = torch_decoders(layers)
    jdec = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                       for w, b in layers]}
    num_active = np.random.default_rng(4).integers(1, 11, size=B_PROD)
    jw = jep.active_weights(jnp.asarray(num_active), 10, B_PROD)[lo:lo + m_loc]
    tw = ef.active_weights_local(torch.from_numpy(num_active), 10, m_loc,
                                 B_PROD, shard)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    gamma = 2.0 * smooth_curves(T_PROD, B_PROD, seed=8)
    rng = np.random.default_rng(10)
    cts = [rng.normal(size=s).astype(np.float32)
           for s in ((T_PROD, B_PROD, 50), (T_PROD, B_PROD, 50),
                     (T_PROD, B_PROD))]

    ref, vjp = jax.vjp(
        lambda g: jep.ensemble_stats_fused(jdec, g, jw, precision),
        jnp.asarray(gamma))
    (dref,) = vjp(tuple(jnp.asarray(c) for c in cts))
    dref = np.asarray(dref)
    g = torch.from_numpy(gamma).requires_grad_(True)
    out = ef.ensemble_stats_fused(tdec, g, tw, precision)
    (dout,) = torch.autograd.grad(
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cts)), g)

    # x0 and yb at the decoder outputs' scale max|x0| (yb is a deviation of
    # a few units that carries the rounding of outputs of ~60), sq at its
    # own, as chip_smoke.py judges the kernels; at bfloat16 a one-ulp
    # summation-order difference flips a bf16 rounding of an activation
    # (measured 3.4e-5 here, 2e-3 between the kernel and its plain version
    # on the card)
    rtol = 1e-4 if precision == "bfloat16" else 1e-5
    x_scale = np.abs(np.asarray(ref[0])).max()
    for name, o, r in zip(("x0", "yb", "sq"), out, ref):
        r = np.asarray(r)
        scale = np.abs(r).max() if name == "sq" else x_scale
        np.testing.assert_allclose(o.detach().numpy(), r, rtol=0,
                                   atol=rtol * scale, err_msg=name)
    err = np.abs(dout.numpy() - dref) / np.abs(dref).max()
    assert np.median(err) < 1e-4, np.median(err)
    assert np.quantile(err, 0.99) < 1e-3, np.quantile(err, 0.99)


def test_stats_wrappers_check_their_arguments():
    """Device, shape and rung checks of the K3/K4 wrappers (pure Python)."""
    tdec, _ = _decoders(2, 0)
    ws, bs = ef.stack_weights(tdec)
    g = torch.from_numpy(smooth_curves(T, B))
    w = ef.uniform_weights_local(M_TOTAL, 2, B)
    meta = torch.empty((T, B, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ef.stats_fwd(ws, bs, meta, w, "float32")
    with pytest.raises(ValueError, match="no kernel for device"):
        ef.stats_bwd(ws, bs, meta, w, meta, meta, meta, "float32")
    with pytest.raises(ValueError, match="precision"):
        ef.ensemble_stats_fused(tdec, g, w, "fp8")
    x0, yb, sq = ef.stats_fwd(ws, bs, g, w, "float32")
    with pytest.raises(ValueError, match="dsq must be"):
        ef.stats_bwd(ws, bs, g, w, x0, yb, x0, "float32")
    # the CUDA path's checks: the kernels take the narrow decoders and a
    # hidden layer of any width
    assert ef._check_cuda(ws, bs, g, w)[3] == 2
    wide = [torch.zeros(2, ws[0].shape[1], 1025),
            torch.zeros(2, 1025, ws[1].shape[2]), *ws[2:]]
    wide_b = [torch.zeros(2, 1025), *bs[1:]]
    assert ef._check_cuda(wide, wide_b, g, w)[3] == 2
    assert ef.LAUNCHES["stats_fwd"] == 0 and ef.LAUNCHES["stats_bwd"] == 0
