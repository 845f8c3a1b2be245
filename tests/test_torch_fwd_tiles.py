"""The forward energies at the reduced rungs on the tensor cores (K1's
``k1_tiles_mma`` in ``ops/csrc/tiles_mma.cuh``, K5/K7's
``mc_tiles_mma`` in ``ops/csrc/energy_mc.cu``), checked where no card is
needed.

- The sources: the reduced-rung branch of each forward launcher (K1, K5/K7)
  launches a tensor-core kernel and no longer the CUDA-core kernels
  (``k1_energy_tiles``, ``mc_segments``, ``k9_tiles_mma``), which are gone;
  both kernels decode with ``decode_mma<R, true>``.
- The tiling: a plain-PyTorch model of the kernels' work split -- tiles of
  32 curve rows x 4 splines that overlap by one row, each owning the 31
  segments that start in its first 31 rows; K1's statistics centred on
  decoder 0 with the per-spline weight plane; K5's differences formed per
  sweep of samples as one subtraction and one addition from 0; the
  segments summed in the tile and the tiles in a fixed order -- gives the
  JAX package's K1 and K5 (interpret mode on the CPU, as
  ``tests/test_torch_mc_samples.py`` runs them) on ragged shapes (T - 1 not
  a multiple of 31, B not a multiple of 4) at f32x2 and bfloat16, at the
  JAX suite's energy tolerance rtol 1e-5, with the decode of the port's
  plain version (``_decode_plain``).
- Early stopping at ``mc_fused`` (the path that launches K7 on every step)
  on the CPU: one seed twice gives the same run bit for bit.

The kernels themselves run only on the card: ``tests/test_torch_isolation.py
-m gpu -k tiles`` holds them against their plain versions there.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    optimize_spline_early_stopping)

from torch_parity_inputs import INIT, MODEL, init_curves, members

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vae_latent_geometry_tpu_torch", "ops", "csrc")
NS, RC = 4, 32          # splines and curve rows of a tile
KR = RC - 1             # segments a tile owns per spline
T, B = 70, 6            # 69 segments: two whole tiles and 7; B: one and a half


@pytest.fixture(scope="module")
def decoders():
    return tevae.load_npz(MODEL, "cpu")


def _code(path):
    """A source without its // comments."""
    return re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, path)).read())


def _body(source, head):
    """The braced block that follows the first ``head`` in ``source``."""
    start = source.index(head)
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[i:j + 1]
    raise AssertionError(f"{head}: unbalanced braces")


def _reduced_branch(source):
    """The reduced-rung branch of ``launch_fwd``: the block after the
    ``else`` of its ``if constexpr (R == F32)``."""
    body = _body(source, "cudaError_t launch_fwd(")
    f32 = body.index("if constexpr (R == F32)")
    rest = body[f32 + len(_body(body[f32:], "if constexpr")):]
    return _body(rest, "else")


@pytest.mark.parametrize("src,kernel", [
    ("energy_expected.cu", "k1_tiles_mma"),
    ("energy_mc.cu", "mc_tiles_mma")])
def test_reduced_rungs_launch_the_tensor_core_kernels(src, kernel):
    branch = _reduced_branch(_code(src))
    assert f"{kernel}<R><<<" in branch, branch
    for old in ("k1_energy_tiles<", "mc_segments<", "launch_segments",
                "k9_tiles_mma"):
        assert old not in branch, (src, old)


def test_the_cuda_core_reduced_rung_kernels_are_gone():
    sources = {name: _code(name) for name in os.listdir(CSRC)}
    for name, code in sources.items():
        assert "k9_tiles_mma" not in code, name
        assert not re.search(r"\bk1_energy_tiles\b", code), name
    # mc_segments stays: the float32 backward's first pass, launched only
    # by the float32 launcher
    mc = sources["energy_mc.cu"]
    assert "mc_segments<R><<<" in _body(mc, "cudaError_t launch_bwd(")
    assert mc.count("mc_segments<R><<<") == 1
    for name, kernel in (("tiles_mma.cuh", "k1_tiles_mma"),
                         ("energy_mc.cu", "mc_tiles_mma")):
        body = _body(sources[name], f"\n{kernel}(")
        assert "decode_mma<R, true>(" in body, kernel


# --------------------------------------------------------------- tiling ---

def _decode_all(ws, bs, gamma, precision):
    """(M, T, B, X) decoder outputs at the rung, the port's plain decode."""
    T_, B_, D = gamma.shape
    g = gamma.reshape(T_ * B_, D)
    return torch.stack([ef._decode_plain(g, ws, bs, m, precision)[0]
                        for m in range(ws[0].shape[0])]).reshape(
        ws[0].shape[0], T_, B_, -1)


def _tiles(T_, B_):
    """(y, t0, b0) of every tile, and the number of tile rows."""
    n_y = (T_ - 1 + KR - 1) // KR
    return [(y, y * KR, b0) for y in range(n_y)
            for b0 in range(0, B_, NS)], n_y


def _tile_sum(partial):
    """Fixed-order sum of the (n_y, B) tile partials, as k1_sum_tiles and
    mc_sum_tiles do."""
    e = torch.zeros(partial.shape[1])
    for y in range(partial.shape[0]):
        e = e + partial[y]
    return e


def tiled_k1(x, wmb):
    """K1's function over the tiles: x (M, T, B, X) decoder outputs, wmb
    (M, B).  Per tile: x0 = decoder 0's output, ybar = sum_m w_m (x_m -
    x0), sq = sum_m w_m ||x_m - x0||^2 (decoders in order), xbar = x0 +
    ybar, var = sq - ||ybar||^2 (0 at M = 1); the owned segments' energies
    summed over rows in order."""
    M, T_, B_, _ = x.shape
    tiles, n_y = _tiles(T_, B_)
    partial = torch.zeros((n_y, B_))
    for y, t0, b0 in tiles:
        rows = [min(t0 + r, T_ - 1) for r in range(RC)]
        cols = [min(b0 + s, B_ - 1) for s in range(NS)]
        xt = x[:, rows][:, :, cols]                       # (M, RC, NS, X)
        x0 = xt[0]
        yb = torch.zeros_like(x0)
        sq = torch.zeros(x0.shape[:2])
        for m in range(1, M):
            w = wmb[m, cols][None, :]
            yv = xt[m] - x0
            yb = yb + w[..., None] * yv
            sq = sq + w * (yv * yv).sum(-1)
        xb = x0 + yb
        var = sq - (yb * yb).sum(-1) if M > 1 else torch.zeros_like(sq)
        d = xb[1:] - xb[:-1]
        seg = (d * d).sum(-1) + var[1:] + var[:-1]        # (KR, NS)
        for s, b in enumerate(range(b0, min(b0 + NS, B_))):
            e = torch.zeros(())
            for r in range(KR):
                if t0 + r + 1 < T_:
                    e = e + seg[r, s]
            partial[y, b] = e
    return _tile_sum(partial)


def tiled_k5(x, d1, d2, sw):
    """K5's function over the tiles, d1 and d2 numpy (S, T-1, B) planes,
    in sweeps of ``sw`` samples: each
    difference 0 - x_{d1}(t) + x_{d2}(t+1), the subtraction and the
    addition in the order the decoders come (exact in either); per segment
    the sweep's squares summed over samples then features and added to the
    segment's running sum; per spline the owned segments in order; / S."""
    M, T_, B_, _ = x.shape
    S = d1.shape[0]
    tiles, n_y = _tiles(T_, B_)
    partial = torch.zeros((n_y, B_))
    for y, t0, b0 in tiles:
        red = torch.zeros((KR, NS))
        segs = [(r, s, t0 + r, b0 + s) for r in range(KR) for s in range(NS)
                if t0 + r < T_ - 1 and b0 + s < B_]
        for s0 in range(0, S, sw):
            ks = range(s0, min(S, s0 + sw))
            diff = {(k, r, s): torch.zeros(x.shape[-1])
                    for k in ks for r, s, _, _ in segs}
            for m in range(M):
                for k in ks:
                    for r, s, t, b in segs:
                        if d1[k, t, b] == m:
                            diff[k, r, s] = diff[k, r, s] - x[m, t, b]
                for k in ks:
                    for r, s, t, b in segs:
                        if d2[k, t, b] == m:
                            diff[k, r, s] = diff[k, r, s] + x[m, t + 1, b]
            for r, s, _, _ in segs:
                e = torch.zeros(())
                for k in ks:
                    e = e + (diff[k, r, s] * diff[k, r, s]).sum()
                red[r, s] = red[r, s] + e
        for s, b in enumerate(range(b0, min(b0 + NS, B_))):
            e = torch.zeros(())
            for r in range(KR):
                e = e + red[r, s]
            partial[y, b] = e
    return _tile_sum(partial) / S


@pytest.mark.parametrize("precision", ["f32x2", "bfloat16"])
@pytest.mark.parametrize("M,mixed", [(10, False), (1, False), (10, True)],
                         ids=["M10", "M1", "M10-mixed"])
def test_k1_tiles_give_the_jax_k1(decoders, precision, M, mixed):
    tdec, jdec = members(decoders, M)
    ws, bs = ef.stack_weights(tdec)
    gamma = init_curves(T, B).copy()
    if mixed:
        k = np.array([1, 3, 10, 7, 2, 10])
        wmb, jwmb = ef.active_weights(torch.from_numpy(k), M, B), \
            jep.active_weights(jnp.asarray(k), M, B)
    else:
        wmb, jwmb = ef.uniform_weights(M, B), None
    e_tiles = tiled_k1(_decode_all(ef.ship_weights(ws, precision), bs,
                                   torch.from_numpy(gamma), precision), wmb)
    e_jax = np.asarray(jep.energy_expected_fused(jdec, jnp.asarray(gamma),
                                                 jwmb, precision))
    assert bool(torch.isfinite(e_tiles).all())
    np.testing.assert_allclose(e_tiles.numpy(), e_jax, rtol=1e-5, atol=0)


@pytest.mark.parametrize("precision", ["f32x2", "bfloat16"])
@pytest.mark.parametrize("S,sw", [(1, 4), (2, 4), (3, 2), (12, 4)])
def test_k5_tiles_give_the_jax_k5(decoders, precision, S, sw):
    M = 5
    tdec, jdec = members(decoders, M)
    ws, bs = ef.stack_weights(tdec)
    gamma = init_curves(T, B).copy()
    rng = np.random.default_rng([S, 13])
    k = np.array([1, 3, 5, 5, 2, 4])
    d = rng.integers(0, k[None, None, :], size=(2 * S, T - 1, B))
    d1, d2 = d[:S].astype(np.int32), d[S:].astype(np.int32)
    x = _decode_all(ef.ship_weights(ws, precision), bs,
                    torch.from_numpy(gamma), precision)
    e_tiles = tiled_k5(x, d1, d2, sw)
    e_jax = np.asarray(jmc.energy_mc_fused(jdec, jnp.asarray(gamma),
                                           jnp.asarray(d1), jnp.asarray(d2),
                                           precision))
    assert bool(torch.isfinite(e_tiles).all())
    np.testing.assert_allclose(e_tiles.numpy(), e_jax, rtol=1e-5, atol=0)


# ------------------------------------------------- early stop, mc_fused ---

@pytest.mark.parametrize("inkernel_rng", [True, False],
                         ids=["philox", "planes"])
def test_mc_fused_early_stop_repeats_bit_for_bit(decoders, inkernel_rng):
    tdec, _ = members(decoders, 3)
    art = load_spline_batch(INIT)
    cfg = GeodesicConfig(
        steps=60, lr=1e-3, lr_schedule="constant", batch_size=3,
        early_stop=True, final_energy_mode="expected_fused",
        energy=EnergyConfig(num_t=24, mode="mc_fused",
                            kernel_precision="f32x2", mc_samples=2,
                            mc_inkernel_rng=inkernel_rng))

    def run():
        return optimize_spline_early_stopping(
            tdec, art.omega_init[:3], art.a[:3], art.b[:3], art.basis, cfg,
            device="cpu", generator=torch.Generator().manual_seed(5))

    first, again = run(), run()
    assert first.steps_run == again.steps_run == 60
    assert torch.equal(first.omega, again.omega)
    assert torch.equal(first.traj_energy, again.traj_energy)
    assert torch.equal(first.energy, again.energy)
    assert bool(torch.isfinite(first.energy).all())
    assert not np.array_equal(first.omega.numpy(), art.omega_init[:3])
