"""The float32 forward-energy kernels on the CUDA cores (K1's k1_fwd_fma,
K5/K7's mc_fwd_fma over ``ops/csrc/decode_f32.cuh``), checked where no card
is needed.

- The identity that K5/K7's selective decode rests on: decoding each curve
  point only through the decoders that its draws name (decoder m at point
  t where d1[s, t] = m or d2[s, t-1] = m), through the port's own
  ``_decode_plain``, and forming each difference as one subtraction and one
  addition from 0, gives ``energy_mc_fwd_plain``'s energy within 1e-6
  relative (the row subsets go through other matmul shapes), at S = 1, 2,
  3, 12 with per-spline decoder counts below M on some splines; and the
  JAX package's K5 (interpret mode on the CPU, as
  ``tests/test_torch_mc_samples.py`` runs it) on the same numpy planes
  within rtol 1e-5.
- The float32 decode holds no tensor-core instruction (TF32 is barred).

The kernels themselves run only on the card: ``tests/test_torch_isolation.py
-m gpu`` holds them against their plain versions there.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef
from vae_latent_geometry_tpu_torch.ops import energy_mc_fused as tmc

from torch_parity_inputs import MODEL, init_curves, members

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "vae_latent_geometry_tpu_torch", "ops", "csrc")
T, B = 48, 6


@pytest.fixture(scope="module")
def decoders():
    return tevae.load_npz(MODEL, "cpu")


def _planes(S, M, seed):
    """(d1, d2) int32 (S, T-1, B) with per-spline decoder counts 1, 3 and
    M in turn: U[0, k_b)."""
    rng = np.random.default_rng([S, M, seed])
    k = np.array([(1, 3, M)[b % 3] for b in range(B)])
    d = rng.integers(0, k[None, None, :], size=(2 * S, T - 1, B))
    return d[:S].astype(np.int32), d[S:].astype(np.int32)


def selective_energy(ws, bs, gamma, d1, d2):
    """K5's function through selective decode: (energies (B,), number of
    (point, decoder) decodes).  Each difference is 0 - x_{d1}(t) + x_{d2}(t+1)
    with the two updates in decoder order, as the kernel forms it."""
    T_, B_, D = gamma.shape
    S, M = d1.shape[0], ws[0].shape[0]
    g = gamma.reshape(T_ * B_, D)
    diff = None
    decoded = 0
    for m in range(M):
        need = torch.zeros((T_, B_), dtype=torch.bool)
        need[:-1] |= (d1 == m).any(0)
        need[1:] |= (d2 == m).any(0)
        rows = need.reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        decoded += rows.numel()
        xr = ef._decode_plain(g[rows], ws, bs, m, "float32")[0]
        x = torch.zeros((T_ * B_, xr.shape[1]))
        x[rows] = xr
        x = x.reshape(T_, B_, -1)
        if diff is None:
            diff = torch.zeros((S, T_ - 1, B_, x.shape[-1]))
        diff = torch.where((d1 == m)[..., None], diff - x[:-1], diff)
        diff = torch.where((d2 == m)[..., None], diff + x[1:], diff)
    return (diff * diff).sum(-1).sum(0).sum(0) / S, decoded


@pytest.mark.parametrize("S", [1, 2, 3, 12])
def test_selective_decode_gives_the_plain_mc_energy(decoders, S):
    tdec, _ = members(decoders, 10)
    ws, bs = ef.stack_weights(tdec)
    M = ws[0].shape[0]
    gamma = torch.from_numpy(init_curves(T, B).copy())
    d1, d2 = (torch.from_numpy(d) for d in _planes(S, M, 0))
    e_sel, decoded = selective_energy(ws, bs, gamma, d1, d2)
    e_plain = tmc.energy_mc_fwd_plain(ws, bs, gamma, d1, d2, "float32")
    assert bool(torch.isfinite(e_sel).all())
    np.testing.assert_allclose(e_sel.numpy(), e_plain.numpy(), rtol=1e-6,
                               atol=0)
    # no more than the drawn decoders: at most min(M, 2S) per point, fewer
    # on the splines with fewer active decoders and at the two end points
    assert decoded <= T * B * min(M, 2 * S)
    assert decoded < T * B * M


@pytest.mark.parametrize("S", [2, 12])
def test_selective_decode_matches_the_jax_k5(decoders, S):
    tdec, jdec = members(decoders, 5)
    ws, bs = ef.stack_weights(tdec)
    gamma = init_curves(T, B).copy()
    d1, d2 = _planes(S, 5, 1)
    e_sel, _ = selective_energy(ws, bs, torch.from_numpy(gamma),
                                torch.from_numpy(d1), torch.from_numpy(d2))
    e_jax = np.asarray(jmc.energy_mc_fused(jdec, jnp.asarray(gamma),
                                           jnp.asarray(d1), jnp.asarray(d2),
                                           "float32"))
    np.testing.assert_allclose(e_sel.numpy(), e_jax, rtol=1e-5, atol=0)


def _body(source, name):
    """The text of kernel ``name``'s definition in ``source``."""
    start = source.index(f"\n{name}(")
    depth, i = 0, source.index("{", start)
    for j in range(i, len(source)):
        depth += {"{": 1, "}": -1}.get(source[j], 0)
        if depth == 0:
            return source[start:j + 1]
    raise AssertionError(f"{name}: unbalanced braces")


# mma / wgmma / wmma / HMMA instructions, the decode_mma.cuh helpers
# (decode_mma, chain_mma, ...) and TF32 conversions; not "gamma"
TENSOR_CORE = re.compile(r"\b(?:w?g?mma|wmma|hmma)\b|_mma\b|\bmma_|tf32",
                         re.IGNORECASE)


def _code(path):
    """A source without its // comments (which name what it avoids)."""
    return re.sub(r"//[^\n]*", "", open(os.path.join(CSRC, path)).read())


def test_float32_decode_holds_no_tensor_core_instruction():
    for header in ("decode_f32.cuh", "k1_fwd_f32.cuh"):
        assert not TENSOR_CORE.findall(_code(header)), header
    for src, kernel in (("k1_fwd_f32.cuh", "k1_fwd_fma"),
                        ("energy_mc.cu", "mc_fwd_fma")):
        body = _body(_code(src), kernel)
        assert "f32_decode_chunk" in body
        assert not TENSOR_CORE.findall(body), (kernel,
                                               TENSOR_CORE.findall(body))
