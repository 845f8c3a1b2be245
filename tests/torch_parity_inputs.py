"""Shared inputs of the PyTorch-port parity tests (``test_torch_*.py``):
the seed-42 production EVAE and init blob, and helpers that hand the same
decoders and weight planes to both packages."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from vae_latent_geometry_tpu.geometry import spline as jspline
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu.ops import energy_pallas as jep
from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "experiment", "model_seed42.npz")
INIT = os.path.join(REPO, "experiment", "splines_init_model_seed42",
                    "spline_batch_init_entropy_20.npz")
OPT = os.path.join(REPO, "experiment", "splines_opt_model_seed42",
                   "spline_batch_opt_entropy_20.npz")

# The parity inputs are tiny.  One intra-op thread keeps torch's thread pool
# from oversubscribing the CPU when pytest-xdist runs several workers, which
# made these tests about fifty times slower.
torch.set_num_threads(1)


def init_curves(T, B):
    """(T, B, 2) float32 points of the first B seed-42 init splines."""
    art = load_spline_batch(INIT)
    jt = jnp.linspace(0.0, 1.0, T)
    phi = jspline.design_matrix(jt, jnp.asarray(art.basis), art.n_poly)
    return np.asarray(jspline.eval_spline_design(
        jnp.asarray(art.omega_init[:B]), jnp.asarray(art.a[:B]),
        jnp.asarray(art.b[:B]), phi, jt))


def members(tp, M):
    """The first M decoders of a port EVAE, as (torch dict, jax dict)."""
    t = {"layers": [{"w": l["w"][:M], "b": l["b"][:M]}
                    for l in tp.decoders["layers"]]}
    j = {"layers": [{"w": jnp.asarray(l["w"].numpy()),
                     "b": jnp.asarray(l["b"].numpy())} for l in t["layers"]]}
    return t, j


def weight_planes(num_active, M, B):
    """First-k (M, B) weight planes for both packages (None: uniform)."""
    if num_active is None:
        return None, None
    k = np.minimum(num_active, M)
    return (ef.active_weights(torch.from_numpy(k), M, B),
            jep.active_weights(jnp.asarray(k), M, B))
