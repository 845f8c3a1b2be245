#!/usr/bin/env python3
"""Reference geodesic lengths from the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tools/jax_reference_lengths.py \
        --out tools/jax_reference_lengths_seed42.json
    JAX_PLATFORMS=cpu python tools/jax_reference_lengths.py \
        --pairs 0 42 65 164 --precision float32 \
        --out tools/jax_reference_lengths_seed42_float32.json

Runs ``vae_latent_geometry_tpu.optim.optimize_splines`` — the reference
recipe (expected_fused, 1000 Adam steps at lr 1e-3 constant, T=2000,
kernel precision f32x2 or ``--precision``, final re-evaluation at
float32) — on ``--pairs`` (default: all 190) of the seed-42 entropy init
blob, with the Pallas kernels in interpret mode, and writes their lengths.
``chip_smoke.py`` holds the PyTorch port against both files above.  CPU
only; all 190 pairs take about 25 minutes on an 8-core CPU.
"""

import argparse
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vae_latent_geometry_tpu.config import EnergyConfig, GeodesicConfig  # noqa: E402
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch  # noqa: E402
from vae_latent_geometry_tpu.io.checkpoint import load_pytree  # noqa: E402
from vae_latent_geometry_tpu.config import ModelConfig  # noqa: E402
from vae_latent_geometry_tpu.models.evae import evae_init  # noqa: E402
from vae_latent_geometry_tpu.optim import optimize_splines  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, nargs="+", default=list(range(190)))
    ap.add_argument("--precision", default="f32x2")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    params, _ = load_pytree(
        os.path.join(ROOT, "experiment", "model_seed42.npz"),
        evae_init(jax.random.PRNGKey(0), ModelConfig()))
    art = load_spline_batch(os.path.join(
        ROOT, "experiment", "splines_init_model_seed42",
        "spline_batch_init_entropy_20.npz"))
    sel = np.asarray(args.pairs)
    cfg = GeodesicConfig(steps=1000, lr=1e-3, lr_schedule="constant",
                         energy=EnergyConfig(num_t=2000, mode="expected_fused",
                                             kernel_precision=args.precision))
    t0 = time.perf_counter()
    res = optimize_splines(params.decoders, jnp.asarray(art.omega_init[sel]),
                           jnp.asarray(art.a[sel]), jnp.asarray(art.b[sel]),
                           art.basis, cfg)
    lengths = np.asarray(res.lengths, np.float64)
    with open(args.out, "w") as f:
        json.dump({"pairs": sel.tolist(), "lengths": lengths.tolist(),
                   "recipe": {"mode": "expected_fused", "steps": 1000,
                              "lr": 1e-3, "lr_schedule": "constant",
                              "num_t": 2000,
                              "kernel_precision": args.precision},
                   "platform": "cpu", "jax": jax.__version__,
                   "seconds": time.perf_counter() - t0}, f, indent=1)


if __name__ == "__main__":
    main()
