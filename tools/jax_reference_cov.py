#!/usr/bin/env python3
"""Reference CoV-analysis lengths from the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_reference_cov.py \
        --out tools/jax_reference_cov_seed42.json

On the seeded surrogate (``load_tasic()`` with no data directory) and the
committed seed-42 EVAE: encode, the first ``--max-labels`` classes'
representatives, all their pairs, then ``cov_analysis`` at
``expected_fused`` (f32x3 steps, float32 final energies) over decoder
counts 1..10, straight-line init, ``--steps`` Adam steps at T=2000, the
Pallas kernels in interpret mode.  The repository holds one EVAE
checkpoint, so one model is run: at ``expected_fused`` a second "seed" of
the same model gives the same lengths.  ``chip_smoke.py`` (phase ``cov``)
holds the PyTorch port's lengths against this file.  The steps are cut from
the recipe's 300 so that the CPU run takes minutes; the card runs the same
cut.
"""

import argparse
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vae_latent_geometry_tpu.config import ModelConfig  # noqa: E402
from vae_latent_geometry_tpu.data import load_tasic  # noqa: E402
from vae_latent_geometry_tpu.io.checkpoint import load_pytree  # noqa: E402
from vae_latent_geometry_tpu.models import evae as evae_lib  # noqa: E402
from vae_latent_geometry_tpu.pipeline.evaluate import cov_analysis  # noqa: E402
from vae_latent_geometry_tpu.pipeline.select_pairs import (  # noqa: E402
    make_pairs,
    select_representatives,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-labels", type=int, default=5)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--num-t", type=int, default=2000)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    params, _ = load_pytree(
        os.path.join(ROOT, "experiment", "model_seed42.npz"),
        evae_lib.evae_init(jax.random.PRNGKey(0), ModelConfig()))
    data = load_tasic()
    if not data.synthetic:
        raise SystemExit("a real data directory was found: this reference "
                         "is defined on the seeded surrogate")
    latents = np.asarray(jax.jit(lambda p, x: evae_lib.encode(p, x)[0])(
        params, jnp.asarray(data.x)))
    reps = select_representatives(latents, data.labels, args.max_labels)
    pairs = make_pairs(reps)
    t0 = time.perf_counter()
    res = cov_analysis([params], [42], data.x, pairs,
                       decoder_counts=tuple(range(1, 11)), steps=args.steps,
                       num_t=args.num_t, mode="expected_fused",
                       kernel_precision="f32x3")
    with open(args.out, "w") as f:
        json.dump({"representatives": reps,
                   "pairs": [list(map(int, p)) for p in pairs],
                   "decoder_counts": res.decoder_counts,
                   "lengths": res.lengths[0].tolist(),      # (pairs, counts)
                   "euclidean": res.euclidean[0].tolist(),
                   "recipe": {"mode": "expected_fused",
                              "kernel_precision": "f32x3",
                              "steps": args.steps, "num_t": args.num_t,
                              "lr": 1e-3, "init": "straight line"},
                   "platform": "cpu", "jax": jax.__version__,
                   "seconds": time.perf_counter() - t0}, f, indent=1)


if __name__ == "__main__":
    main()
