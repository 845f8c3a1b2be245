#!/usr/bin/env python3
"""Reference lengths of the JVP and rescaled energy modes from the JAX
package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_reference_jvp.py \
        --out tools/jax_reference_jvp_seed42.json

Runs ``vae_latent_geometry_tpu.optim.optimize_splines`` on ``--pairs``
(default: every 12th of the 190) of the seed-42 entropy init blob with two
one-phase plans, final energies by ``expected_fused`` at float32 and
T=2000 (the Pallas kernels in interpret mode):

- ``jvp_ensemble``: 200 constant-lr 1e-3 steps of ``jvp_ensemble`` at
  T=128 with ``target_num_t`` = 2000;
- ``expected_rescaled``: the same at T=64 (the ``full133_rescaled64``
  coarse phase).

Every spline's loss and Adam update are its own, so these pairs end where
they end in a run over all 190.  ``chip_smoke.py`` (phase ``jvp``) holds the
PyTorch port's lengths against this file.  CPU only; about a minute.
"""

import argparse
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vae_latent_geometry_tpu.config import (  # noqa: E402
    EnergyConfig,
    GeodesicConfig,
    ModelConfig,
)
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch  # noqa: E402
from vae_latent_geometry_tpu.io.checkpoint import load_pytree  # noqa: E402
from vae_latent_geometry_tpu.models.evae import evae_init  # noqa: E402
from vae_latent_geometry_tpu.optim import optimize_splines  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (steps, num_t, lr_schedule, lr, energy_mode): one phase each
PLANS = {"jvp_ensemble": (200, 128, "constant", 1e-3, "jvp_ensemble"),
         "expected_rescaled": (200, 64, "constant", 1e-3,
                               "expected_rescaled")}
TARGET_NUM_T = 2000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, nargs="+",
                    default=list(range(0, 190, 12)))
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    params, _ = load_pytree(
        os.path.join(ROOT, "experiment", "model_seed42.npz"),
        evae_init(jax.random.PRNGKey(0), ModelConfig()))
    art = load_spline_batch(os.path.join(
        ROOT, "experiment", "splines_init_model_seed42",
        "spline_batch_init_entropy_20.npz"))
    sel = np.asarray(args.pairs)
    out = {"pairs": sel.tolist(), "platform": "cpu", "jax": jax.__version__,
           "target_num_t": TARGET_NUM_T, "final": "expected_fused float32 "
           "at T=2000", "plans": {}}
    for name, plan in PLANS.items():
        cfg = GeodesicConfig(
            steps=plan[0], phase_plan=(plan,),
            energy=EnergyConfig(num_t=TARGET_NUM_T, mode="expected_fused",
                                target_num_t=TARGET_NUM_T))
        t0 = time.perf_counter()
        res = optimize_splines(params.decoders,
                               jnp.asarray(art.omega_init[sel]),
                               jnp.asarray(art.a[sel]), jnp.asarray(art.b[sel]),
                               art.basis, cfg)
        out["plans"][name] = {
            "plan": list(plan),
            "lengths": np.asarray(res.lengths, np.float64).tolist(),
            "seconds": time.perf_counter() - t0}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
