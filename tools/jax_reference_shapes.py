#!/usr/bin/env python3
"""Energies and curve gradients of the fused energy modes from the JAX
package on the CPU, on seeded decoders of other depths and widths than the
production model's.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_reference_shapes.py \
        --out tools/jax_reference_shapes_seed42.json

Decoders (``SHAPES``; numpy weights from ``--seed``, each member a
perturbation of a shared base, so that the members differ):

- S1: 2 -> 16 -> 10, M = 3 (two layers: the JAX suite's narrow decoder);
- S2: 2 -> 64 -> 64 -> 50, M = 10;
- S3: 2 -> 256 -> 128 -> 128, M = 10 (X at the kernels' ceiling);
- S4: 2 -> 96 -> 160 -> 48 -> 100, M = 10 (three hidden layers);
- S5: 2 -> 512 -> 512 -> 50, M = 4 (the port's width cap; not recorded
  here, its kernels are held against their plain versions only).

For S1-S4, at T = 32 and B = 4 on seeded smooth curves, the energies and
dgamma of sum_b ct_b E_b (ct = linspace(0.5, 2, B)) of ``expected_fused``,
``mc_fused`` and ``single_fused`` at float32 and f32x3, and of their
``_bf16`` modes (the bfloat16 rung), through the package's Pallas kernels in
interpret mode.  ``mc_fused`` runs with one active decoder (every draw names
decoder 0), so its estimator is deterministic; ``single_fused`` is decoder
0.  ``chip_smoke.py`` (phase ``shapes``) holds the CUDA kernels against this
file and keeps its own copy of the seed code below; the CPU tests check that
the copies agree.  CPU only; about a minute.
"""

import argparse
import json

import numpy as np

# name -> (layer widths D, ..., X; ensemble size M)
SHAPES = {"S1": ((2, 16, 10), 3),
          "S2": ((2, 64, 64, 50), 10),
          "S3": ((2, 256, 128, 128), 10),
          "S4": ((2, 96, 160, 48, 100), 10),
          "S5": ((2, 512, 512, 50), 4)}
REF_SHAPES = ("S1", "S2", "S3", "S4")
REF_T, REF_B = 32, 4
# mode -> rungs recorded
MODES = {"expected_fused": ("float32", "f32x3"),
         "mc_fused": ("float32", "f32x3"),
         "single_fused": ("float32", "f32x3"),
         "expected_fused_bf16": ("bfloat16",),
         "mc_fused_bf16": ("bfloat16",),
         "single_fused_bf16": ("bfloat16",)}
MC_SAMPLES = 2


def shape_layers(name, seed=42):
    """[(w (M, in, out), b (M, out)), ...] float32 of decoder ``name``: He
    scaled, each member its base plus 0.3 of its scale in noise."""
    dims, M = SHAPES[name]
    rng = np.random.default_rng([seed, int(name[1:])])
    out = []
    for i, o in zip(dims[:-1], dims[1:]):
        scale = np.sqrt(2.0 / i)
        w = scale * (rng.normal(size=(1, i, o))
                     + 0.3 * rng.normal(size=(M, i, o)))
        b = 0.1 * rng.normal(size=(1, o)) + 0.05 * rng.normal(size=(M, o))
        out.append((w.astype(np.float32), b.astype(np.float32)))
    return out


def shape_curves(T, B, seed=42, D=2):
    """(T, B, D) float32 smooth curves between random endpoints."""
    rng = np.random.default_rng([seed, T, B])
    t = np.linspace(0.0, 1.0, T)[:, None, None]
    a, b = 1.5 * rng.normal(size=(2, 1, B, D))
    ph = rng.uniform(0, 2 * np.pi, size=(1, B, D))
    return ((1 - t) * a + t * b + 0.3 * np.sin(3.0 * t + ph)).astype(
        np.float32)


def cotangent(B):
    return np.linspace(0.5, 2.0, B).astype(np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from vae_latent_geometry_tpu.ops import energy_mc_pallas as jmc
    from vae_latent_geometry_tpu.ops import energy_pallas as jep

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    T, B = REF_T, REF_B
    gamma = jnp.asarray(shape_curves(T, B, args.seed))
    ct = jnp.asarray(cotangent(B))
    zeros = jnp.zeros((MC_SAMPLES, T - 1, B), jnp.int32)
    out = {"seed": args.seed, "T": T, "B": B, "mc_samples": MC_SAMPLES,
           "shapes": {}}
    for name in REF_SHAPES:
        layers = shape_layers(name, args.seed)
        dec = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                          for w, b in layers]}
        single = jax.tree_util.tree_map(lambda x: x[:1], dec)
        rec = {}
        for mode, rungs in MODES.items():
            for prec in rungs:
                if mode.startswith("expected"):
                    fn = lambda g: jep.energy_expected_fused(  # noqa: E731
                        dec, g, None, prec)
                elif mode.startswith("single"):
                    fn = lambda g: jep.energy_expected_fused(  # noqa: E731
                        single, g, None, prec)
                else:
                    fn = lambda g: jmc.energy_mc_fused(  # noqa: E731
                        dec, g, zeros, zeros, prec)
                e, vjp = jax.vjp(fn, gamma)
                (dg,) = vjp(ct)
                rec[f"{mode}/{prec}"] = {
                    "energy": np.asarray(e, np.float64).tolist(),
                    "dgamma": np.asarray(dg, np.float64).ravel().tolist()}
        out["shapes"][name] = {"dims": list(SHAPES[name][0]),
                               "M": SHAPES[name][1], "modes": rec}
        print(name, "done", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
