#!/usr/bin/env python3
"""How far K2's kernel is from its plain version on a decoder, and how far
each is from the function computed without rounding.

    python3 tools/k2_rounding.py [--shape S4] [--M 1] [--rungs float32 f32x2]

On ``chip_smoke.py``'s inputs at the production chunk (the seed-42 init
curves, T=2000, B=200, ``cotangent(B)``, every decoder weighted 1/M),
decoder ``--shape`` (``chip_smoke.SHAPES``, its first M members; ``prod``:
the committed model): at each rung K2 (the kernel), its plain version on
the card and the same plain version on the CPU; once, the float32 plain
version in float64 on the CPU (the function without rounding).  Prints one
JSON line per rung with ``chip_smoke.dgamma_stats`` of kernel vs card
plain, CPU plain vs card plain, and of the kernel and the card plain vs
float64.  Needs one CUDA GPU.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="S4")
    ap.add_argument("--M", type=int, default=1)
    ap.add_argument("--rungs", nargs="+",
                    default=["float32", "f32x3", "f32x2", "bfloat16"])
    args = ap.parse_args()

    import torch

    from vae_latent_geometry_tpu_torch.geometry.spline import (
        design_matrix, eval_spline_design, t_grid)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    art = load_spline_batch(chip_smoke.INIT)
    T, B = 2000, 200
    idx = list(range(len(art))) + [len(art) - 1] * (B - len(art))
    t = t_grid(T, cpu)
    phi = design_matrix(t, art.basis, art.n_poly)
    g = eval_spline_design(torch.as_tensor(art.omega_init[idx]),
                           torch.as_tensor(art.a[idx]),
                           torch.as_tensor(art.b[idx]), phi, t).contiguous()
    if args.shape == "prod":
        ws_all, bs_all = ef.stack_weights(load_npz(chip_smoke.MODEL,
                                                   cpu).decoders)
        ws = [w[:args.M].contiguous() for w in ws_all]
        bs = [b[:args.M].contiguous() for b in bs_all]
    else:
        layers = chip_smoke.shape_layers(args.shape)
        ws = [torch.as_tensor(w[:args.M]) for w, _ in layers]
        bs = [torch.as_tensor(b[:args.M]) for _, b in layers]
    M = args.M
    wmb = torch.full((M, B), 1.0 / M)
    ct = torch.as_tensor(chip_smoke.cotangent(B))

    def on(device, dtype=torch.float32):
        return ([w.to(device, dtype) for w in ws],
                [b.to(device, dtype) for b in bs], g.to(device, dtype),
                wmb.to(device, dtype), ct.to(device, dtype))

    card = on(dev)
    ship = ef.ship_weights              # float32's: a cast to float32
    ef.ship_weights = lambda w, _: w
    try:
        truth = ef.energy_bwd_plain(*on(cpu, torch.float64), "float32")
    finally:
        ef.ship_weights = ship
    truth = truth.to(dev)
    for prec in args.rungs:
        k = ef.energy_bwd(*card, prec)
        p = ef.energy_bwd_plain(*card, prec)
        c = ef.energy_bwd_plain(*on(cpu), prec).to(dev)
        print(json.dumps({
            "shape": args.shape, "M": M, "rung": prec,
            "kernel_vs_plain": chip_smoke.dgamma_stats(k, p),
            "cpu_plain_vs_plain": chip_smoke.dgamma_stats(c, p),
            "kernel_vs_float64": chip_smoke.dgamma_stats(k.double(), truth),
            "plain_vs_float64": chip_smoke.dgamma_stats(p.double(), truth)}),
            flush=True)


if __name__ == "__main__":
    main()
