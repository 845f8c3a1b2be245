#!/usr/bin/env python3
"""Steps/s of ``chip_smoke.py``'s host-bound phases for one checkout, so
that two checkouts can be compared on one card in one call.

    python3 tools/phase_times.py --tree <checkout> [--repeat 2] [--tag NAME]

Loads ``<checkout>/chip_smoke.py`` and that checkout's package, builds its
kernels (outside the timed regions), and runs its phase ``cov`` (both
modes) and phase ``single_bf16`` ``--repeat`` times on the committed model
and the seed-42 init blob, as ``chip_smoke.py`` runs them.  Prints one JSON
line per run with the phase's steps/s.  Run each checkout in a process of
its own and interleave them (parent, change, change, parent): host-bound
phases spread between machines and over time.  Needs one CUDA GPU.
"""

import argparse
import importlib.util
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_tree", os.path.join(tree, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from vae_latent_geometry_tpu_torch.config import (EnergyConfig,
                                                      GeodesicConfig)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.ops import _build
    from vae_latent_geometry_tpu_torch.ops import energy_fused as ef

    if not torch.cuda.is_available():
        raise SystemExit("phase_times: no CUDA device available")
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    params = load_npz(smoke.MODEL, dev)
    art = load_spline_batch(smoke.INIT)
    cfg = GeodesicConfig(
        steps=smoke.STEPS, lr=1e-3, lr_schedule="constant", batch_size=200,
        energy=EnergyConfig(num_t=2000, mode="expected_fused",
                            kernel_precision="f32x2"))
    head = {"tree": args.tag or tree, "build_s": build_s,
            "card": smoke.card_line()}
    for rep in range(args.repeat):
        recs = smoke.cov_phase(params, dev)
        recs["single_bf16"] = smoke.single_bf16_phase(params, art, cfg, dev,
                                                      ef)
        print(json.dumps({**head, "repeat": rep, "steps_per_s": {
            "cov_mc_fused": recs["mc_fused"]["steps_per_s"],
            "cov_expected_fused": recs["expected_fused"]["steps_per_s"],
            "single_fused_bf16": recs["single_bf16"]["steps_per_s"],
            "single_fused_f32x2":
                recs["single_bf16"]["f32x2_steps_per_s"]}}), flush=True)


if __name__ == "__main__":
    main()
