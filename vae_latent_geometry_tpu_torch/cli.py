"""Command line of the PyTorch port: ``optimize`` and ``eval --mode matrix``.

  python -m vae_latent_geometry_tpu_torch optimize --model experiment/model_seed42.npz \\
      --splines <init artifact> --energy-mode mc_fused
  python -m vae_latent_geometry_tpu_torch eval --mode matrix --splines <opt artifact>

Flags and defaults follow ``vae_latent_geometry_tpu.cli``; the artifacts are
the same format.  ``--device`` picks the torch device (default ``cuda``;
``--device cpu`` runs the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

# The measured two-phase fast recipe (--fast) and the turbo ladder
# (--turbo), as in the JAX package's CLI.
FAST_PRESET = {"steps": 1000, "lr": 3e-3, "lr_schedule": "cosine",
               "traj_num_t": 512, "polish_steps": 300, "polish_lr": 1e-3}
TURBO_PHASES = ((1200, 256, "cosine", 3e-3),
                (200, 2000, "constant", 1e-3))
# Reference defaults of the recipe-affected flags; the parser leaves them at
# None so a preset only fills flags the user did not pass.
_FAST_FLAG_DEFAULTS = {"steps": 1000, "lr": 1e-3, "lr_schedule": "constant",
                       "traj_num_t": None, "polish_steps": 0,
                       "polish_lr": 1e-3}


# --coarse-bf16: the turbo plan's coarse phase keeps its estimator and runs
# the fused kernels at bfloat16.
_COARSE_BF16_MODE = {"mc": "mc_fused_bf16", "mc_fused": "mc_fused_bf16",
                     "expected": "expected_fused_bf16",
                     "expected_fused": "expected_fused_bf16"}


def coarse_bf16_plan(energy_mode: str, phase_plan):
    """The turbo plan with its coarse (first) phase at the estimator's fused
    bf16 mode; the other phases keep the run's mode and precision."""
    if phase_plan is None:
        raise SystemExit("--coarse-bf16 requires --turbo (it modifies the "
                         "turbo plan's coarse phase)")
    coarse_mode = _COARSE_BF16_MODE.get(energy_mode)
    if coarse_mode is None:
        raise SystemExit(
            f"--coarse-bf16 needs an energy mode with a fused bf16 rung "
            f"({'/'.join(_COARSE_BF16_MODE)}), got {energy_mode!r}")
    first, *rest = phase_plan
    return ((*first[:4], coarse_mode), *rest)


def _fill_unset(args, values: dict) -> None:
    for k, v in values.items():
        if getattr(args, k) is None:
            setattr(args, k, v)


def cmd_optimize(args):
    import torch

    from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.models.evae import load_npz
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        optimize_spline_batch,
    )

    device = resolve_device(args.device)
    params = load_npz(args.model, device)
    model_name = Path(args.model).stem
    spline_path = args.splines or (
        f"experiment/splines_init_{model_name}/"
        f"spline_batch_init_{args.init_type}_{args.pair_count}.npz")
    art = load_spline_batch(spline_path)
    data = None
    if not args.no_euclidean:
        tasic = load_tasic(args.data_dir)
        if tasic.synthetic:
            print("[warn] tasic-pca50.npy not found — using the deterministic "
                  "synthetic surrogate (see data/tasic.py)")
        data = tasic.x
    if args.fast and not args.turbo:
        _fill_unset(args, FAST_PRESET)
    _fill_unset(args, _FAST_FLAG_DEFAULTS)
    phase_plan = TURBO_PHASES if args.turbo else None
    if args.coarse_bf16:
        phase_plan = coarse_bf16_plan(args.energy_mode, phase_plan)
    cfg = GeodesicConfig(
        steps=args.steps, lr=args.lr, batch_size=args.batch_size,
        lr_schedule=args.lr_schedule, traj_num_t=args.traj_num_t,
        polish_steps=args.polish_steps, polish_lr=args.polish_lr,
        phase_plan=phase_plan,
        energy=EnergyConfig(num_t=args.num_t, mc_samples=args.mc_samples,
                            mode=args.energy_mode,
                            kernel_precision=args.kernel_precision),
    )
    out = Path(args.output or
               f"experiment/splines_opt_{model_name}/"
               f"spline_batch_opt_{args.init_type}_{args.pair_count}.npz")
    optimize_spline_batch(params, art, data=data, cfg=cfg, device=device,
                          output_path=str(out),
                          generator=torch.Generator().manual_seed(args.seed))
    print(f"[ok] optimized {len(art)} splines -> {out}")


def cmd_eval(args):
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix

    spline_path = args.splines or (
        f"experiment/splines_opt_model_seed{args.seed}/"
        f"spline_batch_opt_{args.init_type}_{args.pair_count}.npz")
    art = load_spline_batch(spline_path)
    mat, labels = distance_matrix(art, args.len_type)
    out_json = Path(args.output) if args.output else Path(
        "experiment/plots") / (f"{args.len_type}_matrix_seed{args.seed}_"
                               f"{args.init_type}_{args.pair_count}.json")
    out_json.parent.mkdir(parents=True, exist_ok=True)
    out_json.write_text(json.dumps({
        "seed": args.seed, "cluster_ids": labels,
        "distance_matrix": [[None if np.isnan(v) else float(v) for v in row]
                            for row in mat],
    }))
    print(f"[ok] wrote {out_json}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vae_latent_geometry_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    o = sub.add_parser("optimize", help="batched geodesic optimization")
    o.add_argument("--data-dir", default=None)
    o.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    o.add_argument("--model", required=True,
                   help="path-keyed EVAE checkpoint (.npz)")
    o.add_argument("--splines", default=None)
    o.add_argument("--init-type", default="entropy",
                   choices=["entropy", "euclidean"])
    o.add_argument("--pair-count", type=int, default=10)
    o.add_argument("--steps", type=int, default=None,
                   help="Adam steps per chunk (default 1000)")
    o.add_argument("--traj-num-t", type=int, default=None,
                   help="trajectory-only quadrature resolution (final "
                        "energies still reported at --num-t)")
    o.add_argument("--polish-steps", type=int, default=None,
                   help="extra full-resolution Adam steps after the "
                        "--traj-num-t coarse phase (default 0)")
    o.add_argument("--polish-lr", type=float, default=None,
                   help="(default 1e-3)")
    o.add_argument("--lr-schedule", default=None,
                   choices=["constant", "cosine"],
                   help="(default constant, the reference semantics)")
    o.add_argument("--fast", action="store_true",
                   help="two-phase fast recipe: cosine 3e-3 x 1000 steps @ "
                        "T=512 + 300 polish steps @ --num-t; sets steps/lr/"
                        "schedule/traj-num-t/polish unless explicitly given")
    o.add_argument("--turbo", action="store_true",
                   help="turbo ladder: cosine 3e-3 x 1200 steps @ T=256 + "
                        "200 constant 1e-3 steps @ T=2000")
    o.add_argument("--lr", type=float, default=None, help="(default 1e-3)")
    o.add_argument("--batch-size", type=int, default=200,
                   help="pairs per optimization chunk")
    o.add_argument("--num-t", type=int, default=2000)
    o.add_argument("--mc-samples", type=int, default=2)
    o.add_argument("--coarse-bf16", action="store_true",
                   help="run the turbo plan's coarse phase at bfloat16 "
                        "(requires --turbo and mc/mc_fused/expected/"
                        "expected_fused); the polish phase and the final "
                        "evaluation keep their precision")
    o.add_argument("--energy-mode", default="mc",
                   choices=["mc", "mc_scan", "mc_fused", "mc_fused_bf16",
                            "expected", "expected_fused",
                            "expected_fused_bf16", "single", "single_fused"],
                   help="energy estimator: the reference's Monte-Carlo "
                        "estimator (mc; mc_scan streams T in chunks; "
                        "mc_fused runs it in the fused kernels) or its "
                        "closed-form expectation (expected*)")
    o.add_argument("--seed", type=int, default=0,
                   help="seed of the MC modes' decoder draws; a run is "
                        "reproducible per seed")
    o.add_argument("--kernel-precision", default="f32x2",
                   choices=["float32", "f32x3", "f32x2"],
                   help="precision rung of the fused kernels on trajectory "
                        "steps; final energies are always re-evaluated at "
                        "exact float32")
    o.add_argument("--no-euclidean", action="store_true",
                   help="skip encoder Euclidean distances (no data needed)")
    o.add_argument("--output", default=None)
    o.set_defaults(fn=cmd_optimize)

    e = sub.add_parser("eval", help="distance matrix")
    e.add_argument("--mode", required=True, choices=["matrix"])
    e.add_argument("--len-type", default="geodesic",
                   choices=["geodesic", "euclidean"])
    e.add_argument("--init-type", default="euclidean",
                   choices=["entropy", "euclidean"])
    e.add_argument("--pair-count", type=int, default=133)
    e.add_argument("--seed", type=int, default=12)
    e.add_argument("--splines", default=None)
    e.add_argument("--output", default=None,
                   help="distance-matrix JSON path (default: the "
                        "experiment/plots/ naming convention under the cwd)")
    e.set_defaults(fn=cmd_eval)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
