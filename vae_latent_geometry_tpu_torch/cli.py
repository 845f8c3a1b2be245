"""Command line of the PyTorch port: ``train``, ``train-single``,
``select-pairs``, ``init-splines``, ``optimize``, ``eval --mode
matrix|cov``, ``plot``, ``stability`` and ``golden``.

  python -m vae_latent_geometry_tpu_torch train --seeds 12 123 --epochs 600
  python -m vae_latent_geometry_tpu_torch train-single --seed 12
  python -m vae_latent_geometry_tpu_torch select-pairs --model experiment/model_seed42.npz --max-labels 20
  python -m vae_latent_geometry_tpu_torch init-splines --model experiment/model_seed42.npz \\
      --pairfile experiment/pairs/selected_pairs_20.json --use-entropy
  python -m vae_latent_geometry_tpu_torch optimize --model experiment/model_seed42.npz \\
      --splines <init artifact> --energy-mode mc_fused
  python -m vae_latent_geometry_tpu_torch eval --mode matrix --splines <opt artifact>
  python -m vae_latent_geometry_tpu_torch eval --mode cov --seeds 12 123 \\
      --pairfile experiment/pairs/selected_pairs_20.json --energy-mode mc_fused
  python -m vae_latent_geometry_tpu_torch plot density --model experiment/model_seed42.npz \\
      --splines <artifact>
  python -m vae_latent_geometry_tpu_torch stability frobenius --a <matrix.json> --b <matrix.json>
  python -m vae_latent_geometry_tpu_torch golden --seed 12 --reference-root /root/reference

Flags and defaults follow ``vae_latent_geometry_tpu.cli``; the artifacts are
the same format.  ``--model`` takes either model family (the ensemble VAE
or the legacy single VAE) from the port's or the JAX package's ``.npz``, or
a reference ``.pt``/``.pth`` state dict.  The JAX CLI's ``bench`` runs that
package's TPU benchmark and has no counterpart here.  ``--device`` picks
the torch device (default ``cuda``; ``--device cpu`` runs the plain
PyTorch versions of the kernels).
``train --train-state PATH`` writes the whole training state there after
every block and resumes from it when it exists; ``optimize`` checkpoints
every chunk to its ``--output`` and resumes from it, so re-running the same
command continues an interrupted run.

Several ranks (``optimize --dp N --ep M``): start dp*ep processes with the
same command, each with ``--coordinator host:port --num-processes N
--process-id I`` (or ``VLG_COORDINATOR`` / ``VLG_NUM_PROCESSES`` /
``VLG_PROCESS_ID``); every rank computes, rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
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


def _load_data(args):
    from vae_latent_geometry_tpu_torch.data.tasic import load_tasic

    data = load_tasic(args.data_dir)
    if data.synthetic:
        print("[warn] tasic-pca50.npy not found — using the deterministic "
              "synthetic surrogate (see data/tasic.py)")
    return data


def _load_model(path: str, device):
    """An ``EVAEParams`` or a legacy ``VAEParams`` on ``device``: from a
    reference ``.pt``/``.pth`` state dict (tried as an ensemble first), or
    from an ``.npz`` checkpoint of either family (``evae.load_npz``)."""
    from vae_latent_geometry_tpu_torch.models.evae import load_npz

    if str(path).endswith((".pt", ".pth")):
        from vae_latent_geometry_tpu_torch.models.torch_import import (
            load_evae_checkpoint,
            load_single_vae_checkpoint,
        )

        try:
            return load_evae_checkpoint(path, device)
        except KeyError:
            return load_single_vae_checkpoint(path, device)
    return load_npz(path, device)


def _encode(params, x, device) -> np.ndarray:
    """Latent means of the dataset, for either model family."""
    import torch

    from vae_latent_geometry_tpu_torch.models import evae, vae

    enc = vae.encode if isinstance(params, vae.VAEParams) else evae.encode
    with torch.no_grad():
        return enc(params, torch.as_tensor(
            np.asarray(x, np.float32), device=device))[0].cpu().numpy()


def _decoders_of(params):
    """The ensemble's decoders, or None for a single-decoder model."""
    from vae_latent_geometry_tpu_torch.models.evae import EVAEParams

    return params.decoders if isinstance(params, EVAEParams) else None


def _plot_or_warn(what: str, fn, *args, **kw) -> None:
    """A companion figure ``fn(*args, **kw)``; a failure (matplotlib absent
    included) is reported and never fails the run, as in the JAX package's
    CLI."""
    try:
        fn(*args, **kw)
    except Exception as ex:
        print(f"[warn] {what} failed: {type(ex).__name__}: {ex}")


def cmd_train(args):
    from vae_latent_geometry_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
        to_dict,
    )
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree
    from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary
    from vae_latent_geometry_tpu_torch.pipeline.train import (
        train_evae,
        train_evae_multiseed,
    )
    from vae_latent_geometry_tpu_torch.viz import plotting

    device = resolve_device(args.device)
    data = _load_data(args)
    mcfg = ModelConfig(latent_dim=args.latent_dim,
                       num_decoders=args.num_decoders)
    if args.seeds:
        cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                          lr=args.lr)
        results = train_evae_multiseed(data.x, args.seeds, cfg, mcfg,
                                       checkpoint_path=args.train_state,
                                       device=device)
    else:
        cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                          lr=args.lr, seed=args.seed)
        results = {args.seed: train_evae(data.x, cfg, mcfg,
                                         checkpoint_path=args.train_state,
                                         device=device)}
    if not is_primary():
        return
    out = Path(args.save_dir)
    out.mkdir(parents=True, exist_ok=True)
    for seed, res in results.items():
        ckpt = out / f"model_seed{seed}.npz"
        save_pytree(res.params, str(ckpt),
                    extra_meta={"seed": seed, "epochs": args.epochs,
                                "model_config": to_dict(mcfg)})
        np.save(out / f"train_losses_seed{seed}.npy", res.train_losses)
        np.save(out / f"val_losses_seed{seed}.npy", res.val_losses)
        _plot_or_warn("loss-curve plot", plotting.plot_loss_curves,
                      res.train_losses, res.val_losses,
                      str(out / "plots" / f"loss_curve_seed{seed}.png"))
        print(f"[ok] saved {ckpt}")


def cmd_train_single(args):
    from vae_latent_geometry_tpu_torch.config import TrainConfig, to_dict
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.io.checkpoint import save_pytree
    from vae_latent_geometry_tpu_torch.models.vae import LEGACY_CONFIG
    from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary
    from vae_latent_geometry_tpu_torch.pipeline.train import train_single_vae

    device = resolve_device(args.device)
    data = _load_data(args)
    cfg = TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                      lr=args.lr, seed=args.seed,
                      beta_warmup_epochs=30, lr_step_size=200, lr_gamma=0.5)
    res = train_single_vae(data.x, cfg, checkpoint_path=args.train_state,
                           device=device)
    if not is_primary():
        return
    out = Path(args.save_dir)
    out.mkdir(parents=True, exist_ok=True)
    ckpt = out / f"vae_best_seed{args.seed}.npz"
    save_pytree(res.best_params, str(ckpt),
                extra_meta={"seed": args.seed,
                            "model_config": to_dict(LEGACY_CONFIG)})
    np.save(out / f"train_losses_seed{args.seed}.npy", res.train_losses)
    np.save(out / f"val_losses_seed{args.seed}.npy", res.val_losses)
    print(f"[ok] saved {ckpt} (best val {res.best_val_loss:.4f})")


def cmd_select_pairs(args):
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import (
        save_pairs,
        select_representatives,
    )

    device = resolve_device(args.device)
    data = _load_data(args)
    latents = _encode(_load_model(args.model, device), data.x, device)
    reps = select_representatives(latents, data.labels, args.max_labels)
    out = Path(args.output or
               f"experiment/pairs/selected_pairs_{args.max_labels}.json")
    save_pairs(reps, out)
    print(f"[ok] saved {len(reps)} representatives -> {out}")


def cmd_init_splines(args):
    from vae_latent_geometry_tpu_torch.config import InitConfig
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.graph.shortest_path import backend
    from vae_latent_geometry_tpu_torch.io.artifacts import save_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.init_splines import (
        initialize_splines,
        to_artifact,
    )
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import load_pairs

    device = resolve_device(args.device)
    data = _load_data(args)
    params = _load_model(args.model, device)
    latents = _encode(params, data.x, device)
    reps, pairs = load_pairs(args.pairfile)
    cfg = InitConfig(grid_points_per_axis=args.grid,
                     use_entropy=args.use_entropy)
    init = initialize_splines(latents, pairs, decoders=_decoders_of(params),
                              cfg=cfg, device=device)
    art = to_artifact(init, reps, Path(args.pairfile).stem.split("_")[-1])
    model_name = Path(args.model).stem
    graph_type = "entropy" if args.use_entropy else "euclidean"
    pairname = Path(args.pairfile).stem.replace("selected_pairs_", "")
    out = Path(args.output or
               f"experiment/splines_init_{model_name}/"
               f"spline_batch_init_{graph_type}_{pairname}.npz")
    save_spline_batch(art, str(out))
    print(f"[ok] saved {int(init.valid.sum())}/{len(init.valid)} initialized "
          f"splines -> {out} (graph stages: {backend()})")


def resolve_batch_size(batch_size, dp) -> int:
    """Default chunk size: 200 pairs PER data-parallel rank (chunks are
    sharded over dp); an explicit ``--batch-size`` always wins."""
    return batch_size if batch_size is not None else 200 * (dp or 1)


def _fill_unset(args, values: dict) -> None:
    for k, v in values.items():
        if getattr(args, k) is None:
            setattr(args, k, v)


def cmd_optimize(args):
    import torch

    from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
        SINGLE_MODES,
        optimize_spline_batch,
        optimize_spline_batch_backstop,
    )

    device = resolve_device(args.device)
    params = _load_model(args.model, device)
    if _decoders_of(params) is None and args.energy_mode not in SINGLE_MODES:
        raise SystemExit(
            f"{args.model} is a single-decoder model: --energy-mode must be "
            f"one of {', '.join(SINGLE_MODES)} (got {args.energy_mode!r})")
    model_name = Path(args.model).stem
    spline_path = args.splines or (
        f"experiment/splines_init_{model_name}/"
        f"spline_batch_init_{args.init_type}_{args.pair_count}.npz")
    art = load_spline_batch(spline_path)
    data = None if args.no_euclidean else _load_data(args).x
    if args.fast and not args.turbo:
        _fill_unset(args, FAST_PRESET)
    _fill_unset(args, _FAST_FLAG_DEFAULTS)
    # the mesh comes before the default batch size: --ep alone derives
    # dp = world size // ep, and 200 pairs per rank applies to that dp too
    mesh = None
    if args.dp or args.ep > 1:
        from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dp=args.dp, ep=args.ep)
        print(f"[info] mesh {mesh.shape}")
    args.batch_size = resolve_batch_size(
        args.batch_size, mesh.size("dp") if mesh is not None else 1)
    phase_plan = TURBO_PHASES if args.turbo else None
    if args.coarse_bf16:
        phase_plan = coarse_bf16_plan(args.energy_mode, phase_plan)
    energy = EnergyConfig(num_t=args.num_t, mc_samples=args.mc_samples,
                          mode=args.energy_mode,
                          kernel_precision=args.kernel_precision)
    cfg = GeodesicConfig(
        steps=args.steps, lr=args.lr, batch_size=args.batch_size,
        lr_schedule=args.lr_schedule, early_stop=args.early_stop,
        traj_num_t=args.traj_num_t, polish_steps=args.polish_steps,
        polish_lr=args.polish_lr, phase_plan=phase_plan, energy=energy)
    # --output is also the checkpoint: re-running the command resumes
    out = Path(args.output or
               f"experiment/splines_opt_{model_name}/"
               f"spline_batch_opt_{args.init_type}_{args.pair_count}.npz")
    kw = dict(data=data, device=device, checkpoint_path=str(out),
              generator=torch.Generator().manual_seed(args.seed), mesh=mesh)
    if args.backstop_fixed:
        # never worse than the fixed reference recipe on any pair, at the
        # configured grid and estimator (the lengths must measure one
        # objective for the merge to mean anything)
        if args.num_t != 2000:
            print(f"[backstop] note: --num-t {args.num_t} — the guarantee "
                  "is vs the 1000-step fixed recipe at THIS grid, not the "
                  "reference's T=2000")
        res = optimize_spline_batch_backstop(
            params, art, cfg=cfg,
            backstop_cfg=GeodesicConfig(steps=1000, lr=1e-3,
                                        batch_size=args.batch_size,
                                        energy=energy), **kw)
    else:
        res = optimize_spline_batch(params, art, cfg=cfg, **kw)
    from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary

    if is_primary():
        n_bk = res.metadata.get("backstop_selected")
        if n_bk is not None:
            print(f"[backstop] fixed-recipe arm won on {n_bk} pairs")
        print(f"[ok] optimized {len(art)} splines -> {out}")


def cmd_eval(args):
    if args.mode == "cov":
        return _eval_cov(args)
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix
    from vae_latent_geometry_tpu_torch.viz import plotting

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
    _plot_or_warn("heatmap", plotting.plot_distance_matrix, mat, labels,
                  str(out_json.with_suffix(".png")),
                  title=f"{args.len_type} matrix seed {args.seed} "
                        f"({args.init_type})")


def _eval_cov(args):
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary
    from vae_latent_geometry_tpu_torch.pipeline.evaluate import cov_analysis
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import load_pairs
    from vae_latent_geometry_tpu_torch.viz import plotting

    device = resolve_device(args.device)
    data = _load_data(args)
    pairfile = (args.pairfile or
                f"experiment/pairs/selected_pairs_{args.pair_count}.json")
    _, pairs = load_pairs(pairfile)
    models, seeds = [], []
    for seed in args.seeds:
        for ext in (".npz", ".pt"):
            path = Path(args.model_dir) / f"model_seed{seed}{ext}"
            if path.exists():
                models.append(_load_model(str(path), device))
                seeds.append(seed)
                break
        else:
            print(f"[warn] no checkpoint for seed {seed}; skipping")
    if not models:
        raise SystemExit(f"no model_seed<N>.npz or .pt for seeds "
                         f"{args.seeds} in {args.model_dir}")
    mesh = None
    if args.dp or args.ep > 1:
        from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(dp=args.dp, ep=args.ep)
        print(f"[info] mesh {mesh.shape}")
    res = cov_analysis(models, seeds, data.x, pairs,
                       decoder_counts=list(range(1, 11)), steps=args.steps,
                       num_t=args.num_t, mode=args.energy_mode,
                       kernel_precision=args.kernel_precision,
                       batch_size=args.batch_size, mesh=mesh, device=device)
    out = (Path(args.output) if args.output else Path("experiment/plots")
           / f"cov_values_alldec_{args.pair_count}.json")
    if is_primary():
        res.save(out)
        print(f"[ok] wrote {out}")
        plot_dir = out.parent
        _plot_or_warn("cov plot", plotting.plot_cov_curves, res,
                      str(plot_dir / f"cov_plot_{args.pair_count}_alldec.png"))
        # per-pair CoV histogram at the full ensemble size (reference
        # artifact cov_hist_euclidean_10.png)
        _plot_or_warn("cov histogram", plotting.plot_cov_hist,
                      res.raw_cov_geodesic[max(res.raw_cov_geodesic)],
                      str(plot_dir / f"cov_hist_{args.pair_count}.png"))


def cmd_plot(args):
    from vae_latent_geometry_tpu_torch.device import resolve_device
    from vae_latent_geometry_tpu_torch.io.artifacts import load_spline_batch
    from vae_latent_geometry_tpu_torch.viz import plotting

    if args.kind in ("density", "splines", "illustration") \
            and not args.splines:
        raise SystemExit(
            f"plot {args.kind} requires --splines <spline-batch artifact> "
            "(the curves to draw)")
    if not plotting.matplotlib_available():
        raise SystemExit("plot needs matplotlib, which is not installed")
    device = resolve_device(args.device)
    data = _load_data(args)
    params = _load_model(args.model, device)
    if args.kind == "uncertainty" and _decoders_of(params) is None:
        raise SystemExit(
            "plot uncertainty maps ENSEMBLE decoder disagreement and "
            f"needs an EVAE checkpoint; {args.model} loaded as "
            f"{type(params).__name__} (a single-decoder model has no "
            "disagreement to map)")
    latents = _encode(params, data.x, device)
    out = args.output or f"experiment/plots/{args.kind}.png"
    if args.kind == "density":
        plotting.plot_latent_density_with_splines(
            latents, data.labels, load_spline_batch(args.splines), out,
            res=args.resolution, device=device)
    elif args.kind == "uncertainty":
        plotting.plot_uncertainty_map(params, latents, out,
                                      colors=data.colors,
                                      resolution=args.resolution)
    elif args.kind == "latents":
        from vae_latent_geometry_tpu_torch.pipeline.select_pairs import (
            load_pairs,
        )

        reps, _ = load_pairs(args.pairfile)
        plotting.plot_latents_with_selected(latents, reps, out)
    elif args.kind == "splines":
        art = load_spline_batch(args.splines)
        if art.omega_optimized is not None:
            plotting.plot_initial_and_optimized_splines(latents, art, out)
        else:
            plotting.plot_initialized_splines(latents, art, out)
    elif args.kind == "illustration":
        # the reference figure's title carries the model seed
        # (density_illustration_examples{seed}.png): model_seed12 -> 12
        m = re.search(r"seed(\d+)", Path(args.model).stem)
        plotting.plot_density_illustration(
            latents, load_spline_batch(args.splines), out,
            point_colors=data.colors, labels=data.labels,
            res=args.resolution, seed=int(m.group(1)) if m else None,
            device=device)
    print(f"[ok] wrote {out}")


def cmd_stability(args):
    from vae_latent_geometry_tpu_torch.pipeline.stability import (
        check_pair_determinism,
        frobenius_from_json,
    )

    # both kinds read JSON artifacts: parse once here (a binary artifact
    # would otherwise end in a raw UnicodeDecodeError) and hand the dicts on
    expected = ("distance-matrix JSONs (eval --mode matrix output)"
                if args.kind == "frobenius"
                else "selected-pairs JSONs (select-pairs output)")
    parsed = []
    for path in (args.a, args.b):
        try:
            parsed.append(json.loads(Path(path).read_text()))
        except (UnicodeDecodeError, json.JSONDecodeError, OSError) as ex:
            raise SystemExit(
                f"[stability] {path} is not readable as JSON "
                f"({type(ex).__name__}: {ex}); `stability {args.kind}` "
                f"compares two {expected}")
    da, db = parsed
    if args.kind == "frobenius":
        res = frobenius_from_json(da, db)
        print(json.dumps({
            "common": len(res.common_labels),
            "only_in_a": res.only_in_a, "only_in_b": res.only_in_b,
            "frob_a": res.frob_a, "frob_b": res.frob_b,
            "frob_diff": res.frob_diff, "rel_diff": res.rel_diff,
        }, indent=2))
    else:
        same = check_pair_determinism(da, db)
        print(f"pair files {'MATCH' if same else 'DIFFER'}")
        sys.exit(0 if same else 1)


def cmd_golden(args):
    """Real-data golden reproduction of the reference's 133x133
    single-decoder matrix (``pipeline/golden.py``)."""
    from vae_latent_geometry_tpu_torch.pipeline.golden import run_golden

    report = run_golden(args.seed, args.output, root=args.reference_root,
                        steps=args.steps, num_t=args.num_t,
                        batch_size=args.batch_size, mode=args.energy_mode,
                        pairs_limit=args.pairs_limit, device=args.device)
    print(json.dumps(report, indent=2))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vae_latent_geometry_tpu_torch")
    # process-group bring-up: every process runs the same command, one per
    # mesh position; artifact writes happen on process 0 only
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (several ranks; or "
                        "VLG_COORDINATOR)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_common(sp):
        sp.add_argument("--data-dir", default=None)
        sp.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch versions of the kernels)")

    t = sub.add_parser("train", help="train the ensemble VAE")
    add_common(t)
    t.add_argument("--latent-dim", type=int, default=2)
    t.add_argument("--num-decoders", type=int, default=10)
    t.add_argument("--epochs", type=int, default=200)
    t.add_argument("--batch-size", type=int, default=64)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--seeds", nargs="+", type=int, default=None,
                   help="train one model per seed in ONE program (the seed "
                        "axis batches every product), e.g. --seeds 12 123 "
                        "1234 12345 45 456, the reference's six CoV seeds; "
                        "overrides --seed")
    t.add_argument("--save-dir", default="experiment")
    t.add_argument("--train-state", default=None,
                   help="whole-training-state checkpoint (params, Adam "
                        "moments, epoch): written after every block, "
                        "resumed from when present; the resumed run repeats "
                        "the uninterrupted one bit for bit")
    t.set_defaults(fn=cmd_train)

    ts = sub.add_parser("train-single", help="train the legacy single VAE")
    add_common(ts)
    ts.add_argument("--epochs", type=int, default=200)
    ts.add_argument("--batch-size", type=int, default=64)
    ts.add_argument("--lr", type=float, default=1e-3)
    ts.add_argument("--seed", type=int, default=12)
    ts.add_argument("--save-dir", default="src_artifacts")
    ts.add_argument("--train-state", default=None,
                    help="whole-training-state checkpoint for resume (with "
                         "the best-val pair)")
    ts.set_defaults(fn=cmd_train_single)

    s = sub.add_parser("select-pairs", help="pick class representatives")
    add_common(s)
    s.add_argument("--model", required=True)
    s.add_argument("--max-labels", type=int, default=10)
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_select_pairs)

    i = sub.add_parser("init-splines", help="Dijkstra spline initialization")
    add_common(i)
    i.add_argument("--model", required=True)
    i.add_argument("--pairfile", required=True)
    i.add_argument("--use-entropy", action="store_true")
    i.add_argument("--grid", type=int, default=200)
    i.add_argument("--output", default=None)
    i.set_defaults(fn=cmd_init_splines)

    o = sub.add_parser("optimize", help="batched geodesic optimization")
    add_common(o)
    o.add_argument("--model", required=True,
                   help="EVAE or legacy single-VAE checkpoint (.npz, or a "
                        "reference .pt/.pth state dict)")
    o.add_argument("--splines", default=None)
    o.add_argument("--init-type", default="entropy",
                   choices=["entropy", "euclidean"])
    o.add_argument("--pair-count", type=int, default=10)
    o.add_argument("--steps", type=int, default=None,
                   help="Adam steps per chunk (default 1000)")
    o.add_argument("--early-stop", action="store_true",
                   help="chunk-level convergence exit (per-spline patience, "
                        "checked every 50 steps, best omega restored) "
                        "instead of the fixed step budget")
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
    o.add_argument("--batch-size", type=int, default=None,
                   help="pairs per optimization chunk (default 200 per "
                        "data-parallel rank, i.e. 200 x --dp)")
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
                            "expected_fused_bf16", "single", "single_fused",
                            "single_fused_bf16", "jvp", "jvp_ensemble"],
                   help="energy estimator: the reference's Monte-Carlo "
                        "estimator (mc; mc_scan streams T in chunks; "
                        "mc_fused runs it in the fused kernels), its "
                        "closed-form expectation (expected*), or the "
                        "decoder-JVP quadrature (jvp: decoder 0; "
                        "jvp_ensemble: mean decoder plus disagreement)")
    o.add_argument("--seed", type=int, default=0,
                   help="seed of the MC modes' decoder draws; a run is "
                        "reproducible per seed")
    o.add_argument("--kernel-precision", default="f32x2",
                   choices=["float32", "f32x3", "f32x2"],
                   help="precision rung of the fused kernels on trajectory "
                        "steps; final energies are always re-evaluated at "
                        "exact float32")
    o.add_argument("--backstop-fixed", action="store_true",
                   help="also run the fixed reference recipe (1000 steps, "
                        "constant lr 1e-3) at the configured --num-t and "
                        "--energy-mode and keep the per-pair better curve: "
                        "never worse than that recipe on any pair; the MC "
                        "modes compare exact expected energies")
    o.add_argument("--no-euclidean", action="store_true",
                   help="skip encoder Euclidean distances (no data needed)")
    o.add_argument("--dp", type=int, default=None,
                   help="data-parallel mesh size (default: no mesh)")
    o.add_argument("--ep", type=int, default=1,
                   help="expert(ensemble)-parallel mesh size: the "
                        "expected_fused modes split the decoders over it")
    o.add_argument("--output", default=None,
                   help="result artifact, also the per-chunk checkpoint: "
                        "re-running the command resumes")
    o.set_defaults(fn=cmd_optimize)

    e = sub.add_parser("eval", help="distance matrix / CoV analysis")
    add_common(e)
    e.add_argument("--mode", required=True, choices=["matrix", "cov"])
    e.add_argument("--len-type", default="geodesic",
                   choices=["geodesic", "euclidean"])
    e.add_argument("--init-type", default="euclidean",
                   choices=["entropy", "euclidean"])
    e.add_argument("--pair-count", type=int, default=133)
    e.add_argument("--seed", type=int, default=12)
    e.add_argument("--seeds", nargs="*", type=int, default=[12, 123],
                   help="cov: model seeds; each needs "
                        "<model-dir>/model_seed<N>.npz or .pt")
    e.add_argument("--splines", default=None)
    e.add_argument("--pairfile", default=None)
    e.add_argument("--model-dir", default="experiment")
    e.add_argument("--steps", type=int, default=300)
    e.add_argument("--num-t", type=int, default=2000)
    e.add_argument("--energy-mode", default="mc",
                   choices=["mc", "mc_scan", "mc_fused", "mc_fused_bf16",
                            "expected", "expected_fused",
                            "expected_fused_bf16"])
    e.add_argument("--kernel-precision", default="f32x3",
                   choices=["float32", "f32x3", "f32x2"],
                   help="cov: precision rung of the fused kernels on the "
                        "optimization steps (final energies at float32)")
    e.add_argument("--batch-size", type=int, default=None)
    e.add_argument("--dp", type=int, default=None,
                   help="cov: data-parallel mesh size (default: no mesh)")
    e.add_argument("--ep", type=int, default=1,
                   help="cov: ensemble-parallel mesh size")
    e.add_argument("--output", default=None,
                   help="result JSON path (matrix: the distance matrix; "
                        "cov: the CoV values, the JAX package's format); "
                        "companion figures are written next to it; "
                        "default: the experiment/plots/ naming convention "
                        "under the cwd")
    e.set_defaults(fn=cmd_eval)

    pl_ = sub.add_parser("plot", help="latent-space visualizations")
    add_common(pl_)
    pl_.add_argument("kind", choices=["density", "uncertainty", "latents",
                                      "splines", "illustration"])
    pl_.add_argument("--model", required=True)
    pl_.add_argument("--splines", default=None)
    pl_.add_argument("--pairfile", default=None)
    pl_.add_argument("--resolution", type=int, default=100)
    pl_.add_argument("--output", default=None)
    pl_.set_defaults(fn=cmd_plot)

    st = sub.add_parser("stability", help="cross-seed stability checks")
    st.add_argument("kind", choices=["frobenius", "pairs"])
    st.add_argument("--a", required=True,
                    help="first artifact: a distance-matrix JSON (eval "
                         "--mode matrix output) for `frobenius`, a "
                         "selected-pairs JSON (select-pairs output) for "
                         "`pairs`")
    st.add_argument("--b", required=True,
                    help="second artifact, same kind as --a")
    st.set_defaults(fn=cmd_stability)

    gd = sub.add_parser(
        "golden", help="reproduce the reference's real-data 133x133 "
        "single-decoder matrix and compare to its golden JSON")
    gd.add_argument("--seed", type=int, default=12, choices=[12, 123])
    gd.add_argument("--output", default="experiment")
    gd.add_argument("--reference-root", default="/root/reference")
    gd.add_argument("--steps", type=int, default=500)
    gd.add_argument("--num-t", type=int, default=2000)
    gd.add_argument("--batch-size", type=int, default=500)
    gd.add_argument("--energy-mode", default="single_fused")
    gd.add_argument("--pairs-limit", type=int, default=None)
    gd.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    gd.set_defaults(fn=cmd_golden)
    return p


def main(argv=None):
    import os

    args = build_parser().parse_args(argv)
    # a launcher that exports VLG_COORDINATOR gets the process group without
    # threading a flag through its command template
    if args.coordinator or os.environ.get("VLG_COORDINATOR"):
        from vae_latent_geometry_tpu_torch.parallel.multihost import (
            init_multihost,
        )

        backend = "gloo" if getattr(args, "device", None) == "cpu" else None
        pid, n = init_multihost(args.coordinator, args.num_processes,
                                args.process_id, backend=backend)
        print(f"[multihost] process {pid}/{n}")
    args.fn(args)


if __name__ == "__main__":
    main()
