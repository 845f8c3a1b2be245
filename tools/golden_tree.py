#!/usr/bin/env python3
"""A reference-shaped tree for the golden single-decoder reproduction.

    python tools/golden_tree.py --out /tmp/golden_root [--classes 133]

Writes what ``pipeline/golden.py`` (either package) reads under
``<root>/src/artifacts/``, for each model seed (12 and 123):

- ``latents_VAE_ld2_ep100_bs64_lr1e-03_seed<S>.npy``: float32 (N, 2)
  latents, N = 23,822 cells in ``--classes`` seeded 2-D Gaussian classes
  (the class of a cell is the same for every seed; the class centres and
  spreads are the seed's own);
- ``selected_pairs_133.json``: one representative per class (the cell
  nearest its class mean in the first seed's latents, as
  ``select_representatives`` picks) and every pair of them, in the format
  ``select_pairs.load_pairs`` reads;
- ``vae_best_seed<S>.pth``: a legacy VAE state dict in the reference's
  layout (``encoder.encoder_net.{0,2,4}.*``, ``decoder.decoder_net.{0,2,4}.*``,
  ``nn.Linear`` weights (out, in)) at the ``LEGACY_CONFIG`` widths
  50 -> 128 -> 64 -> 4 and 2 -> 128 -> 128 -> 100, drawn as PyTorch's
  default init does (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
  biases) from a numpy seed;
- ``geodesic_distances_seed<S>_p133.json``: a STAND-IN for the golden
  matrix: the Euclidean latent distances between the representatives.  It
  is not a geodesic matrix; it only gives the comparison its shape.

The file names keep ``133`` whatever ``--classes`` is, as the golden
module reads them.  numpy and ``torch.save`` only.
"""

from __future__ import annotations

import argparse
import json
import os
from itertools import combinations

import numpy as np

N_CELLS = 23822
SEEDS = (12, 123)
ENCODER_DIMS = (50, 128, 64, 4)
DECODER_DIMS = (2, 128, 128, 100)


def _labels(n_points: int, n_classes: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return rng.permutation(np.arange(n_points) % n_classes)


def _latents(seed: int, cls: np.ndarray, n_classes: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-3.0, 3.0, size=(n_classes, 2))
    spreads = rng.uniform(0.1, 0.3, size=n_classes)
    noise = rng.standard_normal((len(cls), 2))
    return (centres[cls] + spreads[cls, None] * noise).astype(np.float32)


def _state_dict(seed: int) -> dict:
    import torch

    rng = np.random.default_rng(1000 + seed)
    sd = {}
    for prefix, dims in (("encoder.encoder_net", ENCODER_DIMS),
                         ("decoder.decoder_net", DECODER_DIMS)):
        for i in range(len(dims) - 1):
            bound = 1.0 / np.sqrt(dims[i])
            w = rng.uniform(-bound, bound, size=(dims[i + 1], dims[i]))
            b = rng.uniform(-bound, bound, size=dims[i + 1])
            sd[f"{prefix}.{2 * i}.weight"] = torch.from_numpy(
                w.astype(np.float32))
            sd[f"{prefix}.{2 * i}.bias"] = torch.from_numpy(
                b.astype(np.float32))
    return sd


def write_tree(root: str, seeds=SEEDS, n_classes: int = 133,
               n_points: int = N_CELLS) -> str:
    """Write the tree under ``root``; returns ``root``."""
    import torch

    art = os.path.join(root, "src", "artifacts")
    os.makedirs(art, exist_ok=True)
    cls = _labels(n_points, n_classes)
    names = np.array([f"class_{c:03d}" for c in range(n_classes)])
    latents = {s: _latents(s, cls, n_classes) for s in seeds}
    z0 = latents[seeds[0]]
    reps = []
    for c in range(n_classes):
        idx = np.nonzero(cls == c)[0]
        d = np.linalg.norm(z0[idx] - z0[idx].mean(axis=0), axis=1)
        reps.append({"index": int(idx[np.argmin(d)]), "label": str(names[c])})
    rep_idx = [r["index"] for r in reps]
    with open(os.path.join(art, "selected_pairs_133.json"), "w") as f:
        json.dump({"representatives": reps,
                   "pairs": [list(p) for p in combinations(rep_idx, 2)]},
                  f, indent=2)
    for s in seeds:
        z = latents[s]
        np.save(os.path.join(
            art, f"latents_VAE_ld2_ep100_bs64_lr1e-03_seed{s}.npy"), z)
        torch.save(_state_dict(s), os.path.join(art, f"vae_best_seed{s}.pth"))
        zr = z[rep_idx].astype(np.float64)
        mat = np.linalg.norm(zr[:, None] - zr[None], axis=-1)
        with open(os.path.join(
                art, f"geodesic_distances_seed{s}_p133.json"), "w") as f:
            json.dump({"seed": s, "cluster_ids": [r["label"] for r in reps],
                       "distance_matrix": mat.tolist()}, f)
    return root


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--classes", type=int, default=133)
    ap.add_argument("--points", type=int, default=N_CELLS)
    args = ap.parse_args()
    print(write_tree(args.out, n_classes=args.classes, n_points=args.points))


if __name__ == "__main__":
    main()
