#!/usr/bin/env python3
"""Reference golden reproduction from the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_reference_golden.py \
        --out tools/jax_reference_golden_seed12.json

made the committed ``tools/jax_reference_golden_seed12.json``: 472 s wall
clock (the JSON's ``seconds``) and about 29 minutes of CPU time on an
8-core CPU.

Builds the seeded reference-shaped tree of ``tools/golden_tree.py`` (133
classes, 23,822 latents, seeds 12 and 123) in a temporary directory and
runs ``vae_latent_geometry_tpu.pipeline.golden.run_golden`` on seed 12
with ``pairs_limit`` ``--pairs`` (default 200: the first pairs of the pair
file) and the golden recipe otherwise (single_fused, f32x3, 500 Adam
steps, T=2000, batch 500, float32 final re-evaluation), the Pallas
kernels in interpret mode.  Records the pairs' lengths, their Dijkstra
init paths (by the calls ``initialize_splines`` makes) and the
``compare_to_golden`` report.  ``chip_smoke.py`` (phase ``golden``) holds
the PyTorch port's full-recipe run on the same tree against this file.
"""

import argparse
import json
import os
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from tools.golden_tree import write_tree  # noqa: E402
from vae_latent_geometry_tpu.config import InitConfig  # noqa: E402
from vae_latent_geometry_tpu.graph import (  # noqa: E402
    create_latent_grid,
    dijkstra_multi,
    extract_paths,
    grid_knn_graph,
)
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch  # noqa: E402
from vae_latent_geometry_tpu.pipeline import golden as G  # noqa: E402
from vae_latent_geometry_tpu.pipeline.init_splines import (  # noqa: E402
    _nearest_grid_nodes,
)


def init_paths(latents, pairs, cfg):
    """The Euclidean-graph Dijkstra paths initialize_splines follows:
    (padded node lists, lengths)."""
    grid, shape = create_latent_grid(latents, cfg.grid_points_per_axis,
                                     cfg.grid_margin)
    graph = grid_knn_graph(grid, shape, k=cfg.knn)
    p = np.asarray(pairs, np.int64)
    start = _nearest_grid_nodes(grid, shape, latents[p[:, 0]])
    end = _nearest_grid_nodes(grid, shape, latents[p[:, 1]])
    uniq, rows = np.unique(start, return_inverse=True)
    _, pred = dijkstra_multi(graph, uniq)
    return extract_paths(pred, rows.astype(np.int32), uniq.astype(np.int32),
                         end, max_len=cfg.max_path_len)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=200)
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = write_tree(os.path.join(tmp, "reference"))
        out_dir = os.path.join(tmp, "out")
        report = G.run_golden(args.seed, out_dir, root=root,
                              pairs_limit=args.pairs)
        art = load_spline_batch(os.path.join(
            out_dir, f"golden133_seed{args.seed}_blob_single_fused_s500_t2000"
                     f"_p{args.pairs}.npz"))
        _, pairs = G.reference_pairs(root=root)
        paths, path_len = init_paths(G.reference_latents(args.seed, root),
                                     pairs[:args.pairs], InitConfig())
    with open(args.out, "w") as f:
        json.dump({
            "pairs": args.pairs, "seed": args.seed,
            "pair_indices": np.asarray(art.pair_indices).tolist(),
            "lengths": np.asarray(art.geodesic_length, np.float64).tolist(),
            "path_len": path_len.tolist(),
            "paths": [p[:n].tolist() for p, n in zip(paths, path_len)],
            "report": report,
            "recipe": {"mode": "single_fused", "kernel_precision": "f32x3",
                       "steps": 500, "num_t": 2000, "batch_size": 500,
                       "lr": 1e-3, "tree": "tools/golden_tree.py defaults"},
            "platform": "cpu", "jax": jax.__version__,
            "seconds": time.perf_counter() - t0}, f, indent=1)


if __name__ == "__main__":
    main()
