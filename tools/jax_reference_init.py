#!/usr/bin/env python3
"""Reference init stage from the JAX package on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/jax_reference_init.py \
        --out tools/jax_reference_init_seed42

Runs the JAX package's encode -> ``select_representatives`` ->
``make_pairs`` -> ``initialize_splines`` on the package's seeded surrogate
(``load_tasic()`` with no data directory: 23,822 x 50) with the committed
seed-42 EVAE, ``--max-labels`` 20 (190 pairs) and
``InitConfig(use_entropy=True)`` at its defaults (200 x 200 grid, k=8), and
writes ``<out>.npz`` (representative and pair indices, a, b, omega_init,
valid, the Dijkstra paths as padded node lists, the node entropies, and the
float32 expected-energy lengths of the init curves at T=2000) and
``<out>.json`` (labels, recipe, versions).  ``chip_smoke.py`` holds the
PyTorch port's init stages against both.  CPU only; about a minute.
"""

import argparse
import json
import os
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from vae_latent_geometry_tpu.config import InitConfig, ModelConfig  # noqa: E402
from vae_latent_geometry_tpu.data import load_tasic  # noqa: E402
from vae_latent_geometry_tpu.geometry import energy as energy_lib  # noqa: E402
from vae_latent_geometry_tpu.geometry.spline import (  # noqa: E402
    design_matrix,
    eval_spline_design,
)
from vae_latent_geometry_tpu.graph import (  # noqa: E402
    create_latent_grid,
    dijkstra_multi,
    entropy_weights,
    extract_paths,
    grid_knn_graph,
    reweight_graph_by_entropy,
)
from vae_latent_geometry_tpu.graph.shortest_path import native_available  # noqa: E402
from vae_latent_geometry_tpu.io.checkpoint import load_pytree  # noqa: E402
from vae_latent_geometry_tpu.models import evae as evae_lib  # noqa: E402
from vae_latent_geometry_tpu.pipeline.init_splines import (  # noqa: E402
    _nearest_grid_nodes,
    initialize_splines,
)
from vae_latent_geometry_tpu.pipeline.select_pairs import (  # noqa: E402
    make_pairs,
    select_representatives,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-labels", type=int, default=20)
    ap.add_argument("--num-t", type=int, default=2000)
    ap.add_argument("--out", required=True,
                    help="path stem: writes <out>.npz and <out>.json")
    args = ap.parse_args()
    t0 = time.perf_counter()
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
    cfg = InitConfig(use_entropy=True)
    init = initialize_splines(latents, pairs, decoders=params.decoders,
                              cfg=cfg)

    # the paths themselves, by the same calls initialize_splines makes
    grid, shape = create_latent_grid(latents, cfg.grid_points_per_axis,
                                     cfg.grid_margin)
    node_ent = entropy_weights(params.decoders, grid)
    graph = reweight_graph_by_entropy(grid_knn_graph(grid, shape, k=cfg.knn),
                                      node_ent)
    p = np.asarray(pairs, np.int64)
    start = _nearest_grid_nodes(grid, shape, latents[p[:, 0]])
    end = _nearest_grid_nodes(grid, shape, latents[p[:, 1]])
    uniq, rows = np.unique(start, return_inverse=True)
    _, pred = dijkstra_multi(graph, uniq)
    paths, path_len = extract_paths(pred, rows.astype(np.int32),
                                    uniq.astype(np.int32), end,
                                    max_len=cfg.max_path_len)
    paths = paths[:, :int(path_len.max())]

    # float32 expected-energy lengths of the init curves
    t = jnp.linspace(0.0, 1.0, args.num_t)
    phi = design_matrix(t, jnp.asarray(init.basis), init.n_poly)
    lengths = []
    for lo in range(0, len(init), 38):
        sl = slice(lo, lo + 38)
        gamma = eval_spline_design(jnp.asarray(init.omega[sl]),
                                   jnp.asarray(init.a[sl]),
                                   jnp.asarray(init.b[sl]), phi, t)
        lengths.append(np.sqrt(np.asarray(
            energy_lib.energy_expected(params.decoders, gamma))))
    np.savez_compressed(
        args.out + ".npz",
        rep_indices=np.array([r["index"] for r in reps], np.int64),
        pair_indices=init.pair_indices, a=init.a, b=init.b,
        omega_init=init.omega, valid=init.valid, basis=init.basis,
        paths=paths, path_len=path_len, node_entropy=node_ent,
        rep_latents=latents[[r["index"] for r in reps]],
        init_lengths=np.concatenate(lengths).astype(np.float64))
    with open(args.out + ".json", "w") as f:
        json.dump({"representatives": reps,
                   "recipe": {"data": "load_tasic() seeded surrogate",
                              "n_rows": int(len(data.x)),
                              "model": "experiment/model_seed42.npz",
                              "max_labels": args.max_labels,
                              "init": {"use_entropy": True,
                                       "grid_points_per_axis":
                                           cfg.grid_points_per_axis,
                                       "knn": cfg.knn,
                                       "max_path_len": cfg.max_path_len},
                              "num_t": args.num_t},
                   "graph_backend": "native" if native_available()
                   else "scipy",
                   "platform": "cpu", "jax": jax.__version__,
                   "seconds": time.perf_counter() - t0}, f, indent=1)


if __name__ == "__main__":
    main()
