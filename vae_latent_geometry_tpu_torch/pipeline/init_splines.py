"""Spline initialization: Dijkstra shortest paths + closed-form spline fit.

Pipeline (reference ``src/init_splines_ensemble.py:98-228``):
 1. encode the dataset -> latents (device)
 2. build a latent grid + kNN graph (Euclidean or entropy-weighted)
 3. per pair: nearest grid nodes, Dijkstra path, fit a spline to the path
 4. hand the initialized spline batch on

As in the JAX package, Dijkstra runs once per *unique source* (native C++,
parallel over sources), paths for all pairs come from the shared predecessor
arrays as padded matrices, the per-pair LBFGS fit is replaced by the exact
closed-form least-squares solution, batched on the device over all pairs
(``geometry/spline.fit_spline_lstsq``), and skipped pairs (identical
endpoint nodes / unreachable targets) are tracked with a validity mask so
all downstream arrays keep their shapes.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import InitConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.geometry.spline import (
    design_matrix,
    fit_spline_lstsq,
)
from vae_latent_geometry_tpu_torch.graph.grid import (
    create_latent_grid,
    entropy_weights,
    grid_knn_graph,
    reweight_graph_by_entropy,
)
from vae_latent_geometry_tpu_torch.graph.shortest_path import (
    dijkstra_multi,
    extract_paths,
)


@dataclass
class InitializedSplines:
    """Static-shaped batch of initialized splines."""

    a: np.ndarray            # (P, D) start endpoints (grid nodes)
    b: np.ndarray            # (P, D) end endpoints (grid nodes)
    omega: np.ndarray        # (P, K, D) fitted init params
    valid: np.ndarray        # (P,) bool — False for skipped pairs
    pair_indices: np.ndarray  # (P, 2) original dataset indices
    basis: np.ndarray        # (4*n_poly, K)
    n_poly: int
    init_type: str           # "euclidean" | "entropy"

    def __len__(self) -> int:
        return len(self.a)


def _nearest_grid_nodes(grid: np.ndarray, shape: Tuple[int, int],
                        points: np.ndarray) -> np.ndarray:
    """Nearest grid node per query point — closed form on a regular grid:
    snap each coordinate to the nearest axis tick."""
    nx, ny = shape
    g = grid.reshape(nx, ny, 2)
    x0, y0 = g[0, 0]
    dx = (g[-1, 0, 0] - x0) / max(nx - 1, 1)
    dy = (g[0, -1, 1] - y0) / max(ny - 1, 1)
    ix = np.clip(np.round((points[:, 0] - x0) / dx), 0, nx - 1).astype(np.int64)
    iy = np.clip(np.round((points[:, 1] - y0) / dy), 0, ny - 1).astype(np.int64)
    return (ix * ny + iy).astype(np.int32)


def _fit_batched(paths_xy: np.ndarray, t_vals: np.ndarray, mask: np.ndarray,
                 a: np.ndarray, b: np.ndarray, basis: np.ndarray,
                 n_poly: int, device) -> np.ndarray:
    """Batched least-squares fit over padded paths, on ``device``."""
    def dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    with torch.no_grad():
        t = dev(t_vals)
        phi = design_matrix(t, basis, n_poly)                 # (P, L, K)
        omega = fit_spline_lstsq(dev(paths_xy), dev(mask), dev(a), dev(b),
                                 phi, t)
    return omega.cpu().numpy()


def initialize_splines(
    latents: np.ndarray,
    pairs: Sequence[Tuple[int, int]],
    decoders=None,
    cfg: InitConfig = InitConfig(),
    grid: Optional[np.ndarray] = None,
    grid_shape: Optional[Tuple[int, int]] = None,
    max_path_len: Optional[int] = None,
    device=None,
) -> InitializedSplines:
    """Initialize one spline per pair via Dijkstra + least-squares fit.

    latents: (N, 2) encoder means for the whole dataset.
    pairs:   dataset-index pairs (from pair selection).
    decoders: stacked ensemble dict, required when cfg.use_entropy; the
    grid is decoded on its device.
    max_path_len: overrides ``cfg.max_path_len`` when given.
    device: where the spline fit runs (default cuda).
    """
    dev = resolve_device(device)
    pairs = np.asarray(list(pairs), np.int64)
    if max_path_len is None:
        max_path_len = cfg.max_path_len
    if grid is None:
        grid, grid_shape = create_latent_grid(
            latents, cfg.grid_points_per_axis, cfg.grid_margin
        )
    elif grid_shape is None:
        raise ValueError(
            "a custom `grid` requires `grid_shape` (nx, ny) — the nearest-"
            "node snap and the kNN window search need the grid's 2-D layout")
    graph = grid_knn_graph(grid, grid_shape, k=cfg.knn)
    init_type = "euclidean"
    if cfg.use_entropy:
        if decoders is None:
            raise ValueError("entropy weighting requires ensemble decoders")
        node_ent = entropy_weights(decoders, grid)
        graph = reweight_graph_by_entropy(graph, node_ent)
        init_type = "entropy"

    start_nodes = _nearest_grid_nodes(grid, grid_shape, latents[pairs[:, 0]])
    end_nodes = _nearest_grid_nodes(grid, grid_shape, latents[pairs[:, 1]])

    # one Dijkstra per unique source, shared across pairs
    uniq_sources, src_rows = np.unique(start_nodes, return_inverse=True)
    _, pred = dijkstra_multi(graph, uniq_sources)
    paths, lengths = extract_paths(pred, src_rows.astype(np.int32),
                                   uniq_sources.astype(np.int32),
                                   end_nodes, max_len=max_path_len)

    # a length-0 pair whose target IS reachable (predecessor set) was
    # dropped by the padded-path cap, not by graph topology — that must be
    # loud: a silent drop shows up only as an unexplained NaN hole in the
    # matrix
    capped = (lengths == 0) & (start_nodes != end_nodes) \
        & (pred[src_rows, end_nodes] >= 0)
    if capped.any():
        warnings.warn(
            f"{int(capped.sum())} pair(s) had Dijkstra paths longer than "
            f"max_path_len={max_path_len} and were invalidated — raise "
            "InitConfig.max_path_len to keep them", stacklevel=2)

    valid = (lengths > 1) & (start_nodes != end_nodes)
    P = len(pairs)
    max_l = int(max(lengths.max(), 2))
    paths = paths[:, :max_l]

    # gather path coordinates; padded slots -> clamp to node 0 then mask out
    safe = np.where(paths >= 0, paths, 0)
    paths_xy = grid[safe]                                    # (P, L, 2)
    pos = np.arange(max_l)[None, :]
    mask = (pos < lengths[:, None]) & valid[:, None]         # (P, L)

    # per-pair t grid: linspace(0, 1, len(path)) (reference :183)
    denom = np.maximum(lengths - 1, 1).astype(np.float32)
    t_vals = np.minimum(pos / denom[:, None], 1.0).astype(np.float32)

    a = np.where(valid[:, None], paths_xy[:, 0],
                 latents[pairs[:, 0]]).astype(np.float32)
    b_idx = np.maximum(lengths - 1, 0)
    b = np.where(valid[:, None], paths_xy[np.arange(P), b_idx],
                 latents[pairs[:, 1]]).astype(np.float32)

    basis, _ = nullspace_basis(cfg.spline.n_poly)
    omega = _fit_batched(paths_xy, t_vals, mask.astype(np.float32), a, b,
                         basis, cfg.spline.n_poly, dev)
    omega = np.where(valid[:, None, None], omega, 0.0).astype(np.float32)

    return InitializedSplines(
        a=a, b=b, omega=omega, valid=valid,
        pair_indices=pairs.astype(np.int64),
        basis=basis, n_poly=cfg.spline.n_poly, init_type=init_type,
    )


def to_artifact(init: InitializedSplines, representatives, pair_count: int):
    """The init stage's hand-off: a spline-batch artifact with the pairs'
    class labels and the representatives attached."""
    from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact

    label_of = {r["index"]: r["label"] for r in representatives}
    return SplineBatchArtifact(
        a=init.a, b=init.b, omega_init=init.omega, basis=init.basis,
        n_poly=init.n_poly, pair_indices=init.pair_indices, valid=init.valid,
        pair_labels=[[label_of.get(int(i), "?"), label_of.get(int(j), "?")]
                     for i, j in init.pair_indices],
        representatives=list(representatives),
        metadata={"init_type": init.init_type, "pair_count": pair_count},
    )
