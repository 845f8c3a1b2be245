"""Latent-grid construction and graph weighting.

Reference behavior (``src/init_splines_ensemble.py``):

- ``create_latent_grid_from_data`` (:21-36): uniform n x n grid over the
  latent bounding box expanded by a 10% margin, 'ij' meshgrid flattening.
- ``build_grid_graph`` (:72-82): k=8 nearest neighbours, edge weight =
  Euclidean distance; edges come from the native C++ window search (or a
  vectorized cKDTree query).
- ``build_entropy_weighted_graph`` (:39-68): decode the full grid with every
  ensemble decoder, node disagreement = ||std over decoders||_2, min-max
  normalized; edge weight = mean of endpoint entropies (*not* scaled by edge
  length — faithful to the reference).  The decode runs on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from vae_latent_geometry_tpu_torch.graph import shortest_path as _native
from vae_latent_geometry_tpu_torch.models.evae import decoder_std


def create_latent_grid(latents: np.ndarray, n_points_per_axis: int = 200,
                       margin: float = 0.1) -> Tuple[np.ndarray, Tuple[int, int]]:
    """(n^2, 2) grid over the data bounding box + margin, row-major in x."""
    z_min = latents.min(axis=0).astype(np.float64)
    z_max = latents.max(axis=0).astype(np.float64)
    z_range = z_max - z_min
    z_min = z_min - margin * z_range
    z_max = z_max + margin * z_range
    xs = np.linspace(z_min[0], z_max[0], n_points_per_axis)
    ys = np.linspace(z_min[1], z_max[1], n_points_per_axis)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    grid = np.stack([gx, gy], axis=-1).reshape(-1, 2).astype(np.float32)
    return grid, (n_points_per_axis, n_points_per_axis)


def _grid_spacing(grid: np.ndarray, shape: Tuple[int, int]) -> Tuple[float, float]:
    nx, ny = shape
    g = grid.reshape(nx, ny, 2)
    dx = float(g[1, 0, 0] - g[0, 0, 0]) if nx > 1 else 1.0
    dy = float(g[0, 1, 1] - g[0, 0, 1]) if ny > 1 else 1.0
    return dx, dy


def grid_knn_graph(grid: np.ndarray, shape: Optional[Tuple[int, int]] = None,
                   k: int = 8) -> sp.csr_matrix:
    """kNN graph with Euclidean edge weights, as CSR.

    Uses the native window search when the grid is regular and the shared
    library is there; otherwise a vectorized cKDTree query.
    """
    n = len(grid)
    if shape is not None and _native.native_available():
        nx, ny = shape
        dx, dy = _grid_spacing(grid, shape)
        indptr, indices, dists = _native.grid_knn_native(nx, ny, dx, dy, k)
        # prune boundary self-loops (zero-weight placeholder edges)
        mat = sp.csr_matrix((dists, indices, indptr), shape=(n, n))
        mat.setdiag(0)
        mat.eliminate_zeros()
        return mat
    from scipy.spatial import cKDTree

    tree = cKDTree(grid)
    dists, idxs = tree.query(grid, k=k + 1)
    rows = np.repeat(np.arange(n), k)
    cols = idxs[:, 1:].reshape(-1)
    vals = dists[:, 1:].reshape(-1)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def entropy_weights(decoders, grid: np.ndarray, eps: float = 1e-8,
                    chunk: int = 8192) -> np.ndarray:
    """Per-node ensemble disagreement, min-max normalized to [0, 1].

    disagreement(z) = || std over decoders of f_d(z) ||_2
    (reference ``src/init_splines_ensemble.py:49-54``).  The grid is decoded
    on the decoders' device, in chunks to bound device memory.
    """
    dev = decoders["layers"][0]["w"].device
    parts = []
    with torch.no_grad():
        for start in range(0, len(grid), chunk):
            z = torch.as_tensor(grid[start:start + chunk], dtype=torch.float32,
                                device=dev)
            parts.append(torch.linalg.norm(decoder_std(decoders, z), dim=-1)
                         .cpu().numpy())
    ent = np.concatenate(parts)
    lo, hi = ent.min(), ent.max()
    return ((ent - lo) / (hi - lo + eps)).astype(np.float32)


def reweight_graph_by_entropy(graph: sp.csr_matrix,
                              node_entropy: np.ndarray) -> sp.csr_matrix:
    """Edge weight <- mean of endpoint entropies (reference :64).

    Purely structural reweighting of the kNN graph; zero-entropy edges get a
    tiny floor so CSR does not drop them.
    """
    g = graph.tocoo()
    w = 0.5 * (node_entropy[g.row] + node_entropy[g.col])
    w = np.maximum(w, 1e-12)
    return sp.csr_matrix((w, (g.row, g.col)), shape=graph.shape)
