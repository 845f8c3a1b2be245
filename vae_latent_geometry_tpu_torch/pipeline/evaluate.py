"""Evaluation: the distance matrix over class representatives and the
cross-seed CoV analysis (reference ``src/eval.py``;
``vae_latent_geometry_tpu.pipeline.evaluate``).

- matrix (:13-66): a symmetric n x n matrix of geodesic lengths (or latent
  Euclidean distances) with NaN holes for skipped pairs, zero diagonal.
- CoV (:70-176): for each pair x seed x decoder count k, a straight-line
  spline re-optimized with the first k decoders; CoV = std/mean of the
  lengths over seeds per k.  Each seed runs ONE batched optimization over
  the (pair x count) grid with a per-spline ``num_active``.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    fold_seed,
    optimize_splines,
    root_seed,
)


def distance_matrix(art: SplineBatchArtifact,
                    len_type: str = "geodesic") -> tuple[np.ndarray, List[str]]:
    """Symmetric (n, n) matrix over representatives with NaN holes for
    skipped pairs and a zero diagonal.  Artifacts without representatives
    index by the per-pair class labels."""
    values = (art.geodesic_length if len_type == "geodesic"
              else art.euclidean_distance)
    if values is None:
        raise ValueError(f"artifact carries no {len_type!r} values")

    reps = art.representatives
    if reps:
        global_to_local = {int(r["index"]): i for i, r in enumerate(reps)}
        labels = [str(r.get("label", r.get("cluster_label", r["index"])))
                  for r in reps]

        def locate(p):
            ia, ib = (int(art.pair_indices[p, 0]), int(art.pair_indices[p, 1]))
            if ia not in global_to_local or ib not in global_to_local:
                return None
            return global_to_local[ia], global_to_local[ib]
    else:
        labels = sorted({l for pair in art.pair_labels for l in pair})
        label_to_local = {l: i for i, l in enumerate(labels)}

        def locate(p):
            la, lb = art.pair_labels[p]
            return label_to_local[la], label_to_local[lb]

    n = len(labels)
    mat = np.full((n, n), np.nan)
    for p in range(len(art)):
        if not art.valid[p] or not np.isfinite(values[p]):
            continue
        loc = locate(p)
        if loc is None:
            continue
        la, lb = loc
        mat[la, lb] = mat[lb, la] = float(values[p])
    np.fill_diagonal(mat, 0.0)
    return mat, labels


def compute_cov(values: np.ndarray, axis=None) -> np.ndarray:
    """std/mean with the reference's zero-mean guard (``src/eval.py:70-72``;
    numpy's population std, ddof=0, as the reference)."""
    values = np.asarray(values, np.float64)
    mean = values.mean(axis=axis)
    std = values.std(axis=axis)
    return np.where(mean > 0, std / np.maximum(mean, 1e-300), 0.0)


@dataclass
class CovResult:
    avg_cov_geodesic: Dict[int, float]
    avg_cov_euclidean: float
    raw_cov_geodesic: Dict[int, np.ndarray]   # k -> (P,) per-pair CoV
    raw_cov_euclidean: np.ndarray             # (P,)
    lengths: np.ndarray                       # (S, P, K) geodesic lengths
    euclidean: np.ndarray                     # (S, P)
    seeds: List[int]
    decoder_counts: List[int]

    def to_json(self) -> dict:
        """The JAX package's CovResult JSON, key for key."""
        return {
            "avg_cov_geodesic": {str(k): float(v)
                                 for k, v in self.avg_cov_geodesic.items()},
            "avg_cov_euclidean": float(self.avg_cov_euclidean),
            "raw_cov_geodesic": {str(k): [float(x) for x in v]
                                 for k, v in self.raw_cov_geodesic.items()},
            "raw_cov_euclidean": [float(x) for x in self.raw_cov_euclidean],
            "seeds": list(self.seeds),
            "decoder_counts": list(self.decoder_counts),
            "num_pairs": int(self.lengths.shape[1]),
        }

    def save(self, path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_text(json.dumps(self.to_json(), indent=2))


def cov_analysis(
    models: Sequence[evae_lib.EVAEParams],
    seeds: Sequence[int],
    data: Optional[np.ndarray],
    pairs: Sequence[tuple[int, int]],
    decoder_counts: Sequence[int] = tuple(range(1, 11)),
    steps: int = 300,
    num_t: int = 2000,
    mc_samples: int = 2,
    mode: str = "mc",
    kernel_precision: str = "f32x3",
    lr: float = 1e-3,
    generator: Optional[torch.Generator] = None,
    batch_size: Optional[int] = None,
    mesh=None,
    rep_latents: Optional[Sequence[np.ndarray]] = None,
    device=None,
) -> CovResult:
    """Cross-seed stability of geodesic lengths against ensemble size.

    One batched optimization per model: B = n_pairs * n_counts splines with
    a per-spline ``num_active`` count, straight-line init (omega = 0),
    chunks of ``batch_size`` edge-padded to that size.  Counts above the
    smallest ensemble are dropped with a warning.  ``generator`` names the
    MC modes' random stream (default seed 0); each (model, chunk start)
    draws from a stream folded from it, nested as the JAX package folds its
    key, so no two seeds share draws.  ``mesh``: each chunk's splines shard
    over 'dp' (``parallel/shard.sharded_optimize_splines``).
    ``rep_latents``: one (N, D) latent array per model that ``pairs`` index,
    in place of encoding ``data`` (which may then be None).
    """
    dev = resolve_device(device)
    pairs = np.asarray(list(pairs), np.int64)
    counts = np.asarray(list(decoder_counts), np.int32)
    # a count above the ensemble size would select nothing: drop it loudly
    m_min = min(m.decoders["layers"][0]["w"].shape[0] for m in models)
    if (counts > m_min).any():
        dropped = counts[counts > m_min].tolist()
        warnings.warn(
            f"decoder_counts {dropped} exceed the smallest ensemble size "
            f"({m_min}) and were dropped", stacklevel=2)
        counts = counts[counts <= m_min]
        if counts.size == 0:
            raise ValueError(
                f"no decoder_counts <= ensemble size {m_min} remain")
    if rep_latents is not None and len(rep_latents) != len(models):
        raise ValueError("rep_latents must have one latent array per model")
    P, K = len(pairs), len(counts)
    basis, _ = nullspace_basis(4)
    cfg = GeodesicConfig(
        steps=steps, lr=lr,
        energy=EnergyConfig(num_t=num_t, mc_samples=mc_samples, mode=mode,
                            kernel_precision=kernel_precision))
    root = root_seed(generator)
    lengths = np.zeros((len(models), P, K))
    eucl = np.zeros((len(models), P))
    for s, params in enumerate(models):
        if rep_latents is not None:
            z = np.asarray(rep_latents[s])
        else:
            with torch.no_grad():
                z = evae_lib.encode(params, torch.as_tensor(
                    np.asarray(data, np.float32), device=dev))[0].cpu().numpy()
        za, zb = z[pairs[:, 0]], z[pairs[:, 1]]
        eucl[s] = np.linalg.norm(za - zb, axis=1)
        # the (pair, count) grid on the batch axis
        a = np.repeat(za, K, axis=0).astype(np.float32)
        b = np.repeat(zb, K, axis=0).astype(np.float32)
        num_active = np.tile(counts, P)
        omega0 = np.zeros((P * K, basis.shape[1], 2), np.float32)
        bs = batch_size or P * K
        outs = []
        for start in range(0, P * K, bs):
            stop = min(start + bs, P * K)
            n_sl = stop - start
            idx = np.arange(start, stop)
            if n_sl < bs:   # one chunk shape per run
                idx = np.concatenate([idx, np.full(bs - n_sl, stop - 1)])
            gen = torch.Generator().manual_seed(
                fold_seed(fold_seed(root, s), start))
            if mesh is not None:
                from vae_latent_geometry_tpu_torch.parallel.shard import (
                    sharded_optimize_splines,
                )

                res = sharded_optimize_splines(
                    params.decoders, omega0[idx], a[idx], b[idx], basis, cfg,
                    mesh, generator=gen, num_active=num_active[idx],
                    device=dev)
            else:
                res = optimize_splines(
                    params.decoders, omega0[idx], a[idx], b[idx], basis, cfg,
                    # host counts: the MC wrappers range-check them without
                    # waiting for the device
                    num_active=torch.as_tensor(num_active[idx]),
                    device=dev, generator=gen)
            outs.append(res.lengths.cpu().numpy()[:n_sl])
        lengths[s] = np.concatenate(outs).reshape(P, K)

    raw_cov_geo = {int(k): compute_cov(lengths[:, :, i], axis=0)
                   for i, k in enumerate(counts)}
    raw_cov_euc = compute_cov(eucl, axis=0)
    return CovResult(
        avg_cov_geodesic={k: float(np.mean(v)) for k, v in raw_cov_geo.items()},
        avg_cov_euclidean=float(np.mean(raw_cov_euc)),
        raw_cov_geodesic=raw_cov_geo,
        raw_cov_euclidean=raw_cov_euc,
        lengths=lengths, euclidean=eucl,
        seeds=list(seeds), decoder_counts=[int(k) for k in counts],
    )
