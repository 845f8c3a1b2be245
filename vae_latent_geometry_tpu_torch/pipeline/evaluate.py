"""Evaluation: the distance matrix over class representatives
(reference ``src/eval.py:13-66``; ``vae_latent_geometry_tpu.pipeline.
evaluate.distance_matrix``)."""

from __future__ import annotations

from typing import List

import numpy as np

from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact


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
