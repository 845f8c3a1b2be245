"""Spline-batch artifacts: the pipeline's stage hand-off format.

The same columnar ``.npz`` (dense arrays, no pickle) with a JSON sidecar for
labels and metadata as ``vae_latent_geometry_tpu.io.artifacts``, so each
package reads the other's output.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class SplineBatchArtifact:
    a: np.ndarray                  # (P, D)
    b: np.ndarray                  # (P, D)
    omega_init: np.ndarray         # (P, K, D)
    basis: np.ndarray              # (4*n_poly, K)
    n_poly: int
    pair_indices: np.ndarray       # (P, 2) dataset indices
    valid: np.ndarray              # (P,) bool
    pair_labels: List[List[str]]   # (P, 2) class labels
    representatives: List[dict]    # [{index, label}]
    omega_optimized: Optional[np.ndarray] = None   # (P, K, D)
    geodesic_length: Optional[np.ndarray] = None   # (P,)
    euclidean_distance: Optional[np.ndarray] = None  # (P,)
    metadata: Dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.a)


_ARRAY_FIELDS = ("a", "b", "omega_init", "basis", "pair_indices", "valid",
                 "omega_optimized", "geodesic_length", "euclidean_distance")


def save_spline_batch(art: SplineBatchArtifact, path: str) -> None:
    """Atomic write (temp file + rename) to ``path`` (``.npz`` appended
    when missing)."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays = {}
    for name in _ARRAY_FIELDS:
        v = getattr(art, name)
        if v is not None:
            arrays[name] = np.asarray(v)
    sidecar = {
        "n_poly": int(art.n_poly),
        "pair_labels": art.pair_labels,
        "representatives": art.representatives,
        "metadata": art.metadata,
    }
    tmp = f"{path}.tmp.{os.getpid()}.npz"
    np.savez(tmp, __sidecar__=json.dumps(sidecar), **arrays)
    os.replace(tmp, path)


def load_spline_batch(path: str) -> SplineBatchArtifact:
    path = str(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    with np.load(path, allow_pickle=False) as f:
        sidecar = json.loads(str(f["__sidecar__"]))
        arrays = {k: f[k] for k in f.files if k != "__sidecar__"}
    return SplineBatchArtifact(
        a=arrays["a"], b=arrays["b"], omega_init=arrays["omega_init"],
        basis=arrays["basis"], n_poly=sidecar["n_poly"],
        pair_indices=arrays["pair_indices"], valid=arrays["valid"].astype(bool),
        pair_labels=sidecar["pair_labels"],
        representatives=sidecar["representatives"],
        omega_optimized=arrays.get("omega_optimized"),
        geodesic_length=arrays.get("geodesic_length"),
        euclidean_distance=arrays.get("euclidean_distance"),
        metadata=sidecar.get("metadata", {}),
    )
