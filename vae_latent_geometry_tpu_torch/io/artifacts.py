"""Spline-batch artifacts: the pipeline's stage hand-off format.

The same columnar ``.npz`` (dense arrays, no pickle) with a JSON sidecar for
labels and metadata as ``vae_latent_geometry_tpu.io.artifacts``, so each
package reads the other's output.  The reference's torch blobs (``.pt``:
``spline_data`` per-pair dicts, representatives, pairs, metadata) load
through ``models.torch_import.load_spline_blob`` and
:func:`from_reference_blob`; :func:`to_reference_blob` writes one.
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
    """An artifact from its ``.npz``, or from a reference ``.pt``/``.pth``
    blob (``src/optimize.py:190-201``)."""
    path = str(path)
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path += ".npz"
    if path.endswith((".pt", ".pth")):
        from vae_latent_geometry_tpu_torch.models.torch_import import (
            load_spline_blob,
        )

        return from_reference_blob(load_spline_blob(path))
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


def _plain(v):
    """Plain Python containers and scalars (numpy arrays as tensors), so
    that the ``weights_only=True`` loader reads the blob back."""
    import torch

    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(v))
    if isinstance(v, np.generic):
        return v.item()
    return v


def to_reference_blob(art: SplineBatchArtifact, path: Optional[str] = None):
    """The artifact in the reference's torch blob schema
    (``src/optimize.py:190-201``); written with ``torch.save`` when a path
    is given.  Returns the blob dict."""
    import torch

    spline_data = []
    for p in range(len(art)):
        d = {
            "a": torch.from_numpy(np.asarray(art.a[p])),
            "b": torch.from_numpy(np.asarray(art.b[p])),
            "a_index": int(art.pair_indices[p, 0]),
            "b_index": int(art.pair_indices[p, 1]),
            "a_label": str(art.pair_labels[p][0]),
            "b_label": str(art.pair_labels[p][1]),
            "n_poly": int(art.n_poly),
            "basis": torch.from_numpy(np.asarray(art.basis)),
            "omega_init": torch.from_numpy(np.asarray(art.omega_init[p])),
        }
        if art.omega_optimized is not None:
            d["omega_optimized"] = torch.from_numpy(
                np.asarray(art.omega_optimized[p]))
        if art.geodesic_length is not None:
            d["geodesic_length"] = float(art.geodesic_length[p])
        if art.euclidean_distance is not None:
            d["euclidean_distance"] = float(art.euclidean_distance[p])
        spline_data.append(d)
    blob = {
        "spline_data": spline_data,
        "representatives": _plain(art.representatives),
        "pairs": [[int(i), int(j)] for i, j in art.pair_indices],
        "metadata": _plain(art.metadata),
    }
    if path is not None:
        torch.save(blob, path)
    return blob


def from_reference_blob(blob: dict) -> SplineBatchArtifact:
    """A loaded reference blob (``models.torch_import.load_spline_blob``)
    as the columnar artifact."""
    data = blob["spline_data"]
    if not data:
        raise ValueError(
            "reference blob has an empty 'spline_data' list — nothing to "
            "convert (truncated or partial export?)")

    def col(key):
        if key in data[0]:
            return np.stack([np.asarray(d[key]) for d in data])
        return None

    def scal(*keys):
        for key in keys:
            if key in data[0]:
                return np.array([float(d[key]) for d in data])
        return None

    pair_idx = np.stack([[d.get("a_index", -1), d.get("b_index", -1)]
                         for d in data])
    labels = [[str(d.get("a_label", d.get("cluster_pair", ("?", "?"))[0])),
               str(d.get("b_label", d.get("cluster_pair", ("?", "?"))[1]))]
              for d in data]
    return SplineBatchArtifact(
        a=col("a"), b=col("b"), omega_init=col("omega_init"),
        basis=np.asarray(data[0]["basis"]), n_poly=int(data[0]["n_poly"]),
        pair_indices=pair_idx, valid=np.ones(len(data), bool),
        pair_labels=labels,
        representatives=blob.get("representatives") or [],
        omega_optimized=col("omega_optimized"),
        geodesic_length=scal("geodesic_length", "length_geodesic"),
        euclidean_distance=scal("euclidean_distance", "length_euclidean"),
        metadata=dict(blob.get("metadata") or {}),
    )
