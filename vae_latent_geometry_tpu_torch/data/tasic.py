"""Tasic mouse-cortex RNA-seq dataset (PCA50) loading.

A copy of ``vae_latent_geometry_tpu.data.tasic``: ``tasic-pca50.npy``
(23822, 50), ``tasic-ttypes.npy`` class labels and ``tasic-colors.npy``,
searched under ``data/`` (or ``data_dir``).  When the matrix is absent a
deterministic seeded Gaussian-mixture surrogate of the same shape and class
structure stands in, bit-identical to the JAX package's.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np

DEFAULT_DATA_DIRS = ("data",)
N_CELLS = 23822
N_FEATURES = 50


@dataclass
class TasicData:
    x: np.ndarray            # (N, 50) float32
    labels: np.ndarray       # (N,) str
    colors: Optional[np.ndarray]  # (N,) str hex, or None
    synthetic: bool          # True when ANY component is a surrogate


def _find(name: str, data_dir: Optional[str]) -> Optional[str]:
    dirs = [data_dir] if data_dir else list(DEFAULT_DATA_DIRS)
    for d in dirs:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def synthesize_tasic_like(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Deterministic GMM surrogate for the missing PCA50 matrix: one cluster
    mean per unique label, feature scales decaying like a PCA spectrum."""
    rng = np.random.default_rng(seed)
    uniq, inv = np.unique(labels, return_inverse=True)
    n_classes = len(uniq)
    k = np.arange(1, N_FEATURES + 1)
    scales = np.sqrt(1737.0 / k**1.3).astype(np.float32)
    means = rng.normal(size=(n_classes, N_FEATURES)).astype(np.float32)
    means *= scales[None, :] * 0.9
    noise = rng.normal(size=(len(labels), N_FEATURES)).astype(np.float32)
    x = means[inv] + noise * (scales[None, :] * 0.45)
    return x.astype(np.float32)


def load_tasic(data_dir: Optional[str] = None, allow_synthetic: bool = True,
               seed: int = 0) -> TasicData:
    x_path = _find("tasic-pca50.npy", data_dir)
    x = np.load(x_path).astype(np.float32) if x_path is not None else None

    labels_path = _find("tasic-ttypes.npy", data_dir)
    if labels_path is None:
        if not allow_synthetic:
            raise FileNotFoundError("tasic-ttypes.npy not found")
        rng = np.random.default_rng(seed)
        n = len(x) if x is not None else N_CELLS
        labels = np.array([f"class_{i:03d}"
                           for i in rng.integers(0, 133, n)])
        colors = None
        if x is not None:
            warnings.warn(
                "tasic-pca50.npy found but tasic-ttypes.npy is missing: "
                "pairing the REAL matrix with seeded-random surrogate "
                "labels — class structure (representatives, pairs, CoV) is "
                "meaningless", stacklevel=2)
    else:
        labels = np.load(labels_path, allow_pickle=True).astype(str)
        colors_path = _find("tasic-colors.npy", data_dir)
        colors = (np.load(colors_path, allow_pickle=True).astype(str)
                  if colors_path else None)

    if x is not None:
        if len(labels) != len(x):
            raise ValueError(
                f"tasic-pca50.npy has {len(x)} rows but tasic-ttypes.npy "
                f"has {len(labels)} labels — mismatched data dir")
        return TasicData(x=x, labels=labels, colors=colors,
                         synthetic=labels_path is None)
    if not allow_synthetic:
        raise FileNotFoundError("tasic-pca50.npy not found")
    return TasicData(
        x=synthesize_tasic_like(labels, seed=seed),
        labels=labels, colors=colors, synthetic=True,
    )


def train_val_split(n: int, val_ratio: float = 0.1, seed: int = 42):
    """Seeded permutation split (reference ``src/train.py:148-152``:
    randperm, first 10% validation, rest training); the JAX package's split
    index for index."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    n_val = int(val_ratio * n)
    return idx[n_val:], idx[:n_val]
