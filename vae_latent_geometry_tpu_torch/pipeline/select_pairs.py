"""Representative selection and pair enumeration.

Reference: ``src/select_representative_pairs.py:16-49`` — per class label,
pick the point whose latent is closest to the class's latent centroid; take
the first ``max_labels`` unique labels (np.unique order = sorted), form all
C(n, 2) pairs; persist as JSON {representatives: [{index, label}], pairs}.
Host-side numpy, arithmetic as ``vae_latent_geometry_tpu.pipeline.select_pairs``.
"""

from __future__ import annotations

import json
from itertools import combinations
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def select_representatives(latents: np.ndarray, labels: np.ndarray,
                           max_labels: int = 10) -> List[dict]:
    labels = np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    selected = uniq[:max_labels]
    n_sel = len(selected)
    if n_sel < max_labels:
        print(f"[warn] only {n_sel} unique labels found, expected {max_labels}")

    # per-class centroids over ALL classes, then restrict
    n_classes = len(uniq)
    counts = np.bincount(inv, minlength=n_classes).astype(np.float64)
    sums = np.zeros((n_classes, latents.shape[1]))
    np.add.at(sums, inv, latents)
    centroids = sums / counts[:, None]

    dists = np.linalg.norm(latents - centroids[inv], axis=1)
    reps = []
    for c in range(n_sel):
        idxs = np.nonzero(inv == c)[0]
        closest = idxs[np.argmin(dists[idxs])]
        reps.append({"index": int(closest), "label": str(uniq[c])})
    return reps


def make_pairs(representatives: Sequence[dict]) -> List[Tuple[int, int]]:
    indices = [r["index"] for r in representatives]
    return list(combinations(indices, 2))


def save_pairs(representatives: Sequence[dict], path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"representatives": list(representatives),
               "pairs": [list(p) for p in make_pairs(representatives)]}
    path.write_text(json.dumps(payload, indent=2))


def load_pairs(path):
    data = json.loads(Path(path).read_text())
    return data["representatives"], [tuple(p) for p in data["pairs"]]
