"""Cross-seed stability utilities (``vae_latent_geometry_tpu.pipeline.
stability``), after the reference's ``src/old_`` analysis layer:

- ``frobenius_comparison`` (``src/old_/frobenius.py``): two seeds' distance
  matrices aligned on their common class labels, their Frobenius norms and
  the norm of the difference;
- ``check_pair_determinism`` (``src/old_/stability.py:95-97``): two pair
  files select the same representatives and pairs;
- ``encoder_agreement``: the largest deviation between two models' encoder
  means on shared data;
- ``cross_seed_spread_comparison``: whether two pipelines' cross-seed
  spreads vary alike over the class pairs.

All but ``encoder_agreement`` are host numpy.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Sequence

import numpy as np
import torch


@dataclass
class FrobeniusResult:
    common_labels: list
    only_in_a: list
    only_in_b: list
    frob_a: float
    frob_b: float
    frob_diff: float
    rel_diff: float


def _align(labels_a: Sequence[str], labels_b: Sequence[str]):
    set_a, set_b = set(labels_a), set(labels_b)
    common = sorted(set_a & set_b)
    idx_a = [list(labels_a).index(c) for c in common]
    idx_b = [list(labels_b).index(c) for c in common]
    return common, idx_a, idx_b, sorted(set_a - set_b), sorted(set_b - set_a)


def frobenius_comparison(mat_a: np.ndarray, labels_a: Sequence[str],
                         mat_b: np.ndarray, labels_b: Sequence[str],
                         ignore_nan: bool = True) -> FrobeniusResult:
    """Compare two distance matrices on their common labels (entries where
    either is not finite count as 0 in both with ``ignore_nan``)."""
    common, ia, ib, only_a, only_b = _align(labels_a, labels_b)
    A = np.asarray(mat_a)[np.ix_(ia, ia)].astype(np.float64)
    B = np.asarray(mat_b)[np.ix_(ib, ib)].astype(np.float64)
    if ignore_nan:
        mask = np.isfinite(A) & np.isfinite(B)
        A = np.where(mask, A, 0.0)
        B = np.where(mask, B, 0.0)
    fa = float(np.linalg.norm(A))
    fb = float(np.linalg.norm(B))
    fd = float(np.linalg.norm(A - B))
    return FrobeniusResult(
        common_labels=common, only_in_a=only_a, only_in_b=only_b,
        frob_a=fa, frob_b=fb, frob_diff=fd,
        rel_diff=fd / max(0.5 * (fa + fb), 1e-30))


def _as_artifact(x) -> dict:
    """A path to a JSON artifact, or the parsed dict itself."""
    return x if isinstance(x, dict) else json.loads(Path(x).read_text())


def frobenius_from_json(path_a, path_b) -> FrobeniusResult:
    """Compare two distance-matrix JSON artifacts ({seed, cluster_ids,
    distance_matrix}, ``src/single_decoder/density_batched.py:135-142``);
    each argument a path or a parsed dict, ``null`` entries NaN."""
    da = _as_artifact(path_a)
    db = _as_artifact(path_b)

    def mat(d):
        return np.array([[np.nan if v is None else v for v in row]
                         for row in d["distance_matrix"]])

    return frobenius_comparison(mat(da), da["cluster_ids"],
                                mat(db), db["cluster_ids"])


def check_pair_determinism(path_a, path_b) -> bool:
    """True when two pair files (paths or parsed dicts) hold the same
    representatives and pairs."""
    da = _as_artifact(path_a)
    db = _as_artifact(path_b)
    return (da["representatives"] == db["representatives"]
            and [list(p) for p in da["pairs"]]
            == [list(p) for p in db["pairs"]])


def encoder_agreement(params_a, params_b, data: np.ndarray) -> float:
    """Largest absolute deviation between two EVAEs' encoder means over
    ``data``, on the device of ``params_a``."""
    from vae_latent_geometry_tpu_torch.models.evae import encode

    dev = params_a.encoder["layers"][0]["w"].device
    x = torch.as_tensor(np.asarray(data, np.float32), device=dev)
    with torch.no_grad():
        za = encode(params_a, x)[0]
        zb = encode(params_b, x)[0]
    return float((za - zb).abs().max())


def cross_seed_spread_comparison(mats_ours, labels_ours, mats_golden,
                                 labels_golden) -> dict:
    """Does a pipeline reproduce the reference's cross-seed variability
    structure?  Inputs are two-seed pairs ``(mat_a, mat_b)`` with their
    label lists; for every class pair in all four matrices the relative
    spread |d_a - d_b| / mean(d_a, d_b) is computed for ours and for the
    golden matrices, and the two compared (the reference's analogues: the
    cross-seed Frobenius comparison, ``src/old_/frobenius.py``, and the
    CoV analysis, ``src/eval.py:70-176``)."""
    (oa, ob), (la, lb) = mats_ours, labels_ours
    (ga, gb), (ma, mb) = mats_golden, labels_golden
    keep = [l for l in la if l in set(lb) and l in set(ma) and l in set(mb)]

    def sub(m, ls):
        ix = [list(ls).index(l) for l in keep]
        return np.asarray(m, float)[np.ix_(ix, ix)]

    iu = np.triu_indices(len(keep), k=1)

    def spread(x, y):
        x, y = x[iu], y[iu]
        return np.abs(x - y) / np.maximum(0.5 * (np.abs(x) + np.abs(y)),
                                          1e-12)

    ours = spread(sub(oa, la), sub(ob, lb))
    gold = spread(sub(ga, ma), sub(gb, mb))
    ok = np.isfinite(ours) & np.isfinite(gold)
    return {
        "n_entries": int(ok.sum()),
        "n_labels": len(keep),
        "mean_spread_ours": float(ours[ok].mean()),
        "mean_spread_golden": float(gold[ok].mean()),
        "median_spread_ours": float(np.median(ours[ok])),
        "median_spread_golden": float(np.median(gold[ok])),
        "spread_correlation": float(np.corrcoef(ours[ok], gold[ok])[0, 1]),
    }
