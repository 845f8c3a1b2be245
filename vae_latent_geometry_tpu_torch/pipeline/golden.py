"""Real-data golden reproduction of the reference's 133x133 single-decoder
geodesic distance matrices (``vae_latent_geometry_tpu.pipeline.golden``).

The reference commits what its single-decoder run consumed, under
``<root>/src/artifacts/``: the encoder means of all 23,822 cells
(``latents_VAE_ld2_ep100_bs64_lr1e-03_seed{12,123}.npy``), the 133
representatives and 8,778 pairs (``selected_pairs_133.json``), the trained
VAEs (``vae_best_seed{12,123}.pth``) and the golden matrices
(``geodesic_distances_seed{12,123}_p133.json``).  This module reruns
init -> optimize -> matrix with the port (Dijkstra + least-squares init,
the fused single-decoder energy, batched Adam) and compares the matrix
elementwise with the golden one.  The reference's semantics kept:

- endpoints are the Dijkstra path's grid nodes, not the raw latents
  (``init_spline.py:117``);
- a 200x200 grid with a 10% margin and a k=8 Euclidean kNN graph
  (``init_spline.py:79-80``);
- Adam at lr 1e-3, 500 steps, T=2000, batch 500
  (``optimize_energy_batched.py:95-104,132``);
- the length is the data-space arc length through the decoder mean
  (``optimize_energy_batched.py:42-49``), not sqrt(energy).

Exact equality is not attainable (the reference's LBFGS init fit and
scipy's Dijkstra tie-breaking), so the comparison reports
distribution-level statistics, beside the same statistics between the two
golden seeds as the scale bar.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vae_latent_geometry_tpu_torch.config import (
    EnergyConfig,
    GeodesicConfig,
    InitConfig,
)
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix
from vae_latent_geometry_tpu_torch.pipeline.init_splines import (
    initialize_splines,
)
from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
    optimize_spline_batch,
)
from vae_latent_geometry_tpu_torch.utils.profiling import Timer

REFERENCE_ROOT = "/root/reference"


def _artifacts(root: str, name: str) -> str:
    return os.path.join(root, "src", "artifacts", name)


def reference_latents(seed: int, root: str = REFERENCE_ROOT) -> np.ndarray:
    """The real encoder means (23822, 2) the reference committed."""
    return np.load(_artifacts(
        root, f"latents_VAE_ld2_ep100_bs64_lr1e-03_seed{seed}.npy")
    ).astype(np.float32)


def reference_pairs(n: int = 133, root: str = REFERENCE_ROOT
                    ) -> Tuple[list, np.ndarray]:
    """(representatives, pairs) of ``selected_pairs_{n}.json``."""
    from vae_latent_geometry_tpu_torch.pipeline.select_pairs import load_pairs

    reps, pairs = load_pairs(_artifacts(root, f"selected_pairs_{n}.json"))
    return reps, np.asarray(pairs, np.int64)


def golden_matrix(seed: int, root: str = REFERENCE_ROOT
                  ) -> Tuple[np.ndarray, list]:
    """(matrix, cluster ids) of the golden JSON for ``seed``."""
    with open(_artifacts(root, f"geodesic_distances_seed{seed}_p133.json")
              ) as f:
        doc = json.load(f)
    return np.asarray(doc["distance_matrix"], float), list(doc["cluster_ids"])


def build_init_artifact(seed: int, root: str = REFERENCE_ROOT,
                        pairs_limit: Optional[int] = None,
                        n_pairs_file: int = 133,
                        device=None) -> SplineBatchArtifact:
    """The golden workload's init splines from the real latents (the first
    ``pairs_limit`` pairs of the pair file when given)."""
    latents = reference_latents(seed, root)
    reps, pairs = reference_pairs(n_pairs_file, root)
    if pairs_limit is not None:
        pairs = pairs[:pairs_limit]
    label_of = {int(r["index"]): str(r["label"]) for r in reps}
    init = initialize_splines(latents, pairs, cfg=InitConfig(),
                              device=device)
    return SplineBatchArtifact(
        a=init.a, b=init.b, omega_init=init.omega, basis=init.basis,
        n_poly=init.n_poly, pair_indices=init.pair_indices, valid=init.valid,
        pair_labels=[[label_of[int(ia)], label_of[int(ib)]]
                     for ia, ib in pairs],
        representatives=list(reps),
        metadata={"seed": seed, "init_type": init.init_type,
                  "source": "reference real latents"})


def reproduce_matrix(
    seed: int,
    root: str = REFERENCE_ROOT,
    steps: int = 500,
    num_t: int = 2000,
    batch_size: int = 500,
    mode: str = "single_fused",
    pairs_limit: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    log: bool = True,
    device=None,
    seconds: Optional[dict] = None,
) -> Tuple[np.ndarray, list, SplineBatchArtifact]:
    """The whole real-data single-decoder run -> (matrix, labels, blob);
    each stage's seconds (``init``, ``optimize``, ``matrix``, the device
    synchronized at both ends) go into ``seconds`` when given."""
    from vae_latent_geometry_tpu_torch.models.torch_import import (
        load_single_vae_mean_decoder,
    )

    dev = resolve_device(device)
    seconds = {} if seconds is None else seconds
    with Timer() as t:
        art = build_init_artifact(seed, root, pairs_limit=pairs_limit,
                                  device=dev)
    seconds["init"] = t.elapsed
    params = load_single_vae_mean_decoder(
        _artifacts(root, f"vae_best_seed{seed}.pth"), dev)
    cfg = GeodesicConfig(steps=steps, batch_size=batch_size,
                         energy=EnergyConfig(num_t=num_t, mode=mode))
    with Timer() as t:
        out = optimize_spline_batch(params, art, cfg=cfg, device=dev,
                                    checkpoint_path=checkpoint_path,
                                    log_every_chunk=log)
    seconds["optimize"] = t.elapsed
    with Timer() as t:
        mat, labels = distance_matrix(out)
    seconds["matrix"] = t.elapsed
    return mat, labels, out


def align_by_labels(mat_a: np.ndarray, labels_a: Sequence[str],
                    mat_b: np.ndarray, labels_b: Sequence[str]
                    ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Two label-indexed matrices restricted to their common labels, in
    the first matrix's label order."""
    common = [l for l in labels_a if l in set(labels_b)]
    ia = [list(labels_a).index(l) for l in common]
    ib = [list(labels_b).index(l) for l in common]
    return mat_a[np.ix_(ia, ia)], mat_b[np.ix_(ib, ib)], common


def matrix_stats(ours: np.ndarray, golden: np.ndarray) -> Dict[str, float]:
    """Agreement statistics over the common finite off-diagonal entries
    (upper triangle)."""
    iu = np.triu_indices(ours.shape[0], k=1)
    x, y = ours[iu], golden[iu]
    ok = np.isfinite(x) & np.isfinite(y)
    x, y = x[ok], y[ok]
    rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-12)
    fro = float(np.linalg.norm(x - y) / max(np.linalg.norm(y), 1e-12))
    corr = float(np.corrcoef(x, y)[0, 1]) if len(x) > 1 else float("nan")
    return {
        "n_common": int(ok.sum()),
        "n_total": int(len(ok)),
        "median_rel": float(np.median(rel)),
        "mean_rel": float(np.mean(rel)),
        "p90_rel": float(np.quantile(rel, 0.9)),
        "max_rel": float(np.max(rel)) if len(rel) else float("nan"),
        "pearson_r": corr,
        "rel_frobenius": fro,
    }


def compare_to_golden(mat: np.ndarray, labels: Sequence[str], seed: int,
                      root: str = REFERENCE_ROOT) -> Dict[str, object]:
    """A reproduced matrix against the golden JSON of ``seed``, with the
    golden-vs-golden cross-seed statistics as the scale bar (None when the
    other seed's golden is absent)."""
    gold, gold_labels = golden_matrix(seed, root)
    ours_c, gold_c, common = align_by_labels(mat, labels, gold, gold_labels)
    other = 123 if seed == 12 else 12
    try:
        g2, g2_labels = golden_matrix(other, root)
        ga, gb, _ = align_by_labels(gold, gold_labels, g2, g2_labels)
        cross = matrix_stats(ga, gb)
    except FileNotFoundError:
        cross = None
    return {
        "seed": seed,
        "n_labels_ours": len(labels),
        "n_labels_golden": len(gold_labels),
        "n_labels_common": len(common),
        "vs_golden": matrix_stats(ours_c, gold_c),
        "golden_cross_seed_scale": cross,
    }


def checkpoint_name(seed: int, steps: int = 500, num_t: int = 2000,
                    batch_size: int = 500, mode: str = "single_fused",
                    pairs_limit: Optional[int] = None) -> str:
    """The optimize stage's checkpoint file for this recipe: the canonical
    recipe gets the plain name, any other its config in the name, so a
    rerun of either resumes and neither overwrites the other (the stage's
    resume stamp keys the whole recipe, batch size included)."""
    canonical = (steps == 500 and num_t == 2000 and mode == "single_fused"
                 and pairs_limit is None and batch_size == 500)
    stamp = "" if canonical else (
        f"_{mode}_s{steps}_t{num_t}"
        + (f"_bs{batch_size}" if batch_size != 500 else "")
        + (f"_p{pairs_limit}" if pairs_limit is not None else ""))
    return f"golden133_seed{seed}_blob{stamp}.npz"


def run_golden(seed: int, out_dir: str, root: str = REFERENCE_ROOT,
               steps: int = 500, num_t: int = 2000, batch_size: int = 500,
               mode: str = "single_fused",
               pairs_limit: Optional[int] = None,
               device=None) -> Dict[str, object]:
    """Run the reproduction and write ``golden133_seed<N>_matrix.json`` and
    ``..._compare.json`` into ``out_dir``; the blob is the optimize stage's
    checkpoint there (:func:`checkpoint_name`), so a rerun resumes.  The
    report is JAX's plus ``seconds`` by stage."""
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, checkpoint_name(
        seed, steps, num_t, batch_size, mode, pairs_limit))
    seconds: dict = {}
    mat, labels, _ = reproduce_matrix(
        seed, root, steps=steps, num_t=num_t, batch_size=batch_size,
        mode=mode, pairs_limit=pairs_limit, checkpoint_path=ckpt,
        device=device, seconds=seconds)
    with open(os.path.join(out_dir, f"golden133_seed{seed}_matrix.json"),
              "w") as f:
        json.dump({"seed": seed, "cluster_ids": list(labels),
                   "distance_matrix": mat.tolist()}, f)
    report = compare_to_golden(mat, labels, seed, root)
    report["config"] = {"steps": steps, "num_t": num_t,
                        "batch_size": batch_size, "mode": mode,
                        "pairs_limit": pairs_limit}
    with open(os.path.join(out_dir, f"golden133_seed{seed}_compare.json"),
              "w") as f:
        json.dump(report, f, indent=2)
    report["seconds"] = seconds
    return report
