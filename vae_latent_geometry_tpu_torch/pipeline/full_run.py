"""High-level end-to-end distance-matrix pipeline.

One call runs the reference's four-script sequence (select pairs -> init
splines -> optimize -> matrix eval) and reports per-stage wall-clock (each
stage a ``run.<stage>`` span): the workload behind the full n x n ensemble
geodesic matrix.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import GeodesicConfig, InitConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.graph.shortest_path import backend
from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.pipeline.evaluate import distance_matrix
from vae_latent_geometry_tpu_torch.pipeline.init_splines import (
    initialize_splines,
    to_artifact,
)
from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
    optimize_spline_batch,
)
from vae_latent_geometry_tpu_torch.pipeline.select_pairs import (
    make_pairs,
    select_representatives,
)
from vae_latent_geometry_tpu_torch.utils.profiling import trace_annotation


@dataclass
class FullRunResult:
    matrix: np.ndarray
    labels: list
    artifact: SplineBatchArtifact
    timings: Dict[str, float] = field(default_factory=dict)
    graph_backend: str = ""     # 'native' or 'scipy' (graph/shortest_path.py)


def run_distance_pipeline(
    params: evae_lib.EVAEParams,
    data: np.ndarray,
    labels: np.ndarray,
    max_labels: int = 133,
    init_cfg: InitConfig = InitConfig(),
    geo_cfg: GeodesicConfig = GeodesicConfig(),
    mesh=None,
    compute_euclidean: bool = True,
    checkpoint_path: Optional[str] = None,
    verbose: bool = True,
    device=None,
    generator: Optional[torch.Generator] = None,
) -> FullRunResult:
    """From data to the class-by-class geodesic distance matrix.

    params: EVAE parameters on ``device``.  With a ``mesh`` the optimize
    stage is sharded over its ranks (every rank runs the cheap host stages
    redundantly); ``checkpoint_path`` checkpoints the optimize stage there
    per chunk, resumes it from there and saves the optimized artifact there
    (primary rank only)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings: Dict[str, float] = {}
    with trace_annotation("run.encode", timed=True) as span:
        with torch.no_grad():
            latents = evae_lib.encode(params, torch.as_tensor(
                np.asarray(data, np.float32), device=dev))[0].cpu().numpy()
    timings["encode"] = span.seconds

    with trace_annotation("run.select_pairs", timed=True) as span:
        reps = select_representatives(latents, labels, max_labels)
        pairs = make_pairs(reps)
    timings["select_pairs"] = span.seconds

    with trace_annotation("run.init_splines", timed=True) as span:
        init = initialize_splines(latents, pairs, decoders=params.decoders,
                                  cfg=init_cfg, device=dev)
    timings["init_splines"] = span.seconds
    art = to_artifact(init, reps, max_labels)

    with trace_annotation("run.optimize", timed=True) as span:
        art = optimize_spline_batch(
            params, art, data=data if compute_euclidean else None,
            cfg=geo_cfg, device=dev, checkpoint_path=checkpoint_path,
            log_every_chunk=verbose, generator=generator, mesh=mesh)
        sync()
    timings["optimize"] = span.seconds

    with trace_annotation("run.matrix", timed=True) as span:
        mat, mat_labels = distance_matrix(art, "geodesic")
    timings["matrix"] = span.seconds
    timings["total"] = sum(timings.values())
    if verbose:
        print("[timings] " + "  ".join(f"{k}={v:.2f}s"
                                       for k, v in timings.items())
              + f"  graph={backend()}")
    return FullRunResult(matrix=mat, labels=mat_labels, artifact=art,
                         timings=timings, graph_backend=backend())
