"""Pipeline stage: batched geodesic optimization over an initialized spline
batch (reference ``src/optimize.py:80-218``).

Pairs are optimized in chunks of ``batch_size``; a trailing partial chunk
is padded to the canonical size by edge replication, as in the JAX package,
so every chunk runs the same shapes.  The result carries the same config
stamp as the JAX package's, and is saved once at the end.  With a ``mesh``
every chunk is one collective program over its ranks
(``parallel/shard.sharded_optimize_splines``): all ranks compute, only the
primary one prints and saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import GeodesicConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.geometry import energy as energy_lib
from vae_latent_geometry_tpu_torch.geometry.spline import (
    design_matrix,
    eval_spline_design,
    t_grid,
)
from vae_latent_geometry_tpu_torch.io.artifacts import (
    SplineBatchArtifact,
    save_spline_batch,
)
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    fold_seed,
    optimize_splines,
    root_seed,
)
from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary
from vae_latent_geometry_tpu_torch.parallel.shard import (
    sharded_optimize_splines,
)

# GeodesicConfig fields that cannot change any produced value; left out of
# the recipe stamp (same set as the JAX package).
_RESULT_NEUTRAL = {"energy": {"gradonly_traj"}}


def _recipe_stamp(cfg: GeodesicConfig) -> str:
    d = dataclasses.asdict(cfg)
    for section, keys in _RESULT_NEUTRAL.items():
        for k in keys:
            d.get(section, {}).pop(k, None)
    return json.dumps(d, sort_keys=True, default=str)


def config_stamp(art: SplineBatchArtifact, cfg: GeodesicConfig) -> dict:
    """Metadata binding a result to its config and input artifact."""
    h = hashlib.sha256()
    for arr in (art.pair_indices, art.a, art.b, art.omega_init, art.valid):
        h.update(np.ascontiguousarray(arr).tobytes())
    return {"steps": cfg.steps, "energy_mode": cfg.energy.mode,
            "num_t": cfg.energy.num_t, "mc_samples": cfg.energy.mc_samples,
            "inputs_digest": h.hexdigest(), "recipe": _recipe_stamp(cfg)}


def optimize_spline_batch(
    params: evae_lib.EVAEParams,
    art: SplineBatchArtifact,
    data: Optional[np.ndarray] = None,
    cfg: GeodesicConfig = GeodesicConfig(),
    device=None,
    output_path: Optional[str] = None,
    log_every_chunk: bool = True,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SplineBatchArtifact:
    """Optimize all splines in an artifact; returns the completed artifact.

    params: EVAE parameters on ``device``.  For the single-decoder modes
    (``single``, ``single_fused[_bf16]``, ``jvp``) decoder 0 is used and the
    geodesic length is the data-space arc length; otherwise it is
    sqrt(energy).
    data: dataset for the latent Euclidean distances (skipped when None).
    output_path: when set, the result is saved there at the end.
    generator: names the random stream of the MC modes (default seed 0);
    every chunk draws from a stream of its own, derived from it and the
    chunk's first pair, so a chunk's result does not depend on the others.
    mesh: a ``parallel.mesh.Mesh``; each chunk's pairs are then sharded over
    its 'dp' axis and, in the ``expected_fused*`` modes, the decoders over
    'ep'.  Collective: every rank calls with the same arguments.
    """
    dev = resolve_device(device)
    primary = is_primary()
    log_every_chunk = log_every_chunk and primary
    if cfg.early_stop and mesh is not None:
        raise ValueError(
            "early_stop is not supported on a sharded (mesh) run: drop "
            "early_stop or run without a mesh")
    single = cfg.energy.mode in ("single", "single_fused",
                                 "single_fused_bf16", "jvp")
    energy_params = (evae_lib.decoder_member(params.decoders, 0) if single
                     else params.decoders)
    P = len(art)
    omega_opt = np.array(art.omega_init, np.float32, copy=True)
    lengths = np.full(P, np.nan, np.float32)
    stamp = config_stamp(art, cfg)
    root = root_seed(generator)

    eucl = None
    if data is not None:
        with torch.no_grad():
            z = evae_lib.encode(params, torch.as_tensor(
                np.asarray(data, np.float32), device=dev))[0].cpu().numpy()
        eucl = np.linalg.norm(z[art.pair_indices[:, 0]]
                              - z[art.pair_indices[:, 1]],
                              axis=1).astype(np.float32)

    bs = cfg.batch_size
    n_chunks = (P - 1) // bs + 1 if P else 0
    for c, start in enumerate(range(0, P, bs)):
        stop = min(start + bs, P)
        n_sl = stop - start
        idx = np.arange(start, stop)
        if n_sl < bs:   # canonical chunk shape: edge-replicate the tail
            idx = np.concatenate([idx, np.full(bs - n_sl, stop - 1)])
        gen = torch.Generator().manual_seed(fold_seed(root, start))
        if mesh is not None:
            res = sharded_optimize_splines(
                energy_params, art.omega_init[idx], art.a[idx], art.b[idx],
                art.basis, cfg, mesh, generator=gen, device=dev)
        else:
            res = optimize_splines(energy_params, art.omega_init[idx],
                                   art.a[idx], art.b[idx], art.basis, cfg,
                                   device=dev, generator=gen)
        om = res.omega[:n_sl].cpu().numpy()
        e = res.energy[:n_sl].cpu().numpy()
        omega_opt[start:stop] = om
        if single:
            with torch.no_grad():
                t = t_grid(cfg.energy.num_t, dev)
                phi = design_matrix(t, art.basis, art.n_poly)
                gamma = eval_spline_design(
                    res.omega[:n_sl],
                    torch.as_tensor(art.a[start:stop], device=dev),
                    torch.as_tensor(art.b[start:stop], device=dev), phi, t)
                lengths[start:stop] = energy_lib.geodesic_lengths(
                    energy_params, gamma).cpu().numpy()
        else:
            lengths[start:stop] = np.sqrt(e)
        if log_every_chunk:
            print(f"[chunk {c + 1}/{n_chunks}] mean energy "
                  f"{float(np.mean(e)):.4f}")

    lengths = np.where(art.valid, lengths, np.nan)
    out = dataclasses.replace(
        art, omega_optimized=omega_opt, geodesic_length=lengths,
        euclidean_distance=eucl, metadata={**art.metadata, **stamp})
    if output_path and primary:
        save_spline_batch(out, output_path)
    return out
