"""Pipeline stage: batched geodesic optimization over an initialized spline
batch, with per-chunk checkpointing (reference ``src/optimize.py:80-218``).

Pairs are optimized in chunks of ``batch_size``; a trailing partial chunk
is padded to the canonical size by edge replication, as in the JAX package,
so every chunk runs the same shapes.  With a ``checkpoint_path`` every
finished chunk is snapshotted there by a background writer and a re-run
resumes: finished chunks are kept, the rest recomputed.  The result carries
the JAX package's config stamp.  With a ``mesh`` every chunk is one
collective program over its ranks (``parallel/shard.sharded_optimize_
splines``): all ranks compute, only the primary one prints and saves.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import sys
import threading
import warnings
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
    load_spline_batch,
    save_spline_batch,
)
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.models import vae as vae_lib
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    fold_seed,
    optimize_spline_early_stopping,
    optimize_splines,
    root_seed,
)
from vae_latent_geometry_tpu_torch.parallel.multihost import (
    broadcast_from_primary,
    is_primary,
)
from vae_latent_geometry_tpu_torch.parallel.shard import (
    sharded_optimize_splines,
)
from vae_latent_geometry_tpu_torch.utils.profiling import (
    read_device_times,
    trace_annotation,
)

# GeodesicConfig fields that cannot change any produced value; left out of
# the recipe stamp (same set as the JAX package): a mismatch discards every
# finished chunk, which a how-not-what flag must never do.
_RESULT_NEUTRAL = {"energy": {"gradonly_traj"}}

SINGLE_MODES = ("single", "single_fused", "single_fused_bf16", "jvp")


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


class _AsyncCheckpointer:
    """Latest-wins background checkpoint writer.

    The optimize loop hands a complete snapshot (host numpy copies) to a
    daemon thread and moves on; a snapshot still pending when a newer one
    arrives is replaced (each is self-contained, only the newest matters).
    Write errors do NOT raise: the snapshots are best-effort crash
    protection and the final save is synchronous in the caller, so a
    transient failure must not destroy a finished run.  ``close()`` drains
    the queue and returns the last write error (None if the last write
    succeeded)."""

    def __init__(self, save_fn):
        self._save_fn = save_fn
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            try:
                self._save_fn(item)
                self._err = None     # a later successful write clears it
            except Exception as e:   # reported (not raised) by close()
                self._err = e

    def submit(self, item):
        while True:
            try:
                self._q.put_nowait(item)
                return
            except queue.Full:
                try:
                    self._q.get_nowait()   # drop the stale pending snapshot
                except queue.Empty:
                    pass

    def close(self) -> Optional[BaseException]:
        """Drain, stop the writer thread, and return the most recent write
        error (None if the last write succeeded)."""
        self._q.put(None)
        self._t.join()
        return self._err


def _energy_params(params, single: bool):
    """The decoders the energy reads: the ensemble, or for the
    single-decoder modes one mean-only decoder (a legacy VAE's mean head,
    an ensemble's decoder 0, or a bare decoder dict as given)."""
    if not single:
        return params.decoders
    if isinstance(params, vae_lib.VAEParams):
        return vae_lib.mean_decoder(params.decoder)
    if hasattr(params, "decoders"):
        return evae_lib.decoder_member(params.decoders, 0)
    return params


def _resume_state(art: SplineBatchArtifact, checkpoint_path: str,
                  stamp: dict, log: bool):
    """(omega_opt, lengths, done, prev) from a checkpoint whose stamp equals
    ``stamp``; None for a foreign, partial or absent stamp, which is ignored
    with a message.  Deliberately unlike the trainers' checkpoints (which
    raise): this one is a cache of per-chunk results of the same artifact,
    and recomputing is always correct."""
    loaded = load_spline_batch(checkpoint_path)
    missing = [k for k in stamp if k not in loaded.metadata]
    if missing:
        print(f"[resume] checkpoint at {checkpoint_path} carries no or only "
              f"a partial config stamp (missing {missing}) and cannot be "
              "validated against this run's config — ignoring it and "
              "starting fresh", file=sys.stderr)
        return None
    prev_stamp = {k: loaded.metadata[k] for k in stamp}
    if prev_stamp != stamp:
        print(f"[resume] checkpoint at {checkpoint_path} was produced by a "
              f"different config ({prev_stamp} vs {stamp}) — ignoring it "
              "and starting fresh", file=sys.stderr)
        return None
    if len(loaded) != len(art) or loaded.omega_optimized is None:
        return None
    omega_opt = np.array(loaded.omega_optimized, np.float32, copy=True)
    lengths = np.array(loaded.geodesic_length, np.float32, copy=True)
    # invalid pairs are NaN in every save: they count as done, else a
    # finished checkpoint holding one would re-run its whole chunk
    done = np.isfinite(lengths) | ~np.asarray(art.valid)
    if log and done.any():
        print(f"[resume] {done.sum()}/{len(art)} splines already optimized")
    return omega_opt, lengths, done, loaded


def optimize_spline_batch(
    params,
    art: SplineBatchArtifact,
    data: Optional[np.ndarray] = None,
    cfg: GeodesicConfig = GeodesicConfig(),
    device=None,
    checkpoint_path: Optional[str] = None,
    log_every_chunk: bool = True,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SplineBatchArtifact:
    """Optimize all splines in an artifact; returns the completed artifact.

    params: ``EVAEParams`` (or any object with ``decoders``) on ``device``;
    for the single-decoder modes (``single``, ``single_fused[_bf16]``,
    ``jvp``) also a legacy ``VAEParams`` (its mean head) or a bare decoder
    dict, and the geodesic length is the data-space arc length; otherwise
    it is sqrt(energy).
    data: dataset for the latent Euclidean distances (skipped when None;
    a resume without data keeps the stored ones).
    checkpoint_path: every finished chunk is snapshotted there in the
    background, an existing file with this run's stamp is resumed (finished
    chunks kept), and the result is saved there at the end.
    generator: names the random stream of the MC modes (default seed 0);
    every chunk draws from a stream of its own, derived from it and the
    chunk's first pair, so a chunk's result does not depend on the others
    (which is what makes a resume repeat the uninterrupted run).
    mesh: a ``parallel.mesh.Mesh``; each chunk's pairs are sharded over its
    'dp' axis and, in the ``expected_fused*`` modes, the decoders over
    'ep'.  Collective: every rank calls with the same arguments; rank 0
    reads the checkpoint and broadcasts what it resumes.
    ``cfg.early_stop``: every chunk stops when all its splines are out of
    patience (``optim.geodesic.optimize_spline_early_stopping``); refused
    with a mesh and with the multi-phase recipes, as in the JAX package.
    """
    with trace_annotation("pipeline.optimize"):
        dev = resolve_device(device)
        primary = is_primary()
        log_every_chunk = log_every_chunk and primary
        if cfg.early_stop:
            if cfg.phase_plan or (cfg.traj_num_t is not None
                                  and cfg.polish_steps > 0):
                raise ValueError(
                    "early_stop and the multi-phase fast recipes "
                    "(traj_num_t + polish_steps, or phase_plan) are mutually "
                    "exclusive — pick one")
            if mesh is not None:
                raise ValueError(
                    "early_stop is not supported on a sharded (mesh) run: "
                    "drop early_stop or run without a mesh")
        single = cfg.energy.mode in SINGLE_MODES
        energy_params = _energy_params(params, single)
        P = len(art)
        omega_opt = np.array(art.omega_init, np.float32, copy=True)
        lengths = np.full(P, np.nan, np.float32)
        done = np.zeros(P, bool)
        stamp = config_stamp(art, cfg)
        root = root_seed(generator)

        prev = None
        if checkpoint_path and primary and os.path.exists(checkpoint_path):
            resumed = _resume_state(art, checkpoint_path, stamp,
                                    log_every_chunk)
            if resumed is not None:
                omega_opt, lengths, done, prev = resumed
        if mesh is not None:
            # the chunk schedule drives collective programs: every rank must
            # run the same chunks, so rank 0's resume state goes to all
            omega_opt, lengths, done = (np.array(v) for v in
                                        broadcast_from_primary(
                                            (omega_opt, lengths, done)))

        eucl = None
        if data is not None and hasattr(params, "encoder"):
            x = torch.as_tensor(np.asarray(data, np.float32), device=dev)
            with torch.no_grad():
                z = (vae_lib.encode(params, x) if isinstance(
                    params, vae_lib.VAEParams) else evae_lib.encode(params, x)
                     )[0].cpu().numpy()
            eucl = np.linalg.norm(z[art.pair_indices[:, 0]]
                                  - z[art.pair_indices[:, 1]],
                                  axis=1).astype(np.float32)
        elif prev is not None and prev.euclidean_distance is not None:
            eucl = np.asarray(prev.euclidean_distance, np.float32)

        saver = None
        if checkpoint_path and primary:
            def _save_snapshot(snap):
                om, ln = snap
                save_spline_batch(dataclasses.replace(
                    art, omega_optimized=om, geodesic_length=ln,
                    euclidean_distance=eucl,
                    metadata={**art.metadata, **stamp}), checkpoint_path)

            saver = _AsyncCheckpointer(_save_snapshot)

        bs = cfg.batch_size
        n_chunks = (P - 1) // bs + 1 if P else 0
        for c, start in enumerate(range(0, P, bs)):
            stop = min(start + bs, P)
            if done[start:stop].all():
                continue
            n_sl = stop - start
            with trace_annotation("pipeline.chunk", chunk=c, pairs=n_sl):
                idx = np.arange(start, stop)
                if n_sl < bs:   # canonical chunk shape: edge-replicate
                    idx = np.concatenate([idx, np.full(bs - n_sl, stop - 1)])
                gen = torch.Generator().manual_seed(fold_seed(root, start))
                args = (energy_params, art.omega_init[idx], art.a[idx],
                        art.b[idx], art.basis, cfg)
                if mesh is not None:
                    res = sharded_optimize_splines(*args, mesh, generator=gen,
                                                   device=dev)
                elif cfg.early_stop:
                    res = optimize_spline_early_stopping(*args, device=dev,
                                                         generator=gen)
                else:
                    res = optimize_splines(*args, device=dev, generator=gen)
                with trace_annotation("pipeline.readback"):
                    om = res.omega[:n_sl].cpu().numpy()
                    # the read-back waited for the whole chunk: the device
                    # spans' events are all reached
                    read_device_times()
                    e = res.energy[:n_sl].cpu().numpy()
                    omega_opt[start:stop] = om
                    if single:
                        # legacy semantics: data-space arc length, not
                        # sqrt(energy)
                        with torch.no_grad():
                            t = t_grid(cfg.energy.num_t, dev)
                            phi = design_matrix(t, art.basis, art.n_poly)
                            gamma = eval_spline_design(
                                res.omega[:n_sl],
                                torch.as_tensor(art.a[start:stop], device=dev),
                                torch.as_tensor(art.b[start:stop], device=dev),
                                phi, t)
                            lengths[start:stop] = energy_lib.geodesic_lengths(
                                energy_params, gamma).cpu().numpy()
                    else:
                        lengths[start:stop] = np.sqrt(e)
            done[start:stop] = True
            if log_every_chunk:
                print(f"[chunk {c + 1}/{n_chunks}] mean energy "
                      f"{float(np.mean(e)):.4f}")
            if saver is not None:
                # copies: the loop keeps writing these arrays while the
                # writer thread serializes
                saver.submit((omega_opt.copy(), lengths.copy()))
        if saver is not None:
            err = saver.close()
            if err is not None:
                print(f"[checkpoint] background snapshot writes failed "
                      f"({type(err).__name__}: {err}); relying on the final "
                      "synchronous save", file=sys.stderr)

        lengths = np.where(art.valid, lengths, np.nan)
        out = dataclasses.replace(
            art, omega_optimized=omega_opt, geodesic_length=lengths,
            euclidean_distance=eucl, metadata={**art.metadata, **stamp})
        if checkpoint_path and primary:
            save_spline_batch(out, checkpoint_path)
        return out


def merge_spline_batches(primary: SplineBatchArtifact,
                         secondary: SplineBatchArtifact
                         ) -> SplineBatchArtifact:
    """Per-pair best-of merge of two optimized artifacts over the SAME
    problem: keep whichever run's spline has the smaller final geodesic
    length (both measure the same objective on the same grid), NaN-aware (a
    finite length beats a NaN).  The merge is elementwise not worse than
    either input by construction."""
    if primary.omega_optimized is None or secondary.omega_optimized is None:
        raise ValueError("merge requires two OPTIMIZED artifacts")
    l1 = np.asarray(primary.geodesic_length, np.float64)
    l2 = np.asarray(secondary.geodesic_length, np.float64)
    if l1.shape != l2.shape or not np.array_equal(
            np.asarray(primary.pair_indices),
            np.asarray(secondary.pair_indices)):
        raise ValueError("merge requires artifacts over the same pair set")
    # the same pairs of two models have other endpoints: one run's omega
    # with the other's endpoints reproduces neither run's lengths
    for name in ("a", "b", "basis"):
        if not np.array_equal(np.asarray(getattr(primary, name)),
                              np.asarray(getattr(secondary, name))):
            raise ValueError(
                f"merge requires identical '{name}' arrays: the two "
                "artifacts were produced from different endpoint latents "
                "or spline bases (e.g. different model seeds), so their "
                "curves are not interchangeable")
    if primary.n_poly != secondary.n_poly:
        raise ValueError("merge requires identical n_poly")
    take2 = np.where(np.isnan(l1), np.isfinite(l2),
                     np.isfinite(l2) & (l2 < l1))
    omega = np.where(take2[:, None, None],
                     np.asarray(secondary.omega_optimized),
                     np.asarray(primary.omega_optimized))
    return dataclasses.replace(
        primary,
        omega_optimized=omega,
        geodesic_length=np.where(take2, l2, l1),
        metadata={**primary.metadata,
                  "backstop": {k: v for k, v in secondary.metadata.items()
                               if k not in primary.metadata
                               or primary.metadata[k] != v},
                  "backstop_selected": int(take2.sum())},
    )


def optimize_spline_batch_backstop(
    params,
    art: SplineBatchArtifact,
    cfg: GeodesicConfig,
    backstop_cfg: GeodesicConfig,
    data: Optional[np.ndarray] = None,
    device=None,
    checkpoint_path: Optional[str] = None,
    log_every_chunk: bool = True,
    generator: Optional[torch.Generator] = None,
    mesh=None,
) -> SplineBatchArtifact:
    """Primary recipe + backstop recipe, merged per pair best-of: never
    worse than the backstop (the reference's fixed recipe) on any pair, at
    the cost of both arms.

    The MC modes' final energies are single noisy draws, so a per-pair
    comparison would pick the noise-favoured curve: both arms' final
    re-evaluation switches to ``expected_fused`` (float32), exactly
    E[energy_mc] over decoder draws; the trajectories keep their MC
    estimator.  An explicitly set stochastic ``final_energy_mode`` is kept
    and warned about.  Identical configs run one arm.  With a
    ``checkpoint_path`` the arms checkpoint to ``<root>.primary.npz`` and
    ``<root>.backstop.npz`` and the merge is saved at the path itself."""
    def _denoised(c: GeodesicConfig) -> GeodesicConfig:
        final = (c.final_energy_mode or c.energy.mode).removesuffix("_bf16")
        if not final.startswith("mc"):
            return c
        if c.final_energy_mode is not None:
            warnings.warn(
                f"backstop merge with stochastic final_energy_mode "
                f"{c.final_energy_mode!r}: per-pair comparisons happen at "
                "MC noise scale, so the never-worse guarantee only holds "
                "in distribution — drop final_energy_mode to compare on "
                "the exact expectation instead", stacklevel=3)
            return c
        return dataclasses.replace(c, final_energy_mode="expected_fused")

    cfg, backstop_cfg = _denoised(cfg), _denoised(backstop_cfg)
    ck1 = ck2 = None
    if checkpoint_path:
        root = str(checkpoint_path).removesuffix(".npz")
        ck1, ck2 = root + ".primary.npz", root + ".backstop.npz"
    kw = dict(data=data, device=device, log_every_chunk=log_every_chunk,
              generator=generator, mesh=mesh)
    res1 = optimize_spline_batch(params, art, cfg=cfg, checkpoint_path=ck1,
                                 **kw)
    if backstop_cfg == cfg:
        if log_every_chunk and is_primary():
            print("[backstop] backstop config identical to the primary — "
                  "single arm run, merge is trivial")
        out = dataclasses.replace(
            res1, metadata={**res1.metadata, "backstop_selected": 0,
                            "backstop": {"note": "identical configs; "
                                         "second arm skipped"}})
    else:
        res2 = optimize_spline_batch(params, art, cfg=backstop_cfg,
                                     checkpoint_path=ck2, **kw)
        out = merge_spline_batches(res1, res2)
    if checkpoint_path and is_primary():
        save_spline_batch(out, checkpoint_path)
    return out
