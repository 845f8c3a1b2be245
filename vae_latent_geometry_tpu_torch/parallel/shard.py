"""Sharded execution of the framework's two big workloads.

1. ``sharded_optimize_splines`` — geodesic optimization with pairs over
   'dp' and decoders over 'ep'.  Every rank runs the same program as the
   single-device path (``optim/geodesic.optimize_splines``) on its own
   rows.  Pairs never communicate; with the decoder axis sharded, the ranks
   of a dp row meet in the all-reduces of
   ``ops/energy_fused.energy_expected_sharded`` and in the gradient
   all-reduce of the optimizer.  Pairs are padded to a multiple of the dp
   size with edge replication; the padding is dropped on the way out.
2. ``sharded_train_step`` — one EVAE training step with the batch rows
   over 'dp' and the decoder stack over 'ep'.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import GeodesicConfig, ModelConfig
from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves, tree_map
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.models import nets
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    Adam,
    GeodesicResult,
    fold_seed,
    optimize_splines,
    root_seed,
)
from vae_latent_geometry_tpu_torch.parallel.collectives import (
    all_reduce_sum,
    broadcast,
)
from vae_latent_geometry_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from vae_latent_geometry_tpu_torch.parallel.multihost import gather_global


def sharded_optimize_splines(
    decoders, omega0, a, b, basis, cfg: GeodesicConfig, mesh: Mesh,
    generator: Optional[torch.Generator] = None, num_active=None,
    device=None,
) -> GeodesicResult:
    """Drop-in sharded version of ``optim.geodesic.optimize_splines``;
    collective: every rank of the mesh calls it with the same arguments and
    receives the whole result.

    Each rank optimizes its 1/dp of the pairs, with the dp index folded into
    its random stream.  When the decoder axis divides over 'ep' and the mode
    is ``expected_fused*``, each ep rank holds M/ep decoders and the stats
    kernels plus two all-reduces assemble the energy; otherwise (the MC
    modes' per-segment draws do not decompose into per-shard statistics)
    decoders stay whole on every rank.
    """
    if cfg.early_stop:
        raise ValueError(
            "early_stop is not supported on a sharded (mesh) run: drop "
            "early_stop or run without a mesh")
    dp, ep = mesh.size("dp"), mesh.size("ep")
    i_dp = mesh.index("dp")

    def my_rows(x):
        x, n = pad_to_multiple(np.asarray(x), dp)
        per = len(x) // dp
        return x[i_dp * per:(i_dp + 1) * per], n

    omega0, n = my_rows(omega0)
    a, _ = my_rows(a)
    b, _ = my_rows(b)
    if num_active is not None:
        num_active = my_rows(num_active)[0]

    m_dec = decoders["layers"][0]["w"].shape[0]
    if (ep > 1 and m_dec % ep == 0
            and cfg.energy.mode.startswith("expected_fused")):
        cfg = dataclasses.replace(
            cfg, energy=dataclasses.replace(cfg.energy, ep_axis="ep"))
        m_loc = m_dec // ep
        lo = mesh.index("ep") * m_loc
        decoders = tree_map(lambda v: v[lo:lo + m_loc], decoders)
    gen = torch.Generator().manual_seed(
        fold_seed(root_seed(generator), i_dp))
    res = optimize_splines(decoders, omega0, a, b, basis, cfg,
                           num_active=num_active, device=device,
                           generator=gen, mesh=mesh)
    omega = gather_global(res.omega, mesh)[:n]
    e_final = gather_global(res.energy, mesh)[:n]
    return GeodesicResult(omega=omega, energy=e_final,
                          lengths=torch.sqrt(e_final))


def sharded_train_step(params: evae_lib.EVAEParams, opt_state: dict, batch,
                       eps, decoder_idx: int, mesh: Mesh,
                       model_cfg: ModelConfig = ModelConfig(),
                       lr: float = 1e-3):
    """One dp x ep-sharded EVAE train step (Adam at a constant ``lr``,
    the step's neg-ELBO over the whole batch); collective: every rank calls
    it with the same arguments and returns the same (params, opt_state,
    loss).  ``opt_state`` is ``Adam(...).init(tree_leaves(params))``;
    ``eps`` (N, latent_dim) and ``decoder_idx`` are the step's draws (as
    ``models.evae.elbo`` takes them).  ``params`` and ``opt_state`` are
    updated in place.

    Batch rows shard over 'dp' (N % dp == 0); the decoder stack shards over
    'ep' when M % ep == 0: the step's decoder is read from the rank that
    holds it and broadcast over its 'ep' group (else every rank holds all
    decoders).  The encoder and the optimizer state are replicated: the
    gradients of this rank's rows are all-reduced over 'dp', and every rank
    applies the same update."""
    dp, ep = mesh.size("dp"), mesh.size("ep")
    n = len(batch)
    if n % dp:
        raise ValueError(f"batch of {n} rows does not divide over dp={dp}")
    per = n // dp
    rows = slice(mesh.index("dp") * per, (mesh.index("dp") + 1) * per)
    dev = params.encoder["layers"][0]["w"].device
    x = torch.as_tensor(np.asarray(batch, np.float32)[rows], device=dev)
    e = torch.as_tensor(np.asarray(eps, np.float32)[rows], device=dev)
    m_dec = evae_lib.num_members(params.decoders)
    decoder = tree_map(lambda w: w[decoder_idx].detach().clone(),
                       params.decoders)
    if ep > 1 and m_dec % ep == 0:
        owner = decoder_idx // (m_dec // ep)
        src = mesh.index("dp") * ep + owner          # the owner's rank
        decoder = tree_map(lambda w: broadcast(w, src, mesh.group("ep")),
                           decoder)
    enc_leaves, dec_leaves = tree_leaves(params.encoder), tree_leaves(decoder)
    local = [w.detach().requires_grad_(True)
             for w in enc_leaves + dec_leaves]
    enc = tree_map(lambda _, i=iter(local[:len(enc_leaves)]): next(i),
                   params.encoder)
    dec = tree_map(lambda _, i=iter(local[len(enc_leaves):]): next(i),
                   decoder)
    # this rank's rows' share of the whole batch's mean neg-ELBO
    mean, log_std = nets.encoder_apply(enc, x, activation="silu")
    std = torch.exp(log_std)
    z = mean + std * e
    logpxz = evae_lib._diag_normal_logprob(
        x, nets.decoder_apply(dec, z), float(model_cfg.decoder_sigma))
    kl = (evae_lib._diag_normal_logprob(z, mean, std)
          - evae_lib._diag_normal_logprob(z, 0.0, 1.0))
    part = -(logpxz - model_cfg.beta * kl).sum() / n
    grads = torch.autograd.grad(part, local)
    grads = [all_reduce_sum(g, mesh.group("dp")) for g in grads]
    loss = all_reduce_sum(part.detach(), mesh.group("dp"))
    # the whole tree's gradient: zero on every decoder but the step's
    dec_grads = []
    for w, g in zip(tree_leaves(params.decoders), grads[len(enc_leaves):]):
        full = torch.zeros_like(w)
        full[decoder_idx] = g
        dec_grads.append(full)
    Adam(lambda count: lr).step(tree_leaves(params),
                                grads[:len(enc_leaves)] + dec_grads,
                                opt_state)
    return params, opt_state, loss
