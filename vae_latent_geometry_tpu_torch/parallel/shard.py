"""Sharded geodesic optimization: pairs over 'dp', decoders over 'ep'.

Every rank runs the same program as the single-device path
(``optim/geodesic.optimize_splines``) on its own rows.  Pairs never
communicate; with the decoder axis sharded, the ranks of a dp row meet in
the all-reduces of ``ops/energy_fused.energy_expected_sharded`` and in the
gradient all-reduce of the optimizer.  Pairs are padded to a multiple of the
dp size with edge replication; the padding is dropped on the way out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import GeodesicConfig
from vae_latent_geometry_tpu_torch.optim.geodesic import (
    GeodesicResult,
    fold_seed,
    optimize_splines,
    root_seed,
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
        decoders = {"layers": [{k: v[lo:lo + m_loc] for k, v in l.items()}
                               for l in decoders["layers"]]}
    gen = torch.Generator().manual_seed(
        fold_seed(root_seed(generator), i_dp))
    res = optimize_splines(decoders, omega0, a, b, basis, cfg,
                           num_active=num_active, device=device,
                           generator=gen, mesh=mesh)
    omega = gather_global(res.omega, mesh)[:n]
    e_final = gather_global(res.energy, mesh)[:n]
    return GeodesicResult(omega=omega, energy=e_final,
                          lengths=torch.sqrt(e_final))
