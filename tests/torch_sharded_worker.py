"""Worker processes of ``tests/test_torch_sharded.py``: real
``torch.distributed`` ranks (gloo, CPU) that run the port's
``sharded_optimize_splines`` on seeded inputs.  Importable in a spawned
process: numpy and torch only, no JAX.  Ranks meet through a file."""

import time

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
from vae_latent_geometry_tpu_torch.parallel.multihost import (
    init_multihost,
    is_primary,
    shutdown_multihost,
)
from vae_latent_geometry_tpu_torch.parallel.shard import (
    sharded_optimize_splines,
)

from torch_small_inputs import small_decoders_np, torch_decoders

M = 4


def case_inputs(case):
    """(layers_np, omega0, a, b, basis, num_active) of a case, from its
    seed: the same arrays in every rank and in the test process."""
    rng = np.random.default_rng(case["seed"])
    B = case["B"]
    a = rng.normal(size=(B, 2)).astype(np.float32)
    b = rng.normal(size=(B, 2)).astype(np.float32)
    basis, _ = nullspace_basis(4)
    num_active = (rng.integers(1, M + 1, size=B) if case["num_active"]
                  else None)
    return (small_decoders_np(M, seed=case["seed"] + 1),
            np.zeros((B, 5, 2), np.float32), a, b, basis, num_active)


def case_config(case):
    return GeodesicConfig(
        steps=case["steps"], lr=1e-2,
        energy=EnergyConfig(num_t=32, mode=case["mode"],
                            kernel_precision=case.get("precision", "f32x3")))


def _rank(rank, world, dp, ep, store, out_dir, case):
    torch.set_num_threads(1)
    init_multihost(f"file://{store}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(dp, ep)
        layers, omega0, a, b, basis, num_active = case_inputs(case)
        res = sharded_optimize_splines(
            torch_decoders(layers), omega0, a, b, basis, case_config(case),
            mesh, num_active=num_active, device="cpu")
        np.savez(f"{out_dir}/rank{rank}.npz", omega=res.omega.numpy(),
                 energy=res.energy.numpy(), primary=is_primary(),
                 index=np.array([mesh.index("dp"), mesh.index("ep")]))
    finally:
        shutdown_multihost()


def run_ranks(dp, ep, tmp_path, case, timeout=180.0):
    """Run ``case`` on a dp x ep mesh of spawned ranks; returns each rank's
    saved result.  A rank that fails raises here; ranks still running at the
    time limit are killed and the run counts as hung."""
    import torch.multiprocessing as mp

    world = dp * ep
    ctx = mp.spawn(_rank, args=(world, dp, ep, str(tmp_path / "store"),
                                str(tmp_path), case),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]
