"""Worker processes of ``tests/test_torch_resume.py``: real
``torch.distributed`` ranks (gloo, CPU) that run the port's
``sharded_train_step``, the multiseed trainer on a mesh and a resumed
optimize stage on seeded inputs.  Importable in a spawned process: numpy
and torch only, no JAX.  Ranks meet through a file."""

import time

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import (
    EnergyConfig,
    GeodesicConfig,
    ModelConfig,
    TrainConfig,
)
from vae_latent_geometry_tpu_torch.geometry.basis import nullspace_basis
from vae_latent_geometry_tpu_torch.io.artifacts import SplineBatchArtifact
from vae_latent_geometry_tpu_torch.io.checkpoint import tree_leaves, tree_map
from vae_latent_geometry_tpu_torch.models import evae, nets
from vae_latent_geometry_tpu_torch.optim.geodesic import Adam
from vae_latent_geometry_tpu_torch.parallel.mesh import make_mesh
from vae_latent_geometry_tpu_torch.parallel.multihost import (
    init_multihost,
    shutdown_multihost,
)
from vae_latent_geometry_tpu_torch.parallel.shard import sharded_train_step
from vae_latent_geometry_tpu_torch.pipeline.optimize_stage import (
    optimize_spline_batch,
)
from vae_latent_geometry_tpu_torch.pipeline.train import train_evae_multiseed

STEP_CFG = ModelConfig(input_dim=12, latent_dim=2, num_decoders=4,
                       encoder_hidden=(16,), decoder_hidden=(16,),
                       decoder_sigma=1.0)
STEP_IDX = (1, 3, 0, 3)
SEEDS = [3, 7, 11, 19]
TRAIN_CFG = TrainConfig(epochs=3, batch_size=64)
TRAIN_MODEL = ModelConfig(input_dim=10, latent_dim=2, num_decoders=2,
                          encoder_hidden=(16,), decoder_hidden=(16,),
                          decoder_sigma=1.0)
OPT_CFG = GeodesicConfig(steps=15, batch_size=4,
                         energy=EnergyConfig(num_t=48, mode="single"))


def step_inputs():
    """(params, [(batch, eps, decoder index)]) of the train-step case: an
    ensemble whose members differ, four steps of 32 rows."""
    params = evae.evae_init(torch.Generator().manual_seed(0), STEP_CFG, "cpu")
    g = torch.Generator().manual_seed(1)
    params.decoders = tree_map(
        lambda w: w + 0.1 * torch.randn(w.shape, generator=g),
        params.decoders)
    rng = np.random.default_rng(5)
    return params, [(rng.normal(size=(32, 12)).astype(np.float32),
                     rng.normal(size=(32, 2)).astype(np.float32), i)
                    for i in STEP_IDX]


def run_steps(mesh):
    """Leaves and losses after the train-step case's steps."""
    params, steps = step_inputs()
    state = Adam(lambda count: 1e-2).init(tree_leaves(params))
    losses = []
    for x, eps, idx in steps:
        params, state, loss = sharded_train_step(params, state, x, eps, idx,
                                                 mesh, STEP_CFG, lr=1e-2)
        losses.append(float(loss))
    return [x.numpy() for x in tree_leaves(params)], losses


def train_data():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(512, 10)).astype(np.float32)
    x[:256] += 4.0
    return x


def opt_inputs():
    """(decoder, artifact) of the resumed optimize-stage case: 8 pairs in
    chunks of 4, a narrow decoder, zero spline parameters."""
    rng = np.random.default_rng(9)
    basis, _ = nullspace_basis(4)
    P = 8
    art = SplineBatchArtifact(
        a=rng.normal(size=(P, 2)).astype(np.float32),
        b=rng.normal(size=(P, 2)).astype(np.float32),
        omega_init=np.zeros((P, 5, 2), np.float32), basis=basis, n_poly=4,
        pair_indices=np.arange(2 * P).reshape(P, 2), valid=np.ones(P, bool),
        pair_labels=[["a", "b"]] * P, representatives=[])
    dec = nets.decoder_init(torch.Generator().manual_seed(2), 2, 6, (16,))
    return dec, art


def _rank(rank, world, dp, ep, store, out_dir, checkpoint):
    torch.set_num_threads(1)
    init_multihost(f"file://{store}", world, rank, backend="gloo")
    try:
        mesh = make_mesh(dp, ep)
        leaves, losses = run_steps(mesh)
        out = {"losses": np.asarray(losses)}
        out.update({f"leaf{i}": x for i, x in enumerate(leaves)})
        if dp == 2:
            res = train_evae_multiseed(train_data(), SEEDS, TRAIN_CFG,
                                       TRAIN_MODEL, log_every=0,
                                       block_epochs=2, mesh=mesh,
                                       device="cpu")
            for s in SEEDS:
                out[f"tl{s}"] = res[s].train_losses
                out[f"vl{s}"] = res[s].val_losses
                for i, x in enumerate(tree_leaves(res[s].params)):
                    out[f"p{s}_{i}"] = x.numpy()
            dec, art = opt_inputs()
            opt = optimize_spline_batch(dec, art, cfg=OPT_CFG, device="cpu",
                                        checkpoint_path=checkpoint,
                                        log_every_chunk=False, mesh=mesh)
            out["opt_omega"] = opt.omega_optimized
            out["opt_len"] = opt.geodesic_length
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        shutdown_multihost()


def run_ranks(dp, ep, tmp_path, checkpoint=None, timeout=180.0):
    """Run the cases on a dp x ep mesh of spawned ranks; returns each
    rank's saved result.  A rank that fails raises here; ranks still
    running at the time limit are killed and the run counts as hung."""
    import torch.multiprocessing as mp

    world = dp * ep
    ctx = mp.spawn(_rank, args=(world, dp, ep, str(tmp_path / "store"),
                                str(tmp_path), checkpoint),
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
