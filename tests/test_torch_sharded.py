"""The port's dp x ep mesh over real ``torch.distributed`` processes (gloo,
CPU) vs the JAX package on its virtual CPU device mesh.

``sharded_optimize_splines`` on seeded inputs (4 narrow decoders
2 -> 16 -> 16 -> 10, T=32, 25 Adam steps from omega = 0, as
``tests/test_sharding.py:135-191``): energies at rtol 1e-4, omega at rtol
1e-3 / atol 1e-5, the JAX suite's own tolerances for its mesh against its
single device.  The spawning tests need loopback sockets (gloo) and a
writable ``tmp_path`` (the ranks meet through a file); each has a time
limit of its own, so a hang fails instead of stalling the suite.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.parallel import make_mesh as jmake_mesh
from vae_latent_geometry_tpu.parallel import (
    sharded_optimize_splines as jsharded,
)
from vae_latent_geometry_tpu.parallel.mesh import pad_to_multiple as jpad
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.optim.geodesic import optimize_splines
from vae_latent_geometry_tpu_torch.parallel import collectives
from vae_latent_geometry_tpu_torch.parallel.mesh import (
    make_mesh,
    pad_to_multiple,
)
from vae_latent_geometry_tpu_torch.parallel.multihost import (
    gather_global,
    init_multihost,
    is_primary,
)
from vae_latent_geometry_tpu_torch.parallel.shard import (
    sharded_optimize_splines,
)

from torch_parity_inputs import INIT, MODEL, REPO
from torch_sharded_worker import case_config, case_inputs, run_ranks
from torch_small_inputs import torch_decoders


def _jax_mesh_run(case, dp, ep):
    layers, omega0, a, b, basis, num_active = case_inputs(case)
    jdec = {"layers": [{"w": jnp.asarray(w), "b": jnp.asarray(b_)}
                       for w, b_ in layers]}
    cfg = JGeo(steps=case["steps"], lr=1e-2,
               energy=JEnergy(num_t=32, mode=case["mode"],
                              kernel_precision=case["precision"]))
    res = jsharded(jdec, jnp.asarray(omega0), jnp.asarray(a), jnp.asarray(b),
                   basis, cfg, jmake_mesh(dp=dp, ep=ep),
                   num_active=num_active)
    return np.asarray(res.omega), np.asarray(res.energy)


@pytest.mark.parametrize("dp,ep,num_active,precision", [
    (2, 2, False, "f32x3"), (2, 2, True, "float32"), (1, 2, False, "float32")],
    ids=["dp2xep2", "dp2xep2-num_active", "dp1xep2"])
def test_sharded_optimize_over_processes_matches_jax_mesh(tmp_path, dp, ep,
                                                          num_active,
                                                          precision):
    """B=5 is not a multiple of dp=2: the pair padding is exercised.  One
    case runs the default rung (f32x3); the others float32, where the
    comparison holds the sharding and not the bf16 rounding of a 25-step
    trajectory (at f32x3 the two packages' SINGLE-device curves already
    differ by 7e-4 on the num_active case)."""
    assert len(jax.devices()) >= dp * ep
    case = {"seed": 20 + dp, "B": 5, "steps": 25, "mode": "expected_fused",
            "num_active": num_active, "precision": precision}
    omega_ref, e_ref = _jax_mesh_run(case, dp, ep)
    ranks = run_ranks(dp, ep, tmp_path, case)
    assert [bool(r["primary"]) for r in ranks] == [True] + [False] * (
        dp * ep - 1)
    assert [tuple(r["index"]) for r in ranks] == [
        (i, j) for i in range(dp) for j in range(ep)]
    for r in ranks:              # every rank holds the whole gathered result
        np.testing.assert_array_equal(r["omega"], ranks[0]["omega"])
        np.testing.assert_array_equal(r["energy"], ranks[0]["energy"])
    assert ranks[0]["omega"].shape == omega_ref.shape
    np.testing.assert_allclose(ranks[0]["energy"], e_ref, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["omega"], omega_ref, rtol=1e-3,
                               atol=1e-5)


def test_mc_mode_keeps_decoders_whole_on_a_dp_mesh(tmp_path):
    """A mode whose draws do not decompose into per-shard statistics runs
    with whole decoders; dp ranks draw from streams of their own."""
    case = {"seed": 31, "B": 4, "steps": 4, "mode": "mc_fused",
            "num_active": True}
    ranks = run_ranks(2, 1, tmp_path, case)
    np.testing.assert_array_equal(ranks[0]["omega"], ranks[1]["omega"])
    assert np.isfinite(ranks[0]["energy"]).all()
    assert np.abs(ranks[0]["omega"]).max() > 0


def _case_on_one_rank(case, mesh, **kw):
    layers, omega0, a, b, basis, num_active = case_inputs(case)
    return sharded_optimize_splines(
        torch_decoders(layers), omega0, a, b, basis, case_config(case), mesh,
        num_active=num_active, device="cpu", **kw)


def test_one_rank_mesh_needs_no_process_group():
    mesh = make_mesh(1, 1)
    assert mesh.shape == {"dp": 1, "ep": 1} and mesh.rank == 0
    assert mesh.group("dp") is None and mesh.group("ep") is None
    assert is_primary() and init_multihost() == (0, 1)
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    y = collectives.psum(x, mesh.group("ep"))
    assert y is x and collectives.all_reduce_sum(x, None) is x
    assert gather_global(x, mesh) is x
    case = {"seed": 5, "B": 3, "steps": 6, "mode": "expected_fused",
            "num_active": False}
    res = _case_on_one_rank(case, mesh)
    layers, omega0, a, b, basis, _ = case_inputs(case)
    ref = optimize_splines(torch_decoders(layers), omega0, a, b, basis,
                           case_config(case), device="cpu")
    assert torch.equal(res.omega, ref.omega)      # ep = 1: K1/K2's path


def test_ep_axis_on_a_one_rank_mesh_runs_the_stats_path():
    """``ep_axis`` set by the caller on an ep = 1 mesh: all decoders are
    local, the energy comes from the stats kernels' decomposition, and the
    result agrees with the fused path (rtol 1e-4 energies, omega 1e-3 /
    1e-5)."""
    case = {"seed": 6, "B": 3, "steps": 25, "mode": "expected_fused",
            "num_active": True}
    layers, omega0, a, b, basis, num_active = case_inputs(case)
    cfg = case_config(case)
    ep_cfg = GeodesicConfig(
        steps=cfg.steps, lr=cfg.lr,
        energy=EnergyConfig(num_t=32, mode="expected_fused", ep_axis="ep"))
    dec = torch_decoders(layers)
    ref = optimize_splines(dec, omega0, a, b, basis, cfg, device="cpu",
                           num_active=num_active)
    out = sharded_optimize_splines(dec, omega0, a, b, basis, ep_cfg,
                                   make_mesh(1, 1), num_active=num_active,
                                   device="cpu")
    np.testing.assert_allclose(out.energy.numpy(), ref.energy.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(out.omega.numpy(), ref.omega.numpy(),
                               rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="pass the mesh"):
        optimize_splines(dec, omega0, a, b, basis, ep_cfg, device="cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        optimize_splines(dec, omega0, a, b, basis, GeodesicConfig(
            steps=1, energy=EnergyConfig(num_t=8, mode="expected_fused",
                                         ep_axis="tp")),
            device="cpu", mesh=make_mesh(1, 1))


def test_mesh_and_shard_refusals():
    with pytest.raises(ValueError, match="needs exactly 4 ranks"):
        make_mesh(2, 2)                 # this process is one rank
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(None, 2)
    with pytest.raises(ValueError, match="no coordinator"):
        init_multihost(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="needs num_processes"):
        init_multihost("localhost:1")
    case = {"seed": 5, "B": 3, "steps": 2, "mode": "expected",
            "num_active": False}
    layers, omega0, a, b, basis, _ = case_inputs(case)
    cfg = GeodesicConfig(steps=2, early_stop=True,
                         energy=EnergyConfig(num_t=8, mode="expected"))
    with pytest.raises(ValueError, match="not supported on a sharded"):
        sharded_optimize_splines(torch_decoders(layers), omega0, a, b, basis,
                                 cfg, make_mesh(1, 1), device="cpu")


@pytest.mark.parametrize("n,multiple", [(6, 4), (8, 4), (1, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    out, n_out = pad_to_multiple(x, multiple)
    ref, n_ref = jpad(x, multiple)
    assert n_out == n_ref == n
    np.testing.assert_array_equal(out, ref)


def test_cli_optimize_on_two_ranks_matches_one_process(tmp_path):
    """``optimize --ep 2`` as two processes that meet through the
    ``VLG_*`` variables (gloo, CPU), against the same command as one
    process: the production decoders split 5 + 5, rank 0 writes, lengths at
    rtol 1e-4.  Three pairs, 4 float32 steps, T=32."""
    from vae_latent_geometry_tpu_torch.io import artifacts as tart

    art = tart.load_spline_batch(INIT)
    init = tmp_path / "init.npz"
    tart.save_spline_batch(dataclasses.replace(
        art, a=art.a[:3], b=art.b[:3], omega_init=art.omega_init[:3],
        pair_indices=art.pair_indices[:3], valid=art.valid[:3],
        pair_labels=art.pair_labels[:3]), str(init))
    base = [sys.executable, "-m", "vae_latent_geometry_tpu_torch", "optimize",
            "--device", "cpu", "--model", MODEL, "--splines", str(init),
            "--steps", "4", "--num-t", "32", "--no-euclidean",
            "--energy-mode", "expected_fused", "--kernel-precision",
            "float32"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run(base + ["--output", str(tmp_path / "one.npz")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    procs = [subprocess.Popen(
        base + ["--ep", "2", "--output", str(tmp_path / "two.npz")],
        cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
        env=dict(env, VLG_COORDINATOR=f"file://{tmp_path / 'store'}",
                 VLG_NUM_PROCESSES="2", VLG_PROCESS_ID=str(i)))
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert "[ok] optimized" in outs[0][0] and "[ok]" not in outs[1][0]
    assert "mesh {'dp': 1, 'ep': 2}" in outs[1][0]
    one = tart.load_spline_batch(str(tmp_path / "one.npz"))
    two = tart.load_spline_batch(str(tmp_path / "two.npz"))
    np.testing.assert_allclose(two.geodesic_length, one.geodesic_length,
                               rtol=1e-4)
    np.testing.assert_allclose(two.omega_optimized, one.omega_optimized,
                               rtol=1e-3, atol=1e-5)
    assert not np.array_equal(two.omega_optimized, two.omega_init)
