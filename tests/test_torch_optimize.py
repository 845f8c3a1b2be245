"""``optim/geodesic`` of the PyTorch port vs the JAX package's optimizer
(expected_fused mode; the JAX kernels run in interpret mode on the CPU).

20 Adam steps on 8 seed-42 init pairs at T=64 with the 10-decoder seed-42
ensemble; final energies within rtol 1e-4.  Note optax's warmup-cosine
schedule with init_value=0 makes the first update zero — the port's
schedule must reproduce that.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_latent_geometry_tpu.config import EnergyConfig as JEnergy
from vae_latent_geometry_tpu.config import GeodesicConfig as JGeo
from vae_latent_geometry_tpu.io.artifacts import load_spline_batch
from vae_latent_geometry_tpu.optim import geodesic as jgeo
from vae_latent_geometry_tpu_torch.config import EnergyConfig, GeodesicConfig
from vae_latent_geometry_tpu_torch.models import evae as tevae
from vae_latent_geometry_tpu_torch.optim import geodesic as tgeo

from torch_parity_inputs import MODEL, INIT

NP = 8

RECIPES = {
    "constant": dict(steps=20, lr=1e-3, lr_schedule="constant"),
    "cosine": dict(steps=20, lr=3e-3, lr_schedule="cosine", lr_warmup=4),
    "phase_plan": dict(steps=20, phase_plan=((12, 32, "cosine", 3e-3),
                                             (8, 64, "constant", 1e-3))),
}


@pytest.fixture(scope="module")
def problem():
    tp = tevae.load_npz(MODEL, "cpu")
    jdec = {"layers": [{"w": jnp.asarray(l["w"].numpy()),
                        "b": jnp.asarray(l["b"].numpy())}
                       for l in tp.decoders["layers"]]}
    art = load_spline_batch(INIT)
    return tp, jdec, art


@pytest.mark.parametrize("precision", ["f32x2", "float32"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_optimize_splines_matches_jax(problem, recipe, precision):
    tp, jdec, art = problem
    kw = RECIPES[recipe]
    jcfg = JGeo(**kw, energy=JEnergy(num_t=64, mode="expected_fused",
                                     kernel_precision=precision))
    tcfg = GeodesicConfig(**kw, energy=EnergyConfig(
        num_t=64, mode="expected_fused", kernel_precision=precision))
    om, a, b = art.omega_init[:NP], art.a[:NP], art.b[:NP]
    ref = jgeo.optimize_splines(jdec, jnp.asarray(om), jnp.asarray(a),
                                jnp.asarray(b), art.basis, jcfg)
    out = tgeo.optimize_splines(tp.decoders, om, a, b, art.basis, tcfg,
                                device="cpu")
    e_ref = np.asarray(ref.energy)
    # the run moved the curves (a no-op optimizer would also "match")
    with torch.no_grad():
        e0 = tgeo.make_loss_fn(tp.decoders, art.basis, tgeo._exact_cfg(tcfg),
                               "cpu")(torch.from_numpy(om), torch.from_numpy(a),
                                      torch.from_numpy(b))[1].numpy()
    assert np.all(np.abs(e_ref / e0 - 1) > 1e-4)
    np.testing.assert_allclose(out.energy.numpy(), e_ref, rtol=1e-4)
    np.testing.assert_allclose(out.lengths.numpy(), np.asarray(ref.lengths),
                               rtol=1e-4)


def test_history_records_value_path(problem):
    tp, _, art = problem
    cfg = GeodesicConfig(steps=3, energy=EnergyConfig(
        num_t=32, mode="expected_fused", kernel_precision="f32x2"))
    res = tgeo.optimize_splines(tp.decoders, art.omega_init[:4],
                                art.a[:4], art.b[:4], art.basis, cfg,
                                record_history=True, device="cpu")
    assert res.energy_history.shape == (3, 4)
    assert torch.all(res.energy_history > 0)


@pytest.mark.parametrize("warmup,steps", [(20, 400), (4, 20), (1, 5)])
def test_schedule_matches_optax(warmup, steps):
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-3, warmup_steps=warmup,
        decay_steps=steps, end_value=1e-5)
    ours = tgeo.warmup_cosine_decay(0.0, 3e-3, warmup, steps, 1e-5)
    counts = range(0, steps + 3)
    np.testing.assert_allclose([ours(c) for c in counts],
                               [float(ref(c)) for c in counts],
                               rtol=1e-6, atol=1e-6 * 3e-3)  # optax: f32
    assert ours(0) == 0.0     # the first update is zero


def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(6, 5, 2)).astype(np.float32)
    grads = rng.normal(size=(12, 6, 5, 2)).astype(np.float32)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 12, 1e-4)
    opt = optax.adam(learning_rate=sched)
    jp, st = jnp.asarray(p0), None
    st = opt.init(jp)
    tp = torch.from_numpy(p0.copy())
    topt = tgeo.Adam(tgeo.warmup_cosine_decay(0.0, 1e-2, 3, 12, 1e-4))
    tst = topt.init(tp)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        topt.step(tp, torch.from_numpy(g), tst)
    # a few float32 ulps: optax evaluates the schedule in float32, the port
    # in float64 rounded to float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(traj_num_t=32, polish_steps=5),
    dict(phase_plan=((10, 32, "cosine", 3e-3),
                     (5, 64, "constant", 1e-3, "expected_fused_bf16"))),
])
def test_phase_cfgs_and_exact_cfg_match_jax(kw):
    j = JGeo(steps=7, **kw, energy=JEnergy(num_t=64, mode="expected_fused"))
    t = GeodesicConfig(steps=7, **kw, energy=EnergyConfig(
        num_t=64, mode="expected_fused"))
    assert ([dataclasses.asdict(p) for p in tgeo._phase_cfgs(t)]
            == [dataclasses.asdict(p) for p in jgeo._phase_cfgs(j)])
    assert (dataclasses.asdict(tgeo._exact_cfg(t))
            == dataclasses.asdict(jgeo._exact_cfg(j)))


def test_config_defaults_match_jax():
    from vae_latent_geometry_tpu import config as jc
    from vae_latent_geometry_tpu_torch import config as tc

    # ``to_dict`` leaves out the port's own fields (ModelConfig's decoder
    # head) where they are at their defaults: the rest is the JAX config
    for name in ("ModelConfig", "EnergyConfig", "GeodesicConfig",
                 "InitConfig", "TrainConfig"):
        assert (tc.to_dict(getattr(tc, name)())
                == dataclasses.asdict(getattr(jc, name)())), name


@pytest.mark.parametrize("bad", [
    # expected_rescaled without the target_num_t it rescales to
    dict(energy=EnergyConfig(num_t=16, mode="expected_rescaled")),
    dict(phase_plan=((5, 32, "cosine"),)),
    dict(lr_schedule="linear"),
])
def test_bad_configs_raise(problem, bad):
    tp, _, art = problem
    cfg = dataclasses.replace(GeodesicConfig(steps=2, energy=EnergyConfig(
        num_t=16, mode="expected_fused")), **bad)
    with pytest.raises(ValueError):
        tgeo.optimize_splines(tp.decoders, art.omega_init[:2], art.a[:2],
                              art.b[:2], art.basis, cfg, device="cpu")
