"""Training in the PyTorch port against the JAX package, and the ported
contracts of ``tests/test_train.py``.

Parity, on the CPU, at float32:
- ``evae_init`` / ``vae_init`` / ``legacy_evae_init``: the JAX leaf paths and
  shapes, U(+-1/sqrt(fan_in)) bounds, one decoder copied to every member;
- ``elbo``, ``neg_elbo`` and their gradients for every leaf, on JAX-initialised
  parameters with the ``eps`` and decoder index rebuilt from the JAX key as
  the JAX functions draw them (the ensemble, the legacy VAE and the legacy
  ensemble): loss rtol 1e-5, gradients rtol 1e-4 (atol 1e-5 of the leaf's
  largest gradient);
- Adam against ``optax.adam`` over five updates of a step schedule (rtol
  1e-6, atol 1e-4 of the learning rate: optax forms the bias correction
  1 - 0.999^t in float32, 1.3e-5 from its exact value at t = 1, which the
  port rounds once) and ``_lr_schedule`` at its boundaries (rtol 1e-7);
- two epochs of the port's ``train_epoch`` fed the JAX package's own
  permutation and noise, against JAX's ``make_block_fn`` (ensemble, and the
  single VAE with warm-up, step lr and best-val tracking): epoch losses
  rtol 1e-5, parameters atol 1e-5;
- ``train_val_split`` index for index, and the config stamp's JSON.

The contracts of ``tests/test_train.py`` then hold the port's trainers on the
same tiny data (the port's own draws).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_latent_geometry_tpu.config import ModelConfig as JModel
from vae_latent_geometry_tpu.config import TrainConfig as JTrain
from vae_latent_geometry_tpu.data import train_val_split as j_split
from vae_latent_geometry_tpu.io.checkpoint import _flatten_with_paths
from vae_latent_geometry_tpu.models import evae as jevae
from vae_latent_geometry_tpu.models import vae as jvae
from vae_latent_geometry_tpu.pipeline import train as jtrain
from vae_latent_geometry_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    to_dict,
)
from vae_latent_geometry_tpu_torch.data.tasic import train_val_split
from vae_latent_geometry_tpu_torch.io.checkpoint import (
    flatten_with_paths,
    tree_leaves,
    tree_map,
)
from vae_latent_geometry_tpu_torch.models import evae, vae
from vae_latent_geometry_tpu_torch.optim.geodesic import Adam
from vae_latent_geometry_tpu_torch.pipeline import train as ptrain
from vae_latent_geometry_tpu_torch.pipeline.train import (
    train_evae,
    train_evae_multiseed,
    train_single_vae,
)

torch.set_num_threads(1)

SMALL = dict(input_dim=10, latent_dim=2, num_decoders=3,
             encoder_hidden=(32, 16), decoder_hidden=(32,), decoder_sigma=1.0)
TINY = dict(input_dim=10, latent_dim=2, num_decoders=2,
            encoder_hidden=(16,), decoder_hidden=(16,), decoder_sigma=1.0)
LEGACY = dict(input_dim=10, latent_dim=2, heteroscedastic=True,
              encoder_hidden=(32, 16), decoder_hidden=(32,))


@pytest.fixture(scope="module")
def tiny_data():
    # two well-separated blobs in 10 dims (tests/test_train.py's data)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(512, 10)).astype(np.float32)
    x[:256] += 4.0
    return x


def _t(tree):
    """A JAX dict/list tree as CPU tensors."""
    return tree_map(lambda x: torch.tensor(np.asarray(x)), tree)


def _flat_np(tree):
    return {p: (x.detach().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)) for p, x in flatten_with_paths(tree)}


# --------------------------------------------------------------- init -----

@pytest.mark.parametrize("family", ["evae", "vae", "legacy_evae"])
def test_init_matches_jax_layout_and_bounds(family):
    g = torch.Generator().manual_seed(0)
    if family == "evae":
        cfg = ModelConfig(**SMALL)
        port = evae.evae_init(g, cfg, "cpu")
        ref = jevae.evae_init(jax.random.PRNGKey(0), JModel(**SMALL))
    elif family == "vae":
        cfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
        port = vae.vae_init(g, cfg, "cpu")
        ref = jvae.vae_init(jax.random.PRNGKey(0),
                            dataclasses.replace(jvae.LEGACY_CONFIG, **LEGACY))
    else:
        cfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
        port = vae.legacy_evae_init(g, cfg, 3, "cpu")
        ref = jvae.legacy_evae_init(
            jax.random.PRNGKey(0),
            dataclasses.replace(jvae.LEGACY_CONFIG, **LEGACY), 3)
    p, j = _flat_np(port), _flatten_with_paths(ref)[0]
    assert sorted(p) == sorted(j)
    for k, v in p.items():
        assert v.shape == j[k].shape and v.dtype == np.float32, k
        if k.endswith("/w") or k.endswith("/b"):
            fan_in = p[k[:-1] + "w"].shape[-2]
            assert np.abs(v).max() <= 1 / np.sqrt(fan_in)
            assert np.abs(v).max() > 0.5 / np.sqrt(fan_in)
        if k.startswith("decoders/"):
            same = all(np.array_equal(v[0], v[m]) for m in range(len(v)))
            # the ensemble copies one decoder; the legacy one does not
            assert same == (family == "evae"), k


# --------------------------------------------------------------- ELBO -----

def _jax_case(family, key):
    """(JAX params, JAX loss(params), port params, port loss(params))."""
    x = np.random.default_rng(3).normal(size=(48, 10)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if family == "evae":
        jcfg, cfg = JModel(**SMALL), ModelConfig(**SMALL)
        jp = jevae.evae_init(jax.random.PRNGKey(1), jcfg)
        # members start equal: perturb them so the chosen one matters
        jp = jp._replace(decoders=jax.tree_util.tree_map(
            lambda w: w + 0.05 * jax.random.normal(
                jax.random.PRNGKey(2), w.shape), jp.decoders))
        z_key, d_key = jax.random.split(key)
        eps = np.asarray(jax.random.normal(z_key, (48, 2)))
        idx = int(jax.random.randint(d_key, (), 0, 3))
        tp = evae.from_jax_params(jp, "cpu")
        return (jp, lambda p: jevae.neg_elbo(p, key, jx, jcfg, 0.7), tp,
                lambda p: evae.neg_elbo(p, tx, torch.tensor(eps), idx, cfg,
                                        0.7))
    jcfg = dataclasses.replace(jvae.LEGACY_CONFIG, **LEGACY)
    cfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
    if family == "vae":
        jp = jvae.vae_init(jax.random.PRNGKey(1), jcfg)
        eps = np.asarray(jax.random.normal(key, (48, 2)))
        tp = vae.VAEParams(encoder=_t(jp.encoder), decoder=_t(jp.decoder))
        return (jp, lambda p: -jvae.elbo(p, key, jx, 0.6, jcfg), tp,
                lambda p: -vae.elbo(p, tx, torch.tensor(eps), 0.6, cfg))
    jp = jvae.legacy_evae_init(jax.random.PRNGKey(1), jcfg, 3)
    z_key, d_key = jax.random.split(key)
    idx = int(jax.random.randint(d_key, (), 0, 3))
    eps = np.asarray(jax.random.normal(z_key, (48, 2)))
    tp = vae.LegacyEVAEParams(encoder=_t(jp.encoder),
                              decoders=_t(jp.decoders))
    return (jp, lambda p: -jvae.legacy_evae_elbo(p, key, jx, 0.6, cfg=jcfg),
            tp, lambda p: -vae.legacy_evae_elbo(p, tx, torch.tensor(eps),
                                                idx, 0.6, cfg))


@pytest.mark.parametrize("family", ["evae", "vae", "legacy_evae"])
@pytest.mark.parametrize("key", [0, 5])
def test_elbo_and_gradients_match_jax(family, key):
    jp, jloss, tp, tloss = _jax_case(family, jax.random.PRNGKey(key))
    jl, jg = jax.value_and_grad(jloss)(jp)
    leaves = tree_leaves(tp)
    for x in leaves:
        x.requires_grad_(True)
    tl = tloss(tp)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    j = _flatten_with_paths(jg)[0]
    paths = [p for p, _ in flatten_with_paths(tp)]
    assert sorted(paths) == sorted(j)
    for p, g in zip(paths, tg):
        ref = j[p]
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-30),
                                   err_msg=p)


def test_elbo_drawn_and_sample_shapes():
    cfg = ModelConfig(**SMALL)
    p = evae.evae_init(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(8, 10)
    v1 = evae.elbo_drawn(p, torch.Generator().manual_seed(4), x, cfg)
    v2 = evae.elbo_drawn(p, torch.Generator().manual_seed(4), x, cfg)
    assert v1.shape == () and torch.isfinite(v1) and torch.equal(v1, v2)
    s = evae.sample(p, torch.Generator().manual_seed(1), 5, cfg)
    assert s.shape == (5, 10)
    lcfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
    lp = vae.legacy_evae_init(torch.Generator().manual_seed(0), lcfg, 3,
                              "cpu")
    assert vae.legacy_evae_sample(lp, torch.Generator().manual_seed(1), 4,
                                  cfg=lcfg).shape == (4, 10)
    assert torch.equal(vae.legacy_decoder(lp)["layers"][0]["w"],
                       lp.decoders["layers"][0]["w"][0])
    mean_head = vae.mean_decoder(vae.legacy_decoder(lp))
    assert mean_head["layers"][-1]["w"].shape[-1] == 10


# ----------------------------------------------------------- optimizer -----

def test_adam_and_lr_schedule_match_optax():
    cfg = TrainConfig(lr=1e-2, lr_step_size=2, lr_gamma=0.5)
    spe = 1          # steps per epoch: the lr halves every 2 steps
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jopt = optax.adam(jtrain._lr_schedule(JTrain(**dataclasses.asdict(cfg)),
                                          spe))
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    opt = Adam(ptrain._lr_schedule(cfg, spe))
    tp = [torch.tensor(p) for p in params]
    ts = opt.init(tp)
    for g in grads:
        upd, js = jopt.update([jnp.asarray(x) for x in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, [torch.tensor(x) for x in g], ts)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-4 * cfg.lr)
    assert ts["count"] == int(js[0].count) == 5


def test_lr_schedule_at_its_boundaries():
    cfg = TrainConfig(lr=3e-3, lr_step_size=4, lr_gamma=0.5)
    jsched = jtrain._lr_schedule(JTrain(**dataclasses.asdict(cfg)), 7)
    sched = ptrain._lr_schedule(cfg, 7)
    b = 4 * 7
    for count in (0, 1, b - 1, b, b + 1, 2 * b - 1, 2 * b, 5 * b + 3):
        np.testing.assert_allclose(sched(count),
                                   float(jsched(jnp.int32(count))),
                                   rtol=1e-7)
    assert ptrain._lr_schedule(TrainConfig(lr=2e-3), 7) == 2e-3


# ------------------------------------------ epochs on the JAX draws -----

def _jax_epoch_draws(key, epoch, n, n_val, bs, D, M):
    """The draws JAX's epoch body makes, as an ``EpochDraws`` (S = 1)."""
    nb = n // bs
    vb = min(bs, n_val)
    vn = n_val // vb
    ekey = jax.random.fold_in(key, epoch)
    perm = jax.random.permutation(jax.random.fold_in(ekey, 0), n)

    def noise(keys, rows):
        eps, idx = [], []
        for k in keys:
            if M:       # the ensemble: z key and decoder key
                zk, dk = jax.random.split(k)
                idx.append(int(jax.random.randint(dk, (), 0, M)))
            else:       # the single VAE: the key itself draws eps
                zk = k
                idx.append(0)
            eps.append(np.asarray(jax.random.normal(zk, (rows, D))))
        return torch.tensor(np.stack(eps))[None], torch.tensor(idx)[None]

    eps, idx = noise(jax.random.split(jax.random.fold_in(ekey, 1), nb), bs)
    veps, vidx = noise(jax.random.split(jax.random.fold_in(ekey, 2), vn), vb)
    return ptrain.EpochDraws(perm=torch.tensor(np.asarray(perm))[None],
                             eps=eps, idx=idx, val_eps=veps, val_idx=vidx)


@pytest.mark.parametrize("family", ["evae", "single_vae"])
def test_epochs_on_jax_draws_match_make_block_fn(tiny_data, family):
    epochs, key = 2, jax.random.PRNGKey(11)
    if family == "evae":
        cfg = TrainConfig(batch_size=64, lr=3e-3, seed=2)
        mkw = SMALL
        jcfg_m, cfg_m = JModel(**mkw), ModelConfig(**mkw)
        jp0 = jevae.evae_init(jax.random.PRNGKey(4), jcfg_m)
        jloss = lambda p, k, x, r: jevae.neg_elbo(p, k, x, jcfg_m,  # noqa
                                                  r * jcfg_m.beta)
        tp0 = evae.from_jax_params(jp0, "cpu")
        tloss = ptrain._evae_loss(cfg_m)
        M, track = 3, False
    else:
        cfg = TrainConfig(batch_size=64, lr=3e-3, seed=2,
                          beta_warmup_epochs=3, lr_step_size=1, lr_gamma=0.5)
        jcfg_m = dataclasses.replace(jvae.LEGACY_CONFIG, **LEGACY)
        cfg_m = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
        jp0 = jvae.vae_init(jax.random.PRNGKey(4), jcfg_m)
        jloss = lambda p, k, x, b: -jvae.elbo(p, k, x, b, jcfg_m)  # noqa
        tp0 = vae.VAEParams(encoder=_t(jp0.encoder), decoder=_t(jp0.decoder))
        tloss = lambda p, x, e, i, b: -vae.elbo(p, x, e, b, cfg_m)  # noqa
        M, track = 0, True
    tr, va = j_split(len(tiny_data), cfg.val_ratio, cfg.seed)
    train_x, val_x = tiny_data[tr], tiny_data[va]
    nb = len(tr) // cfg.batch_size
    jcfg = JTrain(**dataclasses.asdict(cfg))
    jopt = optax.adam(jtrain._lr_schedule(jcfg, nb))
    block = jtrain.make_block_fn(jloss, jopt, cfg.batch_size, jcfg,
                                 track_best=track)
    best = (jnp.asarray(jnp.inf), jp0) if track else ()
    out = block(jp0, jopt.init(jp0), key, jnp.asarray(train_x),
                jnp.asarray(val_x), 0, epochs, *best)
    jparams, jtl, jvl = out[0], np.asarray(out[2]), np.asarray(out[3])

    run = ptrain._Run(tree_map(lambda x: x[None].clone(), tp0),
                      ptrain._lr_schedule(cfg, nb), track_best=track,
                      batched=False)
    tx, vx = torch.tensor(train_x)[None], torch.tensor(val_x)[None]
    for e in range(epochs):
        draws = _jax_epoch_draws(key, e, len(tr), len(va), cfg.batch_size,
                                 2, M)
        tl, vl = ptrain.train_epoch(tloss, run.params, run.opt,
                                    run.opt_state, tx, vx, draws,
                                    ptrain._beta_ramp(cfg, e), run.best)
        np.testing.assert_allclose(float(tl[0]), jtl[e], rtol=1e-5)
        np.testing.assert_allclose(float(vl[0]), jvl[e], rtol=1e-5)
    got = _flat_np(run.seeds_of(run.params)[0])
    for p, ref in _flatten_with_paths(jparams)[0].items():
        np.testing.assert_allclose(got[p], ref, atol=1e-5, err_msg=p)
    if track:
        np.testing.assert_allclose(float(run.best["val"][0]),
                                   float(out[4]), rtol=1e-5)


def test_train_val_split_matches_jax():
    for n, ratio, seed in ((23822, 0.1, 42), (512, 0.1, 3), (100, 0.25, 7)):
        for a, b in zip(train_val_split(n, ratio, seed),
                        j_split(n, ratio, seed)):
            np.testing.assert_array_equal(a, b)


def test_cfg_stamp_json_matches_jax():
    cases = [(TrainConfig(), ModelConfig(), {}),
             (TrainConfig(epochs=9, seed=3, beta_warmup_epochs=30,
                          lr_step_size=200), vae.LEGACY_CONFIG,
              {"family": "single_vae"}),
             (TrainConfig(lr=2e-3), ModelConfig(**TINY),
              {"drop_seed": True, "seeds": [12, 123]})]
    for cfg, mcfg, extra in cases:
        jm = JModel(**to_dict(mcfg))
        jc = JTrain(**dataclasses.asdict(cfg))
        assert ptrain._cfg_stamp(cfg, mcfg, **extra) == \
            jtrain._cfg_stamp(jc, jm, **extra)


# ------------------------------------- tests/test_train.py, ported -----

def test_evae_training_reduces_loss(tiny_data):
    cfg = TrainConfig(epochs=8, batch_size=64, lr=1e-3, seed=0)
    res = train_evae(tiny_data, cfg, ModelConfig(**SMALL), log_every=0,
                     device="cpu")
    assert len(res.train_losses) == 8
    assert res.train_losses[-1] < res.train_losses[0]
    assert np.isfinite(res.val_losses).all()


def test_evae_decoders_diverge_during_training(tiny_data):
    """Members start as copies of one decoder and diverge through the
    random decoder choice."""
    mcfg = ModelConfig(**SMALL)
    params0 = evae.evae_init(torch.Generator().manual_seed(0), mcfg, "cpu")
    z = torch.zeros(1, 2)
    outs0 = evae.decode_all(params0.decoders, z)
    assert torch.equal(outs0[0], outs0[1])
    res = train_evae(tiny_data, TrainConfig(epochs=6, batch_size=64,
                                            lr=3e-3, seed=1),
                     mcfg, params=params0, log_every=0, device="cpu")
    outs = evae.decode_all(res.params.decoders, z)
    assert not torch.allclose(outs[0], outs[1], atol=1e-6)


def test_single_vae_training_with_warmup_and_best(tiny_data):
    cfg = TrainConfig(epochs=10, batch_size=64, lr=1e-3, seed=0,
                      beta_warmup_epochs=5, lr_step_size=4, lr_gamma=0.5)
    mcfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
    res = train_single_vae(tiny_data, cfg, mcfg, log_every=0, device="cpu")
    assert res.train_losses[-1] < res.train_losses[0]
    assert res.best_val_loss == pytest.approx(np.min(res.val_losses))


def test_train_resume_restores_optimizer_state(tiny_data, tmp_path):
    """An interrupted run continues the exact trajectory: the resumed loss
    curve equals the uninterrupted run's bit for bit."""
    mcfg = ModelConfig(**TINY)
    ref = train_evae(tiny_data, TrainConfig(epochs=6, batch_size=64, seed=3),
                     mcfg, log_every=0, block_epochs=3, device="cpu")
    ckpt = str(tmp_path / "train_state.npz")
    train_evae(tiny_data, TrainConfig(epochs=3, batch_size=64, seed=3), mcfg,
               log_every=0, block_epochs=3, checkpoint_path=ckpt,
               device="cpu")
    res = train_evae(tiny_data, TrainConfig(epochs=6, batch_size=64, seed=3),
                     mcfg, log_every=0, block_epochs=3, checkpoint_path=ckpt,
                     device="cpu")
    assert len(res.train_losses) == 6
    np.testing.assert_array_equal(res.train_losses, ref.train_losses)
    np.testing.assert_array_equal(res.val_losses, ref.val_losses)
    for a, b in zip(tree_leaves(res.params), tree_leaves(ref.params)):
        assert torch.equal(a, b)


def test_train_resume_refuses_foreign_config(tiny_data, tmp_path):
    mcfg = ModelConfig(**TINY)
    ckpt = str(tmp_path / "train_state.npz")
    train_evae(tiny_data, TrainConfig(epochs=2, batch_size=64, seed=3),
               mcfg, log_every=0, block_epochs=2, checkpoint_path=ckpt,
               device="cpu")
    with pytest.raises(ValueError, match="different run setup"):
        train_evae(tiny_data, TrainConfig(epochs=4, batch_size=64, seed=4),
                   mcfg, log_every=0, block_epochs=2, checkpoint_path=ckpt,
                   device="cpu")
    with pytest.raises(ValueError, match="different run setup"):
        train_evae(tiny_data, TrainConfig(epochs=4, batch_size=64, seed=3),
                   ModelConfig(**{**TINY, "num_decoders": 3}), log_every=0,
                   block_epochs=2, checkpoint_path=ckpt, device="cpu")


def test_multiseed_training_matches_serial_runs(tiny_data):
    """Each seed of the one-program multiseed run equals its serial
    ``train_evae`` run bit for bit on the CPU."""
    mcfg = ModelConfig(**TINY)
    multi = train_evae_multiseed(tiny_data, [3, 7],
                                 TrainConfig(epochs=5, batch_size=64), mcfg,
                                 log_every=0, block_epochs=2, device="cpu")
    for s in (3, 7):
        single = train_evae(tiny_data,
                            TrainConfig(epochs=5, batch_size=64, seed=s),
                            mcfg, log_every=0, block_epochs=2, device="cpu")
        np.testing.assert_array_equal(multi[s].train_losses,
                                      single.train_losses)
        np.testing.assert_array_equal(multi[s].val_losses, single.val_losses)
        for a, b in zip(tree_leaves(multi[s].params),
                        tree_leaves(single.params)):
            assert torch.equal(a, b)
    assert not np.allclose(multi[3].train_losses, multi[7].train_losses)


def test_multiseed_resume_and_foreign_seedlist_refusal(tiny_data, tmp_path):
    mcfg = ModelConfig(**TINY)
    ref = train_evae_multiseed(tiny_data, [3, 7],
                               TrainConfig(epochs=4, batch_size=64), mcfg,
                               log_every=0, block_epochs=2, device="cpu")
    ckpt = str(tmp_path / "multi_state.npz")
    train_evae_multiseed(tiny_data, [3, 7],
                         TrainConfig(epochs=2, batch_size=64), mcfg,
                         log_every=0, block_epochs=2, checkpoint_path=ckpt,
                         device="cpu")
    res = train_evae_multiseed(tiny_data, [3, 7],
                               TrainConfig(epochs=4, batch_size=64), mcfg,
                               log_every=0, block_epochs=2,
                               checkpoint_path=ckpt, device="cpu")
    for s in (3, 7):
        np.testing.assert_array_equal(res[s].train_losses,
                                      ref[s].train_losses)
    with pytest.raises(ValueError, match="different run setup"):
        train_evae_multiseed(tiny_data, [3, 8],
                             TrainConfig(epochs=4, batch_size=64), mcfg,
                             log_every=0, block_epochs=2,
                             checkpoint_path=ckpt, device="cpu")


def test_training_is_deterministic(tiny_data):
    cfg = TrainConfig(epochs=3, batch_size=64, seed=7)
    mcfg = ModelConfig(**TINY)
    r1 = train_evae(tiny_data, cfg, mcfg, log_every=0, device="cpu")
    r2 = train_evae(tiny_data, cfg, mcfg, log_every=0, device="cpu")
    np.testing.assert_array_equal(r1.train_losses, r2.train_losses)


def test_single_vae_resume_restores_best_val_state(tiny_data, tmp_path):
    cfg_full = TrainConfig(epochs=8, batch_size=64, lr=1e-3, seed=5,
                           beta_warmup_epochs=4, lr_step_size=3,
                           lr_gamma=0.5)
    mcfg = dataclasses.replace(vae.LEGACY_CONFIG, **LEGACY)
    ref = train_single_vae(tiny_data, cfg_full, mcfg, log_every=0,
                           block_epochs=2, device="cpu")
    ckpt = str(tmp_path / "svae_state.npz")
    train_single_vae(tiny_data, dataclasses.replace(cfg_full, epochs=4),
                     mcfg, log_every=0, block_epochs=2, checkpoint_path=ckpt,
                     device="cpu")
    res = train_single_vae(tiny_data, cfg_full, mcfg, log_every=0,
                           block_epochs=2, checkpoint_path=ckpt,
                           device="cpu")
    np.testing.assert_array_equal(res.train_losses, ref.train_losses)
    np.testing.assert_array_equal(res.val_losses, ref.val_losses)
    assert res.best_val_loss == ref.best_val_loss
    for x, y in zip(tree_leaves(res.best_params),
                    tree_leaves(ref.best_params)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="different run setup"):
        train_single_vae(tiny_data, dataclasses.replace(cfg_full, lr=2e-3),
                         mcfg, log_every=0, block_epochs=2,
                         checkpoint_path=ckpt, device="cpu")


def test_resume_is_block_boundary_invariant(tiny_data, tmp_path):
    """Draws are keyed by absolute epoch: a resume from an epoch that is
    not a multiple of the block size, with another block size, replays the
    uninterrupted trajectory bit for bit."""
    mcfg = ModelConfig(**TINY)
    cfg_full = TrainConfig(epochs=5, batch_size=64, seed=4)
    ref = train_evae(tiny_data, cfg_full, mcfg, log_every=0, block_epochs=2,
                     device="cpu")
    ckpt = str(tmp_path / "misaligned.npz")
    train_evae(tiny_data, TrainConfig(epochs=3, batch_size=64, seed=4),
               mcfg, log_every=0, block_epochs=3, checkpoint_path=ckpt,
               device="cpu")
    res = train_evae(tiny_data, cfg_full, mcfg, log_every=0, block_epochs=2,
                     checkpoint_path=ckpt, device="cpu")
    np.testing.assert_array_equal(res.train_losses, ref.train_losses)
    np.testing.assert_array_equal(res.val_losses, ref.val_losses)


def test_multiseed_rejects_duplicate_seeds_and_empty_budget(tiny_data):
    mcfg = ModelConfig(**TINY)
    with pytest.raises(ValueError, match="duplicate seeds"):
        train_evae_multiseed(tiny_data, [3, 3, 7],
                             TrainConfig(epochs=1, batch_size=64), mcfg,
                             log_every=0, device="cpu")
    res = train_evae_multiseed(tiny_data, [3, 7],
                               TrainConfig(epochs=0, batch_size=64), mcfg,
                               log_every=0, device="cpu")
    assert res[3].train_losses.shape == (0,)
    with pytest.raises(ValueError, match="empty validation split"):
        train_evae(tiny_data[:9], TrainConfig(epochs=1, batch_size=4),
                   mcfg, log_every=0, device="cpu")


def test_evae_beta_warmup_affects_trajectory(tiny_data):
    mcfg = ModelConfig(input_dim=10, num_decoders=2, encoder_hidden=(8,),
                       decoder_hidden=(8,))
    base = dict(epochs=3, batch_size=16, lr=1e-3, seed=3)
    r_const = train_evae(tiny_data, TrainConfig(**base), mcfg, log_every=0,
                         device="cpu")
    r_warm = train_evae(tiny_data, TrainConfig(**base, beta_warmup_epochs=10),
                        mcfg, log_every=0, device="cpu")
    assert not np.allclose(r_const.train_losses, r_warm.train_losses)
    assert r_const.train_losses[0] != r_warm.train_losses[0]
