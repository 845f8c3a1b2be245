"""VAE / ensemble-VAE training drivers.

Reference drivers: ``src/train.py:91-179`` (ensemble: Adam, per-epoch
train/val neg-ELBO, seeded 90/10 split) and
``src/single_decoder/vae_train.py`` (single VAE: beta warm-up
min(1, epoch/30), StepLR(200, 0.5), best-val checkpointing).  Contracts as
in the JAX package (``vae_latent_geometry_tpu/pipeline/train.py``):

- each epoch shuffles the training rows and drops the ``n % batch_size``
  remainder; validation runs in batches of ``min(batch_size, n_val)`` rows
  (remainder dropped) at warm-up ramp 1.0, and an empty validation split
  raises;
- the beta warm-up ramps by the ABSOLUTE epoch index, the step learning
  rate steps every ``lr_step_size * steps_per_epoch`` optimizer steps
  counted from 0, and Adam has optax's semantics over the whole tree
  (``optim.geodesic.Adam``);
- a checkpoint holds params, Adam state (optax's ``(count, mu, nu)`` leaf
  paths) and the epoch, and is refused on resume unless its config stamp
  matches (``epochs`` and ``block_epochs`` are not in it).

The runs of S seeds advance as ONE program: every parameter carries a
leading seed axis and the products are batched over it; the single-seed
trainers are the case S = 1.  An epoch's random draws (the permutation,
each batch's ``eps`` and decoder index, the validation ``eps`` and
indices) are a pure function of (seed, absolute epoch), drawn by a CPU
``torch.Generator`` and copied to the device once per epoch
(:func:`epoch_draws`); the init has a stream of its own.  So a run resumed
at any block boundary repeats the uninterrupted trajectory, the card and
the CPU see the same draws, and each seed of a multiseed run gets the draws
``train_evae`` gives it.  JAX's ``fold_in`` keys cannot be reproduced in
torch: the draws are not the JAX package's (:func:`train_epoch` takes them
as tensors, so a test can feed it those).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from dataclasses import dataclass
from typing import Callable, List, Optional
from warnings import warn

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
    to_dict,
)
from vae_latent_geometry_tpu_torch.data.tasic import train_val_split
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.io.checkpoint import (
    load_meta,
    load_train_state,
    save_train_state,
    tree_leaves,
    tree_map,
)
from vae_latent_geometry_tpu_torch.models import evae as evae_lib
from vae_latent_geometry_tpu_torch.models import nets
from vae_latent_geometry_tpu_torch.models import vae as vae_lib
from vae_latent_geometry_tpu_torch.optim.geodesic import Adam, fold_seed
from vae_latent_geometry_tpu_torch.parallel.collectives import all_gather_cat
from vae_latent_geometry_tpu_torch.parallel.multihost import is_primary

_INIT_STREAM, _EPOCH_STREAM = 0, 1


@dataclass
class TrainResult:
    params: object
    best_params: object          # best-val params (== params when not tracked)
    train_losses: np.ndarray     # (epochs,)
    val_losses: np.ndarray       # (epochs,)
    best_val_loss: float


def _lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """The constant ``cfg.lr``, or the step schedule of optax's
    ``scale_by_schedule`` count: lr * gamma^(count // (lr_step_size *
    steps_per_epoch))."""
    if cfg.lr_step_size <= 0:
        return cfg.lr
    boundary = cfg.lr_step_size * steps_per_epoch

    def sched(count: int) -> float:
        return cfg.lr * (cfg.lr_gamma ** (count // boundary))

    return sched


def _beta_ramp(cfg: TrainConfig, epoch: int) -> float:
    """The warm-up ramp of the KL weight at an absolute epoch index."""
    if cfg.beta_warmup_epochs <= 0:
        return 1.0
    return float(np.float32(min(1.0, epoch / cfg.beta_warmup_epochs)))


@dataclass
class EpochDraws:
    """One epoch's random draws for S runs (CPU tensors)."""

    perm: torch.Tensor       # (S, n) int64 training-row permutation
    eps: torch.Tensor        # (S, n_batches, batch_size, latent_dim)
    idx: torch.Tensor        # (S, n_batches) int64 decoder per batch
    val_eps: torch.Tensor    # (S, v_batches, vb, latent_dim)
    val_idx: torch.Tensor    # (S, v_batches)


def _val_batches(batch_size: int, n_val: int):
    """(v_batches, vb): validation batches of min(batch_size, n_val) rows."""
    if n_val == 0:
        raise ValueError(
            "empty validation split — per-epoch val losses are part of the "
            "training contract (best-val tracking, loss curves); use a "
            "val_ratio that keeps at least one row")
    vb = min(batch_size, n_val)
    return n_val // vb, vb


def epoch_draws(seeds, epoch: int, n: int, n_val: int, batch_size: int,
                latent_dim: int, num_decoders: int) -> EpochDraws:
    """The draws of absolute epoch ``epoch`` of each seed's run: a CPU
    generator seeded from (seed, epoch) draws the permutation, then each
    batch's eps and decoder index, then the validation's."""
    nb = n // batch_size
    vn, vb = _val_batches(batch_size, n_val)
    parts = []
    for s in seeds:
        g = torch.Generator().manual_seed(
            fold_seed(fold_seed(int(s), _EPOCH_STREAM), epoch))
        parts.append((torch.randperm(n, generator=g),
                      torch.randn((nb, batch_size, latent_dim), generator=g),
                      torch.randint(0, num_decoders, (nb,), generator=g),
                      torch.randn((vn, vb, latent_dim), generator=g),
                      torch.randint(0, num_decoders, (vn,), generator=g)))
    return EpochDraws(*(torch.stack(col) for col in zip(*parts)))


def train_epoch(loss_fn: Callable, params, opt: Adam, opt_state: dict,
                train_x: torch.Tensor, val_x: torch.Tensor,
                draws: EpochDraws, ramp: float, best: Optional[dict] = None):
    """One epoch of S runs: returns (mean train loss, val loss), each (S,)
    on the device.  ``params`` (a tree whose leaves carry the seed axis and
    require grad), ``opt_state`` and ``best`` ({"val": (S,), "params":
    tree}) are updated in place.

    ``loss_fn(params, x, eps, idx, ramp)`` -> per-seed losses (S,) of
    batches x (S, b, X).  Step i trains on rows ``perm[:, i*b:(i+1)*b]``
    with ``eps[:, i]`` and ``idx[:, i]``; validation scores rows
    ``[j*vb, (j+1)*vb)`` of ``val_x`` with ``val_eps[:, j]`` and
    ``val_idx[:, j]`` at ramp 1.0 after the last step."""
    S, _, X = train_x.shape
    nb, bs = draws.eps.shape[1:3]
    vn, vb = draws.val_eps.shape[1:3]
    dev = train_x.device
    # step-major layouts: one contiguous (S, b, ...) block per step
    perm = draws.perm[:, :nb * bs].to(dev)
    rows = torch.arange(S, device=dev)[:, None]
    xb = train_x[rows, perm].view(S, nb, bs, X).transpose(0, 1).contiguous()
    eps = draws.eps.transpose(0, 1).contiguous().to(dev)
    idx = draws.idx.t().contiguous().to(dev)
    leaves = tree_leaves(params)
    losses = []
    for i in range(nb):
        loss = loss_fn(params, xb[i], eps[i], idx[i], ramp)
        grads = torch.autograd.grad(loss.sum(), leaves)
        opt.step(leaves, list(grads), opt_state)
        losses.append(loss.detach())
    with torch.no_grad():
        vx = val_x[:, :vn * vb].reshape(S, vn, vb, X).transpose(0, 1)
        veps = draws.val_eps.transpose(0, 1).contiguous().to(dev)
        vidx = draws.val_idx.t().contiguous().to(dev)
        vmean = torch.stack([loss_fn(params, vx[j], veps[j], vidx[j], 1.0)
                             for j in range(vn)], 1).mean(1)
        if best is not None:
            better = vmean < best["val"]
            best["val"] = torch.where(better, vmean, best["val"])
            for bp, p in zip(tree_leaves(best["params"]), leaves):
                bp.copy_(torch.where(
                    better.view(-1, *[1] * (p.dim() - 1)), p, bp))
    # each seed's row reduced on its own: the same bits for any S
    return torch.stack(losses, 1).mean(1), vmean


def _cfg_stamp(cfg: TrainConfig, model_cfg: ModelConfig,
               drop_seed: bool = False, **extra) -> dict:
    """Every trajectory-affecting input of a training run, as a comparable
    stamp (the JAX package's JSON, field for field).  ``epochs`` is left
    out (a larger budget is the canonical resume), as is ``block_epochs``
    (the draws are keyed by absolute epoch, so the block partitioning cannot
    change the trajectory).  drop_seed: the multiseed trainer, whose seed
    list supersedes cfg.seed."""
    stamped = dataclasses.asdict(cfg)
    del stamped["epochs"]
    if drop_seed:
        stamped["seed"] = None
    return {
        "cfg": json.dumps(stamped, sort_keys=True, default=str),
        "model_cfg": json.dumps(to_dict(model_cfg), sort_keys=True,
                                default=str),
        **extra,
    }


def _check_resume_stamp(path: str, cfg_stamp: dict, label: str) -> None:
    """Validate a checkpoint's config stamp BEFORE the structured load: a
    foreign checkpoint raises (resuming it would corrupt the run); one
    without a stamp warns and resumes."""
    stored_stamp = load_meta(path).get("cfg_stamp")
    if stored_stamp is None:
        warn(f"{label} checkpoint {path!r} carries no config stamp "
             "(pre-stamp format); resuming without validation — the "
             "restored trajectory may not match this run's config")
    elif stored_stamp != cfg_stamp:
        raise ValueError(
            f"{label} checkpoint {path!r} was written by a different run "
            f"setup and cannot be resumed here:\n"
            f"  checkpoint: {stored_stamp}\n  this run:   {cfg_stamp}\n"
            "delete the checkpoint (or point checkpoint_path elsewhere) "
            "to start fresh")


def _optax_state(opt_state: dict, params, scheduled: bool, count):
    """The Adam state as optax's tree: ``(ScaleByAdamState(count, mu, nu),
    ScaleByScheduleState(count) | EmptyState())``, i.e. leaf paths
    ``0/count``, ``0/mu/...``, ``0/nu/...`` and ``1/count``."""
    def like(leaves):
        it = iter(leaves)
        return tree_map(lambda _: next(it), params)

    adam = {"count": count, "mu": like(opt_state["mu"]),
            "nu": like(opt_state["nu"])}
    return (adam, {"count": count}) if scheduled else (adam, ())


class _Run:
    """S training runs advancing together: parameters with a leading seed
    axis, Adam state, loss history, the best-val pair (when tracked) and
    the epoch.  ``batched=False``: one run, checkpointed without the seed
    axis (``train_evae``, ``train_single_vae``).  ``gather``: this rank's
    seed rows -> every seed's (the identity without a mesh); ``rows``:
    this rank's slice of the seed axis."""

    def __init__(self, params, lr, track_best: bool, batched: bool,
                 gather=None, rows=slice(None)):
        self.params, self.batched = params, batched
        self.gather = gather or (lambda x: x)
        self.rows = rows
        self.leaves = tree_leaves(params)
        for x in self.leaves:
            x.requires_grad_(True)
        self.scheduled = callable(lr)
        self.opt = Adam(lr if self.scheduled else (lambda count, v=lr: v))
        self.opt_state = self.opt.init(self.leaves)
        self.best = None
        if track_best:
            self.best = {
                "val": torch.full((self.leaves[0].shape[0],), math.inf,
                                  device=self.leaves[0].device),
                "params": tree_map(lambda x: x.detach().clone(), params)}
        self.train_losses: List = []
        self.val_losses: List = []
        self.epoch = 0

    def _host(self, x) -> np.ndarray:
        """A seed-axis tensor as the host array of every seed (no seed axis
        when not batched).  Collective with a mesh."""
        a = self.gather(x.detach()).cpu().numpy()
        return a if self.batched else a[0]

    def state_trees(self):
        """(params, opt_state, extra_state or None) as host trees in the
        JAX package's layout.  Collective with a mesh."""
        params = tree_map(self._host, self.params)
        count = np.int32(self.opt_state["count"])
        if self.batched:
            count = np.full(tree_leaves(params)[0].shape[0], count, np.int32)
        opt = _optax_state({k: [self._host(x) for x in self.opt_state[k]]
                            for k in ("mu", "nu")},
                           self.params, self.scheduled, count)
        extra = None
        if self.best is not None:
            extra = {"best_val": self._host(self.best["val"]),
                     "best_params": tree_map(self._host,
                                             self.best["params"])}
        return params, opt, extra

    def save(self, path: str, meta: dict) -> None:
        params, opt, extra = self.state_trees()
        if is_primary():
            save_train_state(params, opt, path, epoch=self.epoch,
                             extra_meta=meta, extra_state=extra)

    def restore(self, path: str) -> None:
        """Continue from a checkpoint (every rank reads it and takes its
        seed rows)."""
        params, opt, extra = self.state_trees()
        loaded = load_train_state(path, params, opt, extra)
        p, o, meta = loaded[0], loaded[1], loaded[-1]

        def put(dst, src):
            src = torch.as_tensor(src)
            dst.copy_(src[self.rows] if self.batched else src[None])

        with torch.no_grad():
            for dst, src in zip(self.leaves, tree_leaves(p)):
                put(dst, src)
            for k in ("mu", "nu"):
                for dst, src in zip(self.opt_state[k], tree_leaves(o[0][k])):
                    put(dst, src)
            if self.best is not None:
                e = loaded[2]
                put(self.best["val"], e["best_val"])
                for dst, src in zip(tree_leaves(self.best["params"]),
                                    tree_leaves(e["best_params"])):
                    put(dst, src)
        self.opt_state["count"] = int(np.ravel(o[0]["count"])[0])
        self.epoch = int(meta["epoch"])
        self.train_losses = list(meta.get("train_losses", []))
        self.val_losses = list(meta.get("val_losses", []))

    def seeds_of(self, tree) -> list:
        """Every seed's tree (this rank's rows gathered), without the seed
        axis."""
        full = tree_map(lambda x: self.gather(x.detach()), tree)
        n = tree_leaves(full)[0].shape[0]
        return [tree_map(lambda x, i=i: x[i], full) for i in range(n)]


def _splits(data, seeds, cfg: TrainConfig, dev):
    """(train_x, val_x): each seed's split of ``data``, (S, n, X) and
    (S, n_val, X) on ``dev``."""
    x = np.asarray(data, np.float32)
    tr, va = zip(*(train_val_split(len(x), cfg.val_ratio, int(s))
                   for s in seeds))
    return (torch.as_tensor(np.stack([x[i] for i in tr]), device=dev),
            torch.as_tensor(np.stack([x[i] for i in va]), device=dev))


def _init(init_fn: Callable, seeds, dev):
    """Each seed's init from its own stream, stacked on a seed axis."""
    return nets.stack_params([
        init_fn(torch.Generator().manual_seed(
            fold_seed(int(s), _INIT_STREAM)), dev) for s in seeds])


def _fit(run: _Run, loss_fn: Callable, seeds, cfg: TrainConfig, train_x,
         val_x, latent_dim: int, num_decoders: int, block_epochs: int,
         checkpoint_path: Optional[str], meta: dict, log_every: int,
         callback: Optional[Callable]) -> None:
    """Train ``run`` to ``cfg.epochs`` in blocks of ``block_epochs``: one
    host read of the losses, one callback and one checkpoint per block."""
    if cfg.epochs > run.epoch:
        _val_batches(cfg.batch_size, val_x.shape[1])
    while run.epoch < cfg.epochs:
        n_ep = min(block_epochs, cfg.epochs - run.epoch)
        tls, vls = [], []
        for e in range(run.epoch, run.epoch + n_ep):
            draws = epoch_draws(seeds, e, train_x.shape[1], val_x.shape[1],
                                cfg.batch_size, latent_dim, num_decoders)
            tl, vl = train_epoch(loss_fn, run.params, run.opt,
                                 run.opt_state, train_x, val_x, draws,
                                 _beta_ramp(cfg, e), run.best)
            tls.append(tl)
            vls.append(vl)
        tl = run.gather(torch.stack(tls, 1)).cpu().numpy()   # (S, n_ep)
        vl = run.gather(torch.stack(vls, 1)).cpu().numpy()
        if run.batched:
            run.train_losses.extend(tl.T.tolist())
            run.val_losses.extend(vl.T.tolist())
        else:
            run.train_losses.extend(tl[0].tolist())
            run.val_losses.extend(vl[0].tolist())
        if log_every and is_primary():
            print(f"epoch {run.epoch + n_ep:4d} | train "
                  + " ".join(f"{v:10.3f}" for v in tl[:, -1]) + " | val "
                  + " ".join(f"{v:10.3f}" for v in vl[:, -1]))
        if callback is not None:
            # once per BLOCK (the block's last epoch, its params and losses)
            callback(run.epoch + n_ep - 1, run.seeds_of(run.params)[0],
                     float(tl[0, -1]), float(vl[0, -1]))
        run.epoch += n_ep
        if checkpoint_path is not None:
            run.save(checkpoint_path, {"train_losses": run.train_losses,
                                       "val_losses": run.val_losses, **meta})


def _resume(run: _Run, checkpoint_path: Optional[str], stamp: dict,
            label: str, log_every: int) -> None:
    if checkpoint_path is None or not os.path.exists(checkpoint_path):
        return
    _check_resume_stamp(checkpoint_path, stamp, label)
    run.restore(checkpoint_path)
    if log_every and is_primary():
        print(f"[resume] {label} state restored at epoch {run.epoch}")


def _evae_loss(model_cfg: ModelConfig):
    # the warm-up is a RAMP on the model's own KL weight (0 warm-up epochs,
    # the default, keeps exactly cfg.beta: the reference's constant beta)
    return lambda p, x, eps, idx, ramp: evae_lib.neg_elbo(
        p, x, eps, idx, model_cfg, ramp * model_cfg.beta)


def train_evae(data: np.ndarray, cfg: TrainConfig = TrainConfig(),
               model_cfg: ModelConfig = ModelConfig(),
               params: Optional[evae_lib.EVAEParams] = None,
               log_every: int = 10,
               callback: Optional[Callable] = None,
               block_epochs: int = 20,
               checkpoint_path: Optional[str] = None,
               device=None) -> TrainResult:
    """Train the ensemble VAE (reference ``src/train.py``) on ``device``.

    No best-val tracking for this family (the reference saves the final
    state, src/train.py:165).  checkpoint_path: the whole training state
    (params, Adam moments, epoch, loss history) is written there after
    every block of ``block_epochs`` epochs, and an existing one is resumed:
    the resumed loss curve equals the uninterrupted one bit for bit,
    wherever the interruption fell and whatever ``block_epochs`` either run
    used."""
    dev = resolve_device(device)
    seeds = [cfg.seed]
    if params is None:
        params = _init(lambda g, d: evae_lib.evae_init(g, model_cfg, d),
                       seeds, dev)
    else:
        params = tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float32, device=dev)[None].clone(), params)
    train_x, val_x = _splits(data, seeds, cfg, dev)
    run = _Run(params, _lr_schedule(cfg, train_x.shape[1] // cfg.batch_size),
               track_best=False, batched=False)
    stamp = _cfg_stamp(cfg, model_cfg)
    _resume(run, checkpoint_path, stamp, "training", log_every)
    _fit(run, _evae_loss(model_cfg), seeds, cfg, train_x, val_x,
         model_cfg.latent_dim, model_cfg.num_decoders, block_epochs,
         checkpoint_path, {"seed": cfg.seed, "cfg_stamp": stamp}, log_every,
         callback)
    final = run.seeds_of(run.params)[0]
    return TrainResult(
        params=final, best_params=final,
        train_losses=np.asarray(run.train_losses),
        val_losses=np.asarray(run.val_losses),
        best_val_loss=(float(run.val_losses[-1]) if run.val_losses
                       else float("inf")))


def train_evae_multiseed(data: np.ndarray, seeds,
                         cfg: TrainConfig = TrainConfig(),
                         model_cfg: ModelConfig = ModelConfig(),
                         log_every: int = 10,
                         block_epochs: int = 20,
                         checkpoint_path: Optional[str] = None,
                         mesh=None, device=None) -> dict:
    """Train one ensemble VAE per seed as ONE program (the seed axis is a
    batch axis of every product); returns ``{seed: TrainResult}``.  Each
    seed gets the draws, split and init ``train_evae`` gives it with
    ``cfg.seed = s``.  The reference needs its six seed models for the CoV
    analysis and trains them as six serial processes (``src/train.py:126``).

    checkpoint_path: as in :func:`train_evae`, every seed's state in one
    file; the stamp covers the seed list, so a resume with other seeds
    raises.  mesh: a ``parallel.mesh.Mesh``; whole seeds are split over its
    'dp' ranks (``S % dp == 0``) and train with no collective; the ranks'
    rows are gathered for the checkpoint (written by rank 0) and the
    result."""
    seeds = [int(s) for s in seeds]
    if len(set(seeds)) != len(seeds):
        raise ValueError(
            f"duplicate seeds in {seeds}: each run costs a full seed's "
            "compute but duplicates collapse in the results dict — pass "
            "each seed once")
    gather, rows = None, slice(None)
    mine = seeds
    if mesh is not None:
        dp = mesh.size("dp")
        if len(seeds) % dp != 0:
            raise ValueError(
                f"multiseed training shards whole seed runs over 'dp': "
                f"{len(seeds)} seeds do not divide over dp={dp}; pick a dp "
                "that divides the seed count (or pad the seed list)")
        per = len(seeds) // dp
        rows = slice(mesh.index("dp") * per, (mesh.index("dp") + 1) * per)
        mine = seeds[rows]
        group = mesh.group("dp")
        gather = lambda x: all_gather_cat(x.contiguous(), group)  # noqa: E731
    dev = resolve_device(device)
    params = _init(lambda g, d: evae_lib.evae_init(g, model_cfg, d), mine,
                   dev)
    train_x, val_x = _splits(data, mine, cfg, dev)
    run = _Run(params, _lr_schedule(cfg, train_x.shape[1] // cfg.batch_size),
               track_best=False, batched=True, gather=gather, rows=rows)
    stamp = _cfg_stamp(cfg, model_cfg, drop_seed=True, seeds=seeds)
    _resume(run, checkpoint_path, stamp, "multiseed training", log_every)
    _fit(run, _evae_loss(model_cfg), mine, cfg, train_x, val_x,
         model_cfg.latent_dim, model_cfg.num_decoders, block_epochs,
         checkpoint_path, {"cfg_stamp": stamp}, log_every, None)
    # reshape guards the empty history (epochs=0)
    tl = np.asarray(run.train_losses).reshape(-1, len(seeds))
    vl = np.asarray(run.val_losses).reshape(-1, len(seeds))
    results = {}
    for i, (s, p) in enumerate(zip(seeds, run.seeds_of(run.params))):
        results[s] = TrainResult(
            params=p, best_params=p, train_losses=tl[:, i],
            val_losses=vl[:, i],
            best_val_loss=float(vl[-1, i]) if len(vl) else float("inf"))
    return results


def train_single_vae(data: np.ndarray, cfg: TrainConfig = TrainConfig(),
                     model_cfg: ModelConfig = vae_lib.LEGACY_CONFIG,
                     params: Optional[vae_lib.VAEParams] = None,
                     log_every: int = 10,
                     callback: Optional[Callable] = None,
                     block_epochs: int = 20,
                     checkpoint_path: Optional[str] = None,
                     device=None) -> TrainResult:
    """Train the legacy single VAE with beta warm-up, step lr and best-val
    tracking (reference ``src/single_decoder/vae_train.py``: beta =
    min(1, epoch/30) at :77, StepLR(200, 0.5) at :63, best-val checkpoint
    at :99-101), on ``device``.  The best (val, params) pair is tracked on
    the device every epoch and is part of the checkpoint, so a resumed run
    keeps the best-val semantics across the boundary."""
    dev = resolve_device(device)
    seeds = [cfg.seed]
    if params is None:
        params = _init(lambda g, d: vae_lib.vae_init(g, model_cfg, d),
                       seeds, dev)
    else:
        params = tree_map(lambda x: torch.as_tensor(
            x, dtype=torch.float32, device=dev)[None].clone(), params)
    train_x, val_x = _splits(data, seeds, cfg, dev)
    run = _Run(params, _lr_schedule(cfg, train_x.shape[1] // cfg.batch_size),
               track_best=True, batched=False)
    stamp = _cfg_stamp(cfg, model_cfg, family="single_vae")
    _resume(run, checkpoint_path, stamp, "single-VAE training", log_every)
    _fit(run, lambda p, x, eps, idx, beta: -vae_lib.elbo(p, x, eps, beta,
                                                          model_cfg),
         seeds, cfg, train_x, val_x, model_cfg.latent_dim, 1, block_epochs,
         checkpoint_path, {"cfg_stamp": stamp}, log_every, callback)
    return TrainResult(
        params=run.seeds_of(run.params)[0],
        best_params=run.seeds_of(run.best["params"])[0],
        train_losses=np.asarray(run.train_losses),
        val_losses=np.asarray(run.val_losses),
        best_val_loss=float(run.best["val"][0]))
