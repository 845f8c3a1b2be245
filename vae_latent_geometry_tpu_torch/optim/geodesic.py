"""Batched geodesic energy minimization: the framework's core workload.

Loss semantics match the JAX package and the reference: per-spline
``energy + endpoint_weight * ||gamma(1) - b||^2`` summed over the batch,
Adam(lr, 0.9, 0.999, eps=1e-8) on omega only, with optax's update rule and
learning-rate schedules written out in plain torch (:class:`Adam`,
:func:`warmup_cosine_decay`).  The JAX package runs all steps as one
``lax.scan``; here a Python loop drives the same steps eagerly.  The
early-stopping variant (reference
``src/single_decoder/optimize_energy.py:119-165``: track the best energy,
stop after ``patience`` steps without a relative improvement above
``delta``, restore the best params) is batched over splines with a
per-spline patience counter, checked every 50 steps
(:func:`optimize_spline_early_stopping`).

The stochastic (MC) modes draw from a stream of integer seeds derived from
the caller's ``torch.Generator`` with the structure of the JAX package's key
stream: one independent draw per step, a stream of its own for every phase,
a draw of its own for the final re-evaluation.  The seeds are computed on
the host (:func:`fold_seed`), so the loop never waits for the device.
Results are reproducible per seed; the bits are not the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import GeodesicConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.geometry import energy as energy_lib
from vae_latent_geometry_tpu_torch.geometry.spline import (
    design_matrix,
    design_matrix_derivative,
    eval_spline_design,
    eval_spline_velocity,
    t_grid,
)
from vae_latent_geometry_tpu_torch.io.checkpoint import tree_map
from vae_latent_geometry_tpu_torch.models.nets import fold_batchnorm
from vae_latent_geometry_tpu_torch.ops import energy_fused, energy_mc_fused
from vae_latent_geometry_tpu_torch.parallel.collectives import all_reduce_sum
from vae_latent_geometry_tpu_torch.utils.profiling import trace_annotation

ENERGY_MODES = ("mc", "mc_scan", "mc_fused", "mc_fused_bf16",
                "expected", "expected_fused", "expected_fused_bf16",
                "single", "single_fused", "single_fused_bf16", "jvp",
                "jvp_ensemble", "expected_rescaled")
_M64 = (1 << 64) - 1


def fold_seed(seed: int, data: int) -> int:
    """A new 63-bit seed from ``seed`` and an integer (the splitmix64
    finalizer): the counterpart of ``jax.random.fold_in`` for the integer
    seeds of the MC modes."""
    z = (seed + 0x9E3779B97F4A7C15 * (data + 1)) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) >> 1


def root_seed(generator: Optional[torch.Generator]) -> int:
    """The seed that names a caller's random stream: the generator's
    ``initial_seed()`` (0 without a generator, as the JAX package's
    ``PRNGKey(0)``).  Like a JAX key the generator is only read, never
    advanced: the same generator gives the same run again."""
    return 0 if generator is None else generator.initial_seed() & _M64


class GeodesicResult(NamedTuple):
    omega: torch.Tensor       # (B, K, D) optimized parameters
    energy: torch.Tensor      # (B,) final energy, exact float32
    lengths: torch.Tensor     # (B,) sqrt(energy)
    energy_history: Optional[torch.Tensor] = None  # (steps, B) if recorded
    # early stopping: the Adam steps run, and the best energies as the
    # trajectory tracked them (at the trajectory's rung and grid)
    steps_run: Optional[int] = None
    traj_energy: Optional[torch.Tensor] = None


def _energy_fn(mode: str, decoders, gamma, seed: int = 0, mc_samples: int = 2,
               num_active=None, kernel_precision: str = "f32x3",
               mc_inkernel_rng: bool = True, grad_only: bool = False,
               ep_axis: Optional[str] = None, mesh=None, gamma_dot=None,
               target_num_t: Optional[int] = None):
    """Per-spline energies (B,) of curve points gamma (T, B, D).
    ``decoders`` is the stacked ensemble, or one decoder for ``single`` and
    ``jvp``.  ``seed`` is the step's draw of the MC modes.  ``ep_axis``
    names the axis of ``mesh`` that the decoder ensemble is sharded over
    (``decoders`` is then this rank's local subset); only
    ``expected_fused*`` reads it.  ``gamma_dot``: the curve velocity
    (T, B, D), for the ``jvp*`` modes; ``target_num_t``: the resolution
    ``jvp_ensemble`` and ``expected_rescaled`` carry their terms to."""
    if mode == "single":
        return energy_lib.energy_single(decoders, gamma)
    # no fused JVP kernel, as in the JAX package: the exact metric costs
    # about twice a first-difference point and the rescaling, not the
    # fusion, is the gain (its experiment/jvp_speed_probe.json)
    if mode == "jvp":
        return energy_lib.energy_jvp(decoders, gamma, gamma_dot)
    if mode == "jvp_ensemble":
        return energy_lib.energy_jvp_ensemble(decoders, gamma, gamma_dot,
                                              target_num_t, num_active)
    if mode == "expected_rescaled":
        if target_num_t is None:
            raise ValueError("energy mode 'expected_rescaled' requires "
                             "energy.target_num_t")
        return energy_lib.energy_expected_rescaled(decoders, gamma,
                                                   target_num_t, num_active)
    if mode in ("single_fused", "single_fused_bf16"):
        # the expected kernel with an M=1 ensemble IS the single-decoder
        # energy (its statistics reduce to direct segment differences)
        stacked = tree_map(lambda x: x[None], decoders)
        precision = "bfloat16" if mode.endswith("bf16") else kernel_precision
        fn = (energy_fused.energy_expected_fused_grad if grad_only
              else energy_fused.energy_expected_fused)
        return fn(stacked, gamma, None, precision)
    if mode in ("mc", "mc_scan"):
        gen = torch.Generator(device=gamma.device).manual_seed(seed)
        fn = (energy_lib.energy_mc if mode == "mc"
              else energy_lib.energy_mc_scan)
        return fn(decoders, gamma, gen, mc_samples, num_active)
    if mode in ("mc_fused", "mc_fused_bf16"):
        # a shape the kernels do not take raises in their wrappers: there is
        # no fallback to the unfused estimator
        precision = "bfloat16" if mode.endswith("bf16") else kernel_precision
        T, B, _ = gamma.shape
        m_dec = decoders["layers"][0]["w"].shape[0]
        if mc_inkernel_rng:
            # the draws are made inside the kernels (on the CPU: the same
            # draws, made by philox_draws): no index planes in device memory
            kmax = m_dec if num_active is None else num_active
            fn = (energy_mc_fused.energy_mc_fused_rng_grad if grad_only
                  else energy_mc_fused.energy_mc_fused_rng)
            return fn(decoders, gamma, seed, kmax, mc_samples, precision)
        gen = torch.Generator(device=gamma.device).manual_seed(seed)
        d1, d2 = energy_lib.sample_decoder_indices(
            gen, T, B, m_dec, mc_samples, num_active)
        fn = (energy_mc_fused.energy_mc_fused_grad if grad_only
              else energy_mc_fused.energy_mc_fused)
        # the sampler keeps its planes in range: no device read to check
        return fn(decoders, gamma, d1, d2, precision, check_range=False)
    if mode == "expected":
        return energy_lib.energy_expected(decoders, gamma, num_active)
    if mode in ("expected_fused", "expected_fused_bf16"):
        precision = "bfloat16" if mode.endswith("bf16") else kernel_precision
        m_dec = decoders["layers"][0]["w"].shape[0]
        B = gamma.shape[1]
        if ep_axis is not None:
            # decoder axis sharded over the mesh: per-shard statistics and
            # two all-reduces; no grad-only variant (the value path carries
            # the all-reduces), and a shape the stats kernels do not take
            # raises in their wrappers: there is no fallback
            m_total = m_dec * mesh.size(ep_axis)
            wmb = (energy_fused.active_weights_local(
                       num_active, m_total, m_dec, B, mesh.index(ep_axis),
                       gamma.device)
                   if num_active is not None
                   else energy_fused.uniform_weights_local(
                       m_total, m_dec, B, gamma.device))
            return energy_fused.energy_expected_sharded(
                decoders, gamma, wmb, mesh.group(ep_axis), precision)
        wmb = (energy_fused.active_weights(num_active, m_dec, B, gamma.device)
               if num_active is not None else None)
        fn = (energy_fused.energy_expected_fused_grad if grad_only
              else energy_fused.energy_expected_fused)
        return fn(decoders, gamma, wmb, precision)
    raise ValueError(f"unknown energy mode {mode!r} (the PyTorch port "
                     f"supports {', '.join(ENERGY_MODES)})")


# The modes whose kernels (energy_fused.energy_expected_fused) take the
# decoders with their BatchNorms folded.
_FOLDED_MODES = ("expected_fused", "expected_fused_bf16", "single_fused",
                 "single_fused_bf16")


def make_loss_fn(decoders, basis, cfg: GeodesicConfig, device,
                 grad_only: bool = False, mesh=None) -> Callable:
    """loss(omega, a, b, seed=0, num_active=None) -> (scalar_loss,
    per_spline_energy).  ``seed``: the step's draw of the MC modes.

    ``grad_only=True``: the fused modes return zeros as energy values while
    their gradient is unchanged (the forward kernel never runs).  The total
    is linear in the energies, which is what makes that sound.

    With ``cfg.energy.ep_axis`` set (an axis of ``mesh``) the scalar loss is
    divided by the axis size: the backward of an all-reduce inside the loss
    is an all-reduce, so a consumer replicated over the axis would contribute
    its cotangent once PER RANK.  The scaling makes each rank's gradient a
    true partial; the optimizer all-reduces the gradients over the axis for
    the exact global gradient.  The reported energies stay unscaled."""
    e_cfg = cfg.energy
    ep_size = _ep_size(e_cfg.ep_axis, mesh)
    if e_cfg.mode in _FOLDED_MODES:
        # the fused expected kernels take scVI's eval-mode BatchNorms folded
        # into the layers before them: once here, not on every step
        decoders = fold_batchnorm(decoders)
    t = t_grid(e_cfg.num_t, device)
    phi = design_matrix(t, basis, cfg.spline.n_poly)
    needs_vel = e_cfg.mode.startswith("jvp")
    dphi = (design_matrix_derivative(t, basis, cfg.spline.n_poly)
            if needs_vel else None)
    t_end = torch.ones(1, dtype=torch.float32, device=device)
    phi_end = design_matrix(t_end, basis, cfg.spline.n_poly)

    def loss(omega, a, b, seed=0, num_active=None):
        gamma = eval_spline_design(omega, a, b, phi, t)
        gamma_dot = (eval_spline_velocity(omega, a, b, dphi)
                     if needs_vel else None)
        e = _energy_fn(e_cfg.mode, decoders, gamma, seed, e_cfg.mc_samples,
                       num_active, e_cfg.kernel_precision,
                       e_cfg.mc_inkernel_rng, grad_only, e_cfg.ep_axis, mesh,
                       gamma_dot, e_cfg.target_num_t)
        # endpoint penalty (reference src/optimize.py:158-160): zero in exact
        # arithmetic (the basis enforces offset(1)=0), kept for faithful
        # gradients under float32
        gamma_end = eval_spline_design(omega, a, b, phi_end, t_end)
        ep = ((gamma_end[0] - b) ** 2).sum(-1)
        per_spline = e + e_cfg.endpoint_weight * ep
        total = per_spline.sum()
        if e_cfg.ep_axis is not None:
            total = total / ep_size
        return total, e

    return loss


def _ep_size(ep_axis: Optional[str], mesh) -> int:
    """Size of the mesh axis the decoders are sharded over (1 unsharded)."""
    if ep_axis is None:
        return 1
    if mesh is None:
        raise ValueError(f"energy.ep_axis={ep_axis!r} names a mesh axis: "
                         "pass the mesh (parallel.mesh.make_mesh)")
    return mesh.size(ep_axis)


def _traj_cfg(cfg: GeodesicConfig) -> GeodesicConfig:
    """Config the Adam loop optimizes under: ``traj_num_t`` (when set)
    replaces the quadrature resolution for the trajectory only."""
    if cfg.traj_num_t is None:
        return cfg
    return dataclasses.replace(
        cfg, energy=dataclasses.replace(cfg.energy, num_t=cfg.traj_num_t))


def _phase_cfgs(cfg: GeodesicConfig) -> list:
    """Phases the Adam loop runs, each with its own step count, quadrature
    resolution and schedule: ``phase_plan`` entries (steps, num_t,
    lr_schedule, lr[, energy_mode]) win outright; else a coarse
    ``traj_num_t`` phase plus a full-resolution constant-lr polish when both
    ``traj_num_t`` and ``polish_steps`` are set; else one phase."""
    if cfg.phase_plan:
        phases = []
        for i, entry in enumerate(cfg.phase_plan):
            try:
                s, T, sched, lr, *rest = entry
                if len(rest) > 1:
                    raise ValueError
                mode = rest[0] if rest else cfg.energy.mode
            except (TypeError, ValueError):
                raise ValueError(
                    f"phase_plan[{i}] must be a (steps, num_t, lr_schedule, "
                    f"lr[, energy_mode]) tuple, got {entry!r}") from None
            if int(s) < 1 or int(T) < 2 or float(lr) <= 0.0:
                raise ValueError(
                    f"phase_plan[{i}]={entry!r}: need steps >= 1, "
                    "num_t >= 2, lr > 0")
            phases.append(dataclasses.replace(
                cfg, steps=int(s), lr=float(lr), lr_schedule=sched,
                traj_num_t=None, polish_steps=0, phase_plan=None,
                energy=dataclasses.replace(cfg.energy, num_t=int(T),
                                           mode=str(mode))))
        return phases
    coarse = _traj_cfg(cfg)
    if cfg.traj_num_t is None or cfg.polish_steps <= 0:
        return [coarse]
    polish = dataclasses.replace(
        cfg, steps=cfg.polish_steps, lr=cfg.polish_lr,
        lr_schedule="constant", traj_num_t=None)
    return [coarse, polish]


def _exact_cfg(cfg: GeodesicConfig) -> GeodesicConfig:
    """Config of the final re-evaluation: always float32, full
    ``energy.num_t``, same-T semantics (``target_num_t`` cleared),
    ``final_energy_mode`` when set — reduced rungs, coarse grids and the
    rescaled or JVP modes only steer the trajectory, never the reported
    numbers.  ``expected_rescaled`` with r = 1 IS ``expected``."""
    mode = (cfg.final_energy_mode or cfg.energy.mode).removesuffix("_bf16")
    if mode == "expected_rescaled":
        mode = "expected"
    return dataclasses.replace(
        cfg, energy=dataclasses.replace(
            cfg.energy, mode=mode, target_num_t=None,
            kernel_precision="float32"))


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine to
    ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError("the cosine schedule requires decay_steps > "
                         f"warmup_steps, got {decay_steps} <= {warmup_steps}")

    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return sched


class Adam:
    """optax.adam: mu/nu moments with bias correction,
    update = -lr(count) * mu_hat / (sqrt(nu_hat) + eps), count from 0.

    ``params`` is one tensor (the spline parameters) or a list of tensors
    (a parameter tree's leaves, the trainers'); the list is updated with
    ``torch._foreach`` ops, a few launches for every leaf at once, in
    optax's order of operations."""

    def __init__(self, lr: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params):
        if isinstance(params, torch.Tensor):
            return {"mu": torch.zeros_like(params),
                    "nu": torch.zeros_like(params), "count": 0}
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    def _scalars(self, state):
        """(lr, 1 - b1^t, 1 - b2^t) of the update that state's count
        makes, as float32 values."""
        count = state["count"] + 1
        return (float(np.float32(self.lr(state["count"]))),
                float(np.float32(1.0 - self.b1 ** count)),
                float(np.float32(1.0 - self.b2 ** count)))

    @torch.no_grad()
    def step(self, params, grad, state) -> None:
        """Update ``params`` in place."""
        if not isinstance(params, torch.Tensor):
            return self._step_leaves(params, grad, state)
        lr, c1, c2 = self._scalars(state)
        b1, b2 = self.b1, self.b2
        mu = state["mu"].mul_(b1).add_(grad, alpha=1.0 - b1)
        nu = state["nu"].mul_(b2).addcmul_(grad, grad, value=1.0 - b2)
        params.add_((mu / c1) / (torch.sqrt(nu / c2) + self.eps), alpha=-lr)
        state["count"] += 1

    def _step_leaves(self, params, grads, state) -> None:
        lr, c1, c2 = self._scalars(state)
        mu, nu = state["mu"], state["nu"]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)
        state["count"] += 1


def _make_opt(cfg: GeodesicConfig) -> Adam:
    if cfg.lr_schedule == "constant":
        return Adam(lambda count, lr=cfg.lr: lr)
    if cfg.lr_schedule == "cosine":
        # a phase shorter than the warmup would give a negative cosine span
        warmup = min(cfg.lr_warmup, max(cfg.steps // 4, 1))
        return Adam(warmup_cosine_decay(0.0, cfg.lr, warmup, cfg.steps,
                                        cfg.lr_end))
    raise ValueError(f"unknown lr_schedule: {cfg.lr_schedule!r} "
                     "(expected 'constant' or 'cosine')")


def optimize_splines(decoders, omega0, a, b, basis, cfg: GeodesicConfig,
                     record_history: bool = False, num_active=None,
                     device=None,
                     generator: Optional[torch.Generator] = None,
                     mesh=None) -> GeodesicResult:
    """Optimize a batch of splines jointly.

    decoders: stacked ensemble dict (one decoder for mode 'single'/
    'single_fused'), on ``device``.  omega0: (B, K, D); a, b: (B, D).
    ``generator`` names the random stream of the MC energy modes
    (:func:`root_seed`; default seed 0); the deterministic modes ignore it.
    Returned energies are re-evaluated at the FINAL omega (exact float32,
    full num_t; in an MC mode that is one more draw).
    ``mesh``: required when ``cfg.energy.ep_axis`` is set; ``decoders`` is
    then this rank's subset and every rank of that axis calls together
    (``parallel/shard.sharded_optimize_splines`` arranges both).
    """
    root = root_seed(generator)
    dev = resolve_device(device)
    ep_group = (mesh.group(cfg.energy.ep_axis)
                if _ep_size(cfg.energy.ep_axis, mesh) > 1 else None)
    omega = torch.as_tensor(omega0, dtype=torch.float32, device=dev).clone()
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    hists = []
    for i, pcfg in enumerate(_phase_cfgs(cfg)):
        grad_only = cfg.energy.gradonly_traj and not record_history
        loss_fn = make_loss_fn(decoders, basis, pcfg, dev, grad_only, mesh)
        opt = _make_opt(pcfg)
        state = opt.init(omega)
        phase_seed = fold_seed(root, 1 + i)
        with trace_annotation("opt.phase", phase=i, steps=pcfg.steps):
            for step in range(pcfg.steps):
                with trace_annotation("opt.step", device=dev, step=step):
                    om = omega.detach().requires_grad_(True)
                    with trace_annotation("opt.loss"):
                        total, e = loss_fn(om, a, b,
                                           fold_seed(phase_seed, step),
                                           num_active)
                    with trace_annotation("opt.backward"):
                        (grad,) = torch.autograd.grad(total, om)
                        # each ep rank's gradient covers only its decoder
                        # subset's share of the energy; the gradient of the
                        # replicated omega is the sum
                        grad = all_reduce_sum(grad, ep_group)
                    if record_history:
                        hists.append(e.detach())
                    with trace_annotation("opt.adam"):
                        opt.step(omega, grad, state)
    with torch.no_grad(), trace_annotation("opt.final"):
        exact_loss = make_loss_fn(decoders, basis, _exact_cfg(cfg), dev,
                                  mesh=mesh)
        _, e_final = exact_loss(omega, a, b, fold_seed(root, 0), num_active)
    return GeodesicResult(
        omega=omega, energy=e_final, lengths=torch.sqrt(e_final),
        energy_history=torch.stack(hists) if record_history else None)


def _optimize_early_stop(decoders, omega0, a, b, basis, cfg: GeodesicConfig,
                         num_active=None, block: int = 50, device=None,
                         generator: Optional[torch.Generator] = None
                         ) -> GeodesicResult:
    """Early stopping with per-spline best/patience tracking every step and
    a convergence check only every ``block`` steps (one host read per
    block): the run stops at the first block end where every spline has
    gone more than ``cfg.patience`` steps without a relative improvement
    above ``cfg.delta``.  The ``cfg.steps`` budget is exact: no step past it
    runs.  The restored omega is the one that ACHIEVED the best energy,
    i.e. before that step's update (the reference tracks and restores
    exactly these, ``src/single_decoder/optimize_energy.py:149-163``).

    Every step needs the energy value, so the fused modes launch their
    forward kernel on every step (no grad-only trajectory).  The MC modes
    draw step ``i`` from the stream ``optimize_splines`` gives step ``i``,
    so the trajectory is the fixed-step one up to the stop."""
    root = root_seed(generator)
    dev = resolve_device(device)
    loss_fn = make_loss_fn(decoders, basis, _traj_cfg(cfg), dev)
    opt = _make_opt(cfg)
    omega = torch.as_tensor(omega0, dtype=torch.float32, device=dev).clone()
    a = torch.as_tensor(a, dtype=torch.float32, device=dev)
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    state = opt.init(omega)
    with torch.no_grad():
        _, best_e = loss_fn(omega, a, b, fold_seed(root, 0), num_active)
    best_omega = omega.clone()
    patience = torch.zeros(omega.shape[0], dtype=torch.int32, device=dev)
    step_seed = fold_seed(root, 1)
    step = 0
    with trace_annotation("opt.phase", phase=0, steps=cfg.steps):
        while step < cfg.steps and int(patience.min()) <= cfg.patience:
            for i in range(step, min(step + block, cfg.steps)):
                with trace_annotation("opt.step", device=dev, step=i):
                    om = omega.detach().requires_grad_(True)
                    with trace_annotation("opt.loss"):
                        total, e = loss_fn(om, a, b, fold_seed(step_seed, i),
                                           num_active)
                    with trace_annotation("opt.backward"):
                        (grad,) = torch.autograd.grad(total, om)
                    e = e.detach()
                    improved = (best_e - e) / best_e > cfg.delta
                    best_e = torch.where(improved, e, best_e)
                    best_omega = torch.where(improved[:, None, None], omega,
                                             best_omega)
                    patience = torch.where(improved, 0, patience + 1)
                    with trace_annotation("opt.adam"):
                        opt.step(omega, grad, state)
            step = min(step + block, cfg.steps)
    # exact energies at the restored params (reduced rungs only steer)
    with torch.no_grad(), trace_annotation("opt.final"):
        exact_loss = make_loss_fn(decoders, basis, _exact_cfg(cfg), dev)
        _, e_final = exact_loss(best_omega, a, b, fold_seed(root, 0),
                                num_active)
    return GeodesicResult(omega=best_omega, energy=e_final,
                          lengths=torch.sqrt(e_final), steps_run=step,
                          traj_energy=best_e)


def optimize_spline_early_stopping(decoders, omega0, a, b, basis,
                                   cfg: GeodesicConfig, num_active=None,
                                   device=None,
                                   generator: Optional[torch.Generator] = None
                                   ) -> GeodesicResult:
    """Best-params-restoring early-stopped optimization, batched over B
    with per-spline patience counters (:func:`_optimize_early_stop`).
    Returned energies are exact float32 at the restored omega."""
    if cfg.phase_plan or (cfg.traj_num_t is not None and cfg.polish_steps > 0):
        raise ValueError(
            "early stopping and the multi-phase fast recipes (traj_num_t + "
            "polish_steps, or phase_plan) are mutually exclusive — pick one")
    return _optimize_early_stop(decoders, omega0, a, b, basis, cfg,
                                num_active, device=device,
                                generator=generator)
