"""Transposed-layout fused expected energy: the port of
``ops/_research/energy_pallas_t.py``.

Two entry points, each beside a plain PyTorch version of the same function:

- :func:`energy_t_fwd` (K9, replaces ``energy_pallas_t.py:119
  _fwd_kernel_T``): (T, B, D) curve -> (B,) expected energies with uniform
  ensemble weights, the statistics centred on decoder 0;
- :func:`energy_t_bwd` (K10, ``:193 _bwd_kernel_T``): dgamma for a
  per-spline cotangent.

Both are K1's and K2's function on the uniform weight plane, and on the
card they run K1's and K2's kernels (``energy_fused.energy_fwd`` and
``energy_bwd``, counted there), K10 with float32 W1 in the dgamma product.
The TPU kernels put the weights on the left and the points along the wide
dimension (the TPU layout); on the TPU this layout measured slower than the
production kernels (``energy_pallas_t.py:13-27``).  The op is kept with its
shape rule as the JAX package's research op, checked on the card by
``chip_smoke.py`` (phase ``transposed``), and not dispatched by the
optimizer.

Precision rungs as in the JAX op: the decode's products follow
``_mp_dot_T`` (w.h_hi + w.h_lo, + w_lo.h_hi at f32x3; one bf16 pass at
bfloat16, where the first-layer weights are shipped as bf16 too); the
backward chain is single-pass bf16 under f32x3/f32x2 and the dgamma product
always uses float32 W1.  The TPU's padding of B to 256 lanes is tiling, not
semantics: the port returns exactly the B splines given.

A CUDA tensor launches the kernel or raises; only a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import torch

from vae_latent_geometry_tpu_torch.ops.energy_fused import (
    _decode_plain,
    _mp_matmul,
    check_precision,
    energy_bwd,
    energy_fwd,
    energy_fwd_plain,
    ship_weights,
    stack_weights,
    uniform_weights,
)

_BB = 256              # the JAX op's lane block: only its shape rule reads it


def _pick_tc(T: int, Bb: int = _BB, target_lanes: int = 10240) -> int:
    """The JAX op's T-chunk (``energy_pallas_t._pick_tc``): the largest
    divisor of T with Tc * Bb lanes under the target, preferring multiples
    of 8.  Only :func:`fused_t_fits` reads it."""
    best, best_aligned = 1, 0
    for tc in range(1, T + 1):
        if T % tc == 0 and tc * Bb <= target_lanes:
            best = tc
            if tc % 8 == 0:
                best_aligned = tc
    return best_aligned or best


def fused_t_fits(T, B, D, X, M, num_active=None, wmb=None,
                 n_layers: int = 3) -> bool:
    """The op's shape rule, the same booleans as the JAX package's: uniform
    weights only, the 3-layer reference decoder, D <= 2, X <= 128, M <= 16,
    and T must split into 8-aligned chunks of at most 40 rows (``_pick_tc``).
    The CUDA kernels take these at any hidden width and any B."""
    if num_active is not None or wmb is not None or n_layers != 3:
        return False
    if D > 2 or X > 128 or M > 16:
        return False
    Tc = _pick_tc(T, _BB)
    return Tc % 8 == 0 and T % Tc == 0


def _check_fits(ws, gamma):
    T, B, D = gamma.shape
    M, X = ws[0].shape[0], ws[-1].shape[-1]
    if not fused_t_fits(T, B, D, X, M, n_layers=len(ws)):
        raise ValueError(
            f"energy_expected_fused_t refuses shape (T={T}, B={B}, D={D}, "
            f"X={X}, M={M}, layers={len(ws)}): it takes 3-layer decoders, "
            "D <= 2, X <= 128, M <= 16, and a T that splits into 8-aligned "
            "chunks of at most 40 rows (T divisible by 8, 16, 24, 32 or 40; "
            "fused_t_fits has the rule)")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def energy_t_fwd_plain(ws, bs, gamma, precision):
    """Plain version of K9.  With uniform weights this is K1's function at
    every rung (both ship every weight, W1 included, as bf16 at the bfloat16
    rung), so it is K1's plain version on the uniform weight plane."""
    check_precision(precision)
    M, B = ws[0].shape[0], gamma.shape[1]
    return energy_fwd_plain(ws, bs, gamma,
                            uniform_weights(M, B, gamma.device), precision)


def energy_t_bwd_plain(ws, bs, gamma, ct, precision):
    """Plain version of K10: dgamma (T, B, D) of sum_b ct_b E_b.  The decode
    uses the shipped weights; the dgamma product float32 W1."""
    check_precision(precision)
    w1 = ws[0].float()
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    M = ws[0].shape[0]
    chain = "bfloat16" if precision in ("f32x3", "f32x2") else precision
    g = gamma.reshape(T * B, D)
    wm = torch.tensor(1.0 / M, dtype=torch.float32, device=gamma.device)
    decodes = [_decode_plain(g, ws, bs, m, precision) for m in range(M)]
    xbar = 0.0
    for x, _ in decodes:
        xbar = xbar + wm * x.reshape(T, B, -1)
    t = torch.arange(T, device=gamma.device)
    has_l = (t > 0).float()[:, None, None]
    has_r = (t < T - 1).float()[:, None, None]
    left = torch.zeros_like(xbar)
    left[1:] = xbar[:-1]
    right = torch.zeros_like(xbar)
    right[:-1] = xbar[1:]
    scale = (2.0 * wm * ct)[None, :, None]
    dg = torch.zeros((T * B, D), dtype=torch.float32, device=gamma.device)
    for m, (x, masks) in enumerate(decodes):
        dx = scale * ((has_l + has_r) * x.reshape(T, B, -1) - left - right)
        dh = dx.reshape(T * B, -1)
        for i in range(len(ws) - 1, 0, -1):
            dh = _mp_matmul(dh, ws[i][m].T, chain) * masks[i - 1]
        dg = dg + dh @ w1[m].T
    return dg.reshape(T, B, D)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def energy_t_fwd(ws, bs, gamma, precision):
    """K9: (T, B, D) curve -> (B,) expected energies (uniform weights), by
    K1 (its plain version on a CPU tensor)."""
    _check_fits(ws, gamma)
    M, B = ws[0].shape[0], gamma.shape[1]
    return energy_fwd(ws, bs, gamma, uniform_weights(M, B, gamma.device),
                      precision)


def energy_t_bwd(ws, bs, gamma, ct, precision):
    """K10: dgamma (T, B, D) of sum_b ct_b E_b, by K2 on the uniform plane
    with float32 W1 in the dgamma product (its plain version on a CPU
    tensor)."""
    _check_fits(ws, gamma)
    if gamma.device.type == "cpu":
        return energy_t_bwd_plain(ws, bs, gamma, ct, precision)
    M, B = ws[0].shape[0], gamma.shape[1]
    return energy_bwd(ws, bs, gamma, uniform_weights(M, B, gamma.device), ct,
                      precision, w1=ws[0].float().contiguous())


# ---------------------------------------------------------------------------
# differentiable entry point
# ---------------------------------------------------------------------------

class _EnergyExpectedFusedT(torch.autograd.Function):
    """K9 forward, K10 backward (it recomputes the decode from the inputs)."""

    @staticmethod
    def forward(ctx, gamma, ws, bs, precision):
        ctx.save_for_backward(gamma)
        ctx.ws, ctx.bs, ctx.precision = ws, bs, precision
        return energy_t_fwd(ws, bs, gamma, precision)

    @staticmethod
    def backward(ctx, ct):
        (gamma,) = ctx.saved_tensors
        dg = energy_t_bwd(ctx.ws, ctx.bs, gamma, ct.contiguous().float(),
                          ctx.precision)
        return dg, None, None, None


def energy_expected_fused_t(decoders, gamma, precision: str = "float32"):
    """Transposed-layout fused expected ensemble energy (uniform weights):
    (T, B, D) curve -> (B,) energies, differentiable in ``gamma`` only (the
    decoders get no gradient).  A shape outside :func:`fused_t_fits` raises.
    """
    ws, bs = stack_weights(decoders, "transposed (K9/K10)")
    ws = [w.detach() for w in ws]
    bs = [b.detach().contiguous() for b in bs]
    return _EnergyExpectedFusedT.apply(gamma.contiguous(), ws, bs, precision)
