"""Batched fixed-endpoint spline curves.

The curve family is linear in its free parameters omega:

    gamma_b(t) = (1-t) a_b + t b_b + Phi(t) @ omega_b,        omega_b: (K, D)

with ``Phi(t)`` the (T, K) design matrix combining segment lookup, local
monomials and the constraint-nullspace basis, so curve evaluation is one
contraction.  Arithmetic follows ``vae_latent_geometry_tpu.geometry.spline``
in float32, including the t-grid (:func:`t_grid` reproduces
``jnp.linspace(0, 1, T)`` bit for bit).
"""

from __future__ import annotations

import torch


def t_grid(T: int, device=None) -> torch.Tensor:
    """(T,) float32 sample points in [0, 1]: ``i * float32(1 / (T - 1))``
    with the last point exactly 1, bit-identical to ``jnp.linspace``
    (``torch.linspace`` rounds its second half differently)."""
    if T == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.tensor(1.0 / (T - 1), dtype=torch.float32)
    t = torch.arange(T, dtype=torch.float32) * step
    t[-1] = 1.0
    return t.to(device)


def _segment_powers(t: torch.Tensor, n_poly: int, deriv: int = 0):
    """Segment index (T,) and local monomials [1, u, u^2, u^3] (T, 4) with
    u = t*n_poly - seg_idx, or their ``deriv``-th derivative in t (the
    chain-rule factor n_poly**deriv included)."""
    seg_idx = torch.clamp(torch.floor(t * n_poly).to(torch.int64),
                          0, n_poly - 1)
    u = t * n_poly - seg_idx.to(t.dtype)
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    if deriv == 0:
        u2 = u * u
        powers = torch.stack([one, u, u2, u2 * u], dim=1)
    elif deriv == 1:
        powers = torch.stack([zero, one, 2.0 * u, 3.0 * (u * u)],
                             dim=1) * n_poly
    elif deriv == 2:
        powers = torch.stack([zero, zero, 2.0 * one, 6.0 * u],
                             dim=1) * n_poly ** 2
    else:
        raise ValueError(f"deriv={deriv} not supported")
    return seg_idx, powers


def _design(t: torch.Tensor, basis, n_poly: int, deriv: int) -> torch.Tensor:
    basis = torch.as_tensor(basis, dtype=torch.float32, device=t.device)
    K = basis.shape[1]
    seg_idx, powers = _segment_powers(t.reshape(-1), n_poly, deriv)
    seg_rows = basis.reshape(n_poly, 4, K)[seg_idx]            # (T, 4, K)
    return torch.einsum("ti,tik->tk", powers, seg_rows).reshape(*t.shape, K)


def design_matrix(t: torch.Tensor, basis, n_poly: int = 4) -> torch.Tensor:
    """Phi(t): (..., K) float32 on ``t``'s device, for ``t`` of any shape
    (a (T,) grid, or (B, P) per-path sample points)."""
    return _design(t, basis, n_poly, 0)


def design_matrix_derivative(t: torch.Tensor, basis, n_poly: int = 4,
                             order: int = 1) -> torch.Tensor:
    """dPhi/dt (``order`` 1) or d2Phi/dt2 (``order`` 2), shaped as
    :func:`design_matrix`."""
    return _design(t, basis, n_poly, order)


def eval_spline_design(omega, a, b, phi, t):
    """omega: (B, K, D), a/b: (B, D), phi: (T, K), t: (T,) -> (T, B, D)."""
    t = t[:, None, None]
    linear = (1.0 - t) * a[None] + t * b[None]
    offset = torch.einsum("tk,bkd->tbd", phi, omega)
    return linear + offset


def eval_spline_velocity(omega, a, b, dphi):
    """d gamma / dt through the design-matrix derivative: omega (B, K, D),
    a/b (B, D), dphi (T, K) -> (T, B, D)."""
    return (b - a)[None] + torch.einsum("tk,bkd->tbd", dphi, omega)


def eval_spline(omega, a, b, basis, t, n_poly: int = 4):
    """Curve points the reference's way (``src/optimize.py:22-35``): raw
    coefficients (n_poly, 4, B, D), the segment's four picked per t, local
    powers, plus the straight line.  omega (B, K, D), a/b (B, D), basis
    (4*n_poly, K), t (T,) -> (T, B, D)."""
    B, K, D = omega.shape
    basis = torch.as_tensor(basis, dtype=omega.dtype, device=omega.device)
    coeffs = torch.einsum("nk,bkd->nbd", basis, omega).reshape(n_poly, 4,
                                                                 B, D)
    seg_idx, powers = _segment_powers(t, n_poly)
    poly = torch.einsum("ti,tibd->tbd", powers, coeffs[seg_idx])
    t = t[:, None, None]
    return (1.0 - t) * a[None] + t * b[None] + poly


def fit_spline_lstsq(paths, mask, a, b, phi, t, ridge: float = 0.0):
    """Closed-form least-squares fit of omega to (padded, masked) target
    paths, batched: the ridge solution with an unconditional
    1e-6-of-mean-trace floor on the normal equations, i.e. the exact
    minimizer up to a ~1e-6 relative perturbation on well-posed systems,
    and the minimum-norm omega = 0 on degenerate ones (a two-point path,
    where the Gram matrix is exactly singular) with no data-dependent
    branching.  Replaces the reference's per-pair LBFGS init fit
    (``src/init_splines_ensemble.py:183-192``).

    paths: (B, P, D) padded target points;  mask: (B, P) validity
    a, b: (B, D) endpoints;  phi: (B, P, K) or (P, K);  t: (B, P) or (P,)
    Returns omega: (B, K, D).
    """
    mask = mask.to(paths.dtype)
    if t.ndim == 1:
        t = t[None].expand(paths.shape[:2])
    if phi.ndim == 2:
        phi = phi[None].expand(*paths.shape[:2], phi.shape[-1])
    tt = t[..., None]
    lerp = (1.0 - tt) * a[:, None, :] + tt * b[:, None, :]
    resid = (paths - lerp) * mask[..., None]                  # (B, P, D)
    phi_m = phi * mask[..., None]                             # (B, P, K)
    # normal equations per batch: (K, K) and (K, D); K is tiny (n_poly + 1)
    gram = torch.einsum("bpk,bpl->bkl", phi_m, phi_m)
    K = gram.shape[-1]
    trace = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)[:, None, None]
    eps = (ridge + 1e-6) * (trace / K + 1e-6)
    gram = gram + eps * torch.eye(K, dtype=gram.dtype, device=gram.device)
    rhs = torch.einsum("bpk,bpd->bkd", phi_m, resid)
    return torch.linalg.solve(gram, rhs)
