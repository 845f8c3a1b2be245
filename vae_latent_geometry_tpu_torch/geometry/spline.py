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


def _segment_powers(t: torch.Tensor, n_poly: int):
    """Segment index (T,) and local monomials [1, u, u^2, u^3] (T, 4) with
    u = t*n_poly - seg_idx."""
    seg_idx = torch.clamp(torch.floor(t * n_poly).to(torch.int64),
                          0, n_poly - 1)
    u = t * n_poly - seg_idx.to(t.dtype)
    u2 = u * u
    powers = torch.stack([torch.ones_like(u), u, u2, u2 * u], dim=1)
    return seg_idx, powers


def design_matrix(t: torch.Tensor, basis, n_poly: int = 4) -> torch.Tensor:
    """Phi(t): (T, K) float32 on ``t``'s device."""
    basis = torch.as_tensor(basis, dtype=torch.float32, device=t.device)
    K = basis.shape[1]
    seg_idx, powers = _segment_powers(t, n_poly)
    seg_rows = basis.reshape(n_poly, 4, K)[seg_idx]            # (T, 4, K)
    return torch.einsum("ti,tik->tk", powers, seg_rows)


def eval_spline_design(omega, a, b, phi, t):
    """omega: (B, K, D), a/b: (B, D), phi: (T, K), t: (T,) -> (T, B, D)."""
    t = t[:, None, None]
    linear = (1.0 - t) * a[None] + t * b[None]
    offset = torch.einsum("tk,bkd->tbd", phi, omega)
    return linear + offset
