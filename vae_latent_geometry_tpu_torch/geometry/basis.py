"""Constraint nullspace basis for fixed-endpoint piecewise-cubic splines.

A copy of ``vae_latent_geometry_tpu.geometry.basis`` (host float64 numpy):
the offset of a curve from the straight line is a piecewise cubic with
``n_poly`` segments whose 4*n_poly raw coefficients are constrained to
offset(0) = offset(1) = 0 and C0/C1/C2 continuity at the internal knots.
The free parameters ``omega`` live in the nullspace of that constraint
matrix; ``basis`` maps omega to raw coefficients (float64 SVD with relative
rank cutoff 1e-10, then QR, returned as float32).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def constraint_matrix(n_poly: int) -> np.ndarray:
    """C with shape (2 + 3*(n_poly-1), 4*n_poly), float64; rows are
    [offset(0)=0, offset(1)=0, then per internal knot C0, C1, C2]."""
    if n_poly < 1:
        raise ValueError("n_poly must be >= 1")
    ncoef = 4 * n_poly
    rows = []
    b0 = np.zeros(ncoef)
    b0[0] = 1.0
    b1 = np.zeros(ncoef)
    b1[-4:] = 1.0
    rows += [b0, b1]

    # continuity rows at internal knots, local coordinates tL=1, tR=0
    tL, tR = 1.0, 0.0
    mono = lambda t: np.array([1.0, t, t**2, t**3])
    dmono = lambda t: np.array([0.0, 1.0, 2.0 * t, 3.0 * t**2])
    d2mono = lambda t: np.array([0.0, 0.0, 2.0, 6.0 * t])
    for i in range(n_poly - 1):
        si = 4 * i
        for m in (mono, dmono, d2mono):
            row = np.zeros(ncoef)
            row[si:si + 4] = m(tL)
            row[si + 4:si + 8] = -m(tR)
            rows.append(row)
    return np.stack(rows).astype(np.float64)


def _nullspace(C: np.ndarray, rtol: float = 1e-10) -> np.ndarray:
    U, S, Vh = np.linalg.svd(C, full_matrices=True)
    rank = int((S > rtol * S[0]).sum())
    return np.ascontiguousarray(Vh.T[:, rank:])


@lru_cache(maxsize=None)
def nullspace_basis(n_poly: int) -> tuple[np.ndarray, np.ndarray]:
    """(basis, C) as float32; ``basis`` is (4*n_poly, n_poly + 1) with
    orthonormal columns spanning the nullspace of C."""
    C = constraint_matrix(n_poly)
    ns = _nullspace(C)
    basis, _ = np.linalg.qr(ns)
    expected_k = n_poly + 1
    if basis.shape != (4 * n_poly, expected_k):
        raise RuntimeError(
            f"nullspace basis has shape {basis.shape}, expected "
            f"({4 * n_poly}, {expected_k})")
    resid = float(np.linalg.norm(C @ basis))
    if resid > 1e-8:
        raise RuntimeError(f"||C @ basis|| = {resid:.2e} too large")
    return basis.astype(np.float32), C.astype(np.float32)
