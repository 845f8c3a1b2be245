"""Plain reference of what the benchmark's cells compute, in plain PyTorch.

It imports nothing of the program under test and takes nothing the program
made: it gets the benchmark's own inputs (weights, endpoints, initial spline
parameters, data) and works out again whatever the program derives from
them (the quadrature grid, the spline design matrix, the per-step random
streams, the Monte-Carlo decoder draws).

Semantics are those of the reference implementation the program ports
(johannefranck/vae-latent-geometry):

- curves: fixed-endpoint piecewise cubics, gamma(t) = (1-t) a + t b +
  Phi(t) omega, omega on the nullspace basis of the endpoint and C0/C1/C2
  constraints (``src/optimize.py:22-35``);
- energies: the expected ensemble energy sum_t ||xbar_{t+1} - xbar_t||^2 +
  var_{t+1} + var_t, its one-decoder case (first differences), the
  Monte-Carlo estimator on drawn decoder pairs (``src/optimize.py:38-75``)
  and the data-space arc length (``optimize_energy.py:167-172``);
- the optimizer: Adam(lr, 0.9, 0.999, 1e-8) on omega, loss = sum over
  splines of energy + 1000 ||gamma(1) - b||^2 (``src/optimize.py:143-186``).

Everything runs at a named precision: ``float64`` (the reference) or
``tf32`` (float32, with every product's operands rounded to TF32's 10-bit
mantissa: the final lengths of the control, one precision below the
float32 the configuration states for them).  A decode may also follow the
arithmetic of a reduced rung of the energy kernels (``rung``: ``f32x3``,
``f32x2``, ``bfloat16``, as ``GeodesicConfig.energy.kernel_precision``
names them), with every sum exact: the gradient the trajectory's rung
should give, to hold the program's first gradient to.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# random streams
# ---------------------------------------------------------------------------

def fold_seed(seed: int, data: int) -> int:
    """splitmix64's finalizer over seed + golden-ratio increment * (data + 1),
    shifted to 63 bits: how the program derives a stream's seed from its
    parent's (chunks, phases, steps, epochs)."""
    z = (seed + 0x9E3779B97F4A7C15 * (data + 1)) & M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return (z ^ (z >> 31)) >> 1


def _mul32(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b, a a 32-bit constant, b an int64
    tensor of 32-bit values, in int64 without overflow."""
    p_lo = a * (b & 0xFFFF)                       # < 2^48
    p_hi = a * (b >> 16)                          # < 2^48
    mid = p_lo + ((p_hi & 0xFFFF) << 16)          # < 2^49
    return (p_hi >> 16) + (mid >> 32), mid & M32


def philox4x32(k0, k1, c0, c1, c2, c3):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's constants) on int64
    tensors of 32-bit values; the keys broadcast against the counters."""
    for _ in range(10):
        hi0, lo0 = _mul32(0xD2511F53, c0)
        hi1, lo1 = _mul32(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def mc_draws(step_seeds: torch.Tensor, positions: torch.Tensor, T: int,
             S: int, M: int):
    """The decoder draws of the in-kernel Monte-Carlo estimator.

    step_seeds: (n, P) int64, the 63-bit seed of each step for each spline;
    positions: (P,) the spline's index in its launch.  Draw plane j in
    [0, 2S) at segment t is word j % 4 of Philox keyed by the seed at counter
    (t, position, j // 4, 0); u = (word >> 8) 2^-24 and d = floor(u M) in
    float32, below M.  Returns (d1, d2), each (n, S, T-1, P) int64: d1 draws
    the decoder of each segment's left end, d2 of its right end."""
    dev = step_seeds.device
    k0 = (step_seeds & M32)[:, None, :]
    k1 = (step_seeds >> 32)[:, None, :]
    t = torch.arange(T - 1, dtype=torch.int64, device=dev)[None, :, None]
    b = positions.to(dev, torch.int64)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = []
    for group in range(-(-2 * S // 4)):
        words += philox4x32(k0, k1, t, b, zero + group, zero)
    bits = torch.stack(words[:2 * S], 1)           # (n, 2S, T-1, P)
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    m = torch.tensor(float(M), dtype=torch.float32, device=dev)
    d = torch.minimum(torch.floor(u * m), m - 1).to(torch.int64)
    return d[:, :S], d[:, S:]


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest-even at TF32's 10-bit mantissa; the
    rounding passes the gradient through unchanged."""
    x = x.float()
    i = x.detach().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def matmul(h: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """h @ w at a precision, in its ``real`` type."""
    if prec == "float64":
        return h.double() @ w.double()
    if prec == "tf32":
        return _tf32(h) @ _tf32(w)
    raise ValueError(f"unknown precision {prec!r}")


def real(prec: str) -> torch.dtype:
    """The type a precision keeps its tensors in."""
    return torch.float64 if prec == "float64" else torch.float32


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (nearest-even), kept in its type."""
    return x.to(torch.bfloat16).to(x.dtype)


class _RungLayer(torch.autograd.Function):
    """h @ w of a layer past the first at a reduced rung of the energy
    kernels, each product of bfloat16 parts and summed exactly.  Forward:
    h and w split into a bfloat16 part and a bfloat16 remainder, h_hi w_hi +
    h_lo w_hi (``f32x2``), + h_hi w_lo (``f32x3``), or h and w rounded to
    bfloat16 (``bfloat16``).  The chain back to h at every reduced rung: the
    cotangent and w rounded to bfloat16."""

    @staticmethod
    def forward(ctx, h, w, rung):
        ctx.save_for_backward(w)
        w_hi = _bf16(w)
        if rung == "bfloat16":
            return _bf16(h) @ w_hi
        h_hi = _bf16(h)
        out = h_hi @ w_hi + _bf16(h - h_hi) @ w_hi
        if rung == "f32x3":
            out = out + h_hi @ _bf16(w - w_hi)
        return out

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return _bf16(g) @ _bf16(w).transpose(-1, -2), None, None


# ---------------------------------------------------------------------------
# networks: layers are (w (in, out), b (out,)) pairs, with a leading member
# axis for an ensemble
# ---------------------------------------------------------------------------

def decode(layers: Sequence, z: torch.Tensor, prec: str,
           rung: Optional[str] = None) -> torch.Tensor:
    """Every member of a ReLU MLP ensemble on points z (N, D): (M, N, X).
    At a ``rung`` the first layer is exact (its weights rounded to bfloat16
    at ``bfloat16``, where every weight is) and the others are
    :class:`_RungLayer`'s."""
    dt = real(prec)
    M = layers[0][0].shape[0]
    h = z.to(dt).unsqueeze(0).expand(M, -1, -1)
    for i, (w, b) in enumerate(layers):
        w, b = w.to(dt), b.to(dt)[:, None, :]
        if rung is None:
            h = matmul(h, w, prec).to(dt) + b
        elif i == 0:
            h = h @ (_bf16(w) if rung == "bfloat16" else w) + b
        else:
            h = _RungLayer.apply(h, w, rung) + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def mean_head(layers: Sequence, X: int) -> list:
    """A heteroscedastic decoder's mean head: the first X output columns."""
    w, b = layers[-1]
    return [*layers[:-1], (w[..., :X], b[..., :X])]


# ---------------------------------------------------------------------------
# curves
# ---------------------------------------------------------------------------

def nullspace_basis(n_poly: int = 4) -> np.ndarray:
    """(4 n_poly, n_poly + 1) float64 orthonormal basis of the offsets that
    vanish at both ends and are C0, C1, C2 at the inner knots."""
    mono = (lambda t: [1.0, t, t * t, t ** 3],
            lambda t: [0.0, 1.0, 2 * t, 3 * t * t],
            lambda t: [0.0, 0.0, 2.0, 6 * t])
    rows = []
    first = np.zeros(4 * n_poly)
    first[0] = 1.0
    last = np.zeros(4 * n_poly)
    last[-4:] = 1.0
    rows += [first, last]
    for k in range(n_poly - 1):
        for f in mono:
            r = np.zeros(4 * n_poly)
            r[4 * k:4 * k + 4] = f(1.0)
            r[4 * k + 4:4 * k + 8] = -np.asarray(f(0.0))
            rows.append(r)
    C = np.asarray(rows)
    _, s, vh = np.linalg.svd(C)
    rank = int((s > 1e-10 * s[0]).sum())
    q, _ = np.linalg.qr(vh[rank:].T)
    return q


def t_grid(T: int, device=None) -> torch.Tensor:
    """The quadrature points i / (T - 1) as float32 computes them (the
    float32 step times i, the last point 1), held in float64."""
    step = np.float32(1.0) / np.float32(T - 1)
    t = np.arange(T, dtype=np.float32) * step
    t[-1] = 1.0
    return torch.as_tensor(t.astype(np.float64), device=device)


def design(t: torch.Tensor, basis, n_poly: int = 4) -> torch.Tensor:
    """Phi(t): (T, K), the offset's value at t per basis column."""
    basis = torch.as_tensor(np.asarray(basis, np.float64), device=t.device)
    seg = torch.clamp(torch.floor(t * n_poly), 0, n_poly - 1)
    u = t * n_poly - seg
    powers = torch.stack([torch.ones_like(u), u, u * u, u ** 3], 1)
    rows = basis.reshape(n_poly, 4, -1)[seg.long()]       # (T, 4, K)
    return torch.einsum("ti,tik->tk", powers, rows)


def curve(omega, a, b, phi, t):
    """(T, P, D) points of the splines omega (P, K, D) between a and b."""
    tt = t.to(omega.dtype)[:, None, None]
    return ((1 - tt) * a[None] + tt * b[None]
            + torch.einsum("tk,pkd->tpd", phi.to(omega.dtype), omega))


# ---------------------------------------------------------------------------
# energies: gamma (T, P, D) -> (P,)
# ---------------------------------------------------------------------------

def expected_energy(layers, gamma, prec: str, rung=None) -> torch.Tensor:
    T, P, D = gamma.shape
    x = decode(layers, gamma.reshape(T * P, D), prec, rung)
    x = x.reshape(x.shape[0], T, P, -1)
    xbar = x.mean(0)
    var = ((x - xbar[None]) ** 2).sum(-1).mean(0)
    step = xbar[1:] - xbar[:-1]
    return ((step * step).sum(-1) + var[1:] + var[:-1]).sum(0)


def mc_energy(layers, gamma, d1, d2, prec: str, rung=None) -> torch.Tensor:
    """(1/S) sum_s sum_t ||x_{d2}(t+1) - x_{d1}(t)||^2; d1, d2 (S, T-1, P)."""
    T, P, D = gamma.shape
    x = decode(layers, gamma.reshape(T * P, D), prec, rung)
    x = x.reshape(x.shape[0], T, P, -1).permute(1, 2, 0, 3)   # (T, P, M, X)
    lo = torch.take_along_dim(x[:-1][None], d1[..., None, None], dim=3)
    hi = torch.take_along_dim(x[1:][None], d2[..., None, None], dim=3)
    diff = (hi - lo)[..., 0, :]
    return (diff * diff).sum(-1).mean(0).sum(0)


def arc_length(layers, gamma, prec: str) -> torch.Tensor:
    """sum_t ||f(gamma_{t+1}) - f(gamma_t)|| through member 0."""
    T, P, D = gamma.shape
    x = decode([(w[:1], b[:1]) for w, b in layers],
               gamma.reshape(T * P, D), prec)[0].reshape(T, P, -1)
    return torch.linalg.norm(x[1:] - x[:-1], dim=-1).sum(0)


# ---------------------------------------------------------------------------
# geodesic optimization
# ---------------------------------------------------------------------------

class Adam:
    """optax.adam on one tensor: bias-corrected moments, count from 1."""

    def __init__(self, lr: float, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, p: torch.Tensor, g: torch.Tensor) -> None:
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(p), torch.zeros_like(p)
        self.count += 1
        self.mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
        self.nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
        mu_hat = self.mu / (1 - self.b1 ** self.count)
        nu_hat = self.nu / (1 - self.b2 ** self.count)
        p.sub_(self.lr * mu_hat / (torch.sqrt(nu_hat) + self.eps))


def final_lengths(layers, omega, a, b, basis, T: int, kind: str,
                  prec: str, n_poly: int = 4, block: int = 64):
    """The reported length of each spline: sqrt of the expected energy
    (``kind`` "expected") or the data-space arc length ("arc"), in blocks of
    splines."""
    dev = omega.device
    t = t_grid(T, dev)
    phi = design(t, basis, n_poly)
    out = []
    with torch.no_grad():
        for s in range(0, omega.shape[0], block):
            dt = real(prec)
            g = curve(omega[s:s + block].to(dt), a[s:s + block].to(dt),
                      b[s:s + block].to(dt), phi, t)
            if kind == "arc":
                out.append(arc_length(layers, g, prec).double())
            else:
                out.append(torch.sqrt(expected_energy(layers, g, prec))
                           .double())
    return torch.cat(out)


class Loss:
    """The optimizer's loss of splines omega (P, K, D) between a and b, in
    float64: energy + ``endpoint_weight`` ||gamma(1) - b||^2 summed over
    the splines.  ``energy``: "expected", "single" (member 0 alone) or "mc"
    (the step's draws (d1, d2), each (S, T-1, P), passed to ``grad``);
    ``rung``: the decodes follow a reduced rung's arithmetic."""

    def __init__(self, layers, a, b, basis, T: int, energy: str,
                 endpoint_weight: float = 1000.0, n_poly: int = 4,
                 rung: Optional[str] = None):
        dev = a.device
        self.t = t_grid(T, dev)
        self.phi = design(self.t, basis, n_poly)
        self.t1 = torch.ones(1, dtype=torch.float64, device=dev)
        self.phi1 = design(self.t1, basis, n_poly)
        self.a, self.b = a.double(), b.double()
        self.layers = ([(w[:1], bb[:1]) for w, bb in layers]
                       if energy == "single" else layers)
        self.energy, self.weight, self.rung = energy, endpoint_weight, rung

    def grad(self, omega: torch.Tensor, draws=None) -> torch.Tensor:
        om = omega.detach().double().requires_grad_(True)
        g = curve(om, self.a, self.b, self.phi, self.t)
        if self.energy == "mc":
            e = mc_energy(self.layers, g, *draws, "float64", self.rung)
        else:
            e = expected_energy(self.layers, g, "float64", self.rung)
        end = curve(om, self.a, self.b, self.phi1, self.t1)[0]
        loss = (e + self.weight * ((end - self.b) ** 2).sum(-1)).sum()
        return torch.autograd.grad(loss, om)[0]


def optimize(layers, omega0, a, b, basis, T: int, steps: int, lr: float,
             energy: str, draws: Optional[Callable] = None) -> torch.Tensor:
    """Adam on omega (P, K, D) from omega0 for ``steps`` steps in float64;
    returns the final omega.  ``draws(i)``: step i's Monte-Carlo draws."""
    loss = Loss(layers, a, b, basis, T, energy)
    omega = omega0.double().clone()
    opt = Adam(lr)
    for i in range(steps):
        opt.step(omega, loss.grad(omega, draws(i) if draws else None))
    return omega
