"""Plain reference of the geodesic cells on scVI's decoder, in plain PyTorch.

It imports nothing of the program under test and no JAX.  The curves, the
quadrature grid, the design matrix, Adam, the precisions and the rung
arithmetic are ``reference.py``'s; this file adds scVI's decoder and the
energy, lengths and optimization through it.

The decoder is scvi-tools' ``DecoderSCVI`` (``scvi/nn/_base_components.py``)
with the ``SCVI`` model's defaults (n_latent 10, n_hidden 128, n_layers 1,
``use_batch_norm="both"``, ``use_layer_norm="none"``), as published:

    h = ReLU(BatchNorm1d(z W1 + b1)),   BatchNorm in eval mode: explicit,
        (a - running_mean) / sqrt(running_var + eps) * gamma + beta
    mu(z) = L softmax(h W2 + b2)        (``px_rate = exp(library) px_scale``)

Departures from scVI, each also in the configuration's ``assumed``:

- only the rate mu(z) is decoded: the dispersion and ``px_dropout`` heads
  play no part in the metric;
- no batch covariate is injected (n_batch 0);
- L is one fixed library size (counts per 10k), not a per-cell one;
- the weights, running statistics and affine parameters are drawn from the
  run's seed, not trained; ten decoders are drawn independently (the
  reference repository's decoder ensemble; scVI trains one decoder);
- dropout is off (eval mode), as for every decode of a trained model.

Decoders are dicts: ``layers`` [(W1 (M, D, H), b1 (M, H)), (W2 (M, H, G),
b2 (M, G))], ``norm`` {mean, var, scale, bias: (M, H)}, ``eps`` and
``library`` (numbers).  TF32 is off for matmuls and cuDNN; the ``tf32``
precision rounds each product's operands itself (``reference.matmul``).
"""

from __future__ import annotations

from typing import Optional

import torch

from geobench import reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def decode(dec: dict, z: torch.Tensor, prec: str,
           rung: Optional[str] = None) -> torch.Tensor:
    """Every member on points z (N, D): (M, N, G), in ``prec``'s type.  At a
    ``rung`` (``reference._RungLayer``): the first layer exact, the product
    with W2 in the rung's bf16 parts and its chain in bfloat16, every sum
    exact.  At ``bfloat16`` every weight a decode multiplies by is rounded
    to bfloat16: W2, and for the first layer W1 k, W1 times the
    BatchNorm's scale k = gamma / sqrt(var + eps) as the two act on z
    together (rounded, then k divided out again before the explicit
    BatchNorm)."""
    dt = reference.real(prec)
    (w1, b1), (w2, b2) = [(w.to(dt), b.to(dt)[:, None, :])
                          for w, b in dec["layers"]]
    M = w1.shape[0]
    n = {k: v.to(dt)[:, None, :] for k, v in dec["norm"].items()}
    k = n["scale"] / torch.sqrt(n["var"] + dec["eps"])
    h = z.to(dt).unsqueeze(0).expand(M, -1, -1)
    if rung is None:
        h = reference.matmul(h, w1, prec).to(dt) + b1
    elif rung == "bfloat16":
        h = h @ (reference._bf16(w1 * k) / k) + b1
    else:
        h = h @ w1 + b1
    h = torch.relu((h - n["mean"]) * k + n["bias"])
    if rung is None:
        u = reference.matmul(h, w2, prec).to(dt) + b2
    else:
        u = reference._RungLayer.apply(h, w2, rung) + b2
    return dec["library"] * torch.softmax(u, dim=-1)


def expected_energy(dec, gamma, prec: str, rung=None) -> torch.Tensor:
    """sum_t |xbar_{t+1} - xbar_t|^2 + var_{t+1} + var_t over the ensemble:
    gamma (T, P, D) -> (P,)."""
    T, P, D = gamma.shape
    x = decode(dec, gamma.reshape(T * P, D), prec, rung)
    x = x.reshape(x.shape[0], T, P, -1)
    xbar = x.mean(0)
    var = ((x - xbar[None]) ** 2).sum(-1).mean(0)
    step = xbar[1:] - xbar[:-1]
    return ((step * step).sum(-1) + var[1:] + var[:-1]).sum(0)


def final_lengths(dec, omega, a, b, basis, T: int, prec: str,
                  n_poly: int = 4, block: int = 4) -> torch.Tensor:
    """sqrt of each spline's expected energy, in blocks of splines."""
    dev = omega.device
    t = reference.t_grid(T, dev)
    phi = reference.design(t, basis, n_poly)
    dt = reference.real(prec)
    out = []
    with torch.no_grad():
        for s in range(0, omega.shape[0], block):
            g = reference.curve(omega[s:s + block].to(dt),
                                a[s:s + block].to(dt), b[s:s + block].to(dt),
                                phi, t)
            out.append(torch.sqrt(expected_energy(dec, g, prec)).double())
    return torch.cat(out)


class Loss(reference.Loss):
    """``reference.Loss`` with scVI's decoder: expected energy + the
    endpoint penalty, in float64; ``rung``: the decodes in a reduced rung's
    arithmetic."""

    def __init__(self, dec, a, b, basis, T: int, rung: Optional[str] = None,
                 endpoint_weight: float = 1000.0, n_poly: int = 4):
        super().__init__(dec["layers"], a, b, basis, T, "expected",
                         endpoint_weight, n_poly, rung)
        self.dec = dec

    def grad(self, omega: torch.Tensor, draws=None) -> torch.Tensor:
        om = omega.detach().double().requires_grad_(True)
        g = reference.curve(om, self.a, self.b, self.phi, self.t)
        e = expected_energy(self.dec, g, "float64", self.rung)
        end = reference.curve(om, self.a, self.b, self.phi1, self.t1)[0]
        loss = (e + self.weight * ((end - self.b) ** 2).sum(-1)).sum()
        return torch.autograd.grad(loss, om)[0]


def optimize(dec, omega0, a, b, basis, T: int, steps: int,
             lr: float) -> torch.Tensor:
    """Adam on omega (P, K, D) from omega0 for ``steps`` steps in float64;
    returns the final omega."""
    loss = Loss(dec, a, b, basis, T)
    omega = omega0.double().clone()
    opt = reference.Adam(lr)
    for _ in range(steps):
        opt.step(omega, loss.grad(omega))
    return omega
