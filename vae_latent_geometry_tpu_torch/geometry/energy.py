"""Plain curve-energy functionals (no custom kernels).

- ``energy_single``: discrete first-difference energy through one decoder,
  sum_i ||f(g_{i+1}) - f(g_i)||^2.
- ``energy_expected``: closed-form expectation of the reference's MC
  ensemble estimator in the centered, cancellation-free form
  ||xbar_{i+1} - xbar_i||^2 + var_{i+1} + var_i.
- ``geodesic_lengths``: data-space arc length through one decoder.

They mirror ``vae_latent_geometry_tpu.geometry.energy`` and are the
unfused modes ``single`` / ``expected``.  Inputs are curve points gamma
(T, B, D); outputs are per-spline (B,).
"""

from __future__ import annotations

import torch

from vae_latent_geometry_tpu_torch.models import nets
from vae_latent_geometry_tpu_torch.models.evae import decode_all


def energy_single(decoder_params, gamma):
    x = nets.decoder_apply(decoder_params, gamma)
    diffs = x[1:] - x[:-1]
    return torch.sum(diffs * diffs, dim=(0, 2))


def geodesic_lengths(decoder_params, gamma):
    x = nets.decoder_apply(decoder_params, gamma)
    diffs = x[1:] - x[:-1]
    return torch.sum(torch.linalg.norm(diffs, dim=2), dim=0)


def _ensemble_stats(decoded, num_active=None):
    """(M, T, B, X) decode -> (xbar (T, B, X), var (T, B)); ``num_active``
    (B,) restricts the means to the first k_b decoders per spline."""
    m_dec, _, B, _ = decoded.shape
    if num_active is None:
        xbar = decoded.mean(dim=0)
        dev = decoded - xbar[None]
        var = (dev * dev).sum(dim=-1).mean(dim=0)
    else:
        k = torch.as_tensor(num_active, dtype=torch.int64,
                            device=decoded.device).expand(B)
        mask = (torch.arange(m_dec, device=decoded.device)[:, None]
                < k[None, :]).to(decoded.dtype)
        w = mask / k.to(decoded.dtype)[None, :]
        xbar = torch.einsum("mb,mtbx->tbx", w, decoded)
        dev = decoded - xbar[None]
        var = torch.einsum("mb,mtb->tb", w, (dev * dev).sum(dim=-1))
    return xbar, var


def energy_expected(decoders, gamma, num_active=None):
    decoded = decode_all(decoders, gamma)              # (M, T, B, X)
    xbar, var = _ensemble_stats(decoded, num_active)
    step = xbar[1:] - xbar[:-1]
    seg = (step * step).sum(dim=-1) + var[1:] + var[:-1]
    return seg.sum(dim=0)
