"""Plain curve-energy functionals (no custom kernels).

- ``energy_single``: discrete first-difference energy through one decoder,
  sum_i ||f(g_{i+1}) - f(g_i)||^2.
- ``energy_expected``: closed-form expectation of the reference's MC
  ensemble estimator in the centered, cancellation-free form
  ||xbar_{i+1} - xbar_i||^2 + var_{i+1} + var_i.
- ``energy_mc``: the reference's Monte-Carlo ensemble estimator: per MC
  sample, independent decoder indices d1, d2 per (segment, spline) and
  sum_i ||f_{d2}(g_{i+1}) - f_{d1}(g_i)||^2, averaged over the samples;
  ``energy_mc_from_indices`` is the estimator on given index planes and
  ``energy_mc_scan`` the same distribution streamed over T in chunks;
  ``sample_decoder_indices`` draws the planes.
- ``geodesic_lengths``: data-space arc length through one decoder.

They mirror ``vae_latent_geometry_tpu.geometry.energy`` and are the
unfused modes ``single`` / ``expected`` / ``mc`` / ``mc_scan``.  Inputs are
curve points gamma (T, B, D); outputs are per-spline (B,).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

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


def sample_decoder_indices(generator: torch.Generator, T: int, B: int,
                           m_dec: int, mc_samples: int = 2, num_active=None):
    """(d1, d2): (S, T-1, B) int32 decoder draws, U[0, num_active_b), on the
    generator's device.  31 random bits modulo the bound: the bias of a draw
    is below num_active_b / 2^31 < 1e-5.  ``num_active`` must lie in
    [1, m_dec] (ValueError; checked without waiting for the device when it
    is host data), so every draw names a decoder."""
    dev = generator.device
    if num_active is None:
        maxval = torch.full((B,), m_dec, dtype=torch.int32, device=dev)
    else:
        num_active = torch.as_tensor(num_active)
        k_min, k_max = torch.stack(torch.aminmax(num_active)).tolist()
        if k_min < 1 or k_max > m_dec:
            raise ValueError(f"num_active must lie in [1, {m_dec}], got "
                             f"[{k_min:g}, {k_max:g}]")
        maxval = num_active.to(device=dev, dtype=torch.int32).expand(B)
    val = torch.randint(0, 2**31 - 1, (2 * mc_samples, T - 1, B),
                        generator=generator, device=dev, dtype=torch.int32)
    draws = val % maxval[None, None, :]
    return draws[:mc_samples], draws[mc_samples:]


def _mc_segments(x_lo, x_hi, d1, d2):
    """Per-segment sampled energies (n, B), averaged over the S samples:
    x_lo, x_hi (M, n, B, X) are the decodes of each segment's two ends,
    d1, d2 (S, n, B) the decoders drawn for them."""
    lo = x_lo.permute(1, 2, 0, 3)[None]                 # (1, n, B, M, X)
    hi = x_hi.permute(1, 2, 0, 3)[None]
    x1 = torch.take_along_dim(lo, d1.long()[..., None, None], dim=3)
    x2 = torch.take_along_dim(hi, d2.long()[..., None, None], dim=3)
    d = (x2 - x1)[:, :, :, 0]                           # (S, n, B, X)
    return (d * d).sum(dim=-1).mean(dim=0)


def energy_mc_from_indices(decoders, gamma, d1, d2):
    """The MC estimator on given draws d1, d2 (S, T-1, B): decoder
    ``d1[s, t, b]`` decodes the left end of segment t, ``d2[s, t, b]`` its
    right end.  Decoder means only."""
    decoded = decode_all(decoders, gamma)               # (M, T, B, X)
    return _mc_segments(decoded[:, :-1], decoded[:, 1:], d1, d2).sum(dim=0)


def energy_mc(decoders, gamma, generator, mc_samples: int = 2,
              num_active=None):
    """Reference MC ensemble estimator: d1, d2 ~ U[0, M) independently per
    (sample, segment, spline), drawn from ``generator`` (a
    ``torch.Generator`` on gamma's device).

    ``num_active``: optional (B,) int, per-spline count k of active
    decoders; indices are then drawn from U[0, k_b)."""
    T, B, _ = gamma.shape
    m_dec = decoders["layers"][0]["w"].shape[0]
    d1, d2 = sample_decoder_indices(generator, T, B, m_dec, mc_samples,
                                    num_active)
    return energy_mc_from_indices(decoders, gamma, d1, d2)


def energy_mc_scan(decoders, gamma, generator, mc_samples: int = 2,
                   num_active=None, chunk: int = 125):
    """Memory-flat MC estimator: the distribution of :func:`energy_mc`, but
    the T axis is streamed in chunks with a one-row carry and each chunk is
    rematerialized in the backward pass, so neither the (M, T, B, X) decode
    nor its activations are ever held whole.  The random stream differs from
    :func:`energy_mc`'s (one draw call per chunk)."""
    T, B, _ = gamma.shape
    m_dec = decoders["layers"][0]["w"].shape[0]
    # largest divisor of T <= requested chunk; degenerate cases fall back
    chunk = max((c for c in range(1, min(chunk, T) + 1) if T % c == 0),
                default=1)
    if chunk <= 1:
        return energy_mc(decoders, gamma, generator, mc_samples, num_active)

    def body(gc, prev_x, d1, d2, first):
        xc = decode_all(decoders, gc)                   # (M, chunk, B, X)
        x_ext = torch.cat([prev_x[:, None], xc], dim=1)
        seg = _mc_segments(x_ext[:, :-1], x_ext[:, 1:], d1, d2)
        # the first segment of the first chunk joins nothing
        return (seg[1:] if first else seg).sum(dim=0), xc[:, -1]

    x_dim = decoders["layers"][-1]["w"].shape[-1]
    prev_x = gamma.new_zeros((m_dec, B, x_dim))
    energy = gamma.new_zeros(B)
    for c in range(T // chunk):
        d1, d2 = sample_decoder_indices(generator, chunk + 1, B, m_dec,
                                        mc_samples, num_active)
        # the body draws nothing, so there is no generator state to keep
        # (reading the CUDA generator's state would wait for the device)
        e, prev_x = checkpoint(body, gamma[c * chunk:(c + 1) * chunk], prev_x,
                               d1, d2, c == 0, use_reentrant=False,
                               preserve_rng_state=False)
        energy = energy + e
    return energy
