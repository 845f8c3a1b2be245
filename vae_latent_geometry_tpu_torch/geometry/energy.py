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
- ``geodesic_lengths``: data-space arc length through one decoder;
  ``arc_lengths`` the latent-space one.
- ``energy_jvp`` / ``energy_jvp_ensemble``: the T -> infinity forms, a
  trapezoid quadrature of ||J_f(g) g'||^2 (the decoder JVP along the curve
  velocity) plus, for the ensemble, the decoder-disagreement term;
  ``target_num_t`` rescales both terms to another resolution;
  ``energy_expected_rescaled`` is that rescaling with first differences
  instead of JVPs (the ``jvp*`` / ``expected_rescaled`` modes).

They mirror ``vae_latent_geometry_tpu.geometry.energy`` and are the
unfused modes ``single`` / ``expected`` / ``mc`` / ``mc_scan`` / ``jvp`` /
``jvp_ensemble`` / ``expected_rescaled``.  Inputs are
curve points gamma (T, B, D); outputs are per-spline (B,).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from vae_latent_geometry_tpu_torch.io.checkpoint import tree_map
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


def arc_lengths(gamma):
    """Latent-space curve length sum_i ||g_{i+1} - g_i|| (reference
    ``optimize_energy.py:167-172``): gamma (T, B, D) -> (B,)."""
    return torch.sum(torch.linalg.norm(gamma[1:] - gamma[:-1], dim=2), dim=0)


def _mean_weights(num_active, m_dec, B, dtype, device):
    """(M, B) weights of the mean over each spline's first k_b decoders."""
    k = torch.as_tensor(num_active, dtype=torch.int64, device=device).expand(B)
    mask = (torch.arange(m_dec, device=device)[:, None] < k[None, :]).to(dtype)
    return mask / k.to(dtype)[None, :]


def _ensemble_stats(decoded, num_active=None):
    """(M, T, B, X) decode -> (xbar (T, B, X), var (T, B)); ``num_active``
    (B,) restricts the means to the first k_b decoders per spline."""
    m_dec, _, B, _ = decoded.shape
    if num_active is None:
        xbar = decoded.mean(dim=0)
        dev = decoded - xbar[None]
        var = (dev * dev).sum(dim=-1).mean(dim=0)
    else:
        w = _mean_weights(num_active, m_dec, B, decoded.dtype, decoded.device)
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


# ---------------------------------------------------------------------------
# JVP energies.  Tangents are carried through the ReLU MLPs by hand, beside
# the forward pass: dh_{l+1} = (dh_l W_l) * [pre_l > 0] (the derivative
# jax.nn.relu uses), so one pass gives the decode and its JVP, and autograd
# differentiates both as plain tensor code.  (torch.func.jvp would decode a
# second time for the values the disagreement term needs.)
# ---------------------------------------------------------------------------

def decode_all_jvp(decoders, z, z_dot):
    """Every ensemble member: (x, x_dot), both (M, ..., X).  scVI's
    decoders carry the tangent through their eval-mode BatchNorms (a
    per-feature scale) and their head, L s (u_dot - <s, u_dot>)."""
    lead = z.shape[:-1]
    layers = decoders["layers"]
    norms = decoders.get("norms")
    m_dec = layers[0]["w"].shape[0]
    h = z.reshape(1, -1, z.shape[-1]).expand(m_dec, -1, -1)
    h_dot = z_dot.reshape(1, -1, z.shape[-1]).expand(m_dec, -1, -1)
    for i, lyr in enumerate(layers):
        h = torch.baddbmm(lyr["b"][:, None, :], h, lyr["w"])
        h_dot = torch.bmm(h_dot, lyr["w"])
        if i < len(layers) - 1:
            if norms:
                p = norms[i]
                h = nets.batchnorm_eval(p, h)
                h_dot = h_dot * (p["scale"] * torch.rsqrt(
                    p["var"] + p["eps"][:, None]))[:, None, :]
            h_dot = h_dot * (h > 0).to(h.dtype)
            h = torch.relu(h)
    if nets.decoder_head(decoders) == "softmax":
        lib = decoders["softmax"]["library"][:, None, None]
        s = torch.softmax(h, -1)
        h_dot = lib * s * (h_dot - (s * h_dot).sum(-1, keepdim=True))
        h = lib * s
    return (h.reshape(m_dec, *lead, h.shape[-1]),
            h_dot.reshape(m_dec, *lead, h.shape[-1]))


def _trapezoid_dt2(sq):
    """sum_i w_i sq_i * dt^2 over the T axis of (T, B) values, trapezoid
    weights (1/2 at both ends), dt = 1/(T-1)."""
    T = sq.shape[0]
    dt = 1.0 / (T - 1)
    w = torch.ones(T, dtype=sq.dtype, device=sq.device)
    w[0] = w[-1] = 0.5
    return (sq * w[:, None]).sum(dim=0) * dt * dt


def energy_jvp(decoder_params, gamma, gamma_dot):
    """Quadrature JVP energy through one decoder:
    dt^2 sum_i w_i ||J_f(g_i) g'_i||^2, trapezoid weights, dt = 1/(T-1)
    (the discrete estimators' units as T grows).  (T, B, D) -> (B,)."""
    stacked = tree_map(lambda x: x[None], decoder_params)
    tangents = decode_all_jvp(stacked, gamma, gamma_dot)[1][0]
    return _trapezoid_dt2((tangents * tangents).sum(dim=-1))


def energy_jvp_ensemble(decoders, gamma, gamma_dot,
                        target_num_t: Optional[int] = None, num_active=None):
    """Expected ensemble energy in the T -> infinity limit: the JVP
    quadrature of the mean decoder plus the disagreement term
    sum_i var_{i+1} + var_i.  With ``target_num_t`` the two terms are carried
    to that resolution, r = (target - 1)/(T - 1): jvp / r + disagreement * r
    (the smooth term scales as 1/T, the disagreement as T).
    ``num_active``: (B,) per-spline count of leading decoders (masked
    means in both terms)."""
    decoded, decoded_dot = decode_all_jvp(decoders, gamma, gamma_dot)
    _, var = _ensemble_stats(decoded, num_active)
    disagreement = (var[1:] + var[:-1]).sum(dim=0)
    if num_active is None:
        tangents = decoded_dot.mean(dim=0)
    else:
        wm = _mean_weights(num_active, decoded.shape[0], gamma.shape[1],
                           gamma.dtype, gamma.device)
        tangents = torch.einsum("mb,mtbx->tbx", wm, decoded_dot)
    jvp_term = _trapezoid_dt2((tangents * tangents).sum(dim=-1))
    if target_num_t is None:
        return jvp_term + disagreement
    r = (target_num_t - 1) / (gamma.shape[0] - 1)
    return jvp_term / r + disagreement * r


def energy_expected_rescaled(decoders, gamma, target_num_t: int,
                             num_active=None):
    """The rescaling of :func:`energy_jvp_ensemble` with the smooth term
    estimated by first differences on the local grid:
    smooth / r + disagreement * r, r = (target - 1)/(T - 1)."""
    decoded = decode_all(decoders, gamma)              # (M, T, B, X)
    xbar, var = _ensemble_stats(decoded, num_active)
    step = xbar[1:] - xbar[:-1]
    smooth = (step * step).sum(dim=-1).sum(dim=0)
    disagreement = (var[1:] + var[:-1]).sum(dim=0)
    r = (target_num_t - 1) / (gamma.shape[0] - 1)
    return smooth / r + disagreement * r
