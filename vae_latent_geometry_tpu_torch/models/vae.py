"""Legacy single-decoder VAE family (heteroscedastic observation model).

Reference ``src/single_decoder/vae.py``: ReLU encoder with log-std clamped to
[-4, 2], decoder producing mean AND log-std clamped to [-2, 2]; ELBO with a
beta weight and optional parts; ensemble variant = shared encoder + a list
of heteroscedastic decoders with a random choice per call.  The ensemble
variant reuses the stacked-decoder layout of ``evae.py``.

As in ``evae.py`` the noise is an argument (``eps``, and the decoder index
of the ensemble variant), the parameter trees keep the JAX package's leaf
paths (``encoder/layers/0/w``, ``decoder/layers/2/b``), and every function
also takes parameters with a leading seed axis.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from vae_latent_geometry_tpu_torch.config import ModelConfig
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.models import nets
from vae_latent_geometry_tpu_torch.models.evae import (
    num_members,
    select_member,
    stack_decoders,
)

LEGACY_CONFIG = ModelConfig(
    heteroscedastic=True,
    encoder_hidden=(128, 64),
    decoder_hidden=(128, 128),
)

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@dataclass
class VAEParams:
    encoder: dict
    decoder: dict


def vae_init(generator: torch.Generator, cfg: ModelConfig = LEGACY_CONFIG,
             device=None) -> VAEParams:
    """Encoder, then decoder, drawn from ``generator``."""
    dev = resolve_device(device)
    return VAEParams(
        encoder=nets.encoder_init(generator, cfg.input_dim, cfg.latent_dim,
                                  tuple(cfg.encoder_hidden),
                                  use_layernorm=False, device=dev),
        decoder=nets.decoder_init(generator, cfg.latent_dim, cfg.input_dim,
                                  tuple(cfg.decoder_hidden),
                                  heteroscedastic=True, device=dev))


def encode(params, x, cfg: ModelConfig = LEGACY_CONFIG):
    mean, log_std = nets.encoder_apply(params.encoder, x, activation="relu")
    lo, hi = cfg.encoder_logstd_clamp
    return mean, log_std.clamp(lo, hi)


def decode(decoder_params, z, cfg: ModelConfig = LEGACY_CONFIG):
    return nets.decoder_apply_full(decoder_params, z,
                                   clamp=tuple(cfg.decoder_logstd_clamp))


def _logprob(x, mean, log_std):
    """Independent Normal log-probs summed over the event axis; ``mean`` and
    ``log_std`` may be tensors or numbers."""
    std = torch.exp(log_std) if isinstance(log_std, torch.Tensor) else \
        math.exp(log_std)
    return (-0.5 * ((x - mean) / std) ** 2 - log_std
            - _HALF_LOG_2PI).sum(-1)


def elbo(params: VAEParams, x, eps, beta: float = 1.0,
         cfg: ModelConfig = LEGACY_CONFIG, return_parts: bool = False):
    """Single-sample ELBO, mean over the batch (reference
    ``src/single_decoder/vae.py:54-63``); z = mean + std * eps."""
    mean, log_std = encode(params, x, cfg)
    z = mean + torch.exp(log_std) * eps
    x_mean, x_log_std = decode(params.decoder, z, cfg)
    recon = _logprob(x, x_mean, x_log_std)
    kl = _logprob(z, mean, log_std) - _logprob(z, 0.0, 0.0)
    value = recon - beta * kl
    if return_parts:
        return value.mean(-1), recon.mean(-1), kl.mean(-1)
    return value.mean(-1)


def sample(params: VAEParams, generator: torch.Generator, n: int = 1,
           cfg: ModelConfig = LEGACY_CONFIG):
    """Decoder means of ``n`` prior samples (reference :68-70)."""
    z = torch.randn((n, cfg.latent_dim), generator=generator)
    dev = params.decoder["layers"][0]["w"].device
    return decode(params.decoder, z.to(dev), cfg)[0]


# ---------------------------------------------------------------------------
# Legacy heteroscedastic ENSEMBLE (reference src/single_decoder/vae.py:72-113):
# shared clamped encoder + independently-initialized heteroscedastic decoders
# (NOT copies of one: contrast evae.evae_init), one random decoder per
# elbo/sample call, and a ``decoder = decoders[0]`` alias.
# ---------------------------------------------------------------------------


@dataclass
class LegacyEVAEParams:
    encoder: dict
    decoders: dict    # stacked heteroscedastic decoders (leading M axis)


def legacy_evae_init(generator: torch.Generator,
                     cfg: ModelConfig = LEGACY_CONFIG,
                     num_decoders: int = 3, device=None) -> LegacyEVAEParams:
    """Encoder, then ``num_decoders`` independent decoders, drawn from
    ``generator`` in that order."""
    dev = resolve_device(device)
    encoder = nets.encoder_init(generator, cfg.input_dim, cfg.latent_dim,
                                tuple(cfg.encoder_hidden),
                                use_layernorm=False, device=dev)
    decs = [nets.decoder_init(generator, cfg.latent_dim, cfg.input_dim,
                              tuple(cfg.decoder_hidden), heteroscedastic=True,
                              device=dev)
            for _ in range(num_decoders)]
    return LegacyEVAEParams(encoder=encoder, decoders=stack_decoders(decs))


def legacy_decoder(params: LegacyEVAEParams):
    """The reference's ``self.decoder = self.decoders[0]`` alias
    (``src/single_decoder/vae.py:83``)."""
    return select_member(params.decoders, 0)


def legacy_evae_elbo(params: LegacyEVAEParams, x, eps, decoder_idx,
                     beta: float = 1.0, cfg: ModelConfig = LEGACY_CONFIG,
                     return_parts: bool = False):
    """Ensemble ELBO through heteroscedastic decoder ``decoder_idx``
    (reference ``src/single_decoder/vae.py:87-102``)."""
    vp = VAEParams(encoder=params.encoder,
                   decoder=select_member(params.decoders, decoder_idx))
    return elbo(vp, x, eps, beta, cfg, return_parts)


def legacy_evae_sample(params: LegacyEVAEParams, generator: torch.Generator,
                       n: int = 1, decoder_idx=None,
                       cfg: ModelConfig = LEGACY_CONFIG):
    """Prior samples through one (random unless given) decoder's mean head
    (reference ``src/single_decoder/vae.py:107-113``)."""
    z = torch.randn((n, cfg.latent_dim), generator=generator)
    if decoder_idx is None:
        decoder_idx = int(torch.randint(0, num_members(params.decoders), (),
                                        generator=generator))
    dec = select_member(params.decoders, decoder_idx)
    return decode(dec, z.to(dec["layers"][0]["w"].device), cfg)[0]


def mean_decoder(decoder_params):
    """A heteroscedastic decoder cut to its mean head: the final layer
    emits [mean, log_std] concatenated, so its first half of columns is an
    exact mean-only decoder for every energy functional."""
    layers = decoder_params["layers"]
    half = layers[-1]["w"].shape[-1] // 2
    last = {"w": layers[-1]["w"][..., :half].contiguous(),
            "b": layers[-1]["b"][..., :half].contiguous()}
    return {**decoder_params, "layers": [*layers[:-1], last]}
