"""Ensemble VAE: shared Gaussian encoder + a stacked decoder ensemble.

The ensemble is one parameter dict whose every tensor carries a leading
decoder axis — ``layers[i]["w"]`` is ``(M, in, out)`` and
``layers[i]["b"]`` is ``(M, out)`` — so decoding with every member is one
batched matmul chain.  :func:`from_jax_params` and :func:`load_npz` carry
the JAX package's parameters across unchanged.

ELBO semantics match the reference (``src/train.py:56-62``): one-sample
reparameterized z, a single decoder for the whole batch, fixed observation
noise sigma, and a Monte-Carlo KL log q(z) - log p(z).  The noise is an
argument (``eps`` of the latent means' shape and the decoder index), so a
caller can feed any draws; :func:`elbo_drawn` draws both from a
``torch.Generator``.  Every function here also takes parameters with a
leading seed axis (the multiseed trainer's): ``x`` is then (S, N, X),
``eps`` (S, N, D), the decoder index one per seed, and the ELBO (S,).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import ModelConfig, from_dict
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.io.checkpoint import (
    load_tree,
    tree_leaves,
    tree_map,
)
from vae_latent_geometry_tpu_torch.models import nets

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

Params = Dict[str, Any]


@dataclass
class EVAEParams:
    encoder: Params
    decoders: Params  # stacked: every tensor has leading axis num_decoders


def _to_tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_tensors(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def from_jax_params(tree, device: Optional[Union[str, torch.device]] = None
                    ) -> EVAEParams:
    """EVAE parameters from a tree of arrays in the JAX package's layout:
    a mapping (or object with attributes) holding ``encoder`` and
    ``decoders``, each a nested dict/list of array-likes."""
    dev = resolve_device(device)

    def get(name):
        return tree[name] if isinstance(tree, dict) else getattr(tree, name)

    enc = (tree.get("encoder") if isinstance(tree, dict)
           else getattr(tree, "encoder", None))
    # an scVI ensemble's artifact holds its decoders alone: the geodesic
    # stages never encode
    return EVAEParams(encoder=None if enc is None else _to_tensors(enc, dev),
                      decoders=_to_tensors(get("decoders"), dev))


def load_npz(path: str, device: Optional[Union[str, torch.device]] = None):
    """Load a path-keyed checkpoint written by either package: an
    ``EVAEParams``, or a legacy single VAE's ``models.vae.VAEParams`` when
    the sidecar's ``model_config`` is heteroscedastic (``train-single``'s
    ``vae_best_seed<N>.npz``)."""
    tree, meta = load_tree(path)
    cfg = from_dict(ModelConfig, meta.get("model_config"))
    if cfg.heteroscedastic:
        from vae_latent_geometry_tpu_torch.models.vae import VAEParams

        dev = resolve_device(device)
        return VAEParams(encoder=_to_tensors(tree["encoder"], dev),
                         decoder=_to_tensors(tree["decoder"], dev))
    if "decoders" not in tree:
        raise KeyError(f"{path}: no 'decoders' tree — not an EVAE checkpoint")
    head = nets.decoder_head(tree["decoders"])
    norms = bool(tree["decoders"].get("norms"))
    if head != cfg.decoder_head or norms != cfg.decoder_batchnorm:
        raise ValueError(f"{path}: the sidecar's decoder_head "
                         f"{cfg.decoder_head!r} and decoder_batchnorm "
                         f"{cfg.decoder_batchnorm} do not match the decoders "
                         f"(a {head!r} head, BatchNorms: {norms})")
    return from_jax_params(tree, device)


def evae_init(generator: torch.Generator, cfg: ModelConfig = ModelConfig(),
              device=None) -> EVAEParams:
    """Encoder, then ONE prototype decoder, drawn from ``generator``; the
    prototype is copied to every member, as the reference deep-copies one
    decoder (``src/train.py:53``): members start identical and diverge only
    through the random decoder choice during training."""
    dev = resolve_device(device)
    encoder = nets.encoder_init(
        generator, cfg.input_dim, cfg.latent_dim, tuple(cfg.encoder_hidden),
        use_layernorm=not cfg.heteroscedastic, device=dev)
    proto = nets.decoder_init(
        generator, cfg.latent_dim, cfg.input_dim, tuple(cfg.decoder_hidden),
        heteroscedastic=cfg.heteroscedastic, device=dev)
    decoders = tree_map(
        lambda x: x[None].expand(cfg.num_decoders, *x.shape).clone(), proto)
    return EVAEParams(encoder=encoder, decoders=decoders)


def stack_decoders(decoder_list):
    """Stack a list of per-decoder dicts into one ensemble dict."""
    return nets.stack_params(decoder_list)


def unstack_decoders(decoders: Params, num: int):
    return [tree_map(lambda x, i=i: x[i], decoders) for i in range(num)]


def encode(params: Union[EVAEParams, Params], x,
           cfg: ModelConfig = ModelConfig()):
    """(mean, log_std) of the Gaussian encoder: SiLU + LayerNorm for the
    ensemble family; ReLU with the log-std clamp for the legacy
    (heteroscedastic) family."""
    enc = params.encoder if isinstance(params, EVAEParams) else params
    if not cfg.heteroscedastic:
        return nets.encoder_apply(enc, x, activation="silu")
    mean, log_std = nets.encoder_apply(enc, x, activation="relu")
    lo, hi = cfg.encoder_logstd_clamp
    return mean, log_std.clamp(lo, hi)


def select_member(tree, idx):
    """Member ``idx`` of every stacked leaf of ``tree``: an int or a 0-d
    index picks one; a 1-D index picks one per leading (seed) row,
    ``x[s, idx[s]]``, by one ``index_select`` per leaf (its backward adds
    each row's gradient into a zero tensor once: exact in any order)."""
    if isinstance(idx, torch.Tensor) and idx.dim() == 1:
        leaf = tree_leaves(tree)[0]
        S, M = leaf.shape[:2]
        flat = torch.arange(S, device=leaf.device) * M + idx
        return tree_map(lambda x: x.reshape(S * M, *x.shape[2:])
                        .index_select(0, flat), tree)
    return tree_map(lambda x: x[idx], tree)


def decode_one(decoders: Params, idx, z):
    """Decode with decoder ``idx`` (see :func:`select_member`)."""
    return nets.decoder_apply(select_member(decoders, idx), z)


def decode_all(decoders: Params, z):
    """Decode z (..., D) with every ensemble member: (M, ..., X).  scVI's
    decoders apply their BatchNorms (explicitly, in eval mode) and their
    head."""
    lead = z.shape[:-1]
    h = z.reshape(1, -1, z.shape[-1])
    layers = decoders["layers"]
    norms = decoders.get("norms")
    for i, lyr in enumerate(layers):
        w = lyr["w"]
        h = torch.baddbmm(lyr["b"][:, None, :], h.expand(w.shape[0], -1, -1),
                          w)
        if i < len(layers) - 1:
            if norms:
                h = nets.batchnorm_eval(norms[i], h)
            h = torch.relu(h)
    h = nets.apply_head(decoders, h)
    return h.reshape(h.shape[0], *lead, h.shape[-1])


def decoder_std(decoders: Params, z):
    """Per-feature std over the ensemble decoders at ``z``, with Bessel's
    correction (the reference uses ``torch.std``'s unbiased default:
    ``src/init_splines_ensemble.py:50``); zero for a one-member ensemble."""
    outs = decode_all(decoders, z)                 # (M, ..., X)
    m = outs.shape[0]
    return outs.std(dim=0, correction=0) * float(np.sqrt(m / max(m - 1, 1)))


def _diag_normal_logprob(x, mean, std):
    """Sum over the event axis of independent Normal log-probs (torch
    ``td.Independent(Normal, 1).log_prob`` semantics); ``mean`` and ``std``
    may be tensors or numbers."""
    var = std * std
    log_std = torch.log(std) if isinstance(std, torch.Tensor) else \
        math.log(std)
    return (-0.5 * ((x - mean) ** 2) / var - log_std
            - _HALF_LOG_2PI).sum(-1)


def elbo(params: EVAEParams, x, eps, decoder_idx,
         cfg: ModelConfig = ModelConfig(), beta=None):
    """Single-sample ELBO, mean over the batch (reference
    ``src/train.py:56-62``): z = mean + std * eps, one decoder
    (``decoder_idx``) for the whole batch, the fixed ``cfg.decoder_sigma``.
    ``beta`` overrides the KL weight ``cfg.beta`` (the trainers thread
    their warm-up through it)."""
    mean, log_std = encode(params, x, cfg)
    std = torch.exp(log_std)
    z = mean + std * eps
    x_mean = decode_one(params.decoders, decoder_idx, z)
    logpxz = _diag_normal_logprob(x, x_mean, float(cfg.decoder_sigma))
    kl = _diag_normal_logprob(z, mean, std) - _diag_normal_logprob(z, 0.0,
                                                                   1.0)
    b = cfg.beta if beta is None else beta
    return (logpxz - b * kl).mean(-1)


def neg_elbo(params: EVAEParams, x, eps, decoder_idx,
             cfg: ModelConfig = ModelConfig(), beta=None):
    return -elbo(params, x, eps, decoder_idx, cfg, beta)


def num_members(decoders: Params) -> int:
    return decoders["layers"][0]["w"].shape[0]


def elbo_drawn(params: EVAEParams, generator: torch.Generator, x,
               cfg: ModelConfig = ModelConfig(), beta=None):
    """:func:`elbo` with ``eps`` and the decoder index drawn from
    ``generator`` (a CPU generator; the draws move to ``x``'s device)."""
    eps = torch.randn((*x.shape[:-1], cfg.latent_dim), generator=generator)
    idx = int(torch.randint(0, num_members(params.decoders), (),
                            generator=generator))
    return elbo(params, x, eps.to(x.device), idx, cfg, beta)


def sample(params: EVAEParams, generator: torch.Generator, n: int = 1,
           cfg: ModelConfig = ModelConfig(), decoder_idx=None):
    """Decoder means of ``n`` prior samples; a random ensemble member
    unless ``decoder_idx`` is given (reference
    ``src/single_decoder/vae.py:107-113``)."""
    z = torch.randn((n, cfg.latent_dim), generator=generator)
    if decoder_idx is None:
        decoder_idx = int(torch.randint(0, num_members(params.decoders), (),
                                        generator=generator))
    dev = params.decoders["layers"][0]["w"].device
    return decode_one(params.decoders, decoder_idx, z.to(dev))


def decoder_member(decoders: Params, m: int) -> Params:
    """Decoder ``m`` of the stacked ensemble as a single-decoder dict."""
    return select_member(decoders, m)
