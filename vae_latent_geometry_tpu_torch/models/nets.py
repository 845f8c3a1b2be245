"""Encoder / decoder networks as parameter dicts + pure apply functions.

Architectures match the reference ensemble model (``src/train.py:71-85``):

- encoder: Linear(50,256) SiLU LayerNorm(256) Linear(256,128) SiLU
  LayerNorm(128) Linear(128, 2*latent_dim)
- decoder: Linear(2,128) ReLU Linear(128,128) ReLU Linear(128,50)

Weights keep the JAX package's ``(in, out)`` layout and apply as
``x @ w + b`` — not ``nn.Linear``'s ``(out, in)`` — so parameters carry
across the packages without a transpose that could slip in or out.
"""

from __future__ import annotations

import torch

LN_EPS = 1e-5  # torch.nn.LayerNorm default


def _layernorm(p, x):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + LN_EPS)
    return xhat * p["scale"] + p["bias"]


def encoder_apply(params, x, activation: str = "silu"):
    """Returns (mean, log_std), each (..., latent_dim)."""
    act = torch.nn.functional.silu if activation == "silu" else torch.relu
    norms = params.get("norms")
    layers = params["layers"]
    h = x
    for i, lyr in enumerate(layers[:-1]):
        h = act(h @ lyr["w"] + lyr["b"])
        if norms is not None:
            h = _layernorm(norms[i], h)
    out = h @ layers[-1]["w"] + layers[-1]["b"]
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, log_std


def decoder_apply(params, z):
    """Decoder mean head: (..., latent_dim) -> (..., output_dim)."""
    layers = params["layers"]
    h = z
    for lyr in layers[:-1]:
        h = torch.relu(h @ lyr["w"] + lyr["b"])
    return h @ layers[-1]["w"] + layers[-1]["b"]
