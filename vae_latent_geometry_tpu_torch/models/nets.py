"""Encoder / decoder networks as parameter dicts + pure apply functions.

Architectures match the reference ensemble model (``src/train.py:71-85``):

- encoder: Linear(50,256) SiLU LayerNorm(256) Linear(256,128) SiLU
  LayerNorm(128) Linear(128, 2*latent_dim)
- decoder: Linear(2,128) ReLU Linear(128,128) ReLU Linear(128,50)

and the legacy single-decoder family (``src/single_decoder/vae.py:15-42``):

- encoder: Linear(50,128) ReLU Linear(128,64) ReLU Linear(64, 2*latent_dim)
- decoder: Linear(2,128) ReLU Linear(128,128) ReLU Linear(128, 2*output_dim)

and scVI's decoder (scvi-tools ``scvi/nn/_base_components.py``
``DecoderSCVI`` with ``FCLayers``, n_layers 1, BatchNorm in the decoder),
whose mean is the rate ``px_rate``:

- decoder: Linear(10,128) BatchNorm1d(128, eps 1e-3, eval) ReLU
  Linear(128, G) softmax, times the library size L

A decoder tree is ``{"layers": [...]}``, and for scVI's family also
``"norms"`` (one eval-mode BatchNorm per hidden layer: ``mean``, ``var``,
``scale``, ``bias``, ``eps``) and ``"softmax"`` (the head: ``library``).
Every leaf carries the same leading axes as the layers (a member or seed
axis), so the trees stack, select and save as the linear ones do.

Weights keep the JAX package's ``(in, out)`` layout and apply as
``x @ w + b`` — not ``nn.Linear``'s ``(out, in)`` — so parameters carry
across the packages without a transpose that could slip in or out.  Every
apply function also takes parameters with leading batch axes (the
trainers' seed axis: ``w`` (S, in, out), ``b`` (S, out)) on inputs of shape
(S, N, in): the bias and norm vectors broadcast over the row axis.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from vae_latent_geometry_tpu_torch.io.checkpoint import tree_map

LN_EPS = 1e-5  # torch.nn.LayerNorm default


def _linear_init(generator: torch.Generator, fan_in: int, fan_out: int,
                 device=None):
    """torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for both weight and bias, drawn from ``generator`` (a CPU generator:
    the draws do not depend on the device)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.empty(fan_in, fan_out).uniform_(-bound, bound,
                                              generator=generator)
    b = torch.empty(fan_out).uniform_(-bound, bound, generator=generator)
    return {"w": w.to(device), "b": b.to(device)}


def _layernorm_init(dim: int, device=None):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def _row(v):
    """A per-feature vector broadcast over the row axis of (..., N, F)."""
    return v.unsqueeze(-2)


def _layernorm(p, x):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    xhat = (x - mean) * torch.rsqrt(var + LN_EPS)
    return xhat * _row(p["scale"]) + _row(p["bias"])


def encoder_init(generator: torch.Generator, input_dim: int = 50,
                 latent_dim: int = 2, hidden: Sequence[int] = (256, 128),
                 use_layernorm: bool = True, device=None):
    dims = [input_dim, *hidden, 2 * latent_dim]
    params = {"layers": [_linear_init(generator, dims[i], dims[i + 1], device)
                         for i in range(len(dims) - 1)]}
    if use_layernorm:
        params["norms"] = [_layernorm_init(h, device) for h in hidden]
    return params


def _activation(name: str):
    return torch.nn.functional.silu if name == "silu" else torch.relu


def encoder_apply(params, x, activation: str = "silu"):
    """Returns (mean, log_std), each (..., latent_dim)."""
    act = _activation(activation)
    norms = params.get("norms")
    layers = params["layers"]
    h = x
    for i, lyr in enumerate(layers[:-1]):
        h = act(h @ lyr["w"] + _row(lyr["b"]))
        if norms is not None:
            h = _layernorm(norms[i], h)
    out = h @ layers[-1]["w"] + _row(layers[-1]["b"])
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, log_std


def decoder_init(generator: torch.Generator, latent_dim: int = 2,
                 output_dim: int = 50, hidden: Sequence[int] = (128, 128),
                 heteroscedastic: bool = False, device=None):
    out = 2 * output_dim if heteroscedastic else output_dim
    dims = [latent_dim, *hidden, out]
    return {"layers": [_linear_init(generator, dims[i], dims[i + 1], device)
                       for i in range(len(dims) - 1)]}


def decoder_head(decoders) -> str:
    """"softmax" for a tree with scVI's head, else "linear"."""
    return "softmax" if "softmax" in decoders else "linear"


def _per_row(v):
    """A per-member scalar (..., ) broadcast over (..., N, F)."""
    return v.reshape(*v.shape, 1, 1)


def batchnorm_eval(p, h):
    """BatchNorm1d in eval mode on (..., N, F): the running statistics and
    the affine map."""
    return ((h - _row(p["mean"])) * torch.rsqrt(_row(p["var"])
                                                + _per_row(p["eps"]))
            * _row(p["scale"]) + _row(p["bias"]))


def apply_head(params, out):
    """The output head on the last layer's output (..., N, X): the identity,
    or ``library * softmax`` over the features."""
    if "softmax" not in params:
        return out
    return _per_row(params["softmax"]["library"]) * torch.softmax(out, -1)


def fold_batchnorm(decoders):
    """The tree with each eval-mode BatchNorm folded into the affine map
    before it: w k and (b - mean) k + bias, k = scale / sqrt(var + eps)
    (the same function up to float32 rounding)."""
    norms = decoders.get("norms")
    if not norms:
        return decoders
    layers = list(decoders["layers"])
    for i, p in enumerate(norms):
        k = p["scale"] * torch.rsqrt(p["var"] + p["eps"][..., None])
        layers[i] = {"w": layers[i]["w"] * k.unsqueeze(-2),
                     "b": (layers[i]["b"] - p["mean"]) * k + p["bias"]}
    return {**{k: v for k, v in decoders.items() if k != "norms"},
            "layers": layers}


def decoder_apply(params, z, activation: str = "relu"):
    """Decoder mean head: (..., latent_dim) -> (..., output_dim).  The
    ensemble family's observation noise is a fixed sigma
    (``ModelConfig.decoder_sigma``), so only the mean is produced here;
    heteroscedastic decoders use :func:`decoder_apply_full`.  scVI's
    decoder applies its BatchNorms and its head."""
    act = _activation(activation)
    layers = params["layers"]
    norms = params.get("norms")
    h = z
    for i, lyr in enumerate(layers[:-1]):
        h = h @ lyr["w"] + _row(lyr["b"])
        if norms:
            h = batchnorm_eval(norms[i], h)
        h = act(h)
    return apply_head(params, h @ layers[-1]["w"] + _row(layers[-1]["b"]))


def decoder_apply_full(params, z, clamp=(-2.0, 2.0),
                       activation: str = "relu"):
    """Heteroscedastic decoder: (mean, log_std) with the reference's
    log-std clamp (``src/single_decoder/vae.py:41``)."""
    out = decoder_apply(params, z, activation)
    mean, log_std = torch.chunk(out, 2, dim=-1)
    return mean, log_std.clamp(clamp[0], clamp[1])


def stack_params(trees: list):
    """Leaf-wise ``torch.stack`` of same-shaped parameter trees: a leading
    axis (the ensemble or the seed axis) on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])
