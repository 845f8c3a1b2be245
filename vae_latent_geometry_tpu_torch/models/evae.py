"""Ensemble VAE: shared Gaussian encoder + a stacked decoder ensemble.

The ensemble is one parameter dict whose every tensor carries a leading
decoder axis — ``layers[i]["w"]`` is ``(M, in, out)`` and
``layers[i]["b"]`` is ``(M, out)`` — so decoding with every member is one
batched matmul chain.  :func:`from_jax_params` and :func:`load_npz` carry
the JAX package's parameters across unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.config import ModelConfig, from_dict
from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.io.checkpoint import load_tree
from vae_latent_geometry_tpu_torch.models import nets

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
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def from_jax_params(tree, device: Optional[Union[str, torch.device]] = None
                    ) -> EVAEParams:
    """EVAE parameters from a tree of arrays in the JAX package's layout:
    a mapping (or object with attributes) holding ``encoder`` and
    ``decoders``, each a nested dict/list of array-likes."""
    dev = resolve_device(device)

    def get(name):
        return tree[name] if isinstance(tree, dict) else getattr(tree, name)

    return EVAEParams(encoder=_to_tensors(get("encoder"), dev),
                      decoders=_to_tensors(get("decoders"), dev))


def load_npz(path: str, device: Optional[Union[str, torch.device]] = None
             ) -> EVAEParams:
    """Load a path-keyed EVAE checkpoint written by the JAX package."""
    tree, meta = load_tree(path)
    cfg = from_dict(ModelConfig, meta.get("model_config"))
    if cfg.heteroscedastic:
        raise ValueError(f"{path}: the legacy heteroscedastic single-VAE "
                         "family is not available in the PyTorch port")
    if "decoders" not in tree:
        raise KeyError(f"{path}: no 'decoders' tree — not an EVAE checkpoint")
    return from_jax_params(tree, device)


def encode(params: EVAEParams, x):
    """(mean, log_std) of the Gaussian encoder (ensemble family: SiLU +
    LayerNorm, no log-std clamp)."""
    return nets.encoder_apply(params.encoder, x, activation="silu")


def decode_all(decoders: Params, z):
    """Decode z (..., D) with every ensemble member: (M, ..., X)."""
    lead = z.shape[:-1]
    h = z.reshape(1, -1, z.shape[-1])
    layers = decoders["layers"]
    for i, lyr in enumerate(layers):
        w = lyr["w"]
        h = torch.baddbmm(lyr["b"][:, None, :], h.expand(w.shape[0], -1, -1),
                          w)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h.reshape(h.shape[0], *lead, h.shape[-1])


def decoder_std(decoders: Params, z):
    """Per-feature std over the ensemble decoders at ``z``, with Bessel's
    correction (the reference uses ``torch.std``'s unbiased default:
    ``src/init_splines_ensemble.py:50``); zero for a one-member ensemble."""
    outs = decode_all(decoders, z)                 # (M, ..., X)
    m = outs.shape[0]
    return outs.std(dim=0, correction=0) * float(np.sqrt(m / max(m - 1, 1)))


def decoder_member(decoders: Params, m: int) -> Params:
    """Decoder ``m`` of the stacked ensemble as a single-decoder dict."""
    return {"layers": [{"w": l["w"][m], "b": l["b"][m]}
                       for l in decoders["layers"]]}
