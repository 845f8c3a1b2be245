"""Interop with the reference implementation's checkpoints and blobs
(``vae_latent_geometry_tpu.models.torch_import``).

Loads the reference's ``state_dict`` files (``experiment/model_seed*.pt``,
``src/artifacts/vae_best_seed*.pth``) into the port's parameter trees on an
explicit device, and its spline blobs into numpy.  ``nn.Linear.weight`` is
(out, in) and is transposed into the (in, out) layout of ``models/nets.py``.
Sequential indices are parsed generically: a 2-D ``weight`` is a Linear
layer, a 1-D ``weight`` a LayerNorm.
"""

from __future__ import annotations

import importlib
import pickle
import re
from typing import Any, Dict

import numpy as np
import torch

from vae_latent_geometry_tpu_torch.device import resolve_device
from vae_latent_geometry_tpu_torch.models.evae import (
    EVAEParams,
    _to_tensors,
    stack_decoders,
)
from vae_latent_geometry_tpu_torch.models.vae import VAEParams, mean_decoder


def _numpy_safe_globals() -> list:
    """numpy's array and scalar reconstruction functions and dtype
    classes: data only, as older exporters pickled metadata verbatim."""
    safe = [np.ndarray, np.dtype]
    for mod in ("numpy._core.multiarray", "numpy.core.multiarray"):
        try:
            ma = importlib.import_module(mod)
            safe += [ma._reconstruct, ma.scalar]
            break
        except (ImportError, AttributeError):
            continue
    try:
        from numpy import dtypes as _dtypes

        safe += [getattr(_dtypes, n) for n in dir(_dtypes)
                 if n.endswith("DType")]
    except ImportError:
        pass
    return safe


def _torch_load(path: str):
    """``torch.load`` restricted to data (``weights_only=True``), mapped to
    the CPU.  A blob carrying bare numpy scalars or arrays gets one retry
    with numpy's reconstruction allowlisted (still data only).  A pickle of
    other objects (a full ``nn.Module``) is refused, never executed: the
    error says to export a state_dict."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as ex:
        try:
            with torch.serialization.safe_globals(_numpy_safe_globals()):
                return torch.load(path, map_location="cpu",
                                  weights_only=True)
        except pickle.UnpicklingError:
            raise RuntimeError(
                f"{path} is not loadable under weights_only=True: it "
                "pickles non-data objects (e.g. a full nn.Module). "
                "Untrusted pickle code is never executed here — re-export "
                "the checkpoint as a state_dict "
                "(torch.save(model.state_dict(), ...)) or the blob with "
                "plain tensor/primitive content") from ex


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    return {k: v.detach().numpy() for k, v in _torch_load(path).items()}


def _sequential_to_mlp(entries: Dict[int, Dict[str, np.ndarray]]):
    """{seq_idx: {'weight', 'bias'}} -> {'layers': [{'w', 'b'}], 'norms':
    [{'scale', 'bias'}]} as numpy, weights transposed to (in, out)."""
    layers, norms = [], []
    for idx in sorted(entries):
        e = entries[idx]
        w = e["weight"]
        if w.ndim == 2:
            layers.append({"w": np.ascontiguousarray(w.T), "b": e["bias"]})
        elif w.ndim == 1:
            norms.append({"scale": w, "bias": e["bias"]})
        else:
            raise ValueError(f"unrecognized weight ndim {w.ndim} at index "
                             f"{idx}")
    params: Dict[str, Any] = {"layers": layers}
    if norms:
        params["norms"] = norms
    return params


def _group_sequential(sd: Dict[str, np.ndarray], prefix: str):
    """The '<prefix>.<idx>.<weight|bias>' entries by index."""
    pat = re.compile(re.escape(prefix) + r"\.(\d+)\.(weight|bias)$")
    entries: Dict[int, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            entries.setdefault(int(m.group(1)), {})[m.group(2)] = v
    if not entries:
        raise KeyError(f"no entries under prefix {prefix!r}")
    return entries


def load_evae_checkpoint(path: str, device=None) -> EVAEParams:
    """An ensemble-VAE state_dict (reference ``src/train.py:165``: keys
    ``encoder.encoder_net.{j}.*`` and ``decoder.{i}.decoder_net.{j}.*``)
    as ``EVAEParams`` on ``device`` (default cuda)."""
    dev = resolve_device(device)
    sd = _load_state_dict(path)
    encoder = _sequential_to_mlp(_group_sequential(sd, "encoder.encoder_net"))
    dec_ids = sorted({int(m.group(1)) for k in sd
                      if (m := re.match(r"decoder\.(\d+)\.", k))})
    if not dec_ids:
        raise KeyError("no ensemble decoders found in checkpoint")
    decoders = [_to_tensors(_sequential_to_mlp(_group_sequential(
        sd, f"decoder.{i}.decoder_net")), dev) for i in dec_ids]
    return EVAEParams(encoder=_to_tensors(encoder, dev),
                      decoders=stack_decoders(decoders))


def load_single_vae_checkpoint(path: str, device=None) -> VAEParams:
    """A legacy single-VAE state_dict (reference
    ``src/single_decoder/vae.py``; files ``vae_best_seed*.pth``) as
    ``VAEParams`` on ``device``; the decoder is heteroscedastic (output
    2*X: mean ++ log_std)."""
    dev = resolve_device(device)
    sd = _load_state_dict(path)
    return VAEParams(
        encoder=_to_tensors(_sequential_to_mlp(
            _group_sequential(sd, "encoder.encoder_net")), dev),
        decoder=_to_tensors(_sequential_to_mlp(
            _group_sequential(sd, "decoder.decoder_net")), dev))


def load_decoder_checkpoint(path: str, device=None):
    """A bare decoder state_dict (``decoder_VAE_*.pth``) on ``device``."""
    return _to_tensors(_sequential_to_mlp(
        _group_sequential(_load_state_dict(path), "decoder_net")),
        resolve_device(device))


def mean_head(decoder_params):
    """A heteroscedastic decoder cut to its mean head (reference
    ``src/single_decoder/vae.py:29-42``), the part the single-decoder
    energy uses; ``models.vae.mean_decoder``."""
    return mean_decoder(decoder_params)


def load_single_vae_mean_decoder(path: str, device=None):
    """The mean-head decoder of a legacy single-VAE checkpoint, ready for
    the single-decoder energy modes."""
    return mean_head(load_single_vae_checkpoint(path, device).decoder)


def load_spline_blob(path: str) -> Dict[str, Any]:
    """A reference spline blob (.pt) with its tensors as numpy arrays.

    Schema (``src/optimize.py:190-201`` / ``src/init_splines_ensemble.py:
    212-216``): a dict with 'spline_data' (per-pair dicts of a, b, basis,
    omega_init[, omega_optimized, geodesic_length, euclidean_distance]),
    'representatives', 'pairs' and optionally 'metadata'.  A bare list
    (legacy single-decoder blobs) is wrapped."""
    blob = _torch_load(path)
    if isinstance(blob, list):
        blob = {"spline_data": blob, "representatives": None, "pairs": None}

    def conv(v):
        return v.detach().numpy() if isinstance(v, torch.Tensor) else v

    out = dict(blob)
    out["spline_data"] = [{k: conv(v) for k, v in d.items()}
                          for d in blob["spline_data"]]
    return out
