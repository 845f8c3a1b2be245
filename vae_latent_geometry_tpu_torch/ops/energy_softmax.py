"""K1 and K2 for decoders with scVI's softmax head: the ``"softmax"`` route
of ``energy_fused.energy_fwd`` / ``energy_bwd``.

The decoder (``models/nets.py``, scvi-tools ``DecoderSCVI``): h = ReLU(z W1
+ b1), scVI's eval-mode BatchNorm folded into W1, b1 before the call
(``nets.fold_batchnorm``); u = h W2 + b2 over G genes; x = L softmax(u).
The expected energy is that of ``energy_fused``, E_b = sum_t |xbar_{t+1} -
xbar_t|^2 + var_{t+1} + var_t.

Replaces no TPU kernel: the JAX package has no softmax-headed decoder.  A
linear head's energy is a sum over output columns, so the linear kernels cut
a wide output into column slices (``energy_fused.sum_slices``).  Here a
column's value needs its row's log-sum-exp over all G columns, and the
chain back from x needs a second row reduction, <s, g>, before any column's
contribution: dE/du = L s (g - <s, g>), g = dE/dx.  Each block of the
kernels owns a block of rows and walks all G columns itself, so every
reduction is summed in one fixed order and a repeat is bit for bit the
same.

K1 (forward energies: the final pass, early stopping):
  ``k1s_rows`` (CUDA) pass 1 the log-sum-exps, pass 2 xbar and var
  (centred on decoder 0, as K1's linear kernels); ``k1s_segments``
  (Triton) the segment sums per spline.
K2 (the gradient, every optimizer step):
  ``k2s_rows`` (CUDA) pass 1 the log-sum-exps, pass 2 xbar;
  ``k2s_neighbours`` (Triton) xbar_{t-1} + xbar_{t+1}, read by each
  decoder's passes; ``k2s_chain`` (CUDA) pass 3 <s, g> per (decoder, row),
  pass 4 du W2^T, the ReLU mask and dh W1^T.

What bounds it: the products with W2 (H x G, 99.5% of the decoder's
multiply-adds at scVI's 10-128-2000), on the tensor cores at the reduced
rungs (``csrc/energy_softmax.cu``: mma.sync bf16 hi/lo on
``decode_mma.cuh``'s fragments).  Each pass forms u = h W2 again, so K2
forms u four times per point and decoder (at f32x2 each is two bf16
products) and du W2^T once, where the model needs one of each, in exchange
for no (M, T B, G) buffer: only xbar and its neighbour sums (T B, G) are
kept.  The 10 -> 128 layer runs in float32 on the CUDA cores inside each
pass.  The neighbour and segment passes (``csrc/softmax_passes.py``) are
bandwidth-bound elementwise passes and reductions.

The kernels take the weights padded (hidden width to 128, G to a multiple
of 128) and W2 as the rung's bf16 planes; :func:`prepared` makes them once
for a set of weights and keeps them while those weights are unchanged.
Triton is imported by the first launch (:func:`_passes`), never when this
module is imported: the CPU has no triton.
"""

from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

import torch

from vae_latent_geometry_tpu_torch.utils.profiling import trace_annotation

PASSES = Path(__file__).resolve().parent / "csrc" / "softmax_passes.py"
_RUNG = {"float32": 0, "f32x3": 1, "f32x2": 2, "bfloat16": 3}
# The passes over the G columns of every (point, decoder) row that a launch
# of each op makes (``energy_fused.SOFTMAX_PASSES`` counts them).
PLAN = {"energy_fwd": ("lse", "stats"),
        "energy_bwd": ("lse", "xbar", "row_dot", "chain")}
# Tiles of the Triton passes: rows (or segments) a program owns, columns a
# tile, warps.
BLOCKS = {"neighbours": (32, 128, 4), "segments": (64, 64, 4)}
# The CUDA kernels' hidden width (csrc/decode_common.cuh H) and widest
# latent (csrc/energy_softmax.cu SDMAX); G is padded to a multiple of GP.
MAX_H, MAX_D, GP = 128, 16, 128
# The padded weights of the last call at each rung: (the weights they were
# made from, their versions, the padded tensors).  Holding the weights
# keeps their storage alive, so an equal data pointer and version mean the
# same values.
_PREPARED: dict = {}


@functools.lru_cache(maxsize=None)
def _passes():
    """The Triton passes, loaded once from ``csrc/softmax_passes.py``."""
    name = "vae_latent_geometry_tpu_torch_softmax_passes"
    spec = importlib.util.spec_from_file_location(name, PASSES)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def check_shape(ws, library_size) -> None:
    """Raise for a decoder the route does not take: two layers (scVI's
    n_layers 1), H <= MAX_H, D <= MAX_D, one library size a decoder."""
    from vae_latent_geometry_tpu_torch.ops.energy_fused import _PLAIN_MODES

    if len(ws) != 2:
        raise ValueError(f"the softmax route takes decoders of 2 layers "
                         f"(one hidden layer), got {len(ws)}" + _PLAIN_MODES)
    M, D, H = ws[0].shape
    if H > MAX_H or D > MAX_D:
        raise ValueError(f"the softmax route takes a hidden width up to "
                         f"{MAX_H} and a latent width up to {MAX_D}, got "
                         f"H={H}, D={D}" + _PLAIN_MODES)
    if tuple(library_size.shape) != (M,):
        raise ValueError(f"library sizes must be (M,) = ({M},), got "
                         f"{tuple(library_size.shape)}")


def _pad(ws, bs, precision):
    """(w1 (M, D, 128), b1 (M, 128), W2's planes (M, 128, Gp) (hi, lo; both
    the float W2 at float32, lo = hi below f32x3), b2 (M, Gp), Gp): zero
    past H and G, b2 -inf past G."""
    M, D, H = ws[0].shape
    G = ws[1].shape[-1]
    Gp = -(-G // GP) * GP
    w1 = ws[0].new_zeros((M, D, MAX_H))
    w1[:, :, :H] = ws[0]
    b1 = bs[0].new_zeros((M, MAX_H))
    b1[:, :H] = bs[0]
    w2 = ws[1].new_zeros((M, MAX_H, Gp))
    w2[:, :H, :G] = ws[1]
    b2 = bs[1].new_full((M, Gp), float("-inf"))
    b2[:, :G] = bs[1]
    if precision == "float32":
        return w1, b1, w2, w2, b2, Gp
    hi = w2.to(torch.bfloat16)
    lo = ((w2 - hi.float()).to(torch.bfloat16) if precision == "f32x3"
          else hi)
    return w1, b1, hi, lo, b2, Gp


def prepared(ws, bs, precision):
    """:func:`_pad` of the weights shipped at the rung
    (``energy_fused.ship_weights``), made once and kept while the same
    weights come back unchanged (every step of a chunk)."""
    from vae_latent_geometry_tpu_torch.ops.energy_fused import ship_weights

    key = [(t.data_ptr(), t._version, tuple(t.shape))
           for t in (*ws, *bs)]
    hit = _PREPARED.get(precision)
    if hit is not None and hit[1] == key:
        return hit[2]
    out = _pad(ship_weights(ws, precision), bs, precision)
    _PREPARED[precision] = (list(ws) + list(bs), key, out)
    return out


def _ptr(x):
    return x.data_ptr()


def _rows(lib, stats, planes, library_size, gamma, wmb, rung, name):
    """The row pass (CUDA): (lse (M, N), xbar (N, Gp), var (N,) or None)."""
    from vae_latent_geometry_tpu_torch.ops._build import check
    from vae_latent_geometry_tpu_torch.ops.energy_fused import _stream

    w1, b1, w2a, w2b, b2, Gp = planes
    T, B, D = gamma.shape
    M, N = w1.shape[0], T * B
    dev = gamma.device
    lse = torch.empty((M, N), dtype=torch.float32, device=dev)
    xbar = torch.empty((N, Gp), dtype=torch.float32, device=dev)
    var = torch.empty((N,), dtype=torch.float32, device=dev) if stats else None
    with trace_annotation("op.softmax.rows"):
        check(lib.vlg_softmax_rows(
            rung, int(stats), _ptr(gamma), _ptr(w1), _ptr(b1), _ptr(w2a),
            _ptr(w2b), _ptr(b2), _ptr(library_size), _ptr(wmb), _ptr(lse),
            _ptr(xbar), _ptr(var) if stats else None, N, B, M, D, Gp,
            _stream(dev)), name)
    return lse, xbar, var


def energy_fwd(ws, bs, library_size, gamma, wmb, precision):
    """K1 on the softmax route: (T, B, D) curve -> (B,) energies.  ``ws``,
    ``bs``: the decoder in float32, BatchNorm folded (shipped at the rung
    by :func:`prepared`); ``library_size`` (M,)."""
    from vae_latent_geometry_tpu_torch.ops._build import library

    lib = library("energy_softmax")
    planes = prepared(ws, bs, precision)
    T, B, D = gamma.shape
    Gp = planes[-1]
    _, xbar, var = _rows(lib, True, planes, library_size, gamma, wmb,
                         _RUNG[precision], "k1s_rows")
    tt, bg, warps = BLOCKS["segments"]
    n_t = max(1, -(-(T - 1) // tt))
    part = torch.empty((n_t, B), dtype=torch.float32, device=gamma.device)
    with trace_annotation("op.softmax.segments"):
        _passes().k1s_segments[(n_t, B)](xbar, var, part, T, B, Gp, TT=tt,
                                         BG=bg, num_warps=warps)
    return part.sum(0)


def energy_bwd(ws, bs, library_size, gamma, wmb, ct, precision):
    """K2 on the softmax route: dgamma (T, B, D) of sum_b ct_b E_b."""
    from vae_latent_geometry_tpu_torch.ops._build import check, library
    from vae_latent_geometry_tpu_torch.ops.energy_fused import _stream

    lib = library("energy_softmax")
    planes = prepared(ws, bs, precision)
    w1, b1, w2a, w2b, b2, Gp = planes
    T, B, D = gamma.shape
    M, N = w1.shape[0], T * B
    rung = _RUNG[precision]
    lse, xbar, _ = _rows(lib, False, planes, library_size, gamma, wmb, rung,
                         "k2s_rows")
    br, bg, warps = BLOCKS["neighbours"]
    nb = torch.empty_like(xbar)
    with trace_annotation("op.softmax.neighbours"):
        _passes().k2s_neighbours[(-(-N // br), -(-Gp // bg))](
            xbar, nb, N, B, Gp, BR=br, BG=bg, num_warps=warps)
    del xbar
    dgamma = torch.empty((T, B, D), dtype=torch.float32, device=gamma.device)
    with trace_annotation("op.softmax.chain"):
        check(lib.vlg_softmax_chain(
            rung, _ptr(gamma), _ptr(w1), _ptr(b1), _ptr(w2a), _ptr(w2b),
            _ptr(b2), _ptr(library_size), _ptr(wmb), _ptr(ct), _ptr(lse),
            _ptr(nb), _ptr(dgamma), N, B, M, D, Gp, _stream(gamma.device)),
            "k2s_chain")
    return dgamma
