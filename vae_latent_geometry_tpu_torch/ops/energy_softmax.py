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
  pass 4 du W2^T, the ReLU mask and dh W1^T.  At the reduced rungs the two
  CUDA kernels are ``k2s_rows_wg`` and ``k2s_chain_wg`` (warpgroup MMA),
  at float32 ``k2s_rows<0>`` and ``k2s_chain<0>`` (FMA, no TF32); K1 keeps
  ``k1s_rows`` (mma.sync at the reduced rungs) at every rung.  The spans
  ``op.softmax.rows`` and ``op.softmax.chain`` name the body (``BODIES``).

What bounds it: the products with W2 (H x G, 99.5% of the decoder's
multiply-adds at scVI's 10-128-2000).  Each pass forms u = h W2 again, so K2
forms u four times per point and decoder (at f32x2 each is two bf16
products) and du W2^T once, where the model needs one of each, in exchange
for no (M, T B, G) buffer: only xbar and its neighbour sums (T B, G) are
kept.  On mma.sync each warp waited for its products before its
exponentials and the route ran at 4% of that bound; K2's wgmma kernels
issue the next tile's products between the exponentials of this one, and
their W2 tiles and nb come by bulk copies, one a tile: W2's planes and nb
are shipped tiled (:func:`tiled`; ``k2s_neighbours`` with ``TR``) so that a
tile is one contiguous block in the layout the kernels read.  What bounds
K2 now is the chain's nb, read from device memory twice per decoder, and
pass 2's hidden layer, formed again every second tile
(``csrc/energy_softmax.cu``'s header).  The 10 -> 128 layer runs in
float32 on the CUDA cores inside each pass.  The neighbour and segment
passes (``csrc/softmax_passes.py``) are bandwidth-bound elementwise passes
and reductions.

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
# The body of the CUDA row pass and chain at each rung (the spans'
# ``body``): FMA at float32 (no TF32); K2 at the reduced rungs on warpgroup
# MMA (``k2s_rows_wg``, ``k2s_chain_wg``); K1 (``k1s_rows``) on mma.sync.
BODIES = {"k1s": ("fma", "mma_sync", "mma_sync", "mma_sync"),
          "k2s": ("fma", "wgmma", "wgmma", "wgmma")}
# Tiles of the Triton passes: rows (or segments) a program owns, columns a
# tile, warps.
BLOCKS = {"neighbours": (32, 128, 4), "segments": (64, 64, 4)}
# The CUDA kernels' hidden width (csrc/decode_common.cuh H) and widest
# latent (csrc/energy_softmax.cu SDMAX); G is padded to a multiple of GP.
MAX_H, MAX_D, GP = 128, 16, 128
# Columns of a W2 tile, rows of a block and the float row stride of the
# chain's staged nb tile of the CUDA kernels (csrc/energy_softmax.cu SG,
# SRB, NBS): the tiles of K2's tiled W2 and nb at the reduced rungs.
SG, SRB, NBS = 64, 128, 72
# The padded weights of the last call at each rung: (the weights they were
# made from, their versions, the padded tensors).  Holding the weights
# keeps their storage alive, so an equal data pointer and version mean the
# same values.
_PREPARED: dict = {}
# K2's tiled W2 planes at the reduced rungs: (the planes of prepared() they
# were made from, the tiled hi and lo planes).
_TILED: dict = {}


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


def tiled(planes, precision):
    """K2's W2 planes at a reduced rung, (hi, lo), each (M, Gp / SG, 16,
    8, 8, 8) bf16: column tile c of decoder m is one contiguous block in the
    wgmma kernels' shared-memory layout (``csrc/energy_softmax.cu``: element
    (k, g) of the tile at (k / 8) 512 + (g / 8) 64 + (k % 8) 8 + g % 8), so
    that one bulk copy stages it.  lo is hi below f32x3.  Made once for a
    set of :func:`prepared` planes."""
    hit = _TILED.get(precision)
    if hit is not None and hit[0] is planes:
        return hit[1]
    hi, lo, Gp = planes[2], planes[3], planes[5]
    M = hi.shape[0]

    def tile(x):
        return (x.view(M, MAX_H // 8, 8, Gp // SG, SG // 8, 8)
                .permute(0, 3, 1, 4, 2, 5).contiguous())

    t_hi = tile(hi)
    out = (t_hi, tile(lo) if precision == "f32x3" else t_hi)
    _TILED[precision] = (planes, out)
    return out


def _ptr(x):
    return x.data_ptr()


def _rows(lib, stats, planes, library_size, gamma, wmb, rung, name, w2=None):
    """The row pass (CUDA): (lse (M, N), xbar (N, Gp), var (N,) or None).
    ``w2``: W2's planes in place of the padded ones (K2's tiled planes)."""
    from vae_latent_geometry_tpu_torch.ops._build import check
    from vae_latent_geometry_tpu_torch.ops.energy_fused import _stream

    w1, b1, w2a, w2b, b2, Gp = planes
    if w2 is not None:
        w2a, w2b = w2
    T, B, D = gamma.shape
    M, N = w1.shape[0], T * B
    dev = gamma.device
    lse = torch.empty((M, N), dtype=torch.float32, device=dev)
    xbar = torch.empty((N, Gp), dtype=torch.float32, device=dev)
    var = torch.empty((N,), dtype=torch.float32, device=dev) if stats else None
    with trace_annotation("op.softmax.rows",
                          body=BODIES["k1s" if stats else "k2s"][rung]):
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
    if precision != "float32":
        w2a, w2b = tiled(planes, precision)
    T, B, D = gamma.shape
    M, N = w1.shape[0], T * B
    rung = _RUNG[precision]
    lse, xbar, _ = _rows(lib, False, planes, library_size, gamma, wmb, rung,
                         "k2s_rows", (w2a, w2b))
    br, bg, warps = BLOCKS["neighbours"]
    if precision == "float32":
        rows, tr = N, 0
        nb = torch.empty_like(xbar)
    else:   # tiled for the wgmma chain: one bulk copy a tile
        rows, tr = -(-N // SRB) * SRB, SRB
        nb = xbar.new_empty((rows // SRB, Gp // SG, SRB, NBS))
    with trace_annotation("op.softmax.neighbours"):
        _passes().k2s_neighbours[(-(-rows // br), -(-Gp // bg))](
            xbar, nb, N, B, Gp, BR=br, BG=bg, TR=tr, TC=SG, TS=NBS,
            num_warps=warps)
    del xbar
    dgamma = torch.empty((T, B, D), dtype=torch.float32, device=gamma.device)
    with trace_annotation("op.softmax.chain", body=BODIES["k2s"][rung]):
        check(lib.vlg_softmax_chain(
            rung, _ptr(gamma), _ptr(w1), _ptr(b1), _ptr(w2a), _ptr(w2b),
            _ptr(b2), _ptr(library_size), _ptr(wmb), _ptr(ct), _ptr(lse),
            _ptr(nb), _ptr(dgamma), N, B, M, D, Gp, _stream(gamma.device)),
            "k2s_chain")
    return dgamma
