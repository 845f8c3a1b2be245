"""Fused expected ensemble energy: the port of ``ops/energy_pallas.py``.

Four kernels, each beside a plain PyTorch version of the same function:

- :func:`energy_fwd` (K1, replaces ``energy_pallas.py:254 _fwd_kernel``):
  (T, B, D) curve -> (B,) energies
  E_b = sum_t ||xbar_{t+1} - xbar_t||^2 + var_{t+1} + var_t
  with centered statistics around decoder 0 (cancellation-free).
- :func:`energy_bwd` (K2, replaces ``energy_pallas.py:325 _bwd_kernel``):
  dgamma for a per-spline cotangent, through
  dE/dx_{m,t} = 2 w_{m,b} ct_b (c_t x_{m,t} - (xbar_{t-1} + xbar_{t+1}))
  and the ReLU-masked chain of the same decode.
- :func:`stats_fwd` (K3, replaces ``energy_pallas.py:472
  _stats_fwd_kernel``) and :func:`stats_bwd` (K4, ``:502
  _stats_bwd_kernel``): the per-shard sufficient statistics (x0, yb, sq) of
  a local decoder subset and their gradient, from which
  :func:`energy_expected_sharded` assembles the decoder-sharded energy.

A CUDA tensor launches the kernel (``csrc/energy_expected.cu``,
``csrc/energy_stats.cu``) or raises;
only a CPU tensor takes the plain version.  Both follow the precision-rung
semantics of ``_split_hi_lo`` / ``_prep_w`` / ``_mp_dot``: bf16 hi/lo
operands, exact fp32 products, fp32 accumulation.  The plain version
upcasts the bf16-rounded operands before each product, since a bf16
``torch.matmul`` would round its OUTPUT to bf16.

Weights (decoders) and the weight plane ``wmb`` are never differentiated:
geodesic optimization trains only the curve.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vae_latent_geometry_tpu_torch.utils.profiling import trace_annotation

PRECISIONS = ("float32", "f32x3", "f32x2", "bfloat16")
_RUNG = {"float32": 0, "f32x3": 1, "f32x2": 2, "bfloat16": 3}
# The decoders the CUDA kernels take (``csrc/decode_any.cuh``): two or more
# layers of any width, any latent width D and, per launch, outputs up to
# MAX_X columns; a wider output runs in column slices of MAX_X (every energy
# and dgamma is a sum over output features, K3's x0 and yb concatenate).  At
# a reduced rung the chain rounds each slice's cotangents to bf16 apart, so
# the kernels' dgamma there differs from the plain versions' whole-X chain
# by that rounding.
# D <= 4 -> 128 -> 128 -> X <= 64 runs the production kernels, every other
# shape the generic ones.
MAX_X = 128
# The kernels index with 32-bit ints: one launch takes T * B * (widest
# layer) below this, and a larger batch runs in launches over ranges of its
# splines (every output of a spline depends on that spline alone).
INDEX_LIMIT = 2**31 - 2**16

# Launches of each kernel's wrapper (one per wrapper call that launched the
# CUDA kernel; the plain CPU version does not count).  The launching part of
# each wrapper is an ``op.<wrapper>`` span.
LAUNCHES = {"energy_fwd": 0, "energy_bwd": 0, "stats_fwd": 0, "stats_bwd": 0}
# K2's launches again, by the route each took (:func:`k2_route`).  Kept out
# of LAUNCHES, whose values callers sum as the op's launch count.
K2_ROUTES = {"one_decode": 0, "fma": 0, "any": 0}
# The production decoder shape of the fixed kernels (``csrc/decode_any.cuh``
# fixed_shape): D <= 4 -> 128 -> 128 -> X <= 64.
FIXED_D, FIXED_H, FIXED_X = 4, 128, 64
# The one-pass kernels' tiles (``csrc/tiles_mma.cuh``): curve rows of this
# many splines, this many rows a tile (one of them the next tile's first).
SPAN_SPLINES = 4
SPAN_ROWS = 32


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, K2_ROUTES):
        for k in counts:
            counts[k] = 0


def k2_route(precision: str, widths) -> str:
    """The kernels K2 launches for a rung and a decoder of ``widths`` (D,
    ..., X): ``"one_decode"`` (one launch that decodes every point once per
    decoder, on the tensor cores, after one that prepares the weight planes)
    at a reduced rung on the production shape, ``"fma"`` (two passes through
    an xbar buffer) at float32 there, ``"any"`` (the generic decode's two
    passes) for every other decoder."""
    check_precision(precision)
    D, *hidden, X = widths
    if not (D <= FIXED_D and hidden == [FIXED_H, FIXED_H] and X <= FIXED_X):
        return "any"
    return "fma" if precision == "float32" else "one_decode"


def pick_spans(T: int, B: int, n_sm: int, halo: int,
               rows: int = SPAN_ROWS):
    """(span, G): the T-span each block walks and the number of spans per
    spline, for the kernels whose persistent blocks (one per SM) take the
    ceil(B / 4) * G (spline group, span) items in a fixed stride (K2's
    one-pass kernel, K10); a span's chunks add ``rows`` curve rows each and
    it decodes ``halo`` extra points; G minimises rounds x chunks per span,
    the smaller G on a tie."""
    groups = -(-B // SPAN_SPLINES)
    best = None
    for G in range(1, -(-T // rows) + 1):
        span = -(-T // G)
        g_eff = -(-T // span)
        cost = (-(-groups * g_eff // n_sm)) * (-(-(span + halo) // rows))
        if best is None or cost < best[0]:
            best = (cost, span, g_eff)
    return best[1], best[2]


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown kernel precision {precision!r}")


def uniform_weights(M: int, B: int, device=None):
    """The (M, B) weight plane of the plain ensemble mean."""
    return torch.full((M, B), 1.0 / M, dtype=torch.float32, device=device)


def active_weights(num_active, M: int, B: int, device=None):
    """Masked-mean weight plane for per-spline first-k-decoder subsets:
    w[m, b] = (m < k_b) / k_b."""
    k = torch.as_tensor(num_active, dtype=torch.int32,
                        device=device).expand(B)
    mask = (torch.arange(M, device=k.device)[:, None] < k[None, :]).float()
    return mask / k.float()[None, :]


def stack_weights(decoders):
    """(ws, bs): stacked (M, in, out) weights and (M, out) biases."""
    layers = decoders["layers"]
    return [l["w"] for l in layers], [l["b"] for l in layers]


def ship_weights(ws, precision):
    """At the bfloat16 rung every weight — W1 included — is shipped as bf16
    (``_cast_ws``); the other rungs ship fp32."""
    if precision == "bfloat16":
        return [w.to(torch.bfloat16).float() for w in ws]
    return [w.float() for w in ws]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _bf(x):
    return x.to(torch.bfloat16).float()


def _split(x):
    hi = _bf(x)
    return hi, _bf(x - hi)


def _mp_matmul(h, w, precision):
    """h @ w at a precision rung, fp32 accumulation."""
    if precision == "float32":
        return h @ w
    if precision == "bfloat16":
        return _bf(h) @ _bf(w)
    w_hi, w_lo = _split(w)
    h_hi, h_lo = _split(h)
    out = h_hi @ w_hi + h_lo @ w_hi
    if precision == "f32x3":
        out = out + h_hi @ w_lo
    return out


def _decode_plain(g, ws, bs, m, precision):
    """One decoder on (N, D) points -> (x (N, X), ReLU masks of the hidden
    layers)."""
    w1 = ws[0][m]
    h = bs[0][m]
    for d in range(g.shape[1]):
        h = h + g[:, d:d + 1] * w1[d]
    h = torch.relu(h)
    masks = [h > 0]
    n_layers = len(ws)
    for i in range(1, n_layers):
        h = _mp_matmul(h, ws[i][m], precision) + bs[i][m]
        if i < n_layers - 1:
            h = torch.relu(h)
            masks.append(h > 0)
    return h, masks


def energy_fwd_plain(ws, bs, gamma, wmb, precision):
    """Plain version of K1 (same arguments as :func:`energy_fwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    M = ws[0].shape[0]
    g = gamma.reshape(T * B, D)
    x0 = _decode_plain(g, ws, bs, 0, precision)[0].reshape(T, B, -1)
    ybar = torch.zeros_like(x0)
    sqy = torch.zeros((T, B), dtype=torch.float32, device=gamma.device)
    for m in range(1, M):
        y = _decode_plain(g, ws, bs, m, precision)[0].reshape(T, B, -1) - x0
        ybar = ybar + wmb[m][None, :, None] * y
        sqy = sqy + wmb[m][None, :] * (y * y).sum(-1)
    xbar = x0 + ybar
    diff = xbar[1:] - xbar[:-1]
    seg = (diff * diff).sum(-1)
    if M > 1:
        var = sqy - (ybar * ybar).sum(-1)
        seg = seg + var[1:] + var[:-1]
    return seg.sum(0)


def energy_bwd_plain(ws, bs, gamma, wmb, ct, precision):
    """Plain version of K2 (same arguments as :func:`energy_bwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    M = ws[0].shape[0]
    chain = "bfloat16" if precision in ("f32x3", "f32x2") else precision
    g = gamma.reshape(T * B, D)
    xbar = 0.0
    for m in range(M):
        x = _decode_plain(g, ws, bs, m, precision)[0].reshape(T, B, -1)
        xbar = xbar + wmb[m][None, :, None] * x
    nb = torch.zeros_like(xbar)
    nb[1:] = xbar[:-1]
    nb[:-1] = nb[:-1] + xbar[1:]
    t = torch.arange(T, device=gamma.device)
    c = ((t > 0).float() + (t < T - 1).float())[:, None, None]
    dg = torch.zeros((T * B, D), dtype=torch.float32, device=gamma.device)
    for m in range(M):
        x, masks = _decode_plain(g, ws, bs, m, precision)
        scale = 2.0 * (wmb[m] * ct)[None, :, None]
        dh = (scale * (c * x.reshape(T, B, -1) - nb)).reshape(T * B, -1)
        for i in range(len(ws) - 1, 0, -1):
            dh = _mp_matmul(dh, ws[i][m].T, chain) * masks[i - 1]
        dg = dg + dh @ ws[0][m].T
    return dg.reshape(T, B, D)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

# what a shape refusal says: the fused modes run these kernels and nothing
# else on the card, the plain modes take any decoder
_PLAIN_MODES = ("; on the card the fused modes need the kernels' shapes: run "
                "the plain mode instead (expected, mc or single)")


def _check_cuda(ws, bs, gamma, wmb=None, extra=()):
    """Raise on malformed inputs; returns (T, B, D, M, X).  ``wmb``: the
    (M, B) weight plane of K1/K2 (the MC kernels have none)."""
    dev = gamma.device
    tensors = [gamma, *ws, *bs, *extra] + ([] if wmb is None else [wmb])
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"kernel inputs must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    T, B, D = gamma.shape
    if len(ws) < 2 or len(bs) != len(ws):
        raise ValueError(f"the kernels take decoders of 2 or more layers, got "
                         f"{len(ws)} weights and {len(bs)} biases"
                         + _PLAIN_MODES)
    M = ws[0].shape[0]
    widths = [D] + [w.shape[-1] for w in ws]
    X = widths[-1]
    if D < 1 or min(widths) < 1:
        raise ValueError(f"decoder widths {widths} must be positive")
    if [tuple(w.shape) for w in ws] != [
            (M, i, o) for i, o in zip(widths[:-1], widths[1:])]:
        raise ValueError(f"decoder shapes {[tuple(w.shape) for w in ws]} do "
                         f"not chain from the latent width D={D}")
    for layer, (w, b) in enumerate(zip(ws, bs)):
        if tuple(b.shape) != (M, w.shape[-1]):
            raise ValueError(f"bias {layer} of shape {tuple(b.shape)} does "
                             f"not match its weight {tuple(w.shape)}"
                             + _PLAIN_MODES)
    if wmb is not None and tuple(wmb.shape) != (M, B):
        raise ValueError(f"wmb must be (M, B) = ({M}, {B}), got "
                         f"{tuple(wmb.shape)}")
    if T * max(widths) >= INDEX_LIMIT:
        raise ValueError(f"a curve of T={T} points through a {max(widths)}-"
                         "wide layer exceeds the kernels' 32-bit indexing"
                         + _PLAIN_MODES)
    return T, B, D, M, X


def spline_ranges(T, B, widths):
    """The (b0, b1) spline ranges of a batch's launches: as few as keep
    T * (b1 - b0) * max(widths) under :data:`INDEX_LIMIT`, of equal size."""
    per = max(1, INDEX_LIMIT // (T * max(widths)))
    n = -(-B // per)
    size = -(-B // n)
    return [(b0, min(B, b0 + size)) for b0 in range(0, B, size)]


def _slice_widths(X):
    """The output widths of :func:`x_slices`' column slices."""
    return [min(MAX_X, X - c0) for c0 in range(0, X, MAX_X)]


def x_slices(ws, bs):
    """The decoder with its output layer cut into column slices of at most
    :data:`MAX_X`: [(ws, bs, c0, c1)] (the decoder itself when X fits)."""
    X = ws[-1].shape[-1]
    if X <= MAX_X:
        return [(ws, bs, 0, X)]
    out = []
    for c0 in range(0, X, MAX_X):
        c1 = min(X, c0 + MAX_X)
        out.append(([*ws[:-1], ws[-1][:, :, c0:c1].contiguous()],
                    [*bs[:-1], bs[-1][:, c0:c1].contiguous()], c0, c1))
    return out


def by_splines(T, B, ws, run):
    """``run(b0, b1)`` for each launch range of :func:`spline_ranges`, the
    outputs (a tensor or a tuple of them, splines on axis 1, or on axis 0
    of a (B,) output) joined in range order; one range returns
    ``run(0, B)``."""
    widths = [ws[0].shape[1]] + [w.shape[-1] for w in ws]
    ranges = spline_ranges(T, B, widths)
    if len(ranges) == 1:
        return run(0, B)
    parts = [run(b0, b1) for b0, b1 in ranges]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1 if p[0].dim() > 1 else 0)
                     for p in zip(*parts))
    return torch.cat(parts, dim=1 if parts[0].dim() > 1 else 0)


def sum_slices(ws, bs, run):
    """``run(ws, bs, c0, c1)`` for each column slice of :func:`x_slices`,
    summed in slice order (one slice: returned as is)."""
    total = None
    for wsx, bsx, c0, c1 in x_slices(ws, bs):
        part = run(wsx, bsx, c0, c1)
        total = part if total is None else total + part
    return total


@functools.lru_cache(maxsize=None)
def _int_array(values):
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=64)
def _ptr_array(ptrs):
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _decoder_args(ws, bs):
    """(widths, dec): the widths D, ..., X, and the decoder as the entry
    points take it: L, widths[0..L] and the per-layer weight and bias
    pointers as ctypes arrays, made once per shape and per set of addresses
    (the entry points only read them)."""
    widths = (ws[0].shape[1],) + tuple(w.shape[-1] for w in ws)
    return widths, (len(ws), _int_array(widths),
                    _ptr_array(tuple(w.data_ptr() for w in ws)),
                    _ptr_array(tuple(b.data_ptr() for b in bs)))


@functools.lru_cache(maxsize=None)
def _n_sm(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _scratch_words(lib, widths, n_areas):
    return lib.vlg_any_scratch_words(len(widths) - 1, _int_array(widths),
                                     n_areas)


def _any_scratch(lib, widths, n_areas, dev, n_blocks=None):
    """(scratch, n_blocks) of the generic kernels: the decoder's description
    (``vlg_any_head_words``), then one persistent block per SM (or
    ``n_blocks``), each with its activation planes and ``n_areas`` mask
    areas; (None, n_blocks) for the production shape, whose kernels take
    none."""
    if n_blocks is None:
        n_blocks = _n_sm(dev)
    words = _scratch_words(lib, widths, n_areas)
    if words < 0:
        raise ValueError(f"decoder widths {list(widths)} refused by the "
                         "kernels" + _PLAIN_MODES)
    if words == 0:
        return None, n_blocks
    head = lib.vlg_any_head_words(len(widths) - 1)
    return torch.empty((head + n_blocks * words,), dtype=torch.int32,
                       device=dev), n_blocks


def _fwd_scratch(lib, precision, widths, M, dev):
    """(scratch, n_blocks) of the forward kernels: the generic decode's
    (:func:`_any_scratch`), or at float32 on the production shape the
    float32 kernels' copy of W3 padded to 64 columns."""
    scratch, n_blocks = _any_scratch(lib, widths, 1, dev)
    if scratch is None:
        words = lib.vlg_f32_scratch_words(_RUNG[precision], M, len(widths) - 1,
                                          _int_array(widths))
        if words > 0:
            scratch = torch.empty((words,), dtype=torch.float32, device=dev)
    return scratch, n_blocks


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def energy_fwd(ws, bs, gamma, wmb, precision):
    """K1: (T, B, D) curve -> (B,) expected energies."""
    if gamma.device.type == "cpu":
        return energy_fwd_plain(ws, bs, gamma, wmb, precision)
    if gamma.device.type != "cuda":
        raise ValueError(f"no kernel for device {gamma.device}")
    from vae_latent_geometry_tpu_torch.ops._build import check, library

    check_precision(precision)
    ws = [w.contiguous() for w in ship_weights(ws, precision)]
    T, B, D, M, X = _check_cuda(ws, bs, gamma, wmb)
    lib = library("energy_expected")

    def launch(wsx, bsx, g, w_b):
        Bc = g.shape[1]
        widths, dec = _decoder_args(wsx, bsx)
        scratch, n_blocks = _fwd_scratch(lib, precision, widths, M, g.device)
        partial = torch.empty((lib.vlg_energy_fwd_tiles(T), Bc),
                              dtype=torch.float32, device=g.device)
        out = torch.empty((Bc,), dtype=torch.float32, device=g.device)
        check(lib.vlg_energy_fwd(_RUNG[precision], g.data_ptr(), T, Bc, M,
                                 *dec, w_b.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), _ptr(scratch), n_blocks,
                                 _stream(g.device)),
              "energy_fwd")
        LAUNCHES["energy_fwd"] += 1
        return out

    with trace_annotation("op.energy_fwd"):
        return by_splines(T, B, ws, lambda b0, b1: sum_slices(
            ws, bs, lambda wsx, bsx, c0, c1: launch(
                wsx, bsx, _splines(gamma, b0, b1), _splines(wmb, b0, b1))))


def energy_bwd(ws, bs, gamma, wmb, ct, precision):
    """K2: dgamma (T, B, D) of sum_b ct_b E_b (route: :func:`k2_route`)."""
    if gamma.device.type == "cpu":
        return energy_bwd_plain(ws, bs, gamma, wmb, ct, precision)
    if gamma.device.type != "cuda":
        raise ValueError(f"no kernel for device {gamma.device}")
    from vae_latent_geometry_tpu_torch.ops._build import check, library

    check_precision(precision)
    ws = [w.contiguous() for w in ship_weights(ws, precision)]
    T, B, D, M, X = _check_cuda(ws, bs, gamma, wmb, (ct,))
    if tuple(ct.shape) != (B,):
        raise ValueError(f"ct must be (B,) = ({B},), got {tuple(ct.shape)}")
    lib = library("energy_expected")
    hidden = [w.shape[-1] for w in ws[:-1]]
    routes = [k2_route(precision, [D, *hidden, x]) for x in _slice_widths(X)]
    if "one_decode" in routes:   # its kernel stages W1, b1, b2 by cp.async
        ws = [_aligned16(ws[0]), *ws[1:]]
        bs = [_aligned16(bs[0]), _aligned16(bs[1]), *bs[2:]]

    def launch(wsx, bsx, g, w_b, ct_b):
        Bc, Xs = g.shape[1], wsx[-1].shape[-1]
        widths, dec = _decoder_args(wsx, bsx)
        route = k2_route(precision, widths)
        xbar = None
        if route == "one_decode":
            n_sm = _n_sm(g.device)
            span, G = pick_spans(T, Bc, n_sm, 1, SPAN_ROWS - 1)
            n_blocks = min(G * -(-Bc // SPAN_SPLINES), n_sm)
            scratch = torch.empty(
                (n_blocks * lib.vlg_k2_block_words(M, Xs)
                 + lib.vlg_k2_plane_words(M),), dtype=torch.int32,
                device=g.device)
        else:
            span = G = 0
            scratch, n_blocks = _any_scratch(lib, widths, 1, g.device)
            xbar = torch.empty((T, Bc, Xs), dtype=torch.float32,
                               device=g.device)
        dgamma = torch.empty((T, Bc, D), dtype=torch.float32, device=g.device)
        check(lib.vlg_energy_bwd(_RUNG[precision], g.data_ptr(), T, Bc, M,
                                 span, G, *dec, w_b.data_ptr(),
                                 ct_b.data_ptr(), _ptr(xbar),
                                 dgamma.data_ptr(), _ptr(scratch), n_blocks,
                                 _stream(g.device)),
              "energy_bwd")
        LAUNCHES["energy_bwd"] += 1
        K2_ROUTES[route] += 1
        return dgamma

    with trace_annotation("op.energy_bwd",
                          route="+".join(dict.fromkeys(routes))):
        return by_splines(T, B, ws, lambda b0, b1: sum_slices(
            ws, bs, lambda wsx, bsx, c0, c1: launch(
                wsx, bsx, _splines(gamma, b0, b1), _splines(wmb, b0, b1),
                ct[b0:b1].contiguous())))


def _aligned16(x):
    """x, or a copy of it where its data does not start on 16 bytes."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _splines(x, b0, b1):
    """Splines b0..b1-1 of a (T, B, ...) or (M, B) tensor, contiguous (the
    tensor itself when that is all of it)."""
    return x[:, b0:b1].contiguous()


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

class _EnergyExpectedFused(torch.autograd.Function):
    """Energy (or zeros, ``grad_only``) forward; K2 backward.  The backward
    needs only the inputs (it recomputes activations), so the gradient is
    the same whether or not the forward kernel ran."""

    @staticmethod
    def forward(ctx, gamma, ws, bs, wmb, precision, grad_only):
        ctx.save_for_backward(gamma)
        ctx.ws, ctx.bs, ctx.wmb, ctx.precision = ws, bs, wmb, precision
        if grad_only:
            check_precision(precision)
            return gamma.new_zeros(gamma.shape[1])
        return energy_fwd(ws, bs, gamma, wmb, precision)

    @staticmethod
    def backward(ctx, ct):
        (gamma,) = ctx.saved_tensors
        dg = energy_bwd(ctx.ws, ctx.bs, gamma.contiguous(), ctx.wmb,
                        ct.contiguous().float(), ctx.precision)
        return dg, None, None, None, None, None


def _prepare(decoders, gamma, wmb):
    ws, bs = stack_weights(decoders)
    ws = [w.detach() for w in ws]
    bs = [b.detach().contiguous() for b in bs]
    M, B = ws[0].shape[0], gamma.shape[1]
    if wmb is None:
        wmb = uniform_weights(M, B, gamma.device)
    wmb = wmb.detach().float().contiguous()
    return ws, bs, wmb


def energy_expected_fused(decoders, gamma, wmb=None,
                          precision: str = "float32"):
    """Fused expected ensemble energy: (T, B, D) curve -> (B,) energies.

    ``wmb``: optional (M, B) per-spline weights summing to 1 over M (default
    uniform); see :func:`active_weights`.  Differentiable in ``gamma``
    only."""
    ws, bs, wmb = _prepare(decoders, gamma, wmb)
    return _EnergyExpectedFused.apply(gamma.contiguous(), ws, bs, wmb,
                                      precision, False)


def energy_expected_fused_grad(decoders, gamma, wmb=None,
                               precision: str = "float32"):
    """Gradient-only variant: returns ZEROS as the value but carries the
    same backward, so the forward kernel never runs.  Use only where the
    energy value is discarded (the optimizer's trajectory steps)."""
    ws, bs, wmb = _prepare(decoders, gamma, wmb)
    return _EnergyExpectedFused.apply(gamma.contiguous(), ws, bs, wmb,
                                      precision, True)


# ---------------------------------------------------------------------------
# Ensemble sufficient statistics (the decoder-sharded path).
#
# The expected energy is a function of per-(t, b) statistics that are SUMS
# over decoders, so each shard of the decoder axis computes them over its
# local subset, centered on its own first decoder:
#   x0 = x_{m0}(t, b),  yb = sum_{j>=1} w_j (x_j - x0),
#   sq = sum_{j>=1} w_j ||x_j - x0||^2
# and the energy is assembled from all-reduced statistics in plain PyTorch
# (:func:`energy_expected_sharded`).  Centering keeps every communicated
# quantity at deviation scale, so float32 sums lose nothing.
# ---------------------------------------------------------------------------

def stats_fwd_plain(ws, bs, gamma, wmb, precision):
    """Plain version of K3 (same arguments as :func:`stats_fwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    M = ws[0].shape[0]
    g = gamma.reshape(T * B, D)
    x0 = _decode_plain(g, ws, bs, 0, precision)[0].reshape(T, B, -1)
    yb = torch.zeros_like(x0)
    sq = torch.zeros((T, B), dtype=torch.float32, device=gamma.device)
    for m in range(1, M):
        y = _decode_plain(g, ws, bs, m, precision)[0].reshape(T, B, -1) - x0
        yb = yb + wmb[m][None, :, None] * y
        sq = sq + wmb[m][None, :] * (y * y).sum(-1)
    return x0, yb, sq


def stats_bwd_plain(ws, bs, gamma, wmb, dx0, dyb, dsq, precision):
    """Plain version of K4 (same arguments as :func:`stats_bwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    M = ws[0].shape[0]
    chain = "bfloat16" if precision in ("f32x3", "f32x2") else precision
    g = gamma.reshape(T * B, D)
    dg = torch.zeros((T * B, D), dtype=torch.float32, device=gamma.device)

    def backprop(c, m, masks):
        dh = c.reshape(T * B, -1)
        for i in range(len(ws) - 1, 0, -1):
            dh = _mp_matmul(dh, ws[i][m].T, chain) * masks[i - 1]
        return dh @ ws[0][m].T

    x0, masks0 = _decode_plain(g, ws, bs, 0, precision)
    x0 = x0.reshape(T, B, -1)
    c_sum = torch.zeros_like(x0)
    for m in range(1, M):
        x, masks = _decode_plain(g, ws, bs, m, precision)
        y = x.reshape(T, B, -1) - x0
        c = wmb[m][None, :, None] * (dyb + 2.0 * y * dsq[:, :, None])
        c_sum = c_sum + c
        dg = dg + backprop(c, m, masks)
    # decoder 0: its direct cotangent minus every y_j's dependency on x0
    dg = dg + backprop(dx0 - c_sum, 0, masks0)
    return dg.reshape(T, B, D)


def _check_stats_ct(T, B, X, dx0, dyb, dsq):
    want = {"dx0": (T, B, X), "dyb": (T, B, X), "dsq": (T, B)}
    for name, x in (("dx0", dx0), ("dyb", dyb), ("dsq", dsq)):
        if tuple(x.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(x.shape)}")


def stats_fwd(ws, bs, gamma, wmb, precision):
    """K3: (T, B, D) curve, local decoders and local weight rows (M, B) ->
    (x0 (T, B, X), yb (T, B, X), sq (T, B))."""
    if gamma.device.type == "cpu":
        return stats_fwd_plain(ws, bs, gamma, wmb, precision)
    if gamma.device.type != "cuda":
        raise ValueError(f"no kernel for device {gamma.device}")
    from vae_latent_geometry_tpu_torch.ops._build import check, library

    check_precision(precision)
    ws = [w.contiguous() for w in ship_weights(ws, precision)]
    T, B, D, M, X = _check_cuda(ws, bs, gamma, wmb)
    lib = library("energy_stats")

    def launch(wsx, bsx, g, w_b):
        Bc, Xs = g.shape[1], wsx[-1].shape[-1]
        widths, dec = _decoder_args(wsx, bsx)
        scratch, n_blocks = _any_scratch(lib, widths, 2, g.device)
        x0 = torch.empty((T, Bc, Xs), dtype=torch.float32, device=g.device)
        yb = torch.empty((T, Bc, Xs), dtype=torch.float32, device=g.device)
        sq = torch.empty((T, Bc), dtype=torch.float32, device=g.device)
        check(lib.vlg_stats_fwd(_RUNG[precision], g.data_ptr(), T, Bc, M, *dec,
                                w_b.data_ptr(), x0.data_ptr(), yb.data_ptr(),
                                sq.data_ptr(), _ptr(scratch), n_blocks,
                                _stream(g.device)),
              "stats_fwd")
        LAUNCHES["stats_fwd"] += 1
        return x0, yb, sq

    def over_slices(b0, b1):
        g, w_b = _splines(gamma, b0, b1), _splines(wmb, b0, b1)
        parts = [launch(wsx, bsx, g, w_b) for wsx, bsx, _, _ in x_slices(ws, bs)]
        if len(parts) == 1:
            return parts[0]
        sq = parts[0][2]
        for p in parts[1:]:
            sq = sq + p[2]
        return (torch.cat([p[0] for p in parts], -1),
                torch.cat([p[1] for p in parts], -1), sq)

    with trace_annotation("op.stats_fwd"):
        return by_splines(T, B, ws, over_slices)


def stats_bwd(ws, bs, gamma, wmb, dx0, dyb, dsq, precision):
    """K4: dgamma (T, B, D) for cotangents (dx0, dyb, dsq) of K3's outputs;
    one launch, every decoder decoded once."""
    if gamma.device.type == "cpu":
        _check_stats_ct(*gamma.shape[:2], ws[-1].shape[-1], dx0, dyb, dsq)
        return stats_bwd_plain(ws, bs, gamma, wmb, dx0, dyb, dsq, precision)
    if gamma.device.type != "cuda":
        raise ValueError(f"no kernel for device {gamma.device}")
    from vae_latent_geometry_tpu_torch.ops._build import check, library

    check_precision(precision)
    ws = [w.contiguous() for w in ship_weights(ws, precision)]
    T, B, D, M, X = _check_cuda(ws, bs, gamma, wmb, (dx0, dyb, dsq))
    _check_stats_ct(T, B, X, dx0, dyb, dsq)
    lib = library("energy_stats")

    def launch(wsx, bsx, g, w_b, dx0_c, dyb_c, dsq_c):
        Bc = g.shape[1]
        widths, dec = _decoder_args(wsx, bsx)
        scratch, n_blocks = _any_scratch(lib, widths, 2, g.device)
        dgamma = torch.empty((T, Bc, D), dtype=torch.float32, device=g.device)
        check(lib.vlg_stats_bwd(_RUNG[precision], g.data_ptr(), T, Bc, M, *dec,
                                w_b.data_ptr(), dx0_c.data_ptr(),
                                dyb_c.data_ptr(), dsq_c.data_ptr(),
                                dgamma.data_ptr(), _ptr(scratch), n_blocks,
                                _stream(g.device)),
              "stats_bwd")
        LAUNCHES["stats_bwd"] += 1
        return dgamma

    def over_slices(b0, b1):
        g, w_b = _splines(gamma, b0, b1), _splines(wmb, b0, b1)
        dx0_b, dyb_b = _splines(dx0, b0, b1), _splines(dyb, b0, b1)
        dsq_b = _splines(dsq, b0, b1)
        return sum_slices(ws, bs, lambda wsx, bsx, c0, c1: launch(
            wsx, bsx, g, w_b, _cols(dx0_b, c0, c1, X), _cols(dyb_b, c0, c1, X),
            dsq_b))

    with trace_annotation("op.stats_bwd"):
        return by_splines(T, B, ws, over_slices)


def _cols(x, c0, c1, X):
    """Columns c0..c1-1 of the last axis of x, contiguous (x itself when
    that is all of it)."""
    return x if (c0, c1) == (0, X) else x[..., c0:c1].contiguous()


class _EnsembleStatsFused(torch.autograd.Function):
    """K3 forward, K4 backward (it recomputes activations from the inputs)."""

    @staticmethod
    def forward(ctx, gamma, ws, bs, wmb, precision):
        ctx.save_for_backward(gamma)
        ctx.ws, ctx.bs, ctx.wmb, ctx.precision = ws, bs, wmb, precision
        return stats_fwd(ws, bs, gamma, wmb, precision)

    @staticmethod
    def backward(ctx, dx0, dyb, dsq):
        (gamma,) = ctx.saved_tensors
        dg = stats_bwd(ctx.ws, ctx.bs, gamma, ctx.wmb,
                       dx0.contiguous().float(), dyb.contiguous().float(),
                       dsq.contiguous().float(), ctx.precision)
        return dg, None, None, None, None


def ensemble_stats_fused(decoders, gamma, wmb, precision: str = "float32"):
    """Per-shard ensemble sufficient statistics, fused.

    gamma: (T, B, D) curve; wmb: (M, B) LOCAL decoder weights (the rows of
    the global weight plane that belong to this shard; they need not sum to
    1).  Returns (x0, yb, sq): the local reference decoder's output
    (T, B, X) and the weighted centered moments yb (T, B, X), sq (T, B).
    Differentiable in ``gamma`` only."""
    ws, bs, wmb = _prepare(decoders, gamma, wmb)
    return _EnsembleStatsFused.apply(gamma.contiguous(), ws, bs, wmb,
                                     precision)


def uniform_weights_local(M_total: int, M_local: int, B: int, device=None):
    """Local rows of the uniform global weight plane (each of ``M_local``
    decoders carries weight 1/M_total)."""
    return torch.ones((M_local, B), dtype=torch.float32,
                      device=device) / M_total


def active_weights_local(num_active, M_total: int, M_local: int, B: int,
                         shard_index: int = 0, device=None):
    """Local rows of :func:`active_weights` for shard ``shard_index`` of the
    decoder axis: global decoder index = shard_index * M_local + local
    index.  (``M_total`` is unused, as in the JAX package: the weight is
    1/k_b.)"""
    k = torch.as_tensor(num_active, dtype=torch.int32,
                        device=device).expand(B)
    m_global = shard_index * M_local + torch.arange(M_local, device=k.device)
    mask = (m_global[:, None] < k[None, :]).float()
    return mask / k.float()[None, :]


def energy_expected_sharded(decoders, gamma, wmb, group=None,
                            precision: str = "float32"):
    """Expected ensemble energy with the decoder axis sharded over the ranks
    of process group ``group``: ``decoders`` / ``wmb`` hold this rank's local
    subset.  Per-shard statistics come from the stats kernels; they meet in
    two all-reduces, (T, B, X) and (T, B); the segment assembly is plain
    PyTorch under autograd.  With ``group=None`` (a decoder axis of size 1)
    this is a single-device decomposition of :func:`energy_expected_fused`.

    Returns (B,) energies, identical on every rank of ``group``.

    Autograd contract: the backward of the all-reduce is an all-reduce of
    the cotangent (:func:`parallel.collectives.psum`), which makes each
    rank's cotangent of a summed statistic the SUM of every rank's
    downstream cotangents.  That is the true total derivative provided the
    replicated final consumer contributes its cotangent once in total, so
    the caller scales its per-rank loss by 1/size and all-reduces the
    resulting gradients (``optim/geodesic`` does both)."""
    from vae_latent_geometry_tpu_torch.parallel.collectives import psum

    x0, yb, sq = ensemble_stats_fused(decoders, gamma, wmb, precision)
    w_sum = wmb.detach().float().sum(0)                          # (B,)
    s1 = w_sum[None, :, None] * x0 + yb                          # (T, B, X)
    xbar = psum(s1, group)
    d0 = x0 - xbar                                               # deviation
    var_p = (sq + 2.0 * (yb * d0).sum(-1)
             + w_sum[None, :] * (d0 * d0).sum(-1))
    var = psum(var_p, group)
    diff = xbar[1:] - xbar[:-1]
    seg = (diff * diff).sum(-1) + var[1:] + var[:-1]
    return seg.sum(0)
