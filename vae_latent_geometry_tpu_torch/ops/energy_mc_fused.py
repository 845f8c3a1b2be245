"""Fused Monte-Carlo (sampled) ensemble energy: the port of
``ops/energy_mc_pallas.py``.

Sample s of S draws, per segment t and spline b, a decoder ``d1[s, t, b]``
for the segment's left end (point t) and ``d2[s, t, b]`` for its right end
(point t+1).  Four kernels, each beside a plain PyTorch version:

- :func:`energy_mc_fwd` (K5, replaces ``energy_mc_pallas.py:473
  _fwd_kernel``): E_b = (1/S) sum_s sum_t ||x_{d2}(t+1) - x_{d1}(t)||^2 on
  given int32 planes d1, d2 (S, T-1, B).
- :func:`energy_mc_bwd` (K6, ``:548 _bwd_kernel``): dgamma for a per-spline
  cotangent, dx_m(t) = (2/S) ct_b sum_s ([d2[s,t-1]=m] diff_s(t-1) -
  [d1[s,t]=m] diff_s(t)) through the ReLU-masked chain of decoder m.
- :func:`energy_mc_fwd_rng` (K7, ``:166 _fwd_kernel_rng``) and
  :func:`energy_mc_bwd_rng` (K8, ``:235 _bwd_kernel_rng``): the same with the
  draws made inside the kernel from a per-step seed and the per-spline
  active-decoder counts ``kmax``.

The in-kernel draws come from a counter-based generator (Philox4x32-10), so
a draw depends on (seed, plane, t, b) alone and :func:`philox_draws`
reproduces the kernels' planes bit for bit in plain integer PyTorch: K7 is
K5 on those planes, and that is what K7/K8 compute for a CPU tensor.

A CUDA tensor launches the kernel (``csrc/energy_mc.cu``) or raises; only a
CPU tensor takes the plain version.  Precision rungs as in
``ops/energy_fused.py``.  Differentiable in ``gamma`` only.  The random bits
are this port's own: results are reproducible per seed, not comparable bit
for bit with the JAX package's.
"""

from __future__ import annotations

import torch

# the external planes' sampler lives beside the plain estimator; it is
# re-exported here as the counterpart of energy_mc_pallas's
from vae_latent_geometry_tpu_torch.geometry.energy import (  # noqa: F401
    sample_decoder_indices,
)
from vae_latent_geometry_tpu_torch.ops.energy_fused import (
    _RUNG,
    COUNTERS,
    LAUNCHES,
    SPAN_ROWS,
    SPAN_SPLINES,
    _aligned16,
    _any_scratch,
    _check_cuda,
    _decode_plain,
    _decoder_args,
    _fixed_shape,
    _fwd_scratch,
    _mp_matmul,
    _n_sm,
    _ptr,
    _splines,
    _stream,
    by_splines,
    check_precision,
    pick_spans,
    ship_weights,
    stack_weights,
    sum_slices,
)
from vae_latent_geometry_tpu_torch.utils.profiling import trace_annotation

LAUNCHES.update({"energy_mc_fwd": 0, "energy_mc_bwd": 0,
                 "energy_mc_fwd_rng": 0, "energy_mc_bwd_rng": 0})
# K6's and K8's launches again, by the route each took (:func:`k8_route`);
# kept out of LAUNCHES, reset with it.
K8_ROUTES = {"one_decode": 0, "two_pass": 0, "fma": 0, "any": 0}
COUNTERS.append(K8_ROUTES)

# The one-decode route's shared memory (``csrc/energy_mc.cu``: a block's 227
# KB, sizeof(McOnePassSmem), then per sample the draws and a difference
# plane of 128 rows of SD floats, SD = mc_tiles_stride(X)).
_SMEM_MAX = 232448
_ONEPASS_FIXED = 118560

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant a and an int64
    tensor b of 32-bit values, without leaving int64's range."""
    p0, p1 = b * (a & 0xFFFF), b * (a >> 16)          # both < 2^48
    hi = (p1 + (p0 >> 16)) >> 16
    lo = (((p1 & 0xFFFF) << 16) + (p0 & _M32)) & _M32
    return hi, lo


def philox4x32_10(key, counter):
    """Philox4x32-10 (Salmon et al. 2011, as in Random123): ``key`` two
    32-bit ints, ``counter`` four int64 tensors of 32-bit values; returns
    the four output words as int64 tensors."""
    k0, k1 = key
    c0, c1, c2, c3 = counter
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, c0)
        hi1, lo1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def _seed_key(seed: int):
    return int(seed) & _M32, (int(seed) >> 32) & _M32


def philox_draws(seed: int, S: int, T: int, B: int, kmax):
    """The draws K7/K8 make in the kernel, bit for bit: (d1, d2), each
    (S, T-1, B) int32 on ``kmax``'s device.

    Plane j in [0, 2S) (d1 planes first) at (t, b) is output word j % 4 of
    Philox4x32-10 keyed by the 64-bit ``seed`` at counter (t, b, j // 4, 0),
    mapped as the TPU kernels map bits (``_gen_draws_f32``):
    u = (bits >> 8) * 2^-24, d = floor(u * kmax_b) in float32 (bias below
    kmax_b * 2^-24), kept below kmax_b."""
    kmax = torch.as_tensor(kmax)
    dev = kmax.device
    t = torch.arange(T - 1, dtype=torch.int64, device=dev)[:, None].expand(T - 1, B)
    b = torch.arange(B, dtype=torch.int64, device=dev)[None, :].expand(T - 1, B)
    zero = torch.zeros_like(t)
    words = []
    for group in range(-(-2 * S // 4)):
        words += philox4x32_10(_seed_key(seed), (t, b, zero + group, zero))
    bits = torch.stack(words[:2 * S])
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    k = kmax.float().expand(B)[None, None, :]
    d = torch.minimum(torch.floor(u * k), k - 1).to(torch.int32)
    return d[:S], d[S:]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _diffs_plain(ws, bs, gamma, d1, d2, precision):
    """diff[s, t] = x_{d2[s,t]}(t+1) - x_{d1[s,t]}(t): (S, T-1, B, X).  The
    selected endpoints are copied, not summed, so they are the decoders'
    outputs bit for bit."""
    T, B, D = gamma.shape
    g = gamma.reshape(T * B, D)
    lo = hi = None
    for m in range(ws[0].shape[0]):
        x = _decode_plain(g, ws, bs, m, precision)[0].reshape(T, B, -1)
        if lo is None:
            lo = torch.zeros((d1.shape[0],) + x[:-1].shape, dtype=x.dtype,
                             device=x.device)
            hi = torch.zeros_like(lo)
        lo = torch.where((d1 == m)[..., None], x[:-1], lo)
        hi = torch.where((d2 == m)[..., None], x[1:], hi)
    return hi - lo


def energy_mc_fwd_plain(ws, bs, gamma, d1, d2, precision):
    """Plain version of K5 (same arguments as :func:`energy_mc_fwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    diff = _diffs_plain(ws, bs, gamma, d1, d2, precision)
    return (diff * diff).sum(-1).sum(0).sum(0) / d1.shape[0]


def energy_mc_bwd_plain(ws, bs, gamma, d1, d2, ct, precision):
    """Plain version of K6 (same arguments as :func:`energy_mc_bwd`)."""
    check_precision(precision)
    ws = ship_weights(ws, precision)
    T, B, D = gamma.shape
    S = d1.shape[0]
    chain = "bfloat16" if precision in ("f32x3", "f32x2") else precision
    g = gamma.reshape(T * B, D)
    diff = _diffs_plain(ws, bs, gamma, d1, d2, precision)
    scale = (2.0 / S) * ct[None, :, None]
    zero = diff.new_zeros(())
    dg = torch.zeros((T * B, D), dtype=torch.float32, device=gamma.device)
    for m in range(ws[0].shape[0]):
        _, masks = _decode_plain(g, ws, bs, m, precision)
        dx = torch.zeros((T,) + diff.shape[2:], dtype=torch.float32,
                         device=gamma.device)
        for s in range(S):
            dx[:-1] = dx[:-1] - torch.where((d1[s] == m)[..., None], diff[s], zero)
            dx[1:] = dx[1:] + torch.where((d2[s] == m)[..., None], diff[s], zero)
        dh = (dx * scale).reshape(T * B, -1)
        for i in range(len(ws) - 1, 0, -1):
            dh = _mp_matmul(dh, ws[i][m].T, chain) * masks[i - 1]
        dg = dg + dh @ ws[0][m].T
    return dg.reshape(T, B, D)


def energy_mc_fwd_rng_plain(ws, bs, gamma, seed, kmax, mc_samples, precision):
    """Plain version of K7: K5's on the planes of :func:`philox_draws`."""
    T, B, _ = gamma.shape
    d1, d2 = philox_draws(seed, mc_samples, T, B, kmax)
    return energy_mc_fwd_plain(ws, bs, gamma, d1, d2, precision)


def energy_mc_bwd_rng_plain(ws, bs, gamma, seed, kmax, mc_samples, ct,
                            precision):
    """Plain version of K8: K6's on the planes of :func:`philox_draws`."""
    T, B, _ = gamma.shape
    d1, d2 = philox_draws(seed, mc_samples, T, B, kmax)
    return energy_mc_bwd_plain(ws, bs, gamma, d1, d2, ct, precision)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def mc_onepass_cap(X: int) -> int:
    """The most samples K6/K8's one-decode route takes at output width X
    (``vlg_mc_onepass_cap``): 3 at X = 50 and at X = 64."""
    sd = 16 * ((X + 7) // 16) + 8
    return (_SMEM_MAX - _ONEPASS_FIXED) // (4 * 128 * (2 + sd))


def k8_route(precision: str, widths, mc_samples: int) -> str:
    """The kernels K6/K8 launch for a rung, a decoder of ``widths`` (D,
    ..., X) and S = ``mc_samples``: ``"one_decode"`` (one launch that
    decodes every point once per decoder, on the tensor cores, after one
    that prepares the weight planes) at a reduced rung on the production
    shape up to :func:`mc_onepass_cap`, ``"two_pass"`` (the endpoint planes,
    then the chain, each decoding every point) above it, ``"fma"`` (two
    passes through the difference planes) at float32 there, ``"any"`` (the
    generic decode's two passes) for every other decoder."""
    check_precision(precision)
    widths = list(widths)
    if not _fixed_shape(widths):
        return "any"
    if precision == "float32":
        return "fma"
    return ("one_decode" if mc_samples <= mc_onepass_cap(widths[-1])
            else "two_pass")


def _check_range(what, x, lo, hi):
    """Raise unless lo <= x <= hi everywhere: a value outside selects no
    decoder, and that endpoint would silently be 0 in the kernel and in the
    plain version alike.  Free for host data; for a CUDA tensor it waits for
    the device once."""
    x_min, x_max = torch.stack(torch.aminmax(x)).tolist()
    if x_min < lo or x_max > hi:
        raise ValueError(f"{what} must lie in [{lo}, {hi}], got "
                         f"[{x_min:g}, {x_max:g}]")


def _check_device(gamma):
    if gamma.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {gamma.device}")


def _check_planes(d1, d2, gamma):
    T, B, _ = gamma.shape
    for d in (d1, d2):
        if d.device != gamma.device or d.dtype != torch.int32 \
                or not d.is_contiguous():
            raise ValueError("index planes must be contiguous int32 on "
                             f"{gamma.device}, got {d.dtype} on {d.device}")
    S = d1.shape[0]
    if S < 1 or tuple(d1.shape) != (S, T - 1, B) or d2.shape != d1.shape:
        raise ValueError(f"index planes must be (S, T-1, B) = (S, {T - 1}, "
                         f"{B}), got {tuple(d1.shape)}, {tuple(d2.shape)}")
    return S


def _check_kmax(kmax, gamma, mc_samples):
    B = gamma.shape[1]
    if tuple(kmax.shape) != (B,):
        raise ValueError(f"kmax must be (B,) = ({B},), got {tuple(kmax.shape)}")
    if mc_samples < 1:
        raise ValueError(f"mc_samples must be >= 1, got {mc_samples}")


def _launch(name, backward, ws, bs, gamma, precision, S, d1, d2, kmax, seed,
            ct):
    """Check the inputs, launch ``csrc/energy_mc.cu`` and count the launch
    under ``name``.  ``d1 is None``: the draws are made in the kernel."""
    if gamma.device.type != "cuda":
        raise ValueError(f"no kernel for device {gamma.device}")
    from vae_latent_geometry_tpu_torch.ops._build import check, library

    check_precision(precision)
    ws = [w.contiguous() for w in ship_weights(ws, precision)]
    extra = [x for x in (kmax, ct) if x is not None]
    T, B, D, M, X = _check_cuda(ws, bs, gamma, None, extra)
    if T < 2:
        raise ValueError(f"a curve needs at least 2 points, got T={T}")
    if ct is not None and tuple(ct.shape) != (B,):
        raise ValueError(f"ct must be (B,) = ({B},), got {tuple(ct.shape)}")
    lib = library("energy_mc")
    dev = gamma.device
    key = _seed_key(seed)
    if backward:
        # the one-decode kernel stages W1, b1, b2 by cp.async
        ws = [_aligned16(ws[0]), *ws[1:]]
        bs = [_aligned16(bs[0]), _aligned16(bs[1]), *bs[2:]]

    def launch(wsx, bsx, b0, b1):
        # splines b0..b1-1: their planes, counts and cotangents; the in-kernel
        # draws count splines from b0, so they do not depend on the ranges
        g, Bc, Xs = _splines(gamma, b0, b1), b1 - b0, wsx[-1].shape[-1]
        p1, p2 = (None if d is None else d[:, :, b0:b1].contiguous()
                  for d in (d1, d2))
        k_b = None if kmax is None else kmax[b0:b1].contiguous()
        draws = [_ptr(p1), _ptr(p2), _ptr(k_b), *key, b0]
        widths, dec = _decoder_args(wsx, bsx)
        head = [_RUNG[precision], g.data_ptr(), T, Bc, M, S]
        if backward:
            route = k8_route(precision, widths, S)
            planes = None
            if route == "one_decode":
                # per-block scratch of the one-pass body, then the planes
                n_sm = _n_sm(dev)
                span, G = pick_spans(T, Bc, n_sm, 1, SPAN_ROWS - 1)
                n_blocks = min(G * -(-Bc // SPAN_SPLINES), n_sm)
                scratch = torch.empty(
                    (n_blocks * lib.vlg_mc_block_words(M, Xs)
                     + lib.vlg_mc_plane_words(M),), dtype=torch.int32,
                    device=dev)
            else:
                # the two-pass kernels' difference or endpoint planes
                span = G = 0
                scratch, n_blocks = _any_scratch(lib, widths, 1, dev)
                n_planes = lib.vlg_mc_bwd_planes(_RUNG[precision], T, S,
                                                  *dec[:2])
                planes = torch.empty((n_planes, Bc, Xs), dtype=torch.float32,
                                     device=dev)
            out = torch.empty((T, Bc, D), dtype=torch.float32, device=dev)
            err = lib.vlg_mc_bwd(*head, span, G, *dec, *draws,
                                 ct[b0:b1].contiguous().data_ptr(),
                                 _ptr(planes), out.data_ptr(), _ptr(scratch),
                                 n_blocks, _stream(dev))
        else:
            scratch, n_blocks = _fwd_scratch(lib, precision, widths, M, dev)
            partial = torch.empty((lib.vlg_mc_fwd_tiles(
                _RUNG[precision], T, M, S, *dec[:2]), Bc),
                dtype=torch.float32, device=dev)
            out = torch.empty((Bc,), dtype=torch.float32, device=dev)
            err = lib.vlg_mc_fwd(*head, *dec, *draws, partial.data_ptr(),
                                 out.data_ptr(), _ptr(scratch), n_blocks,
                                 _stream(dev))
        check(err, name)
        LAUNCHES[name] += 1
        if backward:
            K8_ROUTES[route] += 1
        return out

    with trace_annotation(f"op.{name}"):
        return by_splines(T, B, ws, lambda b0, b1: sum_slices(
            ws, bs, lambda wsx, bsx, c0, c1: launch(wsx, bsx, b0, b1)))


def energy_mc_fwd(ws, bs, gamma, d1, d2, precision):
    """K5: (T, B, D) curve and (S, T-1, B) int32 planes -> (B,) sampled
    energies.  The plane values must lie in [0, M) (a value outside selects
    no decoder); :func:`energy_mc_fused` checks that, this wrapper does
    not."""
    _check_device(gamma)
    S = _check_planes(d1, d2, gamma)
    if gamma.device.type == "cpu":
        return energy_mc_fwd_plain(ws, bs, gamma, d1, d2, precision)
    return _launch("energy_mc_fwd", False, ws, bs, gamma, precision, S, d1,
                   d2, None, 0, None)


def energy_mc_bwd(ws, bs, gamma, d1, d2, ct, precision):
    """K6: dgamma (T, B, D) of sum_b ct_b E_b on the given planes (route:
    :func:`k8_route`).

    Any number of samples S.  The one-decode route (a reduced rung on the
    production decoder, S up to :func:`mc_onepass_cap`) holds a per-block
    scratch of M decoders' outputs of two tiles (87 MB at M=10, X=50 on
    132 SMs) whatever T and B; the others a scratch that grows linearly
    with S: the endpoint planes (2S, T, B, X) float32 of the two-pass
    tensor-core kernels or the difference planes (S, T-1, B, X) of the
    others.  At the production chunk (T=2000, B=200, X=50) and S=16 that is
    2.56 GB or 1.28 GB; only a failed allocation refuses a larger S."""
    _check_device(gamma)
    S = _check_planes(d1, d2, gamma)
    if gamma.device.type == "cpu":
        return energy_mc_bwd_plain(ws, bs, gamma, d1, d2, ct, precision)
    return _launch("energy_mc_bwd", True, ws, bs, gamma, precision, S, d1, d2,
                   None, 0, ct)


def energy_mc_fwd_rng(ws, bs, gamma, seed, kmax, mc_samples, precision):
    """K7: K5 with the draws made in the kernel from ``seed`` (an int of up
    to 64 bits) and ``kmax`` ((B,) float32 active decoders per spline, each
    in [1, M]: :func:`energy_mc_fused_rng` checks that, this wrapper does
    not)."""
    _check_device(gamma)
    _check_kmax(kmax, gamma, mc_samples)
    if gamma.device.type == "cpu":
        return energy_mc_fwd_rng_plain(ws, bs, gamma, seed, kmax, mc_samples,
                                       precision)
    return _launch("energy_mc_fwd_rng", False, ws, bs, gamma, precision,
                   mc_samples, None, None, kmax, seed, None)


def energy_mc_bwd_rng(ws, bs, gamma, seed, kmax, mc_samples, ct, precision):
    """K8: K6 on the same in-kernel draws as K7 (the same scratch as
    :func:`energy_mc_bwd`'s)."""
    _check_device(gamma)
    _check_kmax(kmax, gamma, mc_samples)
    if gamma.device.type == "cpu":
        return energy_mc_bwd_rng_plain(ws, bs, gamma, seed, kmax, mc_samples,
                                       ct, precision)
    return _launch("energy_mc_bwd_rng", True, ws, bs, gamma, precision,
                   mc_samples, None, None, kmax, seed, ct)


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

class _EnergyMCFused(torch.autograd.Function):
    """Sampled energy (or zeros, ``grad_only``) forward; K6 backward on the
    same planes.  The backward needs only the inputs."""

    @staticmethod
    def forward(ctx, gamma, ws, bs, d1, d2, precision, grad_only):
        ctx.save_for_backward(gamma)
        ctx.args = (ws, bs, d1, d2, precision)
        if grad_only:
            check_precision(precision)
            return gamma.new_zeros(gamma.shape[1])
        return energy_mc_fwd(ws, bs, gamma, d1, d2, precision)

    @staticmethod
    def backward(ctx, ct):
        (gamma,) = ctx.saved_tensors
        ws, bs, d1, d2, precision = ctx.args
        dg = energy_mc_bwd(ws, bs, gamma.contiguous(), d1, d2,
                           ct.contiguous().float(), precision)
        return dg, None, None, None, None, None, None


class _EnergyMCFusedRng(torch.autograd.Function):
    """The same with in-kernel draws: K7 forward, K8 backward, both from
    ``seed`` alone, so they see the same draws."""

    @staticmethod
    def forward(ctx, gamma, ws, bs, seed, kmax, mc_samples, precision,
                grad_only):
        ctx.save_for_backward(gamma)
        ctx.args = (ws, bs, seed, kmax, mc_samples, precision)
        if grad_only:
            check_precision(precision)
            return gamma.new_zeros(gamma.shape[1])
        return energy_mc_fwd_rng(ws, bs, gamma, seed, kmax, mc_samples,
                                 precision)

    @staticmethod
    def backward(ctx, ct):
        (gamma,) = ctx.saved_tensors
        ws, bs, seed, kmax, mc_samples, precision = ctx.args
        dg = energy_mc_bwd_rng(ws, bs, gamma.contiguous(), seed, kmax,
                               mc_samples, ct.contiguous().float(), precision)
        return dg, None, None, None, None, None, None, None


def _weights(decoders):
    ws, bs = stack_weights(decoders, "Monte-Carlo (mc_fused)")
    return [w.detach() for w in ws], [b.detach().contiguous() for b in bs]


def _fused(decoders, gamma, d1, d2, precision, grad_only, check_range):
    ws, bs = _weights(decoders)
    d1, d2 = (d.to(torch.int32).contiguous() for d in (d1, d2))
    if check_range and d1.numel():
        _check_range("decoder indices", torch.stack([d1, d2]), 0,
                     ws[0].shape[0] - 1)
    return _EnergyMCFused.apply(gamma.contiguous(), ws, bs, d1, d2, precision,
                                grad_only)


def _fused_rng(decoders, gamma, seed, kmax, mc_samples, precision, grad_only):
    ws, bs = _weights(decoders)
    # counts given as host data (a number, an array, a CPU tensor) are
    # checked before they go to the device, so the check costs no wait
    kmax = torch.as_tensor(kmax)
    _check_range("kmax (active decoders per spline)", kmax, 1, ws[0].shape[0])
    if kmax.numel() == 1:
        kmax = torch.full((gamma.shape[1],), float(kmax),
                          dtype=torch.float32, device=gamma.device)
    kmax = kmax.to(device=gamma.device,
                   dtype=torch.float32).reshape(-1).contiguous()
    return _EnergyMCFusedRng.apply(gamma.contiguous(), ws, bs, int(seed),
                                   kmax, mc_samples, precision, grad_only)


def energy_mc_fused(decoders, gamma, d1, d2, precision: str = "float32",
                    check_range: bool = True):
    """Fused sampled ensemble energy.

    gamma: (T, B, D); d1, d2: (S, T-1, B) decoder indices in [0, M), else
    ValueError.  The check waits for the device once when the planes lie
    there; ``check_range=False`` skips it for planes that come straight
    from :func:`sample_decoder_indices`, which keeps them in range.
    Returns (B,)."""
    return _fused(decoders, gamma, d1, d2, precision, False, check_range)


def energy_mc_fused_grad(decoders, gamma, d1, d2, precision: str = "float32",
                         check_range: bool = True):
    """Gradient-only variant of :func:`energy_mc_fused`: zeros as the value,
    the same backward.  Use only where the energy value is discarded."""
    return _fused(decoders, gamma, d1, d2, precision, True, check_range)


def energy_mc_fused_rng(decoders, gamma, seed, kmax, mc_samples: int = 2,
                        precision: str = "float32"):
    """Fused sampled ensemble energy with the draws made in the kernel.

    seed: an int of up to 64 bits, one per optimization step; kmax: (B,) (or
    (1, B), or one number for all splines) per-spline active-decoder counts
    in [1, M], else ValueError; pass host data where the caller has it, the
    check is then free.  Returns (B,)."""
    return _fused_rng(decoders, gamma, seed, kmax, mc_samples, precision,
                      False)


def energy_mc_fused_rng_grad(decoders, gamma, seed, kmax, mc_samples: int = 2,
                             precision: str = "float32"):
    """Gradient-only variant of :func:`energy_mc_fused_rng`."""
    return _fused_rng(decoders, gamma, seed, kmax, mc_samples, precision,
                      True)
