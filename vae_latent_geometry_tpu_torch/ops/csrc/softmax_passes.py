"""Triton passes of the softmax route of K1 and K2 (``ops/energy_softmax.py``
loads this file on the first launch and documents the route): the two
bandwidth-bound passes over xbar (T B, Gp) between the CUDA kernels of
``energy_softmax.cu``.  Rows are curve points, n = t B + b; columns past G
hold zeros, which add nothing.
"""

import triton
import triton.language as tl


@triton.jit
def k1s_segments(xbar_ptr, var_ptr, part_ptr, T, B, G, TT: tl.constexpr,
                 BG: tl.constexpr):
    """Spline b's segments t0..t0+TT: sum_t |xbar_{t+1} - xbar_t|^2 +
    var_{t+1} + var_t, one partial sum per (t-range, spline)."""
    tc = tl.program_id(0)
    b = tl.program_id(1)
    t = tc * TT + tl.arange(0, TT)
    tmask = t < T - 1
    r0 = t * B + b
    seg = tl.zeros((TT,), tl.float32)
    for g0 in range(0, G, BG):
        j = g0 + tl.arange(0, BG)
        msk = tmask[:, None] & (j < G)[None, :]
        x0 = tl.load(xbar_ptr + r0[:, None] * G + j[None, :], mask=msk,
                     other=0.0)
        x1 = tl.load(xbar_ptr + (r0 + B)[:, None] * G + j[None, :], mask=msk,
                     other=0.0)
        dx = x1 - x0
        seg += tl.sum(dx * dx, 1)
    seg += (tl.load(var_ptr + r0 + B, mask=tmask, other=0.0)
            + tl.load(var_ptr + r0, mask=tmask, other=0.0))
    tl.store(part_ptr + tc * B + b, tl.sum(tl.where(tmask, seg, 0.0), 0))


@triton.jit
def k2s_neighbours(xbar_ptr, nb_ptr, N, B, G, BR: tl.constexpr,
                   BG: tl.constexpr, TR: tl.constexpr, TC: tl.constexpr,
                   TS: tl.constexpr):
    """nb = xbar_{t-1} + xbar_{t+1} (zero past either end), once for the
    chain's M x 2 passes.  TR 0: nb (N, G); TR > 0: nb tiled for the
    wgmma chain, each tile of TR rows and TC columns one contiguous block,
    tiles in (row block, column tile) order, a tile's rows TS floats apart,
    rows past N to a multiple of TR zero."""
    rows = tl.program_id(0) * BR + tl.arange(0, BR)
    j = tl.program_id(1) * BG + tl.arange(0, BG)
    jmask = (j < G)[None, :]
    prev = tl.load(xbar_ptr + (rows - B)[:, None] * G + j[None, :],
                   mask=((rows >= B) & (rows < N))[:, None] & jmask,
                   other=0.0)
    nxt = tl.load(xbar_ptr + (rows + B)[:, None] * G + j[None, :],
                  mask=(rows + B < N)[:, None] & jmask, other=0.0)
    if TR > 0:
        tile = (rows // TR * (G // TC))[:, None] + (j // TC)[None, :]
        at = (tile * TR + (rows % TR)[:, None]) * TS + (j % TC)[None, :]
        tl.store(nb_ptr + at, prev + nxt,
                 mask=(rows < tl.cdiv(N, TR) * TR)[:, None] & jmask)
    else:
        tl.store(nb_ptr + rows[:, None] * G + j[None, :], prev + nxt,
                 mask=(rows < N)[:, None] & jmask)
