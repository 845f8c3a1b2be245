// Per-shard ensemble sufficient statistics and their gradient, for sm_90a
// (H100): the kernels of the decoder-sharded (expert-parallel) expected
// energy.
//
// Replaces the Pallas TPU kernels of vae_latent_geometry_tpu/ops/energy_pallas.py:
//   K3  _stats_fwd_kernel (:472)  -> k3_stats_mma (f32x3, f32x2, bfloat16),
//       k3_stats (float32)
//   K4  _stats_bwd_kernel (:502)  -> k4_stats_chain_mma (f32x3, f32x2,
//       bfloat16), k4_stats_chain (float32)
//       (with _backprop_chain :396)
//
// Function.  A shard holds M local ReLU MLP decoders D -> 128 -> 128 -> X and
// the local rows wmb[m, b] of the global weight plane (they need not sum to
// 1).  Pointwise at every curve point gamma[t, b, :] (T, B, D):
//   K3: x0 = x_0,  yb = sum_{m>=1} w_m (x_m - x0),
//       sq = sum_{m>=1} w_m ||x_m - x0||^2.
//   K4: dgamma for cotangents (dx0, dyb, dsq): decoder m >= 1 receives
//       c_m = w_m (dyb + 2 (x_m - x0) dsq), decoder 0 receives
//       dx0 - sum_m c_m, each back-propagated through the ReLU masks of the
//       SAME decode.
// The energy itself is assembled from all-reduced statistics outside the
// kernels (energy_expected_sharded in ops/energy_fused.py).
//
// The FMA decode, the cotangent chain and the precision rungs are shared
// with the other energy kernels (decode_common.cuh); the tensor-core decode
// and chain of the reduced rungs are K2's (decode_mma.cuh).
//
// Work (per point per decoder, D=2, X=50): the float32 decode is 46 kFLOP, so
// K3 at float32 is 1.8e11 FLOP at T=2000, B=200, M=10 (2.75 ms of FP32
// FMAs); at f32x2 its two-pass decode is 3.67e11 FLOP, 0.371 ms at the 989
// TFLOP/s of the bf16 tensor cores.  K4 at f32x2 is a two-pass decode plus a
// single-pass chain, about 138 kFLOP per point and decoder, 5.5e11 FLOP:
// 0.557 ms.  Each moves 161.6 MB of statistics (0.05 ms at 3.35 TB/s), so
// both are bound by operations, not bytes.
//
// Design for Hopper.  The TPU kernels keep all local decoders in VMEM and
// stream (Tc, Bb) tiles through a 2-D grid.  Here a block owns 128 points of
// the flattened (T*B) curve and loops over decoders, staging one at a time.
// The statistics are pointwise in t, so there is no halo, no partial buffer
// and no second launch.  K4 is ONE launch that decodes every decoder once:
// nothing in it needs a neighbouring point's result, so decoder m's chain
// follows its decode directly; decoder 0 is decoded first (its output and
// ReLU masks are kept), and its weights are staged a second time at the end
// for its chain, when sum_m c_m is complete.  Cotangents of points past the
// end of the curve (the last tile) are zero.
//
// At the reduced rungs both run their products on the tensor cores
// (mma.sync m16n8k16 bf16, decode_mma.cuh, as K2's k2_xbar_mma and
// k2_chain_mma): a warp owns 16 points x 128 units, activations, ReLU masks,
// decoder outputs, yb and c_m stay in registers in the m16n8 C-fragment
// layout, and sq is summed by the four lanes of a row in a fixed order.  x0,
// the tile's dyb (then dx0) and K4's sum_m c_m live in shared memory as
// (128 x 72) float tiles (each element read and written only by the lane
// that owns it in the C fragment; with decoder 0's masks and the tile's dsq
// 229,120 bytes with the f32x3 weight planes, of the 232,448 a block may
// use):
// dyb and dx0 are staged with coalesced loads once per tile, x0 and yb go
// out through the same tiles with coalesced stores.  The float32 rung keeps
// the CUDA-core FMAs (TF32 would round the inputs at 2^-11: barred).  What
// still holds them back: each block stages every decoder's weights
// (converted to bf16 planes) with nothing overlapping it; mma.sync rather
// than Hopper's wgmma; and K4 stages decoder 0 twice.
//
// Any decoder.  The kernels above take the production shape D <= 4 -> 128 ->
// 128 -> X <= 64; every other decoder (2 to 6 layers, hidden widths up to
// 512, X <= 128) takes k3_stats_any and k4_stats_chain_any at every rung: the
// FMA bodies over the generic decode of decode_any.cuh, in persistent
// blocks; K4 keeps decoder 0's masks in a second mask area of the block's
// scratch.

#include "decode_any.cuh"
#include "decode_common.cuh"
#include "decode_mma.cuh"

namespace {

template <class Base, int XM>
struct StatsSmem : Base {
  float xs[TP * (XM + 1)];  // x0 of the tile's points
};
using Smem = StatsSmem<DecodeSmem, XMAX>;
using SmemAny = StatsSmem<AnySmem, XMAX_ANY>;

// K3: statistics of tile bx's points -> x0, yb (T*B, X), sq (T*B).
template <int R, class P>
__device__ __forceinline__ void k3_body(StatsSmem<typename P::Smem, P::XM>& s,
                                        const typename P::Ctx& c, int bx,
                                        const float* __restrict__ gamma, int T, int B, int D,
                                        int M, int X, const float* __restrict__ wmb,
                                        float* __restrict__ x0_out, float* __restrict__ yb_out,
                                        float* __restrict__ sq_out) {
  constexpr int SX = P::XM + 1, NJ = P::NJX;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int N = T * B, p0 = bx * TP;
  load_points<P>(s, c, gamma, N, D, p0);
  float yb[8][NJ], sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) yb[i][j] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    float x[8][NJ];
    typename P::Masks mk;
    P::template decode<R>(s, c, m, D, X, x, mk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      if (m == 0) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) s.xs[p * SX + tx + 16 * j] = x[i][j];
      } else {
        const float wm = wmb[(size_t)m * B + min(p0 + p, N - 1) % B];
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float y = x[i][j] - s.xs[p * SX + tx + 16 * j];
          yb[i][j] = yb[i][j] + wm * y;
          q += y * y;
        }
        sq[i] = sq[i] + wm * q;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i, pg = p0 + p;
    const float v = sum16(sq[i]);
    if (pg >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      if (n < X) {
        x0_out[(size_t)pg * X + n] = s.xs[p * SX + n];
        yb_out[(size_t)pg * X + n] = yb[i][j];
      }
    }
    if (tx == 0) sq_out[pg] = v;
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k3_stats(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
         const float* __restrict__ wmb, float* __restrict__ x0_out,
         float* __restrict__ yb_out, float* __restrict__ sq_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  k3_body<R, FixedDecode>(*reinterpret_cast<Smem*>(smem_raw), FixedDecode::Ctx{w}, blockIdx.x,
                          gamma, T, B, D, M, X, wmb, x0_out, yb_out, sq_out);
}

// K4: (dx0, dyb, dsq) -> dgamma (T*B, D) of tile bx, every decoder decoded
// once.
template <int R, class P>
__device__ __forceinline__ void k4_body(StatsSmem<typename P::Smem, P::XM>& s,
                                        const typename P::Ctx& c, int bx,
                                        const float* __restrict__ gamma, int T, int B, int D,
                                        int M, int X, const float* __restrict__ wmb,
                                        const float* __restrict__ dx0,
                                        const float* __restrict__ dyb,
                                        const float* __restrict__ dsq,
                                        float* __restrict__ dgamma) {
  constexpr int C = CHAIN_RUNG<R>;
  constexpr int SX = P::XM + 1, NJ = P::NJX;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = T * B, p0 = bx * TP;
  load_points<P>(s, c, gamma, N, D, p0);
  zero_dgamma<P>(s, c, D);
  float x[8][NJ], csum[8][NJ];
  typename P::Masks mk0;           // decoder 0's masks, kept for its chain
  P::use_area(mk0, 1);
  P::template decode<R>(s, c, 0, D, X, x, mk0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s.xs[(ty * 8 + i) * SX + tx + 16 * j] = x[i][j];
      P::tile(csum, c, i, j) = 0.f;
    }
  for (int m = 1; m < M; ++m) {
    typename P::Masks mk;
    P::template decode<R>(s, c, m, D, X, x, mk);
    // c_m -> act[n][p] at the chain rung, and into the running sum
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
      const float wm = wmb[(size_t)m * B + pc % B];
      const float ds = dsq[pc];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < X) {
          const float y = x[i][j] - s.xs[p * SX + n];
          const float cm = pg < N
              ? __fmul_rn(wm, __fadd_rn(dyb[(size_t)pc * X + n],
                                        __fmul_rn(__fmul_rn(2.f, y), ds)))
              : 0.f;
          P::tile(csum, c, i, j) = P::tile(csum, c, i, j) + cm;
          s.act[n * S_ACT + p] = pack<C>(cm);
        }
      }
    }
    __syncthreads();
    P::template chain<C>(s, c, m, D, X, mk);
  }
  // decoder 0: its direct cotangent minus every y_m's dependency on x0
  if (M > 1) P::template restage<R>(s, c, 0, D, X);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      if (n < X) {
        const float cm = pg < N ? dx0[(size_t)pc * X + n] - P::tile(csum, c, i, j) : 0.f;
        s.act[n * S_ACT + p] = pack<C>(cm);
      }
    }
  }
  __syncthreads();
  P::template chain<C>(s, c, 0, D, X, mk0);
  __syncthreads();
  store_dgamma<P>(s, c, dgamma, N, D, p0);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k4_stats_chain(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
               const float* __restrict__ wmb, const float* __restrict__ dx0,
               const float* __restrict__ dyb, const float* __restrict__ dsq,
               float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  k4_body<R, FixedDecode>(*reinterpret_cast<Smem*>(smem_raw), FixedDecode::Ctx{w}, blockIdx.x,
                          gamma, T, B, D, M, X, wmb, dx0, dyb, dsq, dgamma);
}

// ---------------------------------------------------------------------------
// K3 and K4 at the reduced rungs, on the tensor cores (production shape)
// ---------------------------------------------------------------------------

constexpr int SXM = XMAX + 8;  // row stride (floats) of the (TP x XMAX) tiles

struct StatsMmaSmem : MmaSmem {
  float xs[TP * SXM];  // x0 of the tile's points
  float rt[TP * SXM];  // K3: yb; K4: dyb, then dx0
  float cs[TP * SXM];  // K4: sum_{m>=1} c_m
  uint4 mk0[NT];         // K4: decoder 0's ReLU masks (m1, m2), by thread
  float ds[TP];          // K4: dsq of the tile's points
};

// The lane's columns 8j + 2q and 8j + 2q + 1 of row p + 8r of a tile: the
// elements (j, 2r) and (j, 2r + 1) of its m16n8 C fragments.
__device__ __forceinline__ float2& frag2(float* t, int p, int j, int r) {
  return *reinterpret_cast<float2*>(t + (p + 8 * r) * SXM + 8 * j + 2 * (threadIdx.x & 3));
}

// Rows p0.. of an (N, X) plane into a tile, coalesced; rows past N are not
// written.
__device__ void load_rows(float* t, const float* __restrict__ src, int N, int X, int p0) {
  const int n = min(TP, N - p0) * X;
  const float* row0 = src + (size_t)p0 * X;
  for (int e = threadIdx.x; e < n; e += NT) t[(e / X) * SXM + e % X] = row0[e];
}

// A tile's rows back to rows p0.. of an (N, X) plane, coalesced, rows past N
// dropped.
__device__ void store_rows(const float* t, float* __restrict__ dst, int N, int X, int p0) {
  const int n = min(TP, N - p0) * X;
  float* row0 = dst + (size_t)p0 * X;
  for (int e = threadIdx.x; e < n; e += NT) row0[e] = t[(e / X) * SXM + e % X];
}

// K3 at a reduced rung: x0, yb, sq of tile blockIdx.x as k3_stats.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k3_stats_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
             const float* __restrict__ wmb, float* __restrict__ x0_out,
             float* __restrict__ yb_out, float* __restrict__ sq_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatsMmaSmem& s = *reinterpret_cast<StatsMmaSmem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int N = T * B, p0 = blockIdx.x * TP;
  const int p = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows p, p + 8
  zero_w3_planes(s);
  load_points_mma(s, gamma, N, D, p0);
  float yb[NJ3][4], sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) yb[j][c] = 0.f;
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights_mma<R>(s, m, D, X, w);
    __syncthreads();
    float x[NJ3][4];
    uint32_t m1[2], m2[2];
    decode_mma<R>(s, D, X, x, m1, m2);
    if (m == 0) {
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) frag2(s.xs, p, j, r) = make_float2(x[j][2 * r], x[j][2 * r + 1]);
      continue;
    }
    float wm[2], qs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) wm[r] = wmb[(size_t)m * B + min(p0 + p + 8 * r, N - 1) % B];
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 x0 = frag2(s.xs, p, j, r);
        const float y0 = x[j][2 * r] - x0.x, y1 = x[j][2 * r + 1] - x0.y;
        yb[j][2 * r] = yb[j][2 * r] + wm[r] * y0;
        yb[j][2 * r + 1] = yb[j][2 * r + 1] + wm[r] * y1;
        qs[r] += y0 * y0;
        qs[r] += y1 * y1;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) sq[r] = sq[r] + wm[r] * qs[r];
  }
  // sq of a row: its four lanes' shares, in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], 1);
    sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], 2);
    const int pg = p0 + p + 8 * r;
    if ((lane & 3) == 0 && pg < N) sq_out[pg] = sq[r];
  }
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) frag2(s.rt, p, j, r) = make_float2(yb[j][2 * r], yb[j][2 * r + 1]);
  __syncthreads();
  store_rows(s.xs, x0_out, N, X, p0);
  store_rows(s.rt, yb_out, N, X, p0);
}

// K4 at a reduced rung: dgamma of tile blockIdx.x as k4_stats_chain, one
// decode per decoder, the chain single-pass bf16 (chain_mma).
template <int R>
__global__ void __launch_bounds__(NT, 1)
k4_stats_chain_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X,
                   Weights w, const float* __restrict__ wmb, const float* __restrict__ dx0,
                   const float* __restrict__ dyb, const float* __restrict__ dsq,
                   float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StatsMmaSmem& s = *reinterpret_cast<StatsMmaSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int N = T * B, p0 = blockIdx.x * TP;
  const int p = (tid >> 5) * 16 + (lane >> 2);  // rows p, p + 8
  zero_w3_planes(s);
  load_points_mma(s, gamma, N, D, p0);
  for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
  load_rows(s.rt, dyb, N, X, p0);
  for (int e = tid; e < TP; e += NT) s.ds[e] = dsq[min(p0 + e, N - 1)];
  // per row: whether the point lies past the end (no cotangent)
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) live[r] = p0 + p + 8 * r < N;
  // round 0 decodes decoder 0 (x0 and its masks, kept); rounds 1..M-1
  // decode decoder m and chain c_m; round M chains decoder 0's cotangent,
  // its weights staged again.  One call of each device function: with a
  // second call site of the decode ptxas spilled at f32x3.
  for (int it = 0; it <= M; ++it) {
    __syncthreads();
    if (it < M || M > 1) stage_weights_mma<R>(s, it < M ? it : 0, D, X, w);
    if (it == M) load_rows(s.rt, dx0, N, X, p0);
    __syncthreads();
    float x[NJ3][4];
    uint32_t m1[2], m2[2];
    if (it < M) decode_mma<R>(s, D, X, x, m1, m2);
    if (it == 0) {
      s.mk0[tid] = make_uint4(m1[0], m1[1], m2[0], m2[1]);
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          frag2(s.xs, p, j, r) = make_float2(x[j][2 * r], x[j][2 * r + 1]);
          frag2(s.cs, p, j, r) = make_float2(0.f, 0.f);
        }
      continue;
    }
    if (it < M) {
      // c_m = w_m (dyb + 2 (x_m - x0) dsq) in place, and into the running sum
      float wm[2], ds[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wm[r] = wmb[(size_t)it * B + min(p0 + p + 8 * r, N - 1) % B];
        ds[r] = s.ds[p + 8 * r];
      }
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 x0 = frag2(s.xs, p, j, r), db = frag2(s.rt, p, j, r);
          float2& cs = frag2(s.cs, p, j, r);
          const int n = 8 * j + 2 * q;
          float c0 = 0.f, c1 = 0.f;
          if (live[r] && n < X) {
            c0 = __fmul_rn(wm[r], __fadd_rn(db.x, __fmul_rn(__fmul_rn(2.f, x[j][2 * r] - x0.x),
                                                            ds[r])));
            cs.x = cs.x + c0;
          }
          if (live[r] && n + 1 < X) {
            c1 = __fmul_rn(wm[r], __fadd_rn(db.y, __fmul_rn(__fmul_rn(2.f, x[j][2 * r + 1] - x0.y),
                                                            ds[r])));
            cs.y = cs.y + c1;
          }
          x[j][2 * r] = c0;
          x[j][2 * r + 1] = c1;
        }
    } else {
      // decoder 0: its direct cotangent minus every y_m's dependency on x0
      const uint4 mk = s.mk0[tid];
      m1[0] = mk.x, m1[1] = mk.y, m2[0] = mk.z, m2[1] = mk.w;
#pragma unroll
      for (int j = 0; j < NJ3; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 d0 = frag2(s.rt, p, j, r), cs = frag2(s.cs, p, j, r);
          const int n = 8 * j + 2 * q;
          x[j][2 * r] = live[r] && n < X ? d0.x - cs.x : 0.f;
          x[j][2 * r + 1] = live[r] && n + 1 < X ? d0.y - cs.y : 0.f;
        }
    }
    uint32_t dx[NK3][4];
    to_a<false>(x, dx);
    chain_mma(s, D, X, dx, m1, m2);
  }
  __syncthreads();
  for (int e = tid; e < TP * D; e += NT) {
    const int pp = e / D, d = e % D, pg = p0 + pp;
    if (pg < N) dgamma[(size_t)pg * D + d] = s.dg[pp * DMAX + d];
  }
}

// K3 and K4, any decoder: persistent blocks over the n_items tiles.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k3_stats_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
             const float* __restrict__ wmb, float* __restrict__ x0_out,
             float* __restrict__ yb_out, float* __restrict__ sq_out, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k3_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, wmb, x0_out, yb_out, sq_out);
    __syncthreads();
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k4_stats_chain_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
                   const float* __restrict__ wmb, const float* __restrict__ dx0,
                   const float* __restrict__ dyb, const float* __restrict__ dsq,
                   float* __restrict__ dgamma, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k4_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, wmb, dx0, dyb, dsq, dgamma);
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, float* x0, float* yb, float* sq, cudaStream_t st) {
  const int n_blocks = (T * B + TP - 1) / TP;
  cudaError_t err;
  if constexpr (R == F32) {  // CUDA-core FMAs
    err = prepare<Smem>(k3_stats<R>);
    if (err != cudaSuccess) return err;
    k3_stats<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq);
  } else {  // tensor cores
    err = prepare<StatsMmaSmem>(k3_stats_mma<R>);
    if (err != cudaSuccess) return err;
    k3_stats_mma<R><<<n_blocks, NT, sizeof(StatsMmaSmem), st>>>(gamma, T, B, D, M, X, w, wmb,
                                                                 x0, yb, sq);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, const float* dx0, const float* dyb, const float* dsq,
                       float* dgamma, cudaStream_t st) {
  const int n_blocks = (T * B + TP - 1) / TP;
  cudaError_t err;
  if constexpr (R == F32) {  // CUDA-core FMAs
    err = prepare<Smem>(k4_stats_chain<R>);
    if (err != cudaSuccess) return err;
    k4_stats_chain<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, dx0,
                                                           dyb, dsq, dgamma);
  } else {  // tensor cores
    err = prepare<StatsMmaSmem>(k4_stats_chain_mma<R>);
    if (err != cudaSuccess) return err;
    k4_stats_chain_mma<R><<<n_blocks, NT, sizeof(StatsMmaSmem), st>>>(
        gamma, T, B, D, M, X, w, wmb, dx0, dyb, dsq, dgamma);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_fwd_any(const float* gamma, int T, int B, int M, const AnyArgs& a,
                           int n_blocks, const float* wmb, float* x0, float* yb, float* sq,
                           cudaStream_t st) {
  cudaError_t err = prepare<SmemAny>(k3_stats_any<R>);
  if (err != cudaSuccess) return err;
  k3_stats_any<R><<<n_blocks, NT, sizeof(SmemAny), st>>>(gamma, T, B, M, a, wmb, x0, yb, sq,
                                                         (T * B + TP - 1) / TP);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_any(const float* gamma, int T, int B, int M, const AnyArgs& a,
                           int n_blocks, const float* wmb, const float* dx0, const float* dyb,
                           const float* dsq, float* dgamma, cudaStream_t st) {
  cudaError_t err = prepare<SmemAny>(k4_stats_chain_any<R>);
  if (err != cudaSuccess) return err;
  k4_stats_chain_any<R><<<n_blocks, NT, sizeof(SmemAny), st>>>(
      gamma, T, B, M, a, wmb, dx0, dyb, dsq, dgamma, (T * B + TP - 1) / TP);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The decoder as arrays, as vlg_energy_fwd (energy_expected.cu); the
// generic kernels' scratch is n_blocks x vlg_any_scratch_words(L, widths, 2)
// words (K4 keeps decoder 0's masks beside the current decoder's).
int vlg_stats_fwd(int rung, const float* gamma, int T, int B, int M, int L, const int* widths,
                  const float* const* Ws, const float* const* bs, const float* wmb, float* x0,
                  float* yb, float* sq, void* scratch, int n_blocks, void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 2, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d)
        ? launch_fwd<R>(gamma, T, B, D, M, X, fixed_weights(d), wmb, x0, yb, sq, st)
        : launch_fwd_any<R>(gamma, T, B, M, a, n_blocks, wmb, x0, yb, sq, st);
  });
}

int vlg_stats_bwd(int rung, const float* gamma, int T, int B, int M, int L, const int* widths,
                  const float* const* Ws, const float* const* bs, const float* wmb,
                  const float* dx0, const float* dyb, const float* dsq, float* dgamma,
                  void* scratch, int n_blocks, void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 2, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d)
        ? launch_bwd<R>(gamma, T, B, D, M, X, fixed_weights(d), wmb, dx0, dyb, dsq, dgamma, st)
        : launch_bwd_any<R>(gamma, T, B, M, a, n_blocks, wmb, dx0, dyb, dsq, dgamma, st);
  });
}

}  // extern "C"
