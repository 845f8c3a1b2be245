// Per-shard ensemble sufficient statistics and their gradient, for sm_90a
// (H100): the kernels of the decoder-sharded (expert-parallel) expected
// energy.
//
// Replaces the Pallas TPU kernels of vae_latent_geometry_tpu/ops/energy_pallas.py:
//   K3  _stats_fwd_kernel (:472)  -> k3_stats
//   K4  _stats_bwd_kernel (:502)  -> k4_stats_chain
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
// The decode, the cotangent chain and the precision rungs are shared with the
// other energy kernels: decode_common.cuh.
//
// Work (per point per decoder, D=2, X=50): the float32 decode is 46 kFLOP, so
// K3 is 1.8e11 FLOP at T=2000, B=200, M=10 and writes 161.6 MB of statistics
// (0.05 ms at 3.35 TB/s against 2.75 ms of FP32 FMAs); K4 at f32x2 is a
// two-pass decode plus a single-pass chain, about 138 kFLOP per point and
// decoder, and reads the same 161.6 MB of cotangents.  Both are bound by
// operations, not bytes.
//
// Design for Hopper.  The TPU kernels keep all local decoders in VMEM and
// stream (Tc, Bb) tiles through a 2-D grid.  Here a block owns 128 points of
// the flattened (T*B) curve and loops over decoders, staging one at a time
// (decode_common.cuh).  The statistics are pointwise in t, so there is no
// halo, no partial buffer and no second launch.  x0 lives in shared memory
// (33 KB beside the 174 KB of the decode), the running sums yb/sq (K3) and
// sum_m c_m (K4) in registers.  K4 is ONE launch that decodes every decoder
// once: nothing in it needs a neighbouring point's result, so decoder m's
// chain follows its decode directly; decoder 0 is decoded first (its output
// and ReLU mask words are kept), and its weights are staged a second time at
// the end for its chain, when sum_m c_m is complete.  Cotangents of points
// past the end of the curve (the last tile) are zero.
//
// Any decoder.  The kernels above take the production shape D <= 4 -> 128 ->
// 128 -> X <= 64; every other decoder (2 to 6 layers, hidden widths up to
// 512, X <= 128) takes k3_stats_any and k4_stats_chain_any: the same bodies
// over the generic decode of decode_any.cuh, in persistent blocks; K4 keeps
// decoder 0's masks in a second mask area of the block's scratch.

#include "decode_any.cuh"
#include "decode_common.cuh"

namespace {

constexpr int S_X = XMAX + 1;

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
  load_points(s, gamma, N, D, p0);
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
  load_points(s, gamma, N, D, p0);
  for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
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
  store_dgamma(s, dgamma, N, D, p0);
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

// K3 and K4, any decoder: persistent blocks over the n_items tiles.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k3_stats_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
             const float* __restrict__ wmb, float* __restrict__ x0_out,
             float* __restrict__ yb_out, float* __restrict__ sq_out, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.width[0], X = s.dec.width[s.dec.L];
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
  const int D = s.dec.width[0], X = s.dec.width[s.dec.L];
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k4_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, wmb, dx0, dyb, dsq, dgamma);
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, float* x0, float* yb, float* sq, cudaStream_t st) {
  cudaError_t err = prepare<Smem>(k3_stats<R>);
  if (err != cudaSuccess) return err;
  const int n_blocks = (T * B + TP - 1) / TP;
  k3_stats<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, const float* dx0, const float* dyb, const float* dsq,
                       float* dgamma, cudaStream_t st) {
  cudaError_t err = prepare<Smem>(k4_stats_chain<R>);
  if (err != cudaSuccess) return err;
  const int n_blocks = (T * B + TP - 1) / TP;
  k4_stats_chain<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, dx0, dyb,
                                                         dsq, dgamma);
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
  const int D = d.width[0], X = d.width[L];
  const AnyArgs a{d, static_cast<uint32_t*>(scratch), any_scratch_words(d, 2)};
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
  const int D = d.width[0], X = d.width[L];
  const AnyArgs a{d, static_cast<uint32_t*>(scratch), any_scratch_words(d, 2)};
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d)
        ? launch_bwd<R>(gamma, T, B, D, M, X, fixed_weights(d), wmb, dx0, dyb, dsq, dgamma, st)
        : launch_bwd_any<R>(gamma, T, B, M, a, n_blocks, wmb, dx0, dyb, dsq, dgamma, st);
  });
}

}  // extern "C"
