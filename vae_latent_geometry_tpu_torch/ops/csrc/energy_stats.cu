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

#include "decode_common.cuh"

namespace {

constexpr int S_X = XMAX + 1;

struct Smem : DecodeSmem {
  float xs[TP * S_X];       // x0 of the tile's points
};

// K3: statistics of the tile's points -> x0, yb (T*B, X), sq (T*B).
template <int R>
__global__ void __launch_bounds__(NT, 1)
k3_stats(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
         const float* __restrict__ wmb, float* __restrict__ x0_out,
         float* __restrict__ yb_out, float* __restrict__ sq_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int N = T * B, p0 = blockIdx.x * TP;
  load_points(s, gamma, N, D, p0);
  float yb[8][4], sq[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) yb[i][j] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, w);
    __syncthreads();
    float x[8][4];
    uint32_t m1[2], m2[2];
    decode_tile<R>(s, D, x, m1, m2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      if (m == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s.xs[p * S_X + tx + 16 * j] = x[i][j];
      } else {
        const float wm = wmb[(size_t)m * B + min(p0 + p, N - 1) % B];
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = x[i][j] - s.xs[p * S_X + tx + 16 * j];
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
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < X) {
        x0_out[(size_t)pg * X + n] = s.xs[p * S_X + n];
        yb_out[(size_t)pg * X + n] = yb[i][j];
      }
    }
    if (tx == 0) sq_out[pg] = v;
  }
}

// K4: (dx0, dyb, dsq) -> dgamma (T*B, D), every decoder decoded once.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k4_stats_chain(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
               const float* __restrict__ wmb, const float* __restrict__ dx0,
               const float* __restrict__ dyb, const float* __restrict__ dsq,
               float* __restrict__ dgamma) {
  constexpr int C = CHAIN_RUNG<R>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = T * B, p0 = blockIdx.x * TP;
  load_points(s, gamma, N, D, p0);
  for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
  __syncthreads();
  stage_weights<R>(s, 0, D, X, w);
  __syncthreads();
  float x[8][4], csum[8][4];
  uint32_t m1_0[2], m2_0[2];
  decode_tile<R>(s, D, x, m1_0, m2_0);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.xs[(ty * 8 + i) * S_X + tx + 16 * j] = x[i][j];
      csum[i][j] = 0.f;
    }
  for (int m = 1; m < M; ++m) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, w);
    __syncthreads();
    uint32_t m1[2], m2[2];
    decode_tile<R>(s, D, x, m1, m2);
    // c_m -> act[n][p] at the chain rung, and into the running sum
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
      const float wm = wmb[(size_t)m * B + pc % B];
      const float ds = dsq[pc];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n < X) {
          const float y = x[i][j] - s.xs[p * S_X + n];
          const float c = pg < N
              ? __fmul_rn(wm, __fadd_rn(dyb[(size_t)pc * X + n],
                                        __fmul_rn(__fmul_rn(2.f, y), ds)))
              : 0.f;
          csum[i][j] = csum[i][j] + c;
          s.act[n * S_ACT + p] = pack<C>(c);
        }
      }
    }
    __syncthreads();
    chain_tile<C>(s, D, X, m1, m2);
  }
  // decoder 0: its direct cotangent minus every y_m's dependency on x0
  if (M > 1) {
    __syncthreads();
    stage_weights<R>(s, 0, D, X, w);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < X) {
        const float c = pg < N ? dx0[(size_t)pc * X + n] - csum[i][j] : 0.f;
        s.act[n * S_ACT + p] = pack<C>(c);
      }
    }
  }
  __syncthreads();
  chain_tile<C>(s, D, X, m1_0, m2_0);
  __syncthreads();
  store_dgamma(s, dgamma, N, D, p0);
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

}  // namespace

extern "C" {

int vlg_stats_fwd(int rung, const float* gamma, int T, int B, int D, int M, int X,
                  const float* W1, const float* b1, const float* W2, const float* b2,
                  const float* W3, const float* b3, const float* wmb, float* x0, float* yb,
                  float* sq, void* stream) {
  const Weights w{W1, b1, W2, b2, W3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case F32: return launch_fwd<F32>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq, st);
    case F32X3: return launch_fwd<F32X3>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq, st);
    case F32X2: return launch_fwd<F32X2>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq, st);
    case BF16: return launch_fwd<BF16>(gamma, T, B, D, M, X, w, wmb, x0, yb, sq, st);
  }
  return cudaErrorInvalidValue;
}

int vlg_stats_bwd(int rung, const float* gamma, int T, int B, int D, int M, int X,
                  const float* W1, const float* b1, const float* W2, const float* b2,
                  const float* W3, const float* b3, const float* wmb, const float* dx0,
                  const float* dyb, const float* dsq, float* dgamma, void* stream) {
  const Weights w{W1, b1, W2, b2, W3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case F32:
      return launch_bwd<F32>(gamma, T, B, D, M, X, w, wmb, dx0, dyb, dsq, dgamma, st);
    case F32X3:
      return launch_bwd<F32X3>(gamma, T, B, D, M, X, w, wmb, dx0, dyb, dsq, dgamma, st);
    case F32X2:
      return launch_bwd<F32X2>(gamma, T, B, D, M, X, w, wmb, dx0, dyb, dsq, dgamma, st);
    case BF16:
      return launch_bwd<BF16>(gamma, T, B, D, M, X, w, wmb, dx0, dyb, dsq, dgamma, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
