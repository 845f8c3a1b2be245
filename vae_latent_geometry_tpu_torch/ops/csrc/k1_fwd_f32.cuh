// K1's float32 kernel on the production decoder (k1_fwd_fma), of
// energy_expected.cu (K1, and the transposed op's K9 through it, on the
// uniform weight plane), for sm_90a (H100).  Its decode is
// decode_f32.cuh's; energy_expected.cu says what bounds it and why it is
// built so.

#pragma once

#include "decode_common.cuh"
#include "decode_f32.cuh"

namespace {

// K1, pass 1, at float32 on the production decoder: the decode of
// decode_f32.cuh over tiles of 128 t-rows of ONE spline (127 owned
// segments: 0.8% of the rows decoded twice), one chunk of 128 points per
// staged decoder, the next decoder's weights in flight meanwhile.  The
// running statistics x0, ybar and the lane's share of sum_m w_m ||x_m -
// x0||^2 stay in the registers of the lane whose layer-3 tile holds them;
// after the last decoder xbar (over the activation tile) and var go through
// shared memory to the segments, two threads a segment.
constexpr int K1F_ROWS = 128;
constexpr int K1F_SEGS = K1F_ROWS - 1;
constexpr int F_SX = XMAX + 4;   // xbar row stride (floats)
using K1Lane = F32Lane<4>;

struct K1F32Smem : F32Smem<4> {
  float g[K1F_ROWS * DMAX];      // the tile's points
  float vpart[K1F_ROWS * 2];     // var's two column halves
  float var[K1F_ROWS];
  float seg[K1F_ROWS];
};
static_assert(K1F_ROWS * F_SX <= H * F32Smem<4>::SA, "xbar fits the activation tile");

int k1f_tiles(int T) { return T > 1 ? (T - 1 + K1F_SEGS - 1) / K1F_SEGS : 1; }

template <int R>
__global__ void __launch_bounds__(NT, 1)
k1_fwd_fma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, F32Weights fw,
           const float* __restrict__ wmb, float* __restrict__ partial) {
  static_assert(R == F32, "the float32 rung only");
  constexpr int PL = K1Lane::PL3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K1F32Smem& s = *reinterpret_cast<K1F32Smem*>(smem_raw);
  const int tid = threadIdx.x, b = blockIdx.x, t0 = blockIdx.y * K1F_SEGS;
  const int n_rows = min(K1F_ROWS, T - t0);
  for (int e = tid; e < K1F_ROWS * DMAX; e += NT) {
    const int r = e / DMAX, d = e % DMAX;
    s.g[e] = d < D ? gamma[((size_t)min(t0 + r, T - 1) * B + b) * D + d] : 0.f;
  }
  f32_zero_pads(s, X);
  f32_prologue(s, fw, 0, D, X);
  cp_wait<2>();
  __syncthreads();
  const int p3 = K1Lane::p3(), n3 = K1Lane::n3();
  float x0[PL][4], yb[PL][4], sq[PL];
  NoMid mid;
  for (int m = 0; m < M; ++m) {
    const float wm = wmb[(size_t)m * B + b];
    float x[PL][4];
    f32_decode_chunk(s, fw, s.g, nullptr, 0, n_rows, D, X, m & 1, m + 1 < M ? m + 1 : -1, mid,
                     x);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      if (m == 0) {
        sq[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x0[i][j] = x[i][j];
          yb[i][j] = 0.f;
        }
      } else {
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = x[i][j] - x0[i][j];
          yb[i][j] = yb[i][j] + wm * y;
          q += y * y;
        }
        sq[i] = sq[i] + wm * q;
      }
    }
  }
  // xbar = x0 + ybar over the activation tile; the lane's share of var,
  // summed over the 8 lanes of its column quads, then the two halves
  float* xbar = s.act;
  const bool live = K1Lane::live(n_rows);
#pragma unroll
  for (int i = 0; i < PL; ++i) {
    float v = sq[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0[i][j] += yb[i][j];
      v -= yb[i][j] * yb[i][j];
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if (live) {
      const int r = p3 + i;
      *reinterpret_cast<float4*>(xbar + r * F_SX + n3) =
          make_float4(x0[i][0], x0[i][1], x0[i][2], x0[i][3]);
      if ((tid & 7) == 0) s.vpart[r * 2 + K1Lane::wc()] = v;
    }
  }
  __syncthreads();
  if (tid < n_rows) s.var[tid] = M > 1 ? s.vpart[tid * 2] + s.vpart[tid * 2 + 1] : 0.f;
  __syncthreads();
  // segment r (rows r, r + 1): two threads, alternate features
  {
    const int r = tid >> 1;
    float sd = 0.f;
    if (r < K1F_SEGS && r + 1 < n_rows)
      for (int n = tid & 1; n < X; n += 2) {
        const float d = xbar[(r + 1) * F_SX + n] - xbar[r * F_SX + n];
        sd += d * d;
      }
    sd += __shfl_xor_sync(0xffffffffu, sd, 1);
    if ((tid & 1) == 0 && r < K1F_SEGS)
      s.seg[r] = t0 + r + 1 < T ? (sd + s.var[r + 1]) + s.var[r] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    float e = 0.f;
    for (int r = tid; r < K1F_SEGS; r += 32) e += s.seg[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (tid == 0) partial[(size_t)blockIdx.y * B + b] = e;
  }
}

}  // namespace
