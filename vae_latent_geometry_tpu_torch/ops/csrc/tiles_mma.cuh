// The forward energies' tile on the tensor cores, for sm_90a (H100): 32
// curve rows of 4 splines (point p = r * 4 + s, row r of spline b0 + s), a
// tile owning the 31 segments (r, r + 1) that start in its first 31 rows,
// tile y starting at row 31 y, so that consecutive tiles overlap by one row
// (decoded twice: 1/31 of the work) and need no order.  Each warp decodes
// 16 points (4 rows of 4 splines) through decode_mma.cuh; a lane holds rows
// p and p + 8 of the tile, two rows of ONE spline (p % 4).
//
// K1 at the reduced rungs (f32x3, f32x2, bfloat16) is k1_tiles_mma below
// (and the transposed op's K9 through it, on the uniform weight plane).
// The MC forward (K5/K7, energy_mc.cu: mc_tiles_mma) runs its own
// body over the same tiles.

#pragma once

#include "decode_mma.cuh"

namespace {

constexpr int TILE_NS = 4;                  // splines per tile
constexpr int TILE_RC = 32;                 // curve rows per tile
constexpr int TILE_KR = TILE_RC - 1;        // segments a tile owns per spline
constexpr int TILE_SEGS = TILE_KR * TILE_NS;  // and in all: segment p = (p / 4, p % 4)
static_assert(TILE_NS * TILE_RC == TP, "a tile is one activation tile");

// Rows of the (n_tiles, B) partial-energy buffer of the tiles.
inline int tile_rows(int T) { return T > 1 ? (T - 1 + TILE_KR - 1) / TILE_KR : 1; }

// The tile's points into s.g (rows past the curve and splines past B
// clamped: their segments are not counted).
__device__ __forceinline__ void load_tile_points(MmaSmem& s, const float* __restrict__ gamma,
                                                 int T, int B, int D, int t0, int b0) {
  for (int e = threadIdx.x; e < TP * DMAX; e += NT) {
    const int pp = e / DMAX, d = e % DMAX;
    const int t = min(t0 + pp / TILE_NS, T - 1), b = min(b0 + pp % TILE_NS, B - 1);
    s.g[e] = d < D ? gamma[((size_t)t * B + b) * D + d] : 0.f;
  }
}

// K1 at a reduced rung on the tensor cores (production shape), tile
// (blockIdx.x: splines b0..b0+3, blockIdx.y: rows from t0 = 31 y): per
// staged decoder the decode of decode_mma<R, true> -- each k16 step's
// products summed apart and added in fp32 (the tensor core truncates the
// sums it forms) and layer 1 rounded as the plain version rounds it, so
// that at M = 1, where the energy is a sum of squared adjacent-sample
// differences that shows a decode's rounding ~2000 times larger, it stays
// within 1e-5 of its plain version.  The statistics are centred on decoder
// 0 as k1_body keeps them: x0 in shared memory, ybar = sum_m w_m (x_m -
// x0) and the lane's share of sum_m w_m ||x_m - x0||^2 in registers, w_m =
// wmb[m, b] of the lane's spline.  The tile's 31 segments -> partial[
// blockIdx.y * B + b], summed over the tiles in a fixed order by a second
// launch (no float atomics: repeat runs are bitwise equal).
struct K1MmaSmem : MmaSmem {
  float xs[TP * (XMAX + 8)];        // x0, then xbar [p][n]
  float var[TP];
  float seg[TP];
};

template <int R>
__global__ void __launch_bounds__(NT, 1)
k1_tiles_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
             const float* __restrict__ wmb, float* __restrict__ partial) {
  static_assert(R != F32, "float32 keeps k1_fwd_fma");
  constexpr int SX = XMAX + 8;      // row stride: the float2 rows of 8 lanes in distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K1MmaSmem& s = *reinterpret_cast<K1MmaSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int p0 = (tid >> 5) * 16 + (lane >> 2);      // rows p0, p0 + 8 of the warp's tile
  const int b0 = blockIdx.x * TILE_NS, t0 = blockIdx.y * TILE_KR;
  const float* __restrict__ wl = wmb + min(b0 + p0 % TILE_NS, B - 1);  // the lane's spline
  zero_w3_planes(s);
  load_tile_points(s, gamma, T, B, D, t0, b0);
  float yb[NJ3][4], sq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) yb[j][c] = 0.f;
  for (int m = 0; m < M; ++m) {
    const float wm = m > 0 ? wl[(size_t)m * B] : 0.f;
    __syncthreads();
    stage_weights_mma<R>(s, m, D, X, w);
    __syncthreads();
    float x[NJ3][4];
    uint32_t m1[2], m2[2];
    decode_mma<R, true>(s, D, X, x, m1, m2);
    float qs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2& x0 = *reinterpret_cast<float2*>(&s.xs[(p0 + 8 * r) * SX + 8 * j + 2 * q]);
        if (m == 0) {
          x0 = make_float2(x[j][2 * r], x[j][2 * r + 1]);
        } else {
          const float y0 = x[j][2 * r] - x0.x, y1 = x[j][2 * r + 1] - x0.y;
          yb[j][2 * r] = yb[j][2 * r] + wm * y0;
          yb[j][2 * r + 1] = yb[j][2 * r + 1] + wm * y1;
          qs[r] += y0 * y0;
          qs[r] += y1 * y1;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) sq[r] = sq[r] + wm * qs[r];
  }
  // xbar = x0 + ybar (in place); var = sq - ||ybar||^2, a row's four lanes
  // in a fixed order
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = sq[r];
#pragma unroll
    for (int j = 0; j < NJ3; ++j) {
      float2& xb = *reinterpret_cast<float2*>(&s.xs[(p0 + 8 * r) * SX + 8 * j + 2 * q]);
      xb = make_float2(xb.x + yb[j][2 * r], xb.y + yb[j][2 * r + 1]);
      v -= yb[j][2 * r] * yb[j][2 * r] + yb[j][2 * r + 1] * yb[j][2 * r + 1];
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0) s.var[p0 + 8 * r] = M > 1 ? v : 0.f;
  }
  __syncthreads();
  // segment after point p (rows r, r + 1 of spline p % 4)
  if (tid < TILE_SEGS) {
    const int r = tid / TILE_NS, sl = tid % TILE_NS;
    float sd = 0.f;
    for (int n = 0; n < X; ++n) {
      const float d = s.xs[(tid + TILE_NS) * SX + n] - s.xs[tid * SX + n];
      sd += d * d;
    }
    const bool valid = t0 + r + 1 < T && b0 + sl < B;
    s.seg[tid] = valid ? (sd + s.var[tid + TILE_NS]) + s.var[tid] : 0.f;
  }
  __syncthreads();
  if (tid < TILE_NS && b0 + tid < B) {
    float e = 0.f;
    for (int r = 0; r < TILE_KR; ++r) e += s.seg[r * TILE_NS + tid];
    partial[(size_t)blockIdx.y * B + b0 + tid] = e;
  }
}

}  // namespace
