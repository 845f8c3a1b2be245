// Expected ensemble curve energy and its gradient, for sm_90a (H100).
//
// Replaces the Pallas TPU kernels of vae_latent_geometry_tpu/ops/energy_pallas.py:
//   K1  _fwd_kernel (:254)  -> k1_energy_tiles + k1_sum_tiles
//   K2  _bwd_kernel (:325)  -> k2_xbar + k2_chain
//       (with _backprop_chain_masked :406 and _center_masks :426)
//
// Function.  The decoder ensemble is M ReLU MLPs D -> 128 -> 128 -> X applied
// to every curve point gamma[t, b, :] (T, B, D).  With per-spline weights
// wmb[m, b] (summing to 1 over m):
//   K1: E_b = sum_t ||xbar_{t+1} - xbar_t||^2 + var_{t+1} + var_t, with the
//       centered statistics xbar = x0 + sum_m w_m (x_m - x0) and
//       var = sum_m w_m ||x_m - x0||^2 - ||xbar - x0||^2.
//   K2: dgamma for a per-spline cotangent ct_b:
//       dE/dx_{m,t} = 2 w_{m,b} ct_b (c_t x_{m,t} - (xbar_{t-1} + xbar_{t+1}))
//       (uncentered xbar = sum_m w_m x_m, c_t = has_left + has_right),
//       back-propagated through the ReLU masks of the SAME decode.
//
// Precision rungs (template R) reproduce _split_hi_lo / _prep_w / _mp_dot
// (energy_pallas.py:178-224): operands are rounded to bf16 hi/lo with
// __float2bfloat16_rn, every partial product is an fp32 FMA (the product of
// two bf16 values is exact in fp32) and accumulation is fp32:
//   float32  : exact fp32 products
//   f32x3    : h_hi*w_hi + h_lo*w_hi + h_hi*w_lo
//   f32x2    : h_hi*w_hi + h_lo*w_hi
//   bfloat16 : h_hi*w_hi (the wrapper ships W1..W3 rounded to bf16)
// The first layer is always fp32 FMAs; the cotangent chain runs at bf16
// under f32x3/f32x2 and at the rung itself otherwise (_backprop_chain_masked).
//
// Work (counted from the code, per point per decoder): the float32 decode is
// 2*D*128 + 2*128*128 + 2*128*X = 46 kFLOP at D=2, X=50, i.e. 1.8e11 FLOP
// per K1 call at T=2000, B=200, M=10.  K2 at f32x2 is a two-pass decode plus
// a single-pass chain, about 138 kFLOP, i.e. 5.5e11 FLOP per step.  Both move
// a few MB of inputs and outputs (K2's 80 MB xbar scratch aside), so both
// are bound by operations, not bytes, on this card.
//
// Design for Hopper.  The TPU kernel keeps all M decoders' weights resident
// in VMEM; an SM has 227 KB of shared memory, so a block loops over decoders
// and stages ONE decoder's W2 (64 KB) and W3 (25.6 KB) at a time, already
// split into packed (hi, lo) bf16 words.  A block owns a tile of 128 points
// and 256 threads; each thread owns 8 points x 8 (layer 2, chain) or 8 x 4
// (layer 3) outputs of a register-tiled GEMM over the shared-memory
// activation tile, with its ReLU masks kept as bits in registers.  Running
// statistics live in registers (K1 ybar, sqy) and shared memory (K1 x0,
// K2 neighbour sums and dgamma).  Blocks run in no order, so K1's tile of
// 32 t-rows x 4 splines recomputes its halo row instead of carrying it
// (31 owned segments per 32 decoded rows), writes per-tile partial energies
// to an (n_tiles, B) buffer, and a second launch sums them in a fixed order:
// no float atomics, so repeated runs are bitwise identical.  K2 is two
// launches: k2_xbar writes xbar (T, B, X), then k2_chain re-decodes each
// decoder per tile, forms dx and runs the masked chain.  This decodes twice
// where the TPU kernel decodes once; restoring the single decode is later
// work.  Matrix products use CUDA-core FMAs, not tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int H = 128;          // hidden width of both hidden layers
constexpr int XMAX = 64;        // widest supported output
constexpr int DMAX = 4;         // widest supported latent
constexpr int TP = 128;         // points per tile
constexpr int NT = 256;         // threads per block
constexpr int S_ACT = TP + 4;   // activation tile row stride (words)
constexpr int S_W2 = H + 1;     // odd strides: conflict-free row and column reads
constexpr int S_W3 = XMAX + 1;
constexpr int S_X = XMAX + 1;
constexpr int K1_COLS = 4;      // K1 tile: 32 t-rows x 4 splines
constexpr int K1_ROWS = TP / K1_COLS;
constexpr int K1_SEGS = K1_ROWS - 1;

enum Rung { F32 = 0, F32X3 = 1, F32X2 = 2, BF16 = 3 };

struct Smem {
  uint32_t act[H * S_ACT];  // activation tile [k][p], packed for the rung
  uint32_t w2[H * S_W2];    // W2[k][n] packed
  uint32_t w3[H * S_W3];    // W3[k][n] packed, n >= X zero
  float xs[TP * S_X];       // K1: x0 then xbar; K2: xbar_{t-1} + xbar_{t+1}
  float w1[DMAX * H];
  float g[TP * DMAX];       // the tile's curve points
  float dg[TP * DMAX];      // K2: dgamma accumulators
  float b1[H], b2[H], b3[XMAX];
  float red[TP];            // K1: var per point
  float red2[TP];           // K1: segment energies
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One 32-bit word per operand: the fp32 value (float32 rung) or hi bf16 in
// the top half and lo bf16 in the bottom half (bf16 values are the top 16
// bits of their fp32 representation, so unpacking is one mask or shift).
template <int R>
__device__ __forceinline__ uint32_t pack(float x) {
  if constexpr (R == F32) {
    return __float_as_uint(x);
  } else {
    const float hi = bf16r(x);
    if constexpr (R == BF16) return __float_as_uint(hi);
    const float lo = bf16r(x - hi);
    return (__float_as_uint(hi) & 0xFFFF0000u) | (__float_as_uint(lo) >> 16);
  }
}
__device__ __forceinline__ float hi_of(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float lo_of(uint32_t w) { return __uint_as_float(w << 16); }

// acc[i][j] += sum_k act[k][p_i] * W(k, n_j) at rung R, p_i = ty*8 + i,
// n_j = tx + 16 j.  W(k, n) = w[k*ws + n], or w[n*ws + k] when TRANS (the
// chain's products with W^T).
template <int R, int NJ, bool TRANS>
__device__ __forceinline__ void gemm(const uint32_t* act, const uint32_t* w, int ws,
                                     int kdim, float (&acc)[8][NJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int kk = 0; kk < kdim; ++kk) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(act + kk * S_ACT + ty * 8);
    const uint4 a1 = *reinterpret_cast<const uint4*>(act + kk * S_ACT + ty * 8 + 4);
    const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    uint32_t wv[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wv[j] = TRANS ? w[(tx + 16 * j) * ws + kk] : w[kk * ws + tx + 16 * j];
    if constexpr (R == F32) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[i][j] = fmaf(__uint_as_float(a[i]), __uint_as_float(wv[j]), acc[i][j]);
    } else {
      float ah[8], al[8], wh[NJ], wl[NJ];
#pragma unroll
      for (int i = 0; i < 8; ++i) { ah[i] = hi_of(a[i]); al[i] = lo_of(a[i]); }
#pragma unroll
      for (int j = 0; j < NJ; ++j) { wh[j] = hi_of(wv[j]); wl[j] = lo_of(wv[j]); }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          acc[i][j] = fmaf(ah[i], wh[j], acc[i][j]);
          if constexpr (R == F32X2 || R == F32X3) acc[i][j] = fmaf(al[i], wh[j], acc[i][j]);
          if constexpr (R == F32X3) acc[i][j] = fmaf(ah[i], wl[j], acc[i][j]);
        }
    }
  }
}

// Stage decoder m's weights into shared memory, packed for rung R.
template <int R>
__device__ void stage_weights(Smem& s, int m, int D, int X,
                              const float* __restrict__ W1, const float* __restrict__ b1,
                              const float* __restrict__ W2, const float* __restrict__ b2,
                              const float* __restrict__ W3, const float* __restrict__ b3) {
  const int tid = threadIdx.x;
  const float* w2 = W2 + (size_t)m * H * H;
  for (int e = tid; e < H * H; e += NT) s.w2[(e / H) * S_W2 + e % H] = pack<R>(w2[e]);
  const float* w3 = W3 + (size_t)m * H * X;
  for (int e = tid; e < H * XMAX; e += NT) {
    const int k = e / XMAX, n = e % XMAX;
    s.w3[k * S_W3 + n] = n < X ? pack<R>(w3[k * X + n]) : 0u;
  }
  for (int e = tid; e < DMAX * H; e += NT)
    s.w1[e] = e < D * H ? W1[(size_t)m * D * H + e] : 0.f;
  for (int e = tid; e < H; e += NT) {
    s.b1[e] = b1[(size_t)m * H + e];
    s.b2[e] = b2[(size_t)m * H + e];
  }
  for (int e = tid; e < XMAX; e += NT) s.b3[e] = e < X ? b3[(size_t)m * X + e] : 0.f;
}

// Decode the tile's points (s.g) with the staged decoder.  x[i][j] is the
// output at point ty*8+i, feature tx+16j; m1/m2 hold the ReLU masks of the
// two hidden layers at (point ty*8+i, unit tx+16j) as bit i*8+j.
template <int R>
__device__ void decode_tile(Smem& s, int D, float (&x)[8][4], uint32_t (&m1)[2],
                            uint32_t (&m2)[2]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  m1[0] = m1[1] = m2[0] = m2[1] = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      float h = s.b1[k];
      for (int d = 0; d < D; ++d) h = h + s.g[p * DMAX + d] * s.w1[d * H + k];
      h = fmaxf(h, 0.f);
      const int bit = i * 8 + j;
      if (h > 0.f) m1[bit >> 5] |= 1u << (bit & 31);
      s.act[k * S_ACT + p] = pack<R>(h);
    }
  }
  __syncthreads();
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gemm<R, 8, false>(s.act, s.w2, S_W2, H, acc);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float h = fmaxf(acc[i][j] + s.b2[k], 0.f);
      const int bit = i * 8 + j;
      if (h > 0.f) m2[bit >> 5] |= 1u << (bit & 31);
      s.act[k * S_ACT + ty * 8 + i] = pack<R>(h);
    }
  }
  __syncthreads();
  float acc3[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc3[i][j] = 0.f;
  gemm<R, 4, false>(s.act, s.w3, S_W3, H, acc3);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = acc3[i][j] + s.b3[tx + 16 * j];
  __syncthreads();
}

__device__ __forceinline__ float sum16(float v) {  // over the 16 tx lanes
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

struct Weights {
  const float *W1, *b1, *W2, *b2, *W3, *b3;
};

// K1, pass 1: partial energies of tile (blockIdx.y: t-rows t0..t0+31,
// blockIdx.x: splines b0..b0+3) -> partial[blockIdx.y * B + b].
template <int R>
__global__ void __launch_bounds__(NT, 1)
k1_energy_tiles(const float* __restrict__ gamma, int T, int B, int D, int M, int X,
                Weights w, const float* __restrict__ wmb, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.y * K1_SEGS, b0 = blockIdx.x * K1_COLS;
  for (int e = tid; e < TP * DMAX; e += NT) {
    const int p = e / DMAX, d = e % DMAX;
    const int t = min(t0 + p / K1_COLS, T - 1), b = min(b0 + p % K1_COLS, B - 1);
    s.g[e] = d < D ? gamma[((size_t)t * B + b) * D + d] : 0.f;
  }
  float ybar[8][4], sqy[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sqy[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ybar[i][j] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, w.W1, w.b1, w.W2, w.b2, w.W3, w.b3);
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
        const float wm = wmb[(size_t)m * B + min(b0 + p % K1_COLS, B - 1)];
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = x[i][j] - s.xs[p * S_X + tx + 16 * j];
          ybar[i][j] = ybar[i][j] + wm * y;
          q += y * y;
        }
        sqy[i] = sqy[i] + wm * q;
      }
    }
  }
  // xbar = x0 + ybar (in place over x0); var = sqy - ||ybar||^2
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i;
    float v = sqy[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s.xs[p * S_X + tx + 16 * j] += ybar[i][j];
      v -= ybar[i][j] * ybar[i][j];
    }
    v = sum16(v);
    if (tx == 0) s.red[p] = M > 1 ? v : 0.f;
  }
  __syncthreads();
  if (tid < K1_SEGS * K1_COLS) {
    const int r = tid / K1_COLS, c = tid % K1_COLS;
    const int pa = r * K1_COLS + c, pb = pa + K1_COLS;
    float sd = 0.f;
    for (int n = 0; n < X; ++n) {
      const float d = s.xs[pb * S_X + n] - s.xs[pa * S_X + n];
      sd += d * d;
    }
    const bool valid = (t0 + r + 1 < T) && (b0 + c < B);
    s.red2[tid] = valid ? (sd + s.red[pb]) + s.red[pa] : 0.f;
  }
  __syncthreads();
  if (tid < K1_COLS && b0 + tid < B) {
    float e = 0.f;
    for (int r = 0; r < K1_SEGS; ++r) e += s.red2[r * K1_COLS + tid];
    partial[(size_t)blockIdx.y * B + b0 + tid] = e;
  }
}

// K1, pass 2: fixed-order sum of the per-tile partial energies.
__global__ void k1_sum_tiles(const float* __restrict__ partial, int n_tiles, int B,
                             float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float e = 0.f;
  for (int i = 0; i < n_tiles; ++i) e += partial[(size_t)i * B + b];
  out[b] = e;
}

// Load the tile's points p0..p0+127 of the flattened (T*B) curve.
__device__ void load_points(Smem& s, const float* __restrict__ gamma, int N, int D, int p0) {
  for (int e = threadIdx.x; e < TP * DMAX; e += NT) {
    const int p = e / DMAX, d = e % DMAX;
    s.g[e] = d < D ? gamma[(size_t)min(p0 + p, N - 1) * D + d] : 0.f;
  }
}

// K2, pass 1: uncentered xbar = sum_m w_m x_m for every point -> (T*B, X).
template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_xbar(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
        const float* __restrict__ wmb, float* __restrict__ xbar) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int N = T * B, p0 = blockIdx.x * TP;
  load_points(s, gamma, N, D, p0);
  float xb[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) xb[i][j] = 0.f;
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, w.W1, w.b1, w.W2, w.b2, w.W3, w.b3);
    __syncthreads();
    float x[8][4];
    uint32_t m1[2], m2[2];
    decode_tile<R>(s, D, x, m1, m2);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wm = wmb[(size_t)m * B + min(p0 + ty * 8 + i, N - 1) % B];
#pragma unroll
      for (int j = 0; j < 4; ++j) xb[i][j] = xb[i][j] + wm * x[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pg = p0 + ty * 8 + i;
    if (pg >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      if (n < X) xbar[(size_t)pg * X + n] = xb[i][j];
    }
  }
}

// K2, pass 2: per decoder, re-decode the tile, form dx and run the masked
// cotangent chain back to dgamma (T*B, D).
template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_chain(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
         const float* __restrict__ wmb, const float* __restrict__ ct,
         const float* __restrict__ xbar, float* __restrict__ dgamma) {
  constexpr int C = (R == F32X2 || R == F32X3) ? BF16 : R;  // chain rung
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = T * B, p0 = blockIdx.x * TP;
  load_points(s, gamma, N, D, p0);
  for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
  for (int e = tid; e < TP * XMAX; e += NT) {
    const int p = e / XMAX, n = e % XMAX;
    const int pg = min(p0 + p, N - 1), t = pg / B;
    const float left = (n < X && t > 0) ? xbar[(size_t)(pg - B) * X + n] : 0.f;
    const float right = (n < X && t < T - 1) ? xbar[(size_t)(pg + B) * X + n] : 0.f;
    s.xs[p * S_X + n] = left + right;
  }
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, w.W1, w.b1, w.W2, w.b2, w.W3, w.b3);
    __syncthreads();
    float x[8][4];
    uint32_t m1[2], m2[2];
    decode_tile<R>(s, D, x, m1, m2);
    // dx -> act[n][p] at the chain rung
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
      const int t = pc / B, b = pc % B;
      const float cc = (float)((t > 0) + (t < T - 1));
      const float sc = pg < N ? __fmul_rn(2.f, __fmul_rn(wmb[(size_t)m * B + b], ct[b])) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n < X) {
          const float v = __fmul_rn(sc, __fsub_rn(__fmul_rn(cc, x[i][j]), s.xs[p * S_X + n]));
          s.act[n * S_ACT + p] = pack<C>(v);
        }
      }
    }
    __syncthreads();
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    gemm<C, 8, true>(s.act, s.w3, S_W3, X, acc);  // dh2 = dx @ W3^T
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int bit = i * 8 + j;
        const float v = (m2[bit >> 5] >> (bit & 31)) & 1u ? acc[i][j] : 0.f;
        s.act[(tx + 16 * j) * S_ACT + ty * 8 + i] = pack<C>(v);
        acc[i][j] = 0.f;
      }
    __syncthreads();
    gemm<C, 8, true>(s.act, s.w2, S_W2, H, acc);  // dh1 = dh2 @ W2^T
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      for (int d = 0; d < D; ++d) {
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int bit = i * 8 + j;
          const float v = (m1[bit >> 5] >> (bit & 31)) & 1u ? acc[i][j] : 0.f;
          q += v * s.w1[d * H + tx + 16 * j];
        }
        q = sum16(q);
        if (tx == 0) s.dg[p * DMAX + d] += q;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TP * D; e += NT) {
    const int p = e / D, d = e % D, pg = p0 + p;
    if (pg < N) dgamma[(size_t)pg * D + d] = s.dg[p * DMAX + d];
  }
}

template <typename K>
cudaError_t prepare(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, float* partial, float* out, cudaStream_t st) {
  cudaError_t err = prepare(k1_energy_tiles<R>);
  if (err != cudaSuccess) return err;
  const int n_tiles = T > 1 ? (T - 1 + K1_SEGS - 1) / K1_SEGS : 1;
  dim3 grid((B + K1_COLS - 1) / K1_COLS, n_tiles);
  k1_energy_tiles<R><<<grid, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_sum_tiles<<<(B + 127) / 128, 128, 0, st>>>(partial, n_tiles, B, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, const float* ct, float* xbar, float* dgamma,
                       cudaStream_t st) {
  cudaError_t err = prepare(k2_xbar<R>);
  if (err == cudaSuccess) err = prepare(k2_chain<R>);
  if (err != cudaSuccess) return err;
  const int n_blocks = (T * B + TP - 1) / TP;
  k2_xbar<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, xbar);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_chain<R><<<n_blocks, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, ct, xbar,
                                                   dgamma);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile count of K1's (n_tiles, B) partial-energy buffer.
int vlg_energy_fwd_tiles(int T) { return T > 1 ? (T - 1 + K1_SEGS - 1) / K1_SEGS : 1; }

int vlg_energy_fwd(int rung, const float* gamma, int T, int B, int D, int M, int X,
                   const float* W1, const float* b1, const float* W2, const float* b2,
                   const float* W3, const float* b3, const float* wmb, float* partial,
                   float* out, void* stream) {
  const Weights w{W1, b1, W2, b2, W3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case F32: return launch_fwd<F32>(gamma, T, B, D, M, X, w, wmb, partial, out, st);
    case F32X3: return launch_fwd<F32X3>(gamma, T, B, D, M, X, w, wmb, partial, out, st);
    case F32X2: return launch_fwd<F32X2>(gamma, T, B, D, M, X, w, wmb, partial, out, st);
    case BF16: return launch_fwd<BF16>(gamma, T, B, D, M, X, w, wmb, partial, out, st);
  }
  return cudaErrorInvalidValue;
}

int vlg_energy_bwd(int rung, const float* gamma, int T, int B, int D, int M, int X,
                   const float* W1, const float* b1, const float* W2, const float* b2,
                   const float* W3, const float* b3, const float* wmb, const float* ct,
                   float* xbar, float* dgamma, void* stream) {
  const Weights w{W1, b1, W2, b2, W3, b3};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case F32: return launch_bwd<F32>(gamma, T, B, D, M, X, w, wmb, ct, xbar, dgamma, st);
    case F32X3: return launch_bwd<F32X3>(gamma, T, B, D, M, X, w, wmb, ct, xbar, dgamma, st);
    case F32X2: return launch_bwd<F32X2>(gamma, T, B, D, M, X, w, wmb, ct, xbar, dgamma, st);
    case BF16: return launch_bwd<BF16>(gamma, T, B, D, M, X, w, wmb, ct, xbar, dgamma, st);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
