// Shared device code of the energy kernels (energy_expected.cu,
// energy_mc.cu), for sm_90a (H100): the register-tiled decode of one tile of
// 128 curve points through one ReLU MLP decoder D -> 128 -> 128 -> X, and the
// ReLU-masked cotangent chain back through the same decoder.
//
// Precision rungs (template R) reproduce _split_hi_lo / _prep_w / _mp_dot
// (vae_latent_geometry_tpu/ops/energy_pallas.py:178-224): operands are
// rounded to bf16 hi/lo with __float2bfloat16_rn, every partial product is an
// fp32 FMA (the product of two bf16 values is exact in fp32) and accumulation
// is fp32:
//   float32  : exact fp32 products
//   f32x3    : h_hi*w_hi + h_lo*w_hi + h_hi*w_lo
//   f32x2    : h_hi*w_hi + h_lo*w_hi
//   bfloat16 : h_hi*w_hi (the wrapper ships W1..W3 rounded to bf16)
// The first layer is always fp32 FMAs; the cotangent chain runs at bf16
// under f32x3/f32x2 and at the rung itself otherwise (_backprop_chain_masked).
//
// An SM has 227 KB of shared memory, so a block loops over decoders and
// stages ONE decoder's W2 (64 KB) and W3 (25.6 KB) at a time, already split
// into packed (hi, lo) bf16 words.  A block owns a tile of 128 points and 256
// threads; each thread owns 8 points x 8 (layer 2, chain) or 8 x 4 (layer 3)
// outputs of a register-tiled GEMM over the shared-memory activation tile,
// with its ReLU masks kept as bits in registers.  Matrix products use
// CUDA-core FMAs, not tensor cores.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int H = 128;          // hidden width of both hidden layers
constexpr int XMAX = 64;        // widest supported output
constexpr int DMAX = 4;         // widest supported latent
constexpr int TP = 128;         // points per tile
constexpr int NT = 256;         // threads per block
constexpr int S_ACT = TP + 4;   // activation tile row stride (words)
constexpr int S_W2 = H + 1;     // odd strides: conflict-free row and column reads
constexpr int S_W3 = XMAX + 1;

enum Rung { F32 = 0, F32X3 = 1, F32X2 = 2, BF16 = 3 };

// The chain's rung for a decode at rung R.
template <int R>
constexpr int CHAIN_RUNG = (R == F32X2 || R == F32X3) ? BF16 : R;

// What decode and chain keep in shared memory; a kernel's own struct derives
// from it (act stays first: its rows are read as 16-byte vectors).
struct DecodeSmem {
  uint32_t act[H * S_ACT];  // activation tile [k][p], packed for the rung
  uint32_t w2[H * S_W2];    // W2[k][n] packed
  uint32_t w3[H * S_W3];    // W3[k][n] packed, n >= X zero
  float w1[DMAX * H];
  float g[TP * DMAX];       // the tile's curve points
  float dg[TP * DMAX];      // dgamma accumulators of the chain
  float b1[H], b2[H], b3[XMAX];
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
// U: the k loop's unroll factor.
template <int R, int NJ, bool TRANS, int U = 2>
__device__ __forceinline__ void gemm(const uint32_t* act, const uint32_t* w, int ws,
                                     int kdim, float (&acc)[8][NJ]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll U
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

struct Weights {
  const float *W1, *b1, *W2, *b2, *W3, *b3;
};

// Stage decoder m's weights into shared memory, packed for rung R.
template <int R>
__device__ void stage_weights(DecodeSmem& s, int m, int D, int X, const Weights& w) {
  const int tid = threadIdx.x;
  const float* w2 = w.W2 + (size_t)m * H * H;
  for (int e = tid; e < H * H; e += NT) s.w2[(e / H) * S_W2 + e % H] = pack<R>(w2[e]);
  const float* w3 = w.W3 + (size_t)m * H * X;
  for (int e = tid; e < H * XMAX; e += NT) {
    const int k = e / XMAX, n = e % XMAX;
    s.w3[k * S_W3 + n] = n < X ? pack<R>(w3[k * X + n]) : 0u;
  }
  for (int e = tid; e < DMAX * H; e += NT)
    s.w1[e] = e < D * H ? w.W1[(size_t)m * D * H + e] : 0.f;
  for (int e = tid; e < H; e += NT) {
    s.b1[e] = w.b1[(size_t)m * H + e];
    s.b2[e] = w.b2[(size_t)m * H + e];
  }
  for (int e = tid; e < XMAX; e += NT) s.b3[e] = e < X ? w.b3[(size_t)m * X + e] : 0.f;
}

// Decode the tile's points (s.g) with the staged decoder.  x[i][j] is the
// output at point ty*8+i, feature tx+16j (zero for features >= X); m1/m2
// hold the ReLU masks of the two hidden layers at (point ty*8+i, unit
// tx+16j) as bit i*8+j.
template <int R>
__device__ void decode_tile(DecodeSmem& s, int D, float (&x)[8][4], uint32_t (&m1)[2],
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

// The masked cotangent chain of the staged decoder at rung C.  On entry
// s.act[n][p] holds the packed output cotangent dx (features n < X) and every
// thread has passed a __syncthreads() since writing it; m1/m2 are the masks
// of this tile's decode.  Adds the decoder's dgamma to s.dg.
template <int C>
__device__ void chain_tile(DecodeSmem& s, int D, int X, const uint32_t (&m1)[2],
                           const uint32_t (&m2)[2]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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

// Load the tile's points into the decode policy P's storage (P::gstride(D)
// floats a point): point p is row row(p) of the flattened (T*B, D) curve.
template <class P, class S, class F>
__device__ __forceinline__ void load_points_by(S& s, const typename P::Ctx& c,
                                               const float* __restrict__ gamma, int D, F&& row) {
  float* g = P::points(s, c, D);
  const int gs = P::gstride(D);
  for (int e = threadIdx.x; e < TP * gs; e += NT) {
    const int p = e / gs, d = e % gs;
    g[e] = d < D ? gamma[row(p) * D + d] : 0.f;
  }
}

// Load the tile's points p0..p0+127 of the flattened (T*B) curve.
template <class P, class S>
__device__ void load_points(S& s, const typename P::Ctx& c, const float* __restrict__ gamma,
                            int N, int D, int p0) {
  load_points_by<P>(s, c, gamma, D, [&](int p) { return (size_t)min(p0 + p, N - 1); });
}

// Zero the chain's dgamma accumulators.
template <class P, class S>
__device__ void zero_dgamma(S& s, const typename P::Ctx& c, int D) {
  float* dg = P::dgs(s, c, D);
  for (int e = threadIdx.x; e < TP * P::gstride(D); e += NT) dg[e] = 0.f;
}

// Write the chain's dgamma accumulators of the tile's points to (T*B, D).
template <class P, class S>
__device__ void store_dgamma(S& s, const typename P::Ctx& c, float* __restrict__ dgamma, int N,
                             int D, int p0) {
  const float* dg = P::dgs(s, c, D);
  const int gs = P::gstride(D);
  for (int e = threadIdx.x; e < TP * D; e += NT) {
    const int p = e / D, d = e % D, pg = p0 + p;
    if (pg < N) dgamma[(size_t)pg * D + d] = dg[p * gs + d];
  }
}

// The fixed decoder D -> 128 -> 128 -> X <= 64 as a decode policy of the
// kernel bodies (AnyDecode in decode_any.cuh is the other), at float32
// only: weights staged per decoder, 4 output columns a thread, masks in
// registers.  Its kernels at the reduced rungs run on the tensor cores.
struct FixedDecode {
  static constexpr int NJX = 4;      // output columns a thread: tx + 16 j
  static constexpr int XM = XMAX;
  static constexpr int SLOTS = 2;    // MC samples per decode sweep
  using Smem = DecodeSmem;
  struct Ctx {
    Weights w;
  };
  struct Masks {
    uint32_t m1[2], m2[2];
  };
  __device__ static void use_area(Masks&, int) {}
  template <int R>
  __device__ static void decode(Smem& s, const Ctx& c, int m, int D, int X, float (&x)[8][NJX],
                                Masks& mk) {
    static_assert(R == F32, "the reduced rungs decode on the tensor cores (decode_mma.cuh)");
    __syncthreads();
    stage_weights<R>(s, m, D, X, c.w);
    __syncthreads();
    decode_tile<R>(s, D, x, mk.m1, mk.m2);
  }
  template <int C>
  __device__ static void chain(Smem& s, const Ctx&, int, int D, int X, const Masks& mk) {
    chain_tile<C>(s, D, X, mk.m1, mk.m2);
  }
  // stage decoder m again for a chain that follows other decoders' decodes
  template <int R>
  __device__ static void restage(Smem& s, const Ctx& c, int m, int D, int X) {
    __syncthreads();
    stage_weights<R>(s, m, D, X, c.w);
  }
  // element (i, j) of a running tile: in registers
  template <int NJ>
  __device__ static float& tile(float (&r)[8][NJ], const Ctx&, int i, int j) {
    return r[i][j];
  }
  // the tile's points and dgamma accumulators (D <= DMAX), DMAX floats a point
  template <class S>
  __device__ static float* points(S& s, const Ctx&, int) { return s.g; }
  template <class S>
  __device__ static float* dgs(S& s, const Ctx&, int) { return s.dg; }
  __device__ static constexpr int gstride(int) { return DMAX; }
};

// f(std::integral_constant<int, R>) for the rung R named at run time.
template <class F>
cudaError_t by_rung(int rung, F&& f) {
  switch (rung) {
    case F32: return f(std::integral_constant<int, F32>{});
    case F32X3: return f(std::integral_constant<int, F32X3>{});
    case F32X2: return f(std::integral_constant<int, F32X2>{});
    case BF16: return f(std::integral_constant<int, BF16>{});
  }
  return cudaErrorInvalidValue;
}

// Allow a kernel its struct's worth of dynamic shared memory.
template <typename SM, typename K>
cudaError_t prepare(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(SM));
}

}  // namespace
