// Tensor-core decode and cotangent chain for the reduced precision rungs
// (f32x3, f32x2, bfloat16), for sm_90a (H100): warp-level
// mma.sync.aligned.m16n8k16 bf16 x bf16 -> fp32 through inline PTX, with
// the B operands read from shared memory by ldmatrix.
//
// Rung semantics are those of decode_common.cuh (_split_hi_lo / _prep_w /
// _mp_dot, vae_latent_geometry_tpu/ops/energy_pallas.py:178-224): operands
// split into bf16 hi/lo exactly as pack<R> does (RN of x, then RN of x - hi),
// every product bf16 x bf16 (exact in fp32), fp32 accumulation; only the
// order of the sums differs from the FMA kernels.  The tensor core truncates
// the sums it forms; with RN (the forward energies' decode: K1/K9 and
// K5/K7, tiles_mma.cuh) each k16 step sums its products apart and the steps
// are added by fp32 adds, so that an energy of adjacent-sample differences
// at M = 1 stays within 1e-5 of the plain version.
//   f32x3    : h_hi*W_hi + h_lo*W_hi + h_hi*W_lo   (three mma per k-step)
//   f32x2    : h_hi*W_hi + h_lo*W_hi               (two)
//   bfloat16 : h*W with W as shipped (bf16)        (one)
// Layer 1 (D -> 128) stays fp32 FMAs; the cotangent chain is single-pass
// bf16 at all three rungs (CHAIN_RUNG); the dgamma contraction with W1 is
// fp32.
//
// Tiling.  A block owns TP = 128 points and 8 warps; a warp owns 16 points
// x all 128 hidden units.  Every (points x units) tile -- h1, h2, dh2, dh1 --
// lives in registers in the C-fragment layout of m16n8: lane (g = lane/4,
// q = lane%4) holds rows g and g+8 and columns 8j + 2q + {0,1} of each n8
// tile j.  Two adjacent n8 C tiles, rounded to bf16 pairs, are exactly one
// k16 A fragment of the next product, so no activation goes through shared
// memory between layers, and each thread keeps its ReLU masks as 64 bits in
// two registers per layer (bit 4j + c of the C fragment's element c of tile
// j).  Layer 1 is computed straight into that layout.
//
// Shared memory holds one decoder's weights as bf16 planes W[k][n] (k the
// layer's input unit) with a row pad of 8 values (16 bytes), so that the 8
// row addresses of an ldmatrix phase fall in distinct banks: W2 (128 x 136)
// and W3 (128 x 72: n < 64 = XMAX, zero for n >= X), hi planes and, at
// f32x3, lo planes.  The forward products read B = W with ldmatrix.trans;
// the chain's products with W^T read the same planes without .trans.
// Layer 3's N is X padded to 8 (7 n8 tiles at X = 50); the chain's first
// product has K = X padded to 16 (4 k16 steps at X = 50), zeros beyond X.

#pragma once

#include "decode_common.cuh"

namespace {

constexpr int SW2 = H + 8;      // bf16 row stride of the W2 planes
constexpr int SW3 = XMAX + 8;   // bf16 row stride of the W3 planes
constexpr int NJ2 = H / 8;      // n8 tiles of a hidden layer (16)
constexpr int NJ3 = XMAX / 8;   // n8 tiles of the widest output (8)
constexpr int NK2 = H / 16;     // k16 steps over a hidden layer (8)
constexpr int NK3 = XMAX / 16;  // k16 steps over the widest output (4)

// One decoder's weights and the tile's points; a kernel's own struct derives
// from it.
struct MmaSmem {
  __nv_bfloat16 w2h[H * SW2], w2l[H * SW2];  // lo planes: f32x3 only
  __nv_bfloat16 w3h[H * SW3], w3l[H * SW3];
  float w1[DMAX * H];
  float g[TP * DMAX];   // the tile's curve points
  float dg[TP * DMAX];  // dgamma accumulators of the chain
  float b1[H], b2[H], b3[XMAX];
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// c += a (16x16, row) * b (16x8, col), bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// Two floats as a bf16 pair, the first in the low half (the lower column).
__device__ __forceinline__ uint32_t bf16x2(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Fragments
// ---------------------------------------------------------------------------

// The A fragments (k16 step j, register r) of a 16 x 8*NJ tile held as C
// fragments: step j covers n8 tiles 2j and 2j+1.  LO: the lo parts of the
// hi/lo split (pack<R>'s RN(x - RN(x))), else the hi parts.
template <bool LO, int NJ>
__device__ __forceinline__ void to_a(const float (&c)[NJ][4], uint32_t (&a)[NJ / 2][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v0 = c[j][2 * r], v1 = c[j][2 * r + 1];
      if constexpr (LO) {
        v0 = v0 - bf16r(v0);
        v1 = v1 - bf16r(v1);
      }
      a[j >> 1][(j & 1) * 2 + r] = bf16x2(v0, v1);
    }
}

__device__ __forceinline__ bool mask_bit(const uint32_t (&m)[2], int j, int c) {
  return (m[j >> 3] >> ((j & 7) * 4 + c)) & 1u;
}

// ---------------------------------------------------------------------------
// Warp products over one staged plane
// ---------------------------------------------------------------------------

// acc[j] += A (16 x 128) @ W[:, 8j : 8j+8] for n8 tiles j < nj (nj <= NJ,
// uniform across the warp); W = plane wh (+ wl at f32x3) [k][n] of row
// stride ws.  f32x2/f32x3 add the lo A fragments al against the same B.
template <int R, int NJ, bool RN = false>
__device__ __forceinline__ void gemm_fwd(float (&acc)[NJ][4], const uint32_t (&ah)[NK2][4],
                                         const uint32_t (&al)[NK2][4],
                                         const __nv_bfloat16* wh, const __nv_bfloat16* wl,
                                         int ws, int nj) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans row addresses: matrices (k0, n0), (k0+8, n0),
  // (k0, n0+8), (k0+8, n0+8) -> b0, b1 of tile n0/8, b0, b1 of the next
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  if constexpr (RN) {
    static_assert(NJ % 2 == 0, "n8 tiles in pairs");
    // each k16 step's products (all passes) in a fresh accumulator, added to
    // acc by an fp32 add: the tensor core truncates the sums it forms, so
    // it forms only the step's own, and acc is rounded to nearest
#pragma unroll
    for (int kk = 0; kk < NK2; ++kk) {
#pragma unroll
      for (int j = 0; j < NJ; j += 2) {
        if (j >= nj) continue;
        const int off = (16 * kk + lrow) * ws + 8 * j + lcol;
        uint32_t b[4];
        ldsm_x4<true>(b, wh + off);  // tile j + 1 >= nj reads zero columns
        // t = +-0 computed from acc: the step waits for the previous one, as
        // the accumulating mma does, so its accumulators are not all live
        float t[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) t[i][c] = __fmul_rn(acc[j + i][c], 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(t[i], ah[kk], b[2 * i], b[2 * i + 1]);
          if constexpr (R == F32X2 || R == F32X3) mma_bf16(t[i], al[kk], b[2 * i], b[2 * i + 1]);
        }
        if constexpr (R == F32X3) {
          ldsm_x4<true>(b, wl + off);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_bf16(t[i], ah[kk], b[2 * i], b[2 * i + 1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[j + i][c] = acc[j + i][c] + t[i][c];
      }
    }
    return;
  }
#pragma unroll
  for (int kk = 0; kk < NK2; ++kk) {
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      if (j >= nj) continue;
      const int off = (16 * kk + lrow) * ws + 8 * j + lcol;
      if (j + 1 < nj) {
        uint32_t b[4];
        ldsm_x4<true>(b, wh + off);
        mma_bf16(acc[j], ah[kk], b[0], b[1]);
        mma_bf16(acc[j + 1], ah[kk], b[2], b[3]);
        if constexpr (R == F32X2 || R == F32X3) {
          mma_bf16(acc[j], al[kk], b[0], b[1]);
          mma_bf16(acc[j + 1], al[kk], b[2], b[3]);
        }
        if constexpr (R == F32X3) {
          ldsm_x4<true>(b, wl + off);
          mma_bf16(acc[j], ah[kk], b[0], b[1]);
          mma_bf16(acc[j + 1], ah[kk], b[2], b[3]);
        }
      } else {  // an odd last tile
        uint32_t b[2];
        ldsm_x2_trans(b, wh + off);
        mma_bf16(acc[j], ah[kk], b[0], b[1]);
        if constexpr (R == F32X2 || R == F32X3) mma_bf16(acc[j], al[kk], b[0], b[1]);
        if constexpr (R == F32X3) {
          ldsm_x2_trans(b, wl + off);
          mma_bf16(acc[j], ah[kk], b[0], b[1]);
        }
      }
    }
  }
}

// acc[j] += A (16 x 16*nk) @ W^T[:, 8j : 8j+8] for all 16 n8 tiles, single
// pass bf16; W = plane w [n][k] of row stride ws (the forward layout, read
// without .trans), k16 steps kk < nk (nk <= NK, uniform across the warp).
template <int NK>
__device__ __forceinline__ void gemm_wt(float (&acc)[NJ2][4], const uint32_t (&a)[NK][4],
                                        const __nv_bfloat16* w, int ws, int nk) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 row addresses: matrices (n0, k0), (n0, k0+8), (n0+8, k0),
  // (n0+8, k0+8) -> b0, b1 of tile n0/8, b0, b1 of the next
  const int lrow = (lane & 7) + (lane >> 4) * 8, lcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    if (kk >= nk) continue;
#pragma unroll
    for (int j = 0; j < NJ2; j += 2) {
      uint32_t b[4];
      ldsm_x4<false>(b, w + (8 * j + lrow) * ws + 16 * kk + lcol);
      mma_bf16(acc[j], a[kk], b[0], b[1]);
      mma_bf16(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Staging, decode, chain
// ---------------------------------------------------------------------------

// Zero the W3 planes: columns >= X stay zero for the whole launch.
__device__ void zero_w3_planes(MmaSmem& s) {
  uint32_t* p = reinterpret_cast<uint32_t*>(s.w3h);
  for (int e = threadIdx.x; e < H * SW3; e += NT) p[e] = 0u;  // w3h and w3l
}

__device__ __forceinline__ void put_hi_lo(__nv_bfloat16* hi, __nv_bfloat16* lo, int i, float x,
                                          bool with_lo) {
  const __nv_bfloat16 h = __float2bfloat16_rn(x);
  hi[i] = h;
  if (with_lo) lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
}

// Stage decoder m's weights: W2, W3 as bf16 planes (lo planes at f32x3),
// W1 and the biases as fp32.
template <int R>
__device__ void stage_weights_mma(MmaSmem& s, int m, int D, int X, const Weights& w) {
  constexpr bool LO = R == F32X3;
  const int tid = threadIdx.x;
  const float* w2 = w.W2 + (size_t)m * H * H;
  if ((reinterpret_cast<uintptr_t>(w2) & 15) == 0) {
    const float4* w2v = reinterpret_cast<const float4*>(w2);
    for (int e = tid; e < H * H / 4; e += NT) {
      const float4 v = w2v[e];
      const int i = (e / (H / 4)) * SW2 + (e % (H / 4)) * 4;
      put_hi_lo(s.w2h, s.w2l, i, v.x, LO);
      put_hi_lo(s.w2h, s.w2l, i + 1, v.y, LO);
      put_hi_lo(s.w2h, s.w2l, i + 2, v.z, LO);
      put_hi_lo(s.w2h, s.w2l, i + 3, v.w, LO);
    }
  } else {
    for (int e = tid; e < H * H; e += NT)
      put_hi_lo(s.w2h, s.w2l, (e / H) * SW2 + e % H, w2[e], LO);
  }
  const float* w3 = w.W3 + (size_t)m * H * X;
  for (int e = tid; e < H * X; e += NT)
    put_hi_lo(s.w3h, s.w3l, (e / X) * SW3 + e % X, w3[e], LO);
  for (int e = tid; e < DMAX * H; e += NT)
    s.w1[e] = e < D * H ? w.W1[(size_t)m * D * H + e] : 0.f;
  for (int e = tid; e < H; e += NT) {
    s.b1[e] = w.b1[(size_t)m * H + e];
    s.b2[e] = w.b2[(size_t)m * H + e];
  }
  for (int e = tid; e < XMAX; e += NT) s.b3[e] = e < X ? w.b3[(size_t)m * X + e] : 0.f;
}

// Decode the warp's 16 points (rows g and g+8 of the tile's 16-row slice)
// through the staged decoder at rung R.  x[j][c]: output column 8j + 2q +
// (c & 1) of row g + 8 (c >> 1), zero for columns >= X; m1/m2: the ReLU masks
// of the hidden layers in the C-fragment layout (mask_bit).
template <int R, bool RN = false>
__device__ void decode_mma(const MmaSmem& s, int D, int X, float (&x)[NJ3][4],
                           uint32_t (&m1)[2], uint32_t (&m2)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int p = warp * 16 + gq;  // rows p and p + 8 of the tile
  m1[0] = m1[1] = m2[0] = m2[1] = 0u;
  float h[NJ2][4];
  // layer 1, fp32 FMAs, straight into the C layout
  float gp[2][DMAX];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < DMAX; ++d) gp[r][d] = s.g[(p + 8 * r) * DMAX + d];
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int u = 8 * j + 2 * q + (c & 1);
      float v = s.b1[u];
#pragma unroll
      for (int d = 0; d < DMAX; ++d)
        if (d < D) {
          if constexpr (RN)  // the plain version's multiply, then add
            v = __fadd_rn(v, __fmul_rn(gp[c >> 1][d], s.w1[d * H + u]));
          else
            v = v + gp[c >> 1][d] * s.w1[d * H + u];
        }
      v = fmaxf(v, 0.f);
      if (v > 0.f) m1[j >> 3] |= 1u << ((j & 7) * 4 + c);
      h[j][c] = v;
    }
  uint32_t ah[NK2][4], al[NK2][4];
  to_a<false>(h, ah);
  if constexpr (R != BF16) to_a<true>(h, al);
  // layer 2
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) h[j][c] = 0.f;
  gemm_fwd<R, NJ2, RN>(h, ah, al, s.w2h, s.w2l, SW2, NJ2);
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = fmaxf(h[j][c] + s.b2[8 * j + 2 * q + (c & 1)], 0.f);
      if (v > 0.f) m2[j >> 3] |= 1u << ((j & 7) * 4 + c);
      h[j][c] = v;
    }
  to_a<false>(h, ah);
  if constexpr (R != BF16) to_a<true>(h, al);
  // layer 3
  const int nj = (X + 7) / 8;
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] = 0.f;
  gemm_fwd<R, NJ3, RN>(x, ah, al, s.w3h, s.w3l, SW3, nj);
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[j][c] = x[j][c] + s.b3[8 * j + 2 * q + (c & 1)];
}

// The masked cotangent chain of the staged decoder, single-pass bf16: dx
// holds the output cotangent as A fragments (k16 steps over the output
// features, zero for features >= X), m1/m2 the masks of the same decode.
// Adds the decoder's dgamma of the warp's rows to s.dg.
__device__ void chain_mma(MmaSmem& s, int D, int X, const uint32_t (&dx)[NK3][4],
                          const uint32_t (&m1)[2], const uint32_t (&m2)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int p = warp * 16 + gq;
  float acc[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  gemm_wt<NK3>(acc, dx, s.w3h, SW3, (X + 15) / 16);  // dh2 = dx @ W3^T
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = mask_bit(m2, j, c) ? acc[j][c] : 0.f;
  uint32_t a[NK2][4];
  to_a<false>(acc, a);
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  gemm_wt<NK2>(acc, a, s.w2h, SW2, NK2);  // dh1 = dh2 @ W2^T
  // dgamma[p][d] += sum_u [h1 > 0] dh1[p][u] W1[d][u]: the quad's four
  // lanes hold the row's 128 units
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int d = 0; d < D; ++d) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c)
          if (mask_bit(m1, j, c)) v += acc[j][c] * s.w1[d * H + 8 * j + 2 * q + (c & 1)];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (q == 0) s.dg[(p + 8 * r) * DMAX + d] += v;
    }
}

// Load the tile's points p0..p0+127 of the flattened (T*B) curve (clamped).
__device__ void load_points_mma(MmaSmem& s, const float* __restrict__ gamma, int N, int D,
                                int p0) {
  for (int e = threadIdx.x; e < TP * DMAX; e += NT) {
    const int p = e / DMAX, d = e % DMAX;
    s.g[e] = d < D ? gamma[(size_t)min(p0 + p, N - 1) * D + d] : 0.f;
  }
}

}  // namespace
