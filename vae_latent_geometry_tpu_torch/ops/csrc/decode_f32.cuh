// The float32 decode of the forward energies (K1's k1_fwd_fma in
// energy_expected.cu, K5/K7's mc_fwd_fma in energy_mc.cu), for sm_90a (H100):
// chunks of up to 32 * NP curve points through one ReLU MLP decoder D -> 128
// -> 128 -> X <= 64 on the CUDA cores (FMAs only: TF32 would round the inputs
// at 2^-11, which the numerics gate bars, so no tensor-core instruction here).
// K1 decodes chunks of 128 points (NP = 4), K5/K7 lists of points in chunks
// of 64 (NP = 2: a smaller activation tile leaves room for the differences).
//
// What bounds it: the FP32 FMA rate (67 TFLOP/s on an H100 SXM): one decode
// is 2*D*128 + 2*128*128 + 2*128*X FLOP and reads nothing but the point and
// the decoder's 90 KB of weights.  What the design does about it:
//   - weights are staged asynchronously (cp.async, 16 bytes a copy) so that
//     the multiplies never wait for them: W2 in two halves of 64 rows, W3
//     (from a copy padded to 64 columns that the launcher makes once a
//     call), and W1/biases in one of two slots.  Once a chunk that is its
//     decoder's last has read a buffer, the NEXT decoder's copy of it goes in
//     flight (W2's first half and the small weights after the first half of
//     the layer-2 product, its second half after the product, W3 after layer
//     3); each lands during roughly a chunk's worth of products.  Rows are
//     unpadded: the forward products read W row-wise, 16 bytes a lane,
//     conflict-free.
//   - every operand read is a 16-byte vector: in layer 2 a lane owns 8
//     points x 4 NP/2 units (2 activation and NP/2 weight LDS.128 per 16 NP
//     FMAs), in layer 3 2 NP points x 4 features; layer 1 and the layer-2
//     epilogue write 4 activations at a time.
//   - warp w owns points 32 (w / (8 / NP)) .. + 31 and the (w % (8 / NP))-th
//     share of the columns: a chunk with fewer points skips whole warps (the
//     MC kernels decode lists of points).
// Each output is ONE fmaf chain over k = 0..127 from 0 in order, then the
// bias, exactly as decode_common.cuh's decode_tile<F32>: every decoded value
// equals the older kernels' bit for bit; only the energies' sums change
// order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_any.cuh"
#include "decode_common.cuh"

namespace {

constexpr int F_HALF = H * H / 2;             // floats of one W2 half
constexpr int F_W1 = 0, F_B1 = DMAX * H, F_B2 = F_B1 + H, F_B3 = F_B2 + H;
constexpr int F_SMALL = F_B3 + XMAX;          // w1 | b1 | b2 | b3
constexpr int SMEM_MAX = 232448;              // a block's shared memory (227 KB)

template <int NP>
struct F32Smem {
  static constexpr int FC = 32 * NP;          // points per chunk
  static constexpr int SA = FC + 4;           // activation row stride (floats)
  float w2[H * H];            // W2[k][n]
  float w3[H * XMAX];         // W3[k][n], n >= X zero
  float act[H * SA];          // the chunk's h1, then h2: [unit][point]
  float small[2][F_SMALL];    // two decoders' w1 and biases
};

__device__ __forceinline__ uint32_t f32_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(f32_smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(f32_smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n contiguous floats (n % 4 == 0, both ends 16-byte aligned).
__device__ __forceinline__ void cp_block16(float* dst, const float* src, int n) {
  for (int e = 4 * threadIdx.x; e < n; e += 4 * NT) cp_async16(dst + e, src + e);
}

// W3 padded to XMAX columns (zero beyond X): the f32 kernels' copy of it.
__global__ void f32_pad_w3(const float* __restrict__ W3, int MH, int X, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= MH * XMAX) return;
  const int n = e % XMAX;
  out[e] = n < X ? W3[(size_t)(e / XMAX) * X + n] : 0.f;
}

// The decoder's weights as the kernels read them: W3 from the padded copy.
struct F32Weights {
  Weights w;
  const float* W3p;  // (M, 128, XMAX)
};

template <int NP>
__device__ __forceinline__ void f32_issue_w2(F32Smem<NP>& s, const float* W2, int m, int half) {
  cp_block16(s.w2 + half * F_HALF, W2 + (size_t)m * H * H + half * F_HALF, F_HALF);
}

template <int NP>
__device__ __forceinline__ void f32_issue_small(F32Smem<NP>& s, const Weights& w, int m, int D,
                                                int X, int slot) {
  float* d = s.small[slot];
  cp_block16(d + F_W1, w.W1 + (size_t)m * D * H, D * H);
  cp_block16(d + F_B1, w.b1 + (size_t)m * H, H);
  cp_block16(d + F_B2, w.b2 + (size_t)m * H, H);
  for (int e = threadIdx.x; e < X; e += NT) cp_async4(d + F_B3 + e, w.b3 + (size_t)m * X + e);
}

template <int NP>
__device__ __forceinline__ void f32_issue_w3(F32Smem<NP>& s, const float* W3p, int m) {
  cp_block16(s.w3, W3p + (size_t)m * H * XMAX, H * XMAX);
}

// What no copy writes: b3's columns >= X.
template <int NP>
__device__ __forceinline__ void f32_zero_pads(F32Smem<NP>& s, int X) {
  for (int e = threadIdx.x; e < 2 * XMAX; e += NT)
    if (e % XMAX >= X) s.small[e / XMAX][F_B3 + e % XMAX] = 0.f;
}

// Decoder m's weights in flight, as three commit groups (W2 half 0 with the
// small weights in slot 0, W2 half 1, W3), as a chunk that is the previous
// decoder's last would issue them.  The caller then waits for the first
// group (cp_wait<2>) and passes a barrier before the first chunk.
template <int NP>
__device__ __forceinline__ void f32_prologue(F32Smem<NP>& s, const F32Weights& fw, int m, int D,
                                             int X) {
  f32_issue_w2(s, fw.w.W2, m, 0);
  f32_issue_small(s, fw.w, m, D, X, 0);
  cp_commit();
  f32_issue_w2(s, fw.w.W2, m, 1);
  cp_commit();
  f32_issue_w3(s, fw.W3p, m);
  cp_commit();
}

// The lanes' tiles.  Warp w: points 32 wp .. 32 wp + 31, wp = w / (8 / NP),
// and column share wc = w % (8 / NP).  Layer 2: 8 points x 4 NP/2 units,
// lanes 4 point groups x 8 column quads (quad q: units 16 NP wc + 4 q + 32
// jj, jj < NP/2).  Layer 3: PL3 = 2 NP points x 4 features, lanes 32 / QL3
// point groups x QL3 = 2 NP column quads (features 8 NP wc + 4 q).
template <int NP>
struct F32Lane {
  static constexpr int PL3 = 2 * NP, QL3 = 2 * NP;
  static __device__ __forceinline__ int wp() { return (threadIdx.x >> 5) / (8 / NP); }
  static __device__ __forceinline__ int wc() { return (threadIdx.x >> 5) % (8 / NP); }
  static __device__ __forceinline__ int p2() { return 32 * wp() + 8 * ((threadIdx.x & 31) >> 3); }
  static __device__ __forceinline__ int n2() { return 16 * NP * wc() + 4 * (threadIdx.x & 7); }
  static __device__ __forceinline__ int p3() {
    return 32 * wp() + PL3 * ((threadIdx.x & 31) / QL3);
  }
  static __device__ __forceinline__ int n3() {
    return 8 * NP * wc() + 4 * ((threadIdx.x & 31) % QL3);
  }
  static __device__ __forceinline__ bool live(int n_c) { return 32 * wp() < n_c; }
};

// acc[i][4 jj + j] += sum_{k in [K0, K0+64)} h1[p + i][k] W2[k][n + 32 jj + j],
// k in order.
template <int NP, int K0>
__device__ __forceinline__ void f32_gemm2(const F32Smem<NP>& s, int p, int n,
                                          float (&acc)[8][2 * NP]) {
  constexpr int NQ = NP / 2, SA = F32Smem<NP>::SA;
  const float* a = s.act + p;
  const float* w = s.w2 + n;
#pragma unroll 8
  for (int k = K0; k < K0 + H / 2; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a + k * SA);
    const float4 a1 = *reinterpret_cast<const float4*>(a + k * SA + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float wj[4 * NQ];
#pragma unroll
    for (int jj = 0; jj < NQ; ++jj) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k * H + 32 * jj);
      wj[4 * jj] = wv.x;
      wj[4 * jj + 1] = wv.y;
      wj[4 * jj + 2] = wv.z;
      wj[4 * jj + 3] = wv.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * NQ; ++j) acc[i][j] = fmaf(av[i], wj[j], acc[i][j]);
  }
}

// acc[i][j] = sum_k h2[p + i][k] W3[k][n + j], k = 0..127 in order.
template <int NP>
__device__ __forceinline__ void f32_gemm3(const F32Smem<NP>& s, int p, int n,
                                          float (&acc)[2 * NP][4]) {
  constexpr int SA = F32Smem<NP>::SA;
  const float* a = s.act + p;
  const float* w = s.w3 + n;
#pragma unroll 8
  for (int k = 0; k < H; ++k) {
    float av[2 * NP];
#pragma unroll
    for (int v = 0; v < NP / 2; ++v) {
      const float4 a4 = *reinterpret_cast<const float4*>(a + k * SA + 4 * v);
      av[4 * v] = a4.x;
      av[4 * v + 1] = a4.y;
      av[4 * v + 2] = a4.z;
      av[4 * v + 3] = a4.w;
    }
    const float4 wv = *reinterpret_cast<const float4*>(w + k * XMAX);
    const float wj[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wj[j], acc[i][j]);
  }
}

struct NoMid {
  __device__ void before() {}
  __device__ void after() {}
};

// Decode n_c <= FC points with the staged decoder whose small weights sit in
// `slot`: point c is row rows[c] of the tile's points g (DMAX floats a row,
// 16-byte aligned), or row r0 + c when rows == nullptr.  On return x holds
// the lane's layer-3 tile (F32Lane<NP>::p3, n3) where F32Lane<NP>::live(n_c),
// and every thread has passed a barrier after the last read of act and of
// the weights.  next >= 0: this chunk is its decoder's last, and decoder
// `next`'s weights go in flight into the buffers as they free (small weights
// into slot ^ 1).  Every chunk commits three groups, empty or not, so the
// waits count alike: before the chunk the caller has waited for the
// previous chunk's first group.  mid.before() / mid.after() run on either
// side of the barrier in the middle of the layer-2 product (the MC kernel
// builds its next list there).
template <int NP, class Mid>
__device__ __forceinline__ void f32_decode_chunk(F32Smem<NP>& s, const F32Weights& fw,
                                                 const float* g, const int* rows, int r0, int n_c,
                                                 int D, int X, int slot, int next, Mid& mid,
                                                 float (&x)[2 * NP][4]) {
  using L = F32Lane<NP>;
  constexpr int FC = F32Smem<NP>::FC, SA = F32Smem<NP>::SA;
  const int tid = threadIdx.x;
  const bool live = L::live(n_c);
  const float* sm = s.small[slot];
  // layer 1: unit k = tid % 128 for FC / 2 points, 4 at a time
  {
    const int k = tid & (H - 1), c0 = (tid >> 7) * (FC / 2);
    float w1k[DMAX];
#pragma unroll
    for (int d = 0; d < DMAX; ++d) w1k[d] = d < D ? sm[F_W1 + d * H + k] : 0.f;
    const float b1k = sm[F_B1 + k];
#pragma unroll 2
    for (int v = 0; v < FC / 2; v += 4) {
      const int c = c0 + v;
      if (c >= n_c) break;
      float hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int cc = min(c + u, n_c - 1);
        const float4 gp =
            *reinterpret_cast<const float4*>(g + (rows ? rows[cc] : r0 + cc) * DMAX);
        const float gd[DMAX] = {gp.x, gp.y, gp.z, gp.w};
        float h = b1k;
#pragma unroll
        for (int d = 0; d < DMAX; ++d)
          if (d < D) h = h + gd[d] * w1k[d];
        hv[u] = fmaxf(h, 0.f);
      }
      *reinterpret_cast<float4*>(s.act + k * SA + c) = make_float4(hv[0], hv[1], hv[2], hv[3]);
    }
  }
  __syncthreads();
  // layer 2: the lane's 8 points x 2 NP units
  const int p2 = L::p2(), n2 = L::n2();
  float acc[8][2 * NP];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) acc[i][j] = 0.f;
  if (live) f32_gemm2<NP, 0>(s, p2, n2, acc);
  mid.before();
  cp_wait<1>();  // this decoder's W2 half 1
  __syncthreads();
  mid.after();
  if (next >= 0) {
    f32_issue_w2(s, fw.w.W2, next, 0);
    f32_issue_small(s, fw.w, next, D, X, slot ^ 1);
  }
  cp_commit();
  if (live) f32_gemm2<NP, H / 2>(s, p2, n2, acc);
  __syncthreads();
  if (next >= 0) f32_issue_w2(s, fw.w.W2, next, 1);
  cp_commit();
  if (live) {
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) {
      const int n = n2 + 32 * (j / 4) + j % 4;
      const float bj = sm[F_B2 + n];
      float hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = fmaxf(acc[i][j] + bj, 0.f);
      float* dst = s.act + n * SA + p2;
      *reinterpret_cast<float4*>(dst) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(hv[4], hv[5], hv[6], hv[7]);
    }
  }
  cp_wait<2>();  // this decoder's W3
  __syncthreads();
  // layer 3: the lane's 2 NP points x 4 features
  const int p3 = L::p3(), n3 = L::n3();
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.f;
  if (live) {
    f32_gemm3(s, p3, n3, x);
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[i][j] = x[i][j] + sm[F_B3 + n3 + j];
  }
  cp_wait<1>();  // the next chunk's W2 half 0 and small weights
  __syncthreads();
  if (next >= 0) f32_issue_w3(s, fw.W3p, next);
  cp_commit();
}

// The launchers' part: pad W3 into `w3p` (M * 128 * XMAX floats) on the
// stream; the f32 kernels stage it in 16-byte copies.
inline cudaError_t f32_prepare_w3(const float* W3, int M, int X, float* w3p, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(w3p) % 16 != 0) return cudaErrorMisalignedAddress;
  const int n = M * H * XMAX;
  f32_pad_w3<<<(n + 255) / 256, 256, 0, st>>>(W3, M * H, X, w3p);
  return cudaGetLastError();
}

// Whether W1, b1, W2 and b2 can be staged in 16-byte copies (their
// per-decoder blocks are multiples of 16 bytes).
inline bool f32_aligned(const Weights& w) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(w.W1) | reinterpret_cast<uintptr_t>(w.b1) |
                        reinterpret_cast<uintptr_t>(w.W2) | reinterpret_cast<uintptr_t>(w.b2);
  return any % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of the scratch that the forward entry point needs at this rung and
// decoder for the f32 kernels' padded W3 (M x 128 x 64); 0 where they do not
// run (then the generic decode's scratch, vlg_any_scratch_words, applies).
int vlg_f32_scratch_words(int rung, int M, int L, const int* widths) {
  Decoder d;
  if (!make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  return rung == F32 && fixed_shape(d) ? M * H * XMAX : 0;
}

}  // extern "C"
