// Expected ensemble curve energy and its gradient, for sm_90a (H100).
//
// Replaces the Pallas TPU kernels of vae_latent_geometry_tpu/ops/energy_pallas.py:
//   K1  _fwd_kernel (:254)  -> k1_fwd_fma (float32) or k1_tiles_mma
//       (f32x3, f32x2, bfloat16; tiles_mma.cuh), + k1_sum_tiles
//   K2  _bwd_kernel (:325)  -> k2_prep_planes + k2_onepass_mma (f32x3, f32x2,
//       bfloat16; onepass_mma.cuh), k2_xbar + k2_chain (float32)
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
// The FMA decode, the cotangent chain and the precision rungs are shared
// with the Monte-Carlo kernels (decode_common.cuh); the tensor-core decode
// and chain are in decode_mma.cuh; K1's float32 decode (staged
// asynchronously, vector operands; also K5/K7's) is in decode_f32.cuh.
//
// Work (counted from the code, per point per decoder): the float32 decode is
// 2*D*128 + 2*128*128 + 2*128*X = 46 kFLOP at D=2, X=50, i.e. 1.8e11 FLOP
// per K1 call at T=2000, B=200, M=10.  K2's function at f32x2, counting the
// decode's two passes and the single-pass chain, is about 138 kFLOP, i.e.
// 5.5e11 FLOP per step: 0.557 ms at the 989 TFLOP/s of the bf16 tensor
// cores; counting each decode and chain once (the benchmark's count), 3.69e11
// FLOP, 0.373 ms.  Both kernels move a few MB of inputs and outputs, so both
// are bound by operations, not bytes, on this card.
//
// Design for Hopper.  The TPU kernel keeps all M decoders' weights resident
// in VMEM; here a block loops over decoders and stages one at a time.
// Running statistics live in registers (K1 ybar, sqy) and shared memory (K1
// x0).  Blocks run in no order, so K1's tile of 32 t-rows x 4 splines
// recomputes its halo row instead of carrying it (31 owned segments per 32
// decoded rows), writes per-tile partial energies to an (n_tiles, B)
// buffer, and a second launch sums them in a fixed order: no float atomics,
// so repeated runs are bitwise identical.  At the reduced rungs K1
// (k1_tiles_mma, tiles_mma.cuh: the tile above, x0 in shared memory, ybar
// and the variance share in registers) and K2 run their products on the
// tensor cores (mma.sync m16n8k16 bf16, decode_mma.cuh): a warp owns 16
// points x 128 units, activations, cotangents and ReLU masks stay in
// registers, and each dgamma row is summed by the four lanes that hold it,
// in a fixed order.  K1 decodes with decode_mma<R, true> (each k16 step
// summed apart): early stopping evaluates it at the trajectory rung on every
// step, also at M = 1 (single_fused), where it must stay within 1e-5 of its
// plain version.  K2 at the reduced rungs runs the one-pass body it shares
// with K10 (onepass_mma.cuh): persistent blocks, one per SM, walk spans of
// K1's tiles; each (point, decoder) is decoded once (one row in 31 twice,
// the tiles' overlap), the chain of the previous tile runs with the same
// staged decoder, the decoder outputs and masks of two tiles wait in a
// per-block scratch (~86 MB at T=2000, B=200, M=10 on 132 SMs), and the
// weights are bf16 planes made once per call (k2_prep_planes) and staged by
// cp.async.  What still holds K2 back: mma.sync rather than Hopper's wgmma;
// one block of 8 warps an SM (the body's shared memory is ~227 KB); and
// nothing but those copies overlaps the staging.  The float32 rung keeps
// the CUDA-core FMAs and two passes through a (T, B, X) xbar buffer (TF32
// would round the inputs at 2^-11: barred).
//
// Any decoder.  The kernels above take the production shape D <= 4 -> 128 ->
// 128 -> X <= 64.  Every other decoder (2 to 6 layers, hidden widths up to
// 512, X <= 128) takes k1_energy_tiles_any and k2_xbar_any + k2_chain_any:
// the bodies k1_body, k2_xbar_body and k2_chain_body (the latter two also
// the float32 K2's) over the generic decode of decode_any.cuh, on the CUDA
// cores at every rung, in persistent blocks (one per SM) that walk the
// tiles in a fixed stride, so that the activation scratch is one per
// resident block.

#include "decode_any.cuh"
#include "decode_common.cuh"
#include "decode_f32.cuh"
#include "decode_mma.cuh"
#include "k1_fwd_f32.cuh"
#include "onepass_mma.cuh"
#include "tiles_mma.cuh"

namespace {

constexpr int K1_COLS = 4;      // K1 tile: 32 t-rows x 4 splines
constexpr int K1_ROWS = TP / K1_COLS;
constexpr int K1_SEGS = K1_ROWS - 1;
static_assert(K1_COLS == TILE_NS && K1_SEGS == TILE_KR,
              "the generic and the tensor-core K1 fill the same partial rows");

// Shared memory of K1 and the FMA K2 over a decode policy's own (Base) and
// its widest output XM.
template <class Base, int XM>
struct K12Smem : Base {
  float xs[TP * (XM + 1)];  // K1: x0 then xbar; K2: xbar_{t-1} + xbar_{t+1}
  float red[TP];            // K1: var per point
  float red2[TP];           // K1: segment energies
};
using Smem = K12Smem<DecodeSmem, XMAX>;
using SmemAny = K12Smem<AnySmem, XMAX_ANY>;

// K1, pass 1, on the CUDA cores: partial energies of tile (by: t-rows
// t0..t0+31, bx: splines b0..b0+3) -> partial[by * B + b], over decode
// policy P (the generic decode's).
template <int R, class P>
__device__ __forceinline__ void k1_body(K12Smem<typename P::Smem, P::XM>& s,
                                        const typename P::Ctx& c, int bx, int by,
                                        const float* __restrict__ gamma, int T, int B, int D,
                                        int M, int X, const float* __restrict__ wmb,
                                        float* __restrict__ partial) {
  constexpr int SX = P::XM + 1, NJ = P::NJX;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = by * K1_SEGS, b0 = bx * K1_COLS;
  load_points_by<P>(s, c, gamma, D, [&](int p) {
    const int t = min(t0 + p / K1_COLS, T - 1), b = min(b0 + p % K1_COLS, B - 1);
    return (size_t)t * B + b;
  });
  float ybar[8][NJ], sqy[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sqy[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) ybar[i][j] = 0.f;
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
        const float wm = wmb[(size_t)m * B + min(b0 + p % K1_COLS, B - 1)];
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float y = x[i][j] - s.xs[p * SX + tx + 16 * j];
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
    for (int j = 0; j < NJ; ++j) {
      s.xs[p * SX + tx + 16 * j] += ybar[i][j];
      v -= ybar[i][j] * ybar[i][j];
    }
    v = sum16(v);
    if (tx == 0) s.red[p] = M > 1 ? v : 0.f;
  }
  __syncthreads();
  if (tid < K1_SEGS * K1_COLS) {
    const int r = tid / K1_COLS, cc = tid % K1_COLS;
    const int pa = r * K1_COLS + cc, pb = pa + K1_COLS;
    float sd = 0.f;
    for (int n = 0; n < X; ++n) {
      const float d = s.xs[pb * SX + n] - s.xs[pa * SX + n];
      sd += d * d;
    }
    const bool valid = (t0 + r + 1 < T) && (b0 + cc < B);
    s.red2[tid] = valid ? (sd + s.red[pb]) + s.red[pa] : 0.f;
  }
  __syncthreads();
  if (tid < K1_COLS && b0 + tid < B) {
    float e = 0.f;
    for (int r = 0; r < K1_SEGS; ++r) e += s.red2[r * K1_COLS + tid];
    partial[(size_t)by * B + b0 + tid] = e;
  }
}

// K1, pass 1, any decoder: persistent blocks take the (gx x gy) tiles in a
// fixed stride.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k1_energy_tiles_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
                    const float* __restrict__ wmb, float* __restrict__ partial, int gx,
                    int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k1_body<R, AnyDecode>(s, c, item % gx, item / gx, gamma, T, B, D, M, X, wmb, partial);
    __syncthreads();
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

// K2, pass 1: uncentered xbar = sum_m w_m x_m for every point of tile bx ->
// (T*B, X).
template <int R, class P>
__device__ __forceinline__ void k2_xbar_body(K12Smem<typename P::Smem, P::XM>& s,
                                             const typename P::Ctx& c, int bx,
                                             const float* __restrict__ gamma, int T, int B,
                                             int D, int M, int X, const float* __restrict__ wmb,
                                             float* __restrict__ xbar) {
  constexpr int NJ = P::NJX;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int N = T * B, p0 = bx * TP;
  load_points<P>(s, c, gamma, N, D, p0);
  float xb[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) xb[i][j] = 0.f;
  for (int m = 0; m < M; ++m) {
    float x[8][NJ];
    typename P::Masks mk;
    P::template decode<R>(s, c, m, D, X, x, mk);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wm = wmb[(size_t)m * B + min(p0 + ty * 8 + i, N - 1) % B];
#pragma unroll
      for (int j = 0; j < NJ; ++j) xb[i][j] = xb[i][j] + wm * x[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pg = p0 + ty * 8 + i;
    if (pg >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = tx + 16 * j;
      if (n < X) xbar[(size_t)pg * X + n] = xb[i][j];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_xbar(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
        const float* __restrict__ wmb, float* __restrict__ xbar) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  k2_xbar_body<R, FixedDecode>(*reinterpret_cast<Smem*>(smem_raw), FixedDecode::Ctx{w},
                               blockIdx.x, gamma, T, B, D, M, X, wmb, xbar);
}

// K2, pass 2: per decoder, re-decode tile bx, form dx and run the masked
// cotangent chain back to dgamma (T*B, D).
template <int R, class P>
__device__ __forceinline__ void k2_chain_body(K12Smem<typename P::Smem, P::XM>& s,
                                              const typename P::Ctx& c, int bx,
                                              const float* __restrict__ gamma, int T, int B,
                                              int D, int M, int X,
                                              const float* __restrict__ wmb,
                                              const float* __restrict__ ct,
                                              const float* __restrict__ xbar,
                                              float* __restrict__ dgamma) {
  constexpr int C = CHAIN_RUNG<R>;
  constexpr int SX = P::XM + 1, NJ = P::NJX;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = T * B, p0 = bx * TP;
  load_points<P>(s, c, gamma, N, D, p0);
  zero_dgamma<P>(s, c, D);
  for (int e = tid; e < TP * P::XM; e += NT) {
    const int p = e / P::XM, n = e % P::XM;
    const int pg = min(p0 + p, N - 1), t = pg / B;
    const float left = (n < X && t > 0) ? xbar[(size_t)(pg - B) * X + n] : 0.f;
    const float right = (n < X && t < T - 1) ? xbar[(size_t)(pg + B) * X + n] : 0.f;
    s.xs[p * SX + n] = left + right;
  }
  for (int m = 0; m < M; ++m) {
    float x[8][NJ];
    typename P::Masks mk;
    P::template decode<R>(s, c, m, D, X, x, mk);
    // dx -> act[n][p] at the chain rung
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i, pg = p0 + p, pc = min(pg, N - 1);
      const int t = pc / B, b = pc % B;
      const float cc = (float)((t > 0) + (t < T - 1));
      const float sc = pg < N ? __fmul_rn(2.f, __fmul_rn(wmb[(size_t)m * B + b], ct[b])) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < X) {
          const float v = __fmul_rn(sc, __fsub_rn(__fmul_rn(cc, x[i][j]), s.xs[p * SX + n]));
          s.act[n * S_ACT + p] = pack<C>(v);
        }
      }
    }
    __syncthreads();
    P::template chain<C>(s, c, m, D, X, mk);
  }
  __syncthreads();
  store_dgamma<P>(s, c, dgamma, N, D, p0);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_chain(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
         const float* __restrict__ wmb, const float* __restrict__ ct,
         const float* __restrict__ xbar, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  k2_chain_body<R, FixedDecode>(*reinterpret_cast<Smem*>(smem_raw), FixedDecode::Ctx{w},
                                blockIdx.x, gamma, T, B, D, M, X, wmb, ct, xbar, dgamma);
}

// K2, any decoder, at every rung on the CUDA cores: the two passes with
// persistent blocks over the n_items tiles.
template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_xbar_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
            const float* __restrict__ wmb, float* __restrict__ xbar, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k2_xbar_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, wmb, xbar);
    __syncthreads();
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_chain_any(const float* __restrict__ gamma, int T, int B, int M, AnyArgs a,
             const float* __restrict__ wmb, const float* __restrict__ ct,
             const float* __restrict__ xbar, float* __restrict__ dgamma, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SmemAny& s = *reinterpret_cast<SmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    k2_chain_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, wmb, ct, xbar, dgamma);
    __syncthreads();
  }
}

// K2 at a reduced rung, on the tensor cores: one launch of the one-pass
// body (onepass_mma.cuh) after one that prepares the bf16 weight planes; the
// dgamma product takes the W1 the decode takes (W1 as shipped).
__global__ void k2_prep_planes(const float* __restrict__ W2, const float* __restrict__ W3, int M,
                               int X, __nv_bfloat16* __restrict__ planes) {
  prep_planes(W2, W3, M, X, planes);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k2_onepass_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int span,
               int n_items, Weights w, const float* __restrict__ W1c,
               const float* __restrict__ wmb, const float* __restrict__ ct,
               float4* __restrict__ xs_scr, uint4* __restrict__ mk_scr,
               const __nv_bfloat16* __restrict__ planes, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  onepass_body<R>(*reinterpret_cast<OnePassSmem*>(smem_raw), gamma, T, B, D, M, X, span,
                  n_items, w, W1c, wmb, ct, xs_scr, mk_scr, planes, dgamma);
}

// The warp product of decode_mma.cuh alone, for its test: out (n, 128) =
// h (n, 128) @ w (128, 128) (trans = 0, the forward operand) or h @ w^T
// (trans = 1, the chain's), inputs rounded to bf16 (exact if they are bf16
// values), fp32 accumulation.
__global__ void __launch_bounds__(NT, 1)
k_mma_selftest(int trans, const float* __restrict__ h, const float* __restrict__ w,
               float* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem& s = *reinterpret_cast<MmaSmem*>(smem_raw);
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int p = blockIdx.x * TP + (threadIdx.x >> 5) * 16 + (lane >> 2);
  for (int e = threadIdx.x; e < H * H; e += NT)
    s.w2h[(e / H) * SW2 + e % H] = __float2bfloat16_rn(w[e]);
  __syncthreads();
  float a[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      a[j][c] = h[(size_t)min(p + 8 * (c >> 1), n - 1) * H + 8 * j + 2 * q + (c & 1)];
  uint32_t ah[NK2][4];
  to_a<false>(a, ah);
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[j][c] = 0.f;
  if (trans)
    gemm_wt<NK2>(a, ah, s.w2h, SW2, NK2);
  else
    gemm_fwd<BF16, NJ2>(a, ah, ah, s.w2h, s.w2h, SW2, NJ2);
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pg = p + 8 * (c >> 1);
      if (pg < n) out[(size_t)pg * H + 8 * j + 2 * q + (c & 1)] = a[j][c];
    }
}

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, float* partial, float* out, float* w3p,
                       cudaStream_t st) {
  cudaError_t err;
  int n_tiles;
  if constexpr (R == F32) {  // the float32 decode of decode_f32.cuh
    if (!f32_aligned(w)) return cudaErrorMisalignedAddress;
    err = f32_prepare_w3(w.W3, M, X, w3p, st);
    if (err == cudaSuccess) err = prepare<K1F32Smem>(k1_fwd_fma<R>);
    if (err != cudaSuccess) return err;
    n_tiles = k1f_tiles(T);
    k1_fwd_fma<R><<<dim3(B, n_tiles), NT, sizeof(K1F32Smem), st>>>(
        gamma, T, B, D, M, X, F32Weights{w, w3p}, wmb, partial);
  } else {  // tensor cores (tiles_mma.cuh)
    err = prepare<K1MmaSmem>(k1_tiles_mma<R>);
    if (err != cudaSuccess) return err;
    n_tiles = tile_rows(T);
    k1_tiles_mma<R><<<dim3((B + TILE_NS - 1) / TILE_NS, n_tiles), NT, sizeof(K1MmaSmem), st>>>(
        gamma, T, B, D, M, X, w, wmb, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_sum_tiles<<<(B + 127) / 128, 128, 0, st>>>(partial, n_tiles, B, out);
  return cudaGetLastError();
}

// K2 on the production shape: at float32 the two FMA passes through the
// (T, B, X) xbar buffer; at a reduced rung one launch of k2_onepass_mma over
// `scratch`: each block's outputs (onepass_xs_words), then each block's
// masks (onepass_mk_words), then the planes (onepass_plane_words).
template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, int span, int G,
                       int n_blocks, Weights w, const float* wmb, const float* ct, float* xbar,
                       void* scratch, float* dgamma, cudaStream_t st) {
  if constexpr (R == F32) {  // CUDA-core FMAs
    const int n_tiles = (T * B + TP - 1) / TP;
    cudaError_t err = prepare<Smem>(k2_xbar<R>);
    if (err == cudaSuccess) err = prepare<Smem>(k2_chain<R>);
    if (err != cudaSuccess) return err;
    k2_xbar<R><<<n_tiles, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, xbar);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    k2_chain<R><<<n_tiles, NT, sizeof(Smem), st>>>(gamma, T, B, D, M, X, w, wmb, ct, xbar,
                                                    dgamma);
    return cudaGetLastError();
  } else {  // tensor cores, one decode
    if (scratch == nullptr || span < 1 || G < 1 || n_blocks < 1) return cudaErrorInvalidValue;
    uint32_t* words = static_cast<uint32_t*>(scratch);
    float4* xs = reinterpret_cast<float4*>(words);
    uint4* mk = reinterpret_cast<uint4*>(words + n_blocks * onepass_xs_words(M, X));
    __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(
        words + n_blocks * (onepass_xs_words(M, X) + onepass_mk_words(M)));
    return launch_onepass<R>(k2_prep_planes, k2_onepass_mma<R>, gamma, T, B, D, M, X, span, G,
                             n_blocks, w, w.W1, wmb, ct, xs, mk, planes, dgamma, st);
  }
}

template <int R>
cudaError_t launch_fwd_any(const float* gamma, int T, int B, int M, const AnyArgs& a,
                           int n_blocks, const float* wmb, float* partial, float* out,
                           cudaStream_t st) {
  cudaError_t err = prepare<SmemAny>(k1_energy_tiles_any<R>);
  if (err != cudaSuccess) return err;
  const int n_tiles = T > 1 ? (T - 1 + K1_SEGS - 1) / K1_SEGS : 1;
  const int gx = (B + K1_COLS - 1) / K1_COLS;
  k1_energy_tiles_any<R><<<n_blocks, NT, sizeof(SmemAny), st>>>(gamma, T, B, M, a, wmb, partial,
                                                                gx, gx * n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k1_sum_tiles<<<(B + 127) / 128, 128, 0, st>>>(partial, n_tiles, B, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_any(const float* gamma, int T, int B, int M, const AnyArgs& a,
                           int n_blocks, const float* wmb, const float* ct, float* xbar,
                           float* dgamma, cudaStream_t st) {
  const int n_items = (T * B + TP - 1) / TP;
  cudaError_t err = prepare<SmemAny>(k2_xbar_any<R>);
  if (err == cudaSuccess) err = prepare<SmemAny>(k2_chain_any<R>);
  if (err != cudaSuccess) return err;
  k2_xbar_any<R><<<n_blocks, NT, sizeof(SmemAny), st>>>(gamma, T, B, M, a, wmb, xbar, n_items);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2_chain_any<R><<<n_blocks, NT, sizeof(SmemAny), st>>>(gamma, T, B, M, a, wmb, ct, xbar,
                                                         dgamma, n_items);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row count of K1's (n_tiles, B) partial-energy buffer: the reduced rungs'
// and the generic kernels' tiles of 31 segments; the float32 kernel's tiles
// of 127 fill fewer of its rows.
int vlg_energy_fwd_tiles(int T) { return T > 1 ? (T - 1 + K1_SEGS - 1) / K1_SEGS : 1; }

// The decoder comes as L layers: widths[0..L] (D first, X last) and the
// per-layer weight (M, in, out) and bias (M, out) pointers.  The fixed shape
// (D <= 4 -> 128 -> 128 -> X <= 64) takes the fixed kernels, at float32
// with `scratch` of vlg_f32_scratch_words floats; every other decoder the
// generic ones, with n_blocks persistent blocks and `scratch` of n_blocks x
// vlg_any_scratch_words(L, widths, 1) words.
int vlg_energy_fwd(int rung, const float* gamma, int T, int B, int M, int L, const int* widths,
                   const float* const* Ws, const float* const* bs, const float* wmb,
                   float* partial, float* out, void* scratch, int n_blocks, void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 1, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d)
        ? launch_fwd<R>(gamma, T, B, D, M, X, fixed_weights(d), wmb, partial, out,
                        static_cast<float*>(scratch), st)
        : launch_fwd_any<R>(gamma, T, B, M, a, n_blocks, wmb, partial, out, st);
  });
}

// K2: the decoder and `scratch` as vlg_energy_fwd's, but at a reduced rung
// on the fixed shape, where `scratch` holds n_blocks x vlg_k2_block_words +
// vlg_k2_plane_words words and the blocks take the G spans of `span` rows
// per group of four splines; `xbar` is the (T, B, X) buffer of the other
// kernels (unused there).
int vlg_energy_bwd(int rung, const float* gamma, int T, int B, int M, int span, int G, int L,
                   const int* widths, const float* const* Ws, const float* const* bs,
                   const float* wmb, const float* ct, float* xbar, float* dgamma,
                   void* scratch, int n_blocks, void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 1, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d)
        ? launch_bwd<R>(gamma, T, B, D, M, X, span, G, n_blocks, fixed_weights(d), wmb, ct,
                        xbar, scratch, dgamma, st)
        : launch_bwd_any<R>(gamma, T, B, M, a, n_blocks, wmb, ct, xbar, dgamma, st);
  });
}

// 32-bit words of K2's one-pass scratch: per block (outputs and masks of two
// tiles of M decoders), and of the M decoders' weight planes.
int vlg_k2_block_words(int M, int X) {
  return (int)(onepass_xs_words(M, X) + onepass_mk_words(M));
}

int vlg_k2_plane_words(int M) { return (int)onepass_plane_words(M); }

int vlg_mma_selftest(int trans, const float* h, const float* w, float* out, int n,
                     void* stream) {
  cudaError_t err = prepare<MmaSmem>(k_mma_selftest);
  if (err != cudaSuccess) return err;
  k_mma_selftest<<<(n + TP - 1) / TP, NT, sizeof(MmaSmem), static_cast<cudaStream_t>(stream)>>>(
      trans, h, w, out, n);
  return cudaGetLastError();
}

}  // extern "C"
