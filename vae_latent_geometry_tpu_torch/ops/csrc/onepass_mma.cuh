// The expected energy's gradient in one pass on the tensor cores, for sm_90a
// (H100): one body for K2's reduced rungs (energy_expected.cu:
// k2_onepass_mma) and K10's (energy_transposed.cu: k10_mma), the same
// function with other parameters.
//
// Function.  dgamma (T, B, D) of sum_b ct_b E_b for the per-spline weight
// plane wmb (M, B) (K10 passes its uniform one):
//   dx_m = 2 wmb[m, b] ct_b (c_t x_m - xbar_{t-1}[t>0] - xbar_{t+1}[t<T-1]),
//   xbar = sum_m wmb[m, b] x_m (uncentred), c_t = [t>0] + [t<T-1],
// back through the ReLU masks of the same decode (decode_mma.cuh: the decode
// at the rung, the chain single-pass bf16).  The dgamma product takes W1c:
// the W1 the decode uses (K2) or float32 W1 where that differs, at the
// bfloat16 rung (K10), swapped into the staged decoder around the chain.
//
// Design.  The decode and chain of decode_mma.cuh (a warp owns 16 points x
// 128 units, activations and ReLU masks in registers, mma.sync m16n8k16
// bf16) over the tiles of tiles_mma.cuh: 32 curve rows of 4 splines, point p
// = r * 4 + s (a warp holds rows 4w .. 4w + 3); consecutive tiles of a span
// overlap by one row, so a tile owns rows 0..30 and its row 31 (the next
// tile's row 0) is the right neighbour of its row 30: every tile's dgamma
// needs only its own xbar and the left carry (the previous tile's row 30).
// Tile k's dgamma is emitted in the round that decodes tile k+1, with the
// same staged decoder: per round and decoder one staging, the chain of tile
// k-1 (its outputs and masks read back from the block's scratch by cp.async
// while the decoder stages), then the decode of tile k (outputs and masks to
// the scratch, xbar summed in shared memory in decoder order).  Each (point,
// decoder) is decoded once, but for the overlap row (32 rows decoded per 31
// owned) and one row before each span.  The weights are converted to bf16
// planes once per call (prep_planes) and staged by 16-byte cp.async copies.
// Blocks are persistent, one per SM, and take the (spline group, span) items
// in a fixed stride (the wrappers' pick_spans), so the scratch is per
// resident block.  A tile's four splines share the decoder's weight:
// wmb[m, b0..b0+3] rides in a two-row table in shared memory, the row of
// decoder m written as its round starts (any M).  Repeated calls are bitwise
// equal: no float atomics, every sum in a fixed order.

#pragma once

#include "decode_f32.cuh"   // the cp.async helpers
#include "tiles_mma.cuh"    // the tile: 32 rows of 4 splines, 31 owned

namespace {

constexpr int OP_SXB = XMAX + 8;   // xbar row stride (floats)

// One decoder's bf16 planes as MmaSmem holds them from w2h on (w2h | w2l |
// w3h | w3l, pads zero), made once per call by prep_planes so that a block
// stages a decoder with 16-byte cp.async copies and no conversion; the rungs
// other than f32x3 copy no lo plane.
constexpr int PLANE_W2 = H * SW2, PLANE_W3 = H * SW3;      // bf16 elements
constexpr int PLANE_ELEMS = 2 * (PLANE_W2 + PLANE_W3);     // a decoder's four
static_assert(sizeof(MmaSmem::w2h) == 2 * PLANE_W2 && sizeof(MmaSmem::w3h) == 2 * PLANE_W3,
              "the planes are MmaSmem's");

// The body of each op's plane-preparing kernel (a grid-stride loop).
__device__ __forceinline__ void prep_planes(const float* __restrict__ W2,
                                            const float* __restrict__ W3, int M, int X,
                                            __nv_bfloat16* __restrict__ planes) {
  const size_t n = (size_t)M * PLANE_ELEMS;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(e / PLANE_ELEMS);
    int r = (int)(e % PLANE_ELEMS);
    const bool w3 = r >= 2 * PLANE_W2;
    if (w3) r -= 2 * PLANE_W2;
    const int plane = w3 ? PLANE_W3 : PLANE_W2, ws = w3 ? SW3 : SW2;
    const bool lo = r >= plane;
    if (lo) r -= plane;
    const int k = r / ws, col = r % ws;
    float v = 0.f;
    if (w3 && col < X) v = W3[((size_t)m * H + k) * X + col];
    if (!w3 && col < H) v = W2[((size_t)m * H + k) * H + col];
    const __nv_bfloat16 h = __float2bfloat16_rn(v);
    planes[e] = lo ? __float2bfloat16_rn(v - __bfloat162float(h)) : h;
  }
}

// Stage decoder m from its prepared planes: cp.async copies of the planes
// (the lo planes at f32x3 only), W1 (rows d < D) and the biases (b3's
// columns < X); committed as one group.  Rows of W1 past D and columns of
// b3 past X keep the zeros written at kernel start.
template <int R>
__device__ void stage_planes(MmaSmem& s, int m, int D, int X, const Weights& w,
                             const __nv_bfloat16* __restrict__ planes) {
  const float* src = reinterpret_cast<const float*>(planes + (size_t)m * PLANE_ELEMS);
  float* w2 = reinterpret_cast<float*>(s.w2h);
  float* w3 = reinterpret_cast<float*>(s.w3h);
  if constexpr (R == F32X3) {
    cp_block16(w2, src, PLANE_ELEMS / 2);   // w2h | w2l | w3h | w3l
  } else {
    cp_block16(w2, src, PLANE_W2 / 2);
    cp_block16(w3, src + PLANE_W2, PLANE_W3 / 2);
  }
  cp_block16(s.w1, w.W1 + (size_t)m * D * H, D * H);
  cp_block16(s.b1, w.b1 + (size_t)m * H, H);
  cp_block16(s.b2, w.b2 + (size_t)m * H, H);
  for (int e = threadIdx.x; e < X; e += NT) cp_async4(s.b3 + e, w.b3 + (size_t)m * X + e);
  cp_commit();
}

// Span of work item `item`: spline group and T-span (first row t_s, end t_e).
struct Span {
  int b0, g, t_s, t_e;
};
__device__ __forceinline__ Span span_of(int item, int groups, int span, int T) {
  Span sp;
  sp.b0 = (item % groups) * TILE_NS;
  sp.g = item / groups;
  sp.t_s = sp.g * span;
  sp.t_e = min(T, sp.t_s + span);
  return sp;
}

// The round's state, written by thread 0 between barriers and read where it
// is used, so that no register holds it across the decode and the chain.
struct OnePassRound {
  int b0, t_s, t_e, t0, n_tiles;
};

struct OnePassSmem : MmaSmem {
  float xb[2][TP * OP_SXB];         // xbar of tiles k-1 and k [p][n]
  float edge[XMAX * TILE_NS];       // left carry: xbar of tile k-2's row 30 [n][s]
  float4 xpre[NJ3 * NT];            // the chain's outputs of tile k-1 [j][thread]
  uint4 mpre[NT];                   // and its masks, each thread's own
  float cct[TP], ccl[TP];           // tile k-1's point: ct_b (0 if not owned), c_t
  int cfl[TP];                      // and its neighbours: bit 0 t > 0, bit 1 t < T - 1
  float wq[2][TILE_NS];             // wmb[m, b0 + s], row m & 1
  OnePassRound rd;
};

// 32-bit words of one block's scratch: outputs [buf][m][j] (one float4 per
// thread) and masks [buf][m] (one uint4) of two tiles; and of all M
// decoders' planes.
inline size_t onepass_xs_words(int M, int X) { return (size_t)2 * M * ((X + 7) / 8) * NT * 4; }
inline size_t onepass_mk_words(int M) { return (size_t)2 * M * NT * 4; }
inline size_t onepass_plane_words(int M) { return (size_t)M * PLANE_ELEMS / 2; }

template <int R>
__device__ __forceinline__ void onepass_body(OnePassSmem& s, const float* __restrict__ gamma,
                                             int T, int B, int D, int M, int X, int span,
                                             int n_items, const Weights& w,
                                             const float* __restrict__ W1c,
                                             const float* __restrict__ wmb,
                                             const float* __restrict__ ct,
                                             float4* __restrict__ xs_scr,
                                             uint4* __restrict__ mk_scr,
                                             const __nv_bfloat16* __restrict__ planes,
                                             float* __restrict__ dgamma) {
  static_assert(R != F32, "float32 keeps the FMA kernels");
  constexpr int NS = TILE_NS, KR = TILE_KR;
  const int tid = threadIdx.x;
  const int nj = (X + 7) / 8;
  const bool swap_w1 = R == BF16 && W1c != w.W1;   // uniform: the barriers below hold
  for (int e = tid; e < DMAX * H; e += NT) s.w1[e] = 0.f;
  for (int e = tid; e < XMAX; e += NT) s.b3[e] = 0.f;
  int staged = -1;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    for (int k = 0;; ++k) {
      __syncthreads();
      if (tid == 0) {
        const Span sp = span_of(item, (B + NS - 1) / NS, span, T);
        const int t_a = max(sp.t_s - 1, 0);
        s.rd = OnePassRound{sp.b0, sp.t_s, sp.t_e, t_a + k * KR,
                            sp.t_s < T ? (sp.t_e - t_a + KR - 1) / KR : 0};
      }
      __syncthreads();
      const int n_tiles = s.rd.n_tiles;
      if (n_tiles == 0 || k > n_tiles) break;
      const int cur = k & 1;
      if (k < n_tiles) {
        for (int e = tid; e < TP * DMAX; e += NT) {
          const int pp = e / DMAX, d = e % DMAX;
          const int t = min(s.rd.t0 + pp / NS, T - 1), b = min(s.rd.b0 + pp % NS, B - 1);
          s.g[e] = d < D ? gamma[((size_t)t * B + b) * D + d] : 0.f;
        }
        for (int e = tid; e < TP * OP_SXB; e += NT) s.xb[cur][e] = 0.f;
      }
      for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
      if (k > 0 && tid < TP) {   // tile k-1's points: cotangent, c_t, neighbours
        const int row = tid / NS, t = s.rd.t0 - KR + row, b = s.rd.b0 + tid % NS;
        const bool own = row < KR && t >= s.rd.t_s && t < s.rd.t_e && t < T && b < B;
        s.cct[tid] = own ? ct[b] : 0.f;
        s.ccl[tid] = (float)((int)(t > 0) + (int)(t < T - 1));
        s.cfl[tid] = (t > 0 ? 1 : 0) | (t < T - 1 ? 2 : 0);
      }
      for (int m = 0; m < M; ++m) {
        const int prv = (k & 1) ^ 1;
        // the decoder's weight of the tile's splines, by cp.async so that no
        // warp waits on the load before the staging's barrier (row m & 1 was
        // last read two decoders or a round ago, barriers between)
        if (tid < NS)
          cp_async4(&s.wq[m & 1][tid], wmb + (size_t)m * B + min(s.rd.b0 + tid, B - 1));
        if (k > 0) {   // tile k-1's outputs and masks of decoder m, in flight while it stages
          const float4* xm =
              xs_scr + ((size_t)blockIdx.x * 2 * M + prv * M + m) * nj * NT + tid;
          for (int j = 0; j < nj; ++j)
            cp_async16(reinterpret_cast<float*>(&s.xpre[j * NT + tid]),
                       reinterpret_cast<const float*>(xm + (size_t)j * NT));
          cp_async16(reinterpret_cast<float*>(&s.mpre[tid]),
                     reinterpret_cast<const float*>(
                         mk_scr + ((size_t)blockIdx.x * 2 * M + prv * M + m) * NT + tid));
        }
        cp_commit();
        if (m != staged) {
          __syncthreads();
          stage_planes<R>(s, m, D, X, w, planes);
          staged = m;
        }
        cp_wait<0>();   // the staged decoder and the chain's inputs
        if (swap_w1) {   // the chain's W1c
          __syncthreads();
          for (int e = tid; e < DMAX * H; e += NT)
            s.w1[e] = e < D * H ? W1c[(size_t)m * D * H + e] : 0.f;
        }
        __syncthreads();
        // ---- chain of tile k-1 ----
        if (k > 0) {
          // dx = 2 wm ct_b (c_t x - xbar_{t-1} - xbar_{t+1}) on the lane's
          // rows that tile k-1 owns (both of the lane's spline p0 % 4),
          // packed straight into A fragments
          const int lane = tid & 31, q = lane & 3, p0 = (tid >> 5) * 16 + (lane >> 2);
          const float w2 = __fmul_rn(2.f, s.wq[m & 1][p0 & (NS - 1)]);
          uint32_t a[NK3][4];
#pragma unroll
          for (int j = 0; j < NJ3; ++j) {
            const float4 v = j < nj ? s.xpre[j * NT + tid] : make_float4(0.f, 0.f, 0.f, 0.f);
            const float xv[4] = {v.x, v.y, v.z, v.w};
            float dv[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int pp = p0 + 8 * (c >> 1), n = 8 * j + 2 * q + (c & 1);
              const float sc = __fmul_rn(w2, s.cct[pp]);
              dv[c] = 0.f;
              if (sc != 0.f && n < X) {
                const int fl = s.cfl[pp];
                const float left = (fl & 1) ? (pp >= NS ? s.xb[prv][(pp - NS) * OP_SXB + n]
                                                        : s.edge[n * NS + pp])
                                            : 0.f;
                const float right = (fl & 2) ? s.xb[prv][(pp + NS) * OP_SXB + n] : 0.f;
                dv[c] = __fmul_rn(sc, __fsub_rn(__fsub_rn(__fmul_rn(s.ccl[pp], xv[c]), left),
                                                right));
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) a[j >> 1][(j & 1) * 2 + r] = bf16x2(dv[2 * r], dv[2 * r + 1]);
          }
          const uint4 mv = s.mpre[tid];
          const uint32_t m1[2] = {mv.x, mv.y}, m2[2] = {mv.z, mv.w};
          chain_mma(s, D, X, a, m1, m2);
        }
        // the barrier keeps the chain's registers and the decode's apart
        __syncthreads();
        if (swap_w1) {   // back to the shipped W1 for the decode
          for (int e = tid; e < DMAX * H; e += NT)
            s.w1[e] = e < D * H ? w.W1[(size_t)m * D * H + e] : 0.f;
          __syncthreads();
        }
        // ---- decode of tile k ----
        if (k < s.rd.n_tiles) {
          float x[NJ3][4];
          uint32_t m1[2], m2[2];
          decode_mma<R>(s, D, X, x, m1, m2);
          const int lane = tid & 31, q = lane & 3, p0 = (tid >> 5) * 16 + (lane >> 2);
          const int cb = k & 1;
          float4* xm = xs_scr + ((size_t)blockIdx.x * 2 * M + cb * M + m) * nj * NT + tid;
          const float wm = s.wq[m & 1][p0 & (NS - 1)];
#pragma unroll
          for (int j = 0; j < NJ3; ++j) {
            if (j >= nj) continue;
            xm[(size_t)j * NT] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float2* xb2 =
                  reinterpret_cast<float2*>(&s.xb[cb][(p0 + 8 * r) * OP_SXB + 8 * j + 2 * q]);
              const float2 o = *xb2;
              *xb2 = make_float2(o.x + wm * x[j][2 * r], o.y + wm * x[j][2 * r + 1]);
            }
          }
          mk_scr[((size_t)blockIdx.x * 2 * M + cb * M + m) * NT + tid] =
              make_uint4(m1[0], m1[1], m2[0], m2[1]);
        }
      }
      __syncthreads();
      // dgamma of tile k-1's owned points
      if (k > 0)
        for (int e = tid; e < TP * D; e += NT) {
          const int pp = e / D, d = e % D, row = pp / NS;
          const int t = s.rd.t0 - KR + row, b = s.rd.b0 + pp % NS;
          if (row < KR && t >= s.rd.t_s && t < s.rd.t_e && t < T && b < B)
            dgamma[((size_t)t * B + b) * D + d] = s.dg[pp * DMAX + d];
        }
      // left carry of tile k: tile k-1's row 30
      if (k > 0 && k < s.rd.n_tiles)
        for (int e = tid; e < XMAX * NS; e += NT)
          s.edge[e] = s.xb[(k & 1) ^ 1][((KR - 1) * NS + e % NS) * OP_SXB + e / NS];
    }
  }
}

// Prepare the planes, then run the body: `prep` and `body` are the op's own
// kernels over prep_planes and onepass_body (K2's and K10's names differ, so
// that each op's device time reads by its own prefix).  W1, b1, b2 and the
// planes must be 16-byte aligned (cp.async).
template <int R, class Prep, class Body>
cudaError_t launch_onepass(Prep prep, Body body, const float* gamma, int T, int B, int D, int M,
                           int X, int span, int G, int n_blocks, const Weights& w,
                           const float* W1c, const float* wmb, const float* ct, float4* xs_scr,
                           uint4* mk_scr, __nv_bfloat16* planes, float* dgamma,
                           cudaStream_t st) {
  cudaError_t err = prepare<OnePassSmem>(body);
  if (err != cudaSuccess) return err;
  if ((reinterpret_cast<uintptr_t>(w.W1) | reinterpret_cast<uintptr_t>(w.b1) |
       reinterpret_cast<uintptr_t>(w.b2) | reinterpret_cast<uintptr_t>(planes)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  prep<<<n_blocks, NT, 0, st>>>(w.W2, w.W3, M, X, planes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_items = G * ((B + TILE_NS - 1) / TILE_NS);
  body<<<n_blocks, NT, sizeof(OnePassSmem), st>>>(gamma, T, B, D, M, X, span, n_items, w, W1c,
                                                  wmb, ct, xs_scr, mk_scr, planes, dgamma);
  return cudaGetLastError();
}

}  // namespace
