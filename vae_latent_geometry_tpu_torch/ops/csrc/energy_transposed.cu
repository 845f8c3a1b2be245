// Expected ensemble energy in the transposed layout, and its gradient, for
// sm_90a (H100).
//
// Replaces the Pallas TPU kernels of
// vae_latent_geometry_tpu/ops/_research/energy_pallas_t.py
// (public op energy_expected_fused_t, :387):
//   K9   _fwd_kernel_T (:119)  -> K1's kernels on the uniform weight plane:
//        k1_tiles_mma (f32x3, f32x2, bfloat16; tiles_mma.cuh) or k1_fwd_fma
//        (float32, k1_fwd_f32.cuh), + k9_sum_spans
//   K10  _bwd_kernel_T (:193)  -> k10_mma (f32x3, f32x2, bfloat16; K2's body,
//        onepass_mma.cuh) or k10_dgamma<0> (float32), one launch
//
// Function.  Uniform ensemble weights 1/M over M ReLU MLP decoders
// D -> 128 -> 128 -> X on the curve points gamma (T, B, D):
//   K9:  E_b = sum_t ||xbar_{t+1} - xbar_t||^2 + var_{t+1} + var_t with the
//        statistics centred on decoder 0 (no var term at M = 1): K1's
//        function on the uniform weight plane;
//   K10: dgamma for a per-spline cotangent ct_b through
//        dx_m = (2/M) ct_b (c_t x_m - xbar_{t-1}[t>0] - xbar_{t+1}[t<T-1]),
//        c_t = [t>0] + [t<T-1], back through the ReLU masks of the same decode;
//        the chain runs at bf16 under f32x3/f32x2 and the dgamma product
//        always uses float32 W1 (at the bfloat16 rung the decode uses W1
//        rounded to bf16, as the TPU kernel ships it).
//
// Layout.  The TPU kernels put the weights on the left and the points along
// the wide dimension, the output features padded to a multiple of 8.  Here
// a tile is 32 curve rows of 4 splines, point p = r * 4 + s (the TPU's lane
// index l = t * B + b), so the neighbour in t is p -+ 4; the tensor-core
// kernels take the points as the rows of mma.sync's A (a warp 16 points, 4
// rows of 4 splines) and layer 3's N is X padded to 8, the narrow output of
// the transposed layout.
//
// Bound on this card.  The same function as K1/K2 at the same FLOP count:
// K9 at float32 decodes every point once per decoder, 1.8e11 FLOP at
// T=2000, B=200, M=10 over the 67 TFLOP/s FP32 peak: 2.751 ms; at f32x2 a
// two-pass decode, 3.67e11 FLOP over the 989 TFLOP/s bf16 tensor-core peak:
// 0.371 ms; K10 at f32x2 is a two-pass decode plus a single-pass chain,
// 5.5e11 FLOP: 0.557 ms.  Both move a few MB: bound by operations.  What the
// design does about it:
//   - K10 (k10_mma) does no work twice: it runs K2's one-pass body
//     (onepass_mma.cuh) on the uniform weight plane.  Every decoder decodes
//     each point ONCE and is staged once per tile; tiles overlap by one row,
//     tile k-1's dgamma is emitted in the round that decodes tile k with the
//     same staged decoder, the kept outputs and masks (M x 128 x X floats
//     per tile, 256 KB at M = 10: they do not fit beside the staged weights)
//     go to a per-block scratch and come back by cp.async while the next
//     decoder stages, and the weights are bf16 planes made once per call
//     (t_prep_planes) and staged by 16-byte cp.async copies.  It differs
//     from K2's only in the W1 of the dgamma product: float32 W1 at every
//     rung.  What still holds it back: one block of 8 warps an SM, nothing
//     overlapping the staging but those copies, mma.sync rather than wgmma.
//   - K9 runs K1's kernels on the uniform weight plane: k1_tiles_mma at the
//     reduced rungs (tiles_mma.cuh: K3's statistics over K10's tiles, x0 in
//     shared memory, ybar and the variance share in registers, each k16
//     step of the decode summed apart so that at M = 1 it stays within 1e-5
//     of its plain version), k1_fwd_fma (cp.async-staged FMA decode) at
//     float32: TF32 is barred.
//   - k10_dgamma<0> (K10 at float32) keeps the FMA kernel: a block owns 4
//     splines and walks a span of T in a loop that takes the place of the
//     TPU's sequential grid axis, chunk j decoded while chunk j-1's dgamma
//     is emitted (it needs chunk j's first xbar row), outputs and masks in
//     the block's scratch, the emit walking the decoders in reverse so the
//     decoder staged last is reused.
// K10's blocks are persistent (one per SM) and take the (spline group, span)
// items in a fixed stride, so the scratch is per resident block; the
// wrapper picks G spans per spline so that the items fill the SMs in even
// rounds (pick_spans).
//
// Any decoder.  The kernels above take D <= 2 -> 128 -> 128 -> X <= 64;
// every other 3-layer decoder (any hidden width, X <= 128) takes
// k9_energy_spans_any and k10_dgamma_any: the bodies k9_body and k10_body
// over the generic decode of decode_any.cuh, its outputs read out of shared
// memory into the narrow tile (16 row groups of 8 at X <= 128); K10 keeps
// every decoder's masks of two chunks in 2 M mask areas of the block's
// scratch, and its chain (decode_any.cuh's) sums dgamma in shared memory in
// decoder order; K9 carries the previous chunk's last xbar row and var
// between the chunks of a span.

#include "decode_any.cuh"
#include "decode_common.cuh"
#include "decode_f32.cuh"
#include "decode_mma.cuh"
#include "k1_fwd_f32.cuh"
#include "onepass_mma.cuh"
#include "tiles_mma.cuh"

namespace {

constexpr int XPM = 64;            // widest padded output, Xp <= 64
constexpr int S_W3T = XPM + 1;     // odd stride: conflict-free row and column reads
constexpr int NS = 4;              // splines per chunk
constexpr int RC = 32;             // curve rows per chunk
constexpr int PC = NS * RC;        // points per chunk
constexpr int DT = 2;              // widest latent of the transposed op
static_assert(PC == TP, "a chunk is one activation tile");
static_assert(NS == 4 && NS == TILE_NS,
              "the narrow tile maps one lane to one row of 4 splines; span_of's groups");

// The float32 K10's (k10_dgamma<0>) shared memory on the production decoder.
struct TSmem {
  uint32_t act[H * S_ACT];    // activation tile [feature][point], packed for the rung
  uint32_t w2[H * S_W2];      // W2[in][out] packed
  uint32_t w3[H * S_W3T];     // W3[in][out] packed, out >= X zero
  float xb[XPM * S_ACT];      // xbar of chunk j-1
  float w1[DT * H];           // W1 as shipped (the decode)
  float w1f[DT * H];          // W1 in float32 (the dgamma product)
  float b1[H], b2[H], b3[XPM];
  float g[PC * DT];           // the chunk's curve points
  float edge[2][XPM * NS];    // left carry (0), right row (1)
};

// Wide tile (128 output rows): thread (ry = tid / 16, px = tid % 16) owns rows
// ry + 16 i and points wide_p(px, j), i, j < 8.
__device__ __forceinline__ int wide_p(int px, int j) { return 4 * px + (j & 3) + 64 * (j >> 2); }

template <int R, int NJ>
__device__ __forceinline__ void split_act(const uint32_t (&a)[NJ], float (&ah)[NJ],
                                          float (&al)[NJ]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if constexpr (R == F32) {
      ah[j] = __uint_as_float(a[j]);
      al[j] = 0.f;
    } else {
      ah[j] = hi_of(a[j]);
      al[j] = lo_of(a[j]);
    }
  }
}

// acc[j] += w * act[j] at rung R: w.h_hi + w.h_lo (+ w_lo.h_hi at f32x3).
template <int R, int NJ>
__device__ __forceinline__ void row_mac(uint32_t w, const float (&ah)[NJ], const float (&al)[NJ],
                                        float (&acc)[NJ]) {
  if constexpr (R == F32) {
    const float wf = __uint_as_float(w);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] = fmaf(wf, ah[j], acc[j]);
  } else {
    const float wh = hi_of(w), wl = lo_of(w);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j] = fmaf(wh, ah[j], acc[j]);
      if constexpr (R == F32X2 || R == F32X3) acc[j] = fmaf(wh, al[j], acc[j]);
      if constexpr (R == F32X3) acc[j] = fmaf(wl, ah[j], acc[j]);
    }
  }
}

// acc[i][j] += sum_kk Wsel(ry + 16 i, kk) * act[kk][wide_p(px, j)];  Wsel(r, kk)
// = w[kk * ws + r] when WT (forward: W^T . H), else w[r * ws + kk] (chain: W . dH).
template <int R, bool WT>
__device__ __forceinline__ void gemm_wide(const uint32_t* act, const uint32_t* w, int ws,
                                          int kdim, float (&acc)[8][8]) {
  const int px = threadIdx.x & 15, ry = threadIdx.x >> 4;
#pragma unroll 2
  for (int kk = 0; kk < kdim; ++kk) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(act + kk * S_ACT + 4 * px);
    const uint4 a1 = *reinterpret_cast<const uint4*>(act + kk * S_ACT + 64 + 4 * px);
    const uint32_t a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float ah[8], al[8];
    split_act<R, 8>(a, ah, al);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t wv = WT ? w[kk * ws + ry + 16 * i] : w[(ry + 16 * i) * ws + kk];
      row_mac<R, 8>(wv, ah, al, acc[i]);
    }
  }
}

// Narrow tile (Xp output rows): thread (qy = tid / 32, qx = tid % 32) owns rows
// qy + 8 i (i < ni = Xp / 8) and points 4 qx + j, j < 4: one curve row, its 4
// splines.  acc[i][j] += sum_k W3[k][qy + 8 i] * act[k][4 qx + j].
template <int R>
__device__ __forceinline__ void gemm_narrow(const uint32_t* act, const uint32_t* w3, int ni,
                                            float (&acc)[8][4]) {
  const int qx = threadIdx.x & 31, qy = threadIdx.x >> 5;
#pragma unroll 2
  for (int kk = 0; kk < H; ++kk) {
    const uint4 a0 = *reinterpret_cast<const uint4*>(act + kk * S_ACT + 4 * qx);
    const uint32_t a[4] = {a0.x, a0.y, a0.z, a0.w};
    float ah[4], al[4];
    split_act<R, 4>(a, ah, al);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < ni) row_mac<R, 4>(w3[kk * S_W3T + qy + 8 * i], ah, al, acc[i]);
  }
}

// Stage decoder m's weights, packed for rung R (W1f: float32 W1, or null).
template <int R>
__device__ void stage_T(TSmem& s, int m, int D, int X, const Weights& w, const float* W1f) {
  const int tid = threadIdx.x;
  const float* w2 = w.W2 + (size_t)m * H * H;
  for (int e = tid; e < H * H; e += NT) s.w2[(e / H) * S_W2 + e % H] = pack<R>(w2[e]);
  const float* w3 = w.W3 + (size_t)m * H * X;
  for (int e = tid; e < H * XPM; e += NT) {
    const int k = e / XPM, n = e % XPM;
    s.w3[k * S_W3T + n] = n < X ? pack<R>(w3[k * X + n]) : 0u;
  }
  for (int e = tid; e < DT * H; e += NT) {
    s.w1[e] = e < D * H ? w.W1[(size_t)m * D * H + e] : 0.f;
    if (W1f != nullptr) s.w1f[e] = e < D * H ? W1f[(size_t)m * D * H + e] : 0.f;
  }
  for (int e = tid; e < H; e += NT) {
    s.b1[e] = w.b1[(size_t)m * H + e];
    s.b2[e] = w.b2[(size_t)m * H + e];
  }
  for (int e = tid; e < XPM; e += NT) s.b3[e] = e < X ? w.b3[(size_t)m * X + e] : 0.f;
}

// Decode the chunk's points (s.g) with the staged decoder.  x[i][j]: output
// row qy + 8 i at point 4 qx + j (zero for rows >= X); m1/m2: ReLU masks of
// the hidden layers at the wide tile's (row ry + 16 i, point wide_p(px, j)) as
// bit i * 8 + j, the positions the chain's products produce.
template <int R>
__device__ void decode_T(TSmem& s, int D, int ni, float (&x)[8][4], uint32_t (&m1)[2],
                         uint32_t (&m2)[2]) {
  const int tid = threadIdx.x, px = tid & 15, ry = tid >> 4;
  m1[0] = m1[1] = m2[0] = m2[1] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ry + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = wide_p(px, j);
      float h = s.b1[k];
      for (int d = 0; d < D; ++d) h = h + s.g[p * DT + d] * s.w1[d * H + k];
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
  gemm_wide<R, true>(s.act, s.w2, S_W2, H, acc);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ry + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float h = fmaxf(acc[i][j] + s.b2[k], 0.f);
      const int bit = i * 8 + j;
      if (h > 0.f) m2[bit >> 5] |= 1u << (bit & 31);
      s.act[k * S_ACT + wide_p(px, j)] = pack<R>(h);
    }
  }
  __syncthreads();
  float acc3[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc3[i][j] = 0.f;
  gemm_narrow<R>(s.act, s.w3, ni, acc3);
  const int qy = tid >> 5;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = acc3[i][j] + s.b3[qy + 8 * i];
  __syncthreads();
}

// The chunk's points rows t0.. (clamped to row t_last) of splines b0..b0+3,
// GS values a point.
template <int GS, class S>
__device__ void load_chunk(S& s, const float* __restrict__ gamma, int B, int D, int t0,
                           int t_last, int b0) {
  for (int e = threadIdx.x; e < PC * GS; e += NT) {
    const int p = e / GS, d = e % GS;
    const int t = min(t0 + p / NS, t_last), b = min(b0 + p % NS, B - 1);
    s.g[e] = d < D ? gamma[((size_t)t * B + b) * D + d] : 0.f;
  }
}

// The generic decode's counterpart of TSmem: the same per-chunk state, the
// output rows padded to XMAX_ANY.
struct TSmemAny : AnySmem {
  float xb[XMAX_ANY * S_ACT];
  float red[8 * PC];
  float var[PC];
  float seg[PC];
  float edge[2][XMAX_ANY * NS];
  float edge_v[NS];
};

// The two decodes of the transposed kernels' bodies: the fixed decode_T
// (weights staged per decoder) and the generic decode_any read out to the
// narrow tile.  NI: the narrow tile's row groups (8 rows apart) a thread
// holds, XP: the widest padded output, GS: floats a point in s.g.
// tile(): element (i, j) of a running narrow tile (K10's xbar), in
// registers or, beside the generic decode, in the block's scratch.
struct TFixed {
  static constexpr bool kFixed = true;
  static constexpr int NI = 8, XP = XPM, GS = DT;
  using Smem = TSmem;
  struct Ctx {
    Weights w;
    const float* W1f;
  };
  __device__ static float& tile(float (&r)[NI][4], const Ctx&, int i, int j) { return r[i][j]; }
};
struct TAny {
  static constexpr bool kFixed = false;
  static constexpr int NI = XMAX_ANY / 8, XP = XMAX_ANY, GS = DMAX;
  using Smem = TSmemAny;
  struct Ctx {
    AnyCtx a;
    const float* W1f;
  };
  __device__ static float& tile(float (&)[NI][4], const Ctx& c, int i, int j) {
    return c.a.priv[(i * 4 + j) * NT + threadIdx.x];
  }
};

// decode_any of decoder m (masks to area `area`) read out to the narrow
// tile: x[i][j] = output row qy + 8 i at point 4 qx + j.
template <int R>
__device__ void decode_narrow_any(TSmemAny& s, const AnyCtx& c, int m, int area,
                                  float (&x)[TAny::NI][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, qx = tid & 31, qy = tid >> 5;
  float xw[8][NJA];
  decode_any<R>(s, c, m, area, xw);
  float* o = reinterpret_cast<float*>(s.act);
#pragma unroll
  for (int j = 0; j < NJA; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) o[(tx + 16 * j) * S_ACT + ty * 8 + i] = xw[i][j];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TAny::NI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = o[(qy + 8 * i) * S_ACT + 4 * qx + j];
  __syncthreads();
}

// K9 on the generic decode, pass 1: partial energy of every (spline, span)
// -> partial[g * B + b].
template <int R, class P>
__device__ __forceinline__ void k9_body(typename P::Smem& s, const typename P::Ctx& c,
                                        const float* __restrict__ gamma, int T, int B, int D,
                                        int M, int X, int span, int n_items,
                                        float* __restrict__ partial) {
  constexpr int NI = P::NI;
  const int tid = threadIdx.x, qx = tid & 31, qy = tid >> 5;
  const int ni = (X + 7) / 8, groups = (B + NS - 1) / NS;
  const float wm = 1.f / (float)M;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Span sp = span_of(item, groups, span, T);
    const int t_a = max(sp.t_s - 1, 0), t_b = sp.t_e;   // one carried-in point
    const int n_chunks = sp.t_s < T ? (t_b - t_a + RC - 1) / RC : 0;
    float e_acc = 0.f;                                   // thread tid < NS: spline b0 + tid
    for (int cc = 0; cc < n_chunks; ++cc) {
      const int t0 = t_a + cc * RC;
      __syncthreads();
      load_chunk<P::GS>(s, gamma, B, D, t0, t_b - 1, sp.b0);
      float yb[NI][4], sq[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sq[j] = 0.f;
#pragma unroll
        for (int i = 0; i < NI; ++i) yb[i][j] = 0.f;
      }
      for (int m = 0; m < M; ++m) {
        float x[NI][4];
        decode_narrow_any<R>(s, c.a, m, 0, x);
        float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i >= ni) continue;
          const int n = qy + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* xs = &s.xb[n * S_ACT + 4 * qx + j];
            if (m == 0) {
              *xs = x[i][j];
            } else {
              const float y = x[i][j] - *xs;
              yb[i][j] = yb[i][j] + wm * y;
              q[j] += y * y;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) sq[j] = sq[j] + wm * q[j];
      }
      // xbar = x0 + ybar (in place over x0); var = sqy - ||ybar||^2, summed
      // over the 8 row groups below in a fixed order
      float v[4] = {sq[0], sq[1], sq[2], sq[3]};
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if (i >= ni) continue;
        const int n = qy + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s.xb[n * S_ACT + 4 * qx + j] += yb[i][j];
          v[j] -= yb[i][j] * yb[i][j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) s.red[qy * PC + 4 * qx + j] = v[j];
      __syncthreads();
      if (tid < PC) {
        float vt = 0.f;
        for (int r8 = 0; r8 < 8; ++r8) vt += s.red[r8 * PC + tid];
        s.var[tid] = M > 1 ? vt : 0.f;
      }
      __syncthreads();
      if (tid < PC) {
        const int r = tid / NS, sl = tid % NS, t = t0 + r;
        float seg = 0.f;
        if (t < t_b && sp.b0 + sl < B && (r > 0 || cc > 0)) {
          float sd = 0.f;
          for (int n = 0; n < X; ++n) {
            const float prev = r > 0 ? s.xb[n * S_ACT + tid - NS] : s.edge[0][n * NS + sl];
            const float d = s.xb[n * S_ACT + tid] - prev;
            sd += d * d;
          }
          seg = (sd + s.var[tid]) + (r > 0 ? s.var[tid - NS] : s.edge_v[sl]);
        }
        s.seg[tid] = seg;
      }
      __syncthreads();
      if (tid < NS)
        for (int r = 0; r < RC; ++r) e_acc += s.seg[r * NS + tid];
      // carry the chunk's last row into the next chunk
      for (int e = tid; e < P::XP * NS; e += NT)
        s.edge[0][e] = s.xb[(e / NS) * S_ACT + (RC - 1) * NS + e % NS];
      if (tid < NS) s.edge_v[tid] = s.var[(RC - 1) * NS + tid];
    }
    if (tid < NS && sp.b0 + tid < B && sp.t_s < T) partial[(size_t)sp.g * B + sp.b0 + tid] = e_acc;
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k9_energy_spans_any(const float* __restrict__ gamma, int T, int B, int M, int span,
                    int n_items, AnyArgs a, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TSmemAny& s = *reinterpret_cast<TSmemAny*>(smem_raw);
  const TAny::Ctx c{any_begin(s, a), nullptr};
  k9_body<R, TAny>(s, c, gamma, T, B, s.dec.D, M, s.dec.X, span, n_items,
                   partial);
}

// K9, pass 2: fixed-order sum of the G span energies.
__global__ void k9_sum_spans(const float* __restrict__ partial, int G, int B,
                             float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float e = 0.f;
  for (int g = 0; g < G; ++g) e += partial[(size_t)g * B + b];
  out[b] = e;
}

// K10: dgamma of sum_b ct_b E_b, one launch, one decode per point and decoder.
template <int R, class P>
__device__ __forceinline__ void k10_body(typename P::Smem& s, const typename P::Ctx& c,
                                         const float* __restrict__ gamma, int T, int B, int D,
                                         int M, int X, int span, int n_items,
                                         const float* __restrict__ ct,
                                         float4* __restrict__ xs_scr, uint4* __restrict__ mk_scr,
                                         float4* __restrict__ xb_scr,
                                         float* __restrict__ dgamma) {
  constexpr int C = CHAIN_RUNG<R>;
  constexpr int NI = P::NI;
  const int tid = threadIdx.x, qx = tid & 31, qy = tid >> 5, px = tid & 15, ry = tid >> 4;
  const int ni = (X + 7) / 8, groups = (B + NS - 1) / NS;
  const float wm = 1.f / (float)M;
  const float sc2 = __fmul_rn(2.f, wm);
  // this block's scratch: decoder outputs [buf][m][i][tid], masks [buf][m][tid]
  // (the fixed decode; the generic one keeps area buf * M + m of its own),
  // the chunk's xbar [i][tid]
  float4* xs = xs_scr + (size_t)blockIdx.x * 2 * M * ni * NT;
  uint4* mk = mk_scr + (size_t)blockIdx.x * 2 * M * NT;
  float4* xbs = xb_scr + (size_t)blockIdx.x * ni * NT;
  int staged = -1;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Span sp = span_of(item, groups, span, T);
    const int t_a = max(sp.t_s - 1, 0), t_b = min(sp.t_e + 1, T);   // one extra point each side
    const int n_chunks = sp.t_s < T ? (t_b - t_a + RC - 1) / RC : 0;
    for (int cc = 0; cc <= n_chunks && n_chunks > 0; ++cc) {
      const int buf = cc & 1;
      // ---- decode chunk cc, keep every decoder's output and masks ----
      if (cc < n_chunks) {
        __syncthreads();
        load_chunk<P::GS>(s, gamma, B, D, t_a + cc * RC, t_b - 1, sp.b0);
        float xb[NI][4];
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) P::tile(xb, c, i, j) = 0.f;
        for (int m = 0; m < M; ++m) {
          float x[NI][4];
          uint32_t m1[2], m2[2];
          if constexpr (P::kFixed) {
            if (m != staged) {
              __syncthreads();
              stage_T<R>(s, m, D, X, c.w, c.W1f);
              staged = m;
            }
            __syncthreads();
            decode_T<R>(s, D, ni, x, m1, m2);
          } else {
            decode_narrow_any<R>(s, c.a, m, buf * M + m, x);
          }
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (i >= ni) continue;
            xs[((size_t)(buf * M + m) * ni + i) * NT + tid] =
                make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
#pragma unroll
            for (int j = 0; j < 4; ++j) P::tile(xb, c, i, j) = P::tile(xb, c, i, j) + wm * x[i][j];
          }
          if constexpr (P::kFixed)
            mk[(size_t)(buf * M + m) * NT + tid] = make_uint4(m1[0], m1[1], m2[0], m2[1]);
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i >= ni) continue;
          xbs[(size_t)i * NT + tid] = make_float4(P::tile(xb, c, i, 0), P::tile(xb, c, i, 1),
                                                  P::tile(xb, c, i, 2), P::tile(xb, c, i, 3));
          // row 0 of this chunk: the right neighbour of chunk cc-1's last row
          if (qx == 0)
#pragma unroll
            for (int j = 0; j < 4; ++j) s.edge[1][(qy + 8 * i) * NS + j] = P::tile(xb, c, i, j);
        }
      }
      // ---- emit dgamma of chunk cc-1 ----
      if (cc > 0) {
        const int pb = buf ^ 1, t0 = t_a + (cc - 1) * RC;
        const int r = qx, t = t0 + r;                       // the narrow tile's row
        const bool row_out = t >= sp.t_s && t < sp.t_e;
        const bool has_l = t > 0, has_r = t < T - 1;
        const float cl = (float)((int)has_l + (int)has_r);
        float q[8][DT];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int d = 0; d < DT; ++d) q[j][d] = 0.f;
        if constexpr (!P::kFixed)
          for (int e = tid; e < PC * DMAX; e += NT) s.dg[e] = 0.f;
        __syncthreads();
        for (int mm = 0; mm < M; ++mm) {
          const int m = M - 1 - mm;                          // reuse the staged decoder
          if constexpr (P::kFixed) {
            if (m != staged) {
              __syncthreads();
              stage_T<R>(s, m, D, X, c.w, c.W1f);
              staged = m;
              __syncthreads();
            }
          }
          // dx -> act[n][p] at the chain rung
#pragma unroll
          for (int i = 0; i < NI; ++i) {
            if (i >= ni) continue;
            const int n = qy + 8 * i;
            const float4 xv = xs[((size_t)(pb * M + m) * ni + i) * NT + tid];
            const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = 4 * qx + j, b = sp.b0 + j;
              float v = 0.f;
              if (row_out && b < B) {
                const float left =
                    has_l ? (r > 0 ? s.xb[n * S_ACT + p - NS] : s.edge[0][n * NS + j]) : 0.f;
                const float right =
                    has_r ? (r < RC - 1 ? s.xb[n * S_ACT + p + NS] : s.edge[1][n * NS + j]) : 0.f;
                const float sc = __fmul_rn(sc2, ct[b]);
                v = __fmul_rn(sc, __fsub_rn(__fsub_rn(__fmul_rn(cl, xr[j]), left), right));
              }
              s.act[n * S_ACT + p] = pack<C>(v);
            }
          }
          if constexpr (P::kFixed) {
            const uint4 mv = mk[(size_t)(pb * M + m) * NT + tid];
            const uint32_t m1[2] = {mv.x, mv.y}, m2[2] = {mv.z, mv.w};
            __syncthreads();
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
            gemm_wide<C, false>(s.act, s.w3, S_W3T, 8 * ni, acc);   // dh2 = W3 . dx
            __syncthreads();
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int bit = i * 8 + j;
                const float v = (m2[bit >> 5] >> (bit & 31)) & 1u ? acc[i][j] : 0.f;
                s.act[(ry + 16 * i) * S_ACT + wide_p(px, j)] = pack<C>(v);
                acc[i][j] = 0.f;
              }
            __syncthreads();
            gemm_wide<C, false>(s.act, s.w2, S_W2, H, acc);         // dh1 = W2 . dh2
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int k = ry + 16 * i;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int bit = i * 8 + j;
                const float v = (m1[bit >> 5] >> (bit & 31)) & 1u ? acc[i][j] : 0.f;
#pragma unroll
                for (int d = 0; d < DT; ++d) q[j][d] += v * s.w1f[d * H + k];
              }
            }
          } else {
            __syncthreads();
            chain_any<C>(s, c.a, m, pb * M + m, c.W1f);
          }
          __syncthreads();
        }
        if constexpr (P::kFixed) {
          // dgamma: sum of the 16 wide row groups in a fixed order
          float* red = reinterpret_cast<float*>(s.act);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int d = 0; d < DT; ++d) red[(ry * PC + wide_p(px, j)) * DT + d] = q[j][d];
          __syncthreads();
          for (int e = tid; e < PC * D; e += NT) {
            const int p = e / D, d = e % D;
            float v = 0.f;
            for (int r16 = 0; r16 < 16; ++r16) v += red[(r16 * PC + p) * DT + d];
            const int tp = t0 + p / NS, b = sp.b0 + p % NS;
            if (tp >= sp.t_s && tp < sp.t_e && b < B) dgamma[((size_t)tp * B + b) * D + d] = v;
          }
        } else {
          for (int e = tid; e < PC * D; e += NT) {
            const int p = e / D, d = e % D;
            const int tp = t0 + p / NS, b = sp.b0 + p % NS;
            if (tp >= sp.t_s && tp < sp.t_e && b < B)
              dgamma[((size_t)tp * B + b) * D + d] = s.dg[p * DMAX + d];
          }
        }
      }
      // ---- rotate: left carry <- chunk cc-1's last row; xbar <- chunk cc's ----
      if (cc < n_chunks) {
        __syncthreads();
        for (int e = tid; e < P::XP * NS; e += NT)
          s.edge[0][e] = s.xb[(e / NS) * S_ACT + (RC - 1) * NS + e % NS];
        __syncthreads();
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          if (i >= ni) continue;
          const float4 v = xbs[(size_t)i * NT + tid];
          float* row = &s.xb[(qy + 8 * i) * S_ACT + 4 * qx];
          row[0] = v.x;
          row[1] = v.y;
          row[2] = v.z;
          row[3] = v.w;
        }
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k10_dgamma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int span,
           int n_items, Weights w, const float* __restrict__ W1f, const float* __restrict__ ct,
           float4* __restrict__ xs_scr, uint4* __restrict__ mk_scr, float4* __restrict__ xb_scr,
           float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  k10_body<R, TFixed>(*reinterpret_cast<TSmem*>(smem_raw), TFixed::Ctx{w, W1f}, gamma, T, B, D,
                      M, X, span, n_items, ct, xs_scr, mk_scr, xb_scr, dgamma);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k10_dgamma_any(const float* __restrict__ gamma, int T, int B, int M, int span, int n_items,
               AnyArgs a, const float* __restrict__ W1f, const float* __restrict__ ct,
               float4* __restrict__ xs_scr, float4* __restrict__ xb_scr,
               float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TSmemAny& s = *reinterpret_cast<TSmemAny*>(smem_raw);
  const TAny::Ctx c{any_begin(s, a), W1f};
  k10_body<R, TAny>(s, c, gamma, T, B, s.dec.D, M, s.dec.X, span, n_items,
                    ct, xs_scr, nullptr, xb_scr, dgamma);
}

// K10 at the reduced rungs on the tensor cores (production shape): the
// one-pass body of onepass_mma.cuh, K2's, on the uniform weight plane, the
// dgamma product with float32 W1 (W1f; at the bfloat16 rung the decode takes
// the shipped, bf16-rounded W1).
__global__ void t_prep_planes(const float* __restrict__ W2, const float* __restrict__ W3, int M,
                              int X, __nv_bfloat16* __restrict__ planes) {
  prep_planes(W2, W3, M, X, planes);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
k10_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int span,
        int n_items, Weights w, const float* __restrict__ W1f, const float* __restrict__ wmb,
        const float* __restrict__ ct, float4* __restrict__ xs_scr, uint4* __restrict__ mk_scr,
        const __nv_bfloat16* __restrict__ planes, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  onepass_body<R>(*reinterpret_cast<OnePassSmem*>(smem_raw), gamma, T, B, D, M, X, span,
                  n_items, w, W1f, wmb, ct, xs_scr, mk_scr, planes, dgamma);
}

// Rows of K9's partial-energy buffer: K1's float32 tiles of 127 segments,
// the tensor-core tiles of 31, or the G spans of the generic kernels.
int k9_tiles(int rung, int T, int G, bool fixed) {
  if (!fixed) return G;
  if (rung == F32) return k1f_tiles(T);
  return tile_rows(T);
}

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, Weights w,
                       const float* wmb, float* w3p, float* partial, float* out,
                       cudaStream_t st) {
  const int n_tiles = k9_tiles(R, T, 0, true);
  cudaError_t err;
  if constexpr (R == F32) {  // K1's float32 kernel on the uniform weight plane
    if (!f32_aligned(w)) return cudaErrorMisalignedAddress;
    err = f32_prepare_w3(w.W3, M, X, w3p, st);
    if (err == cudaSuccess) err = prepare<K1F32Smem>(k1_fwd_fma<R>);
    if (err != cudaSuccess) return err;
    k1_fwd_fma<R><<<dim3(B, n_tiles), NT, sizeof(K1F32Smem), st>>>(
        gamma, T, B, D, M, X, F32Weights{w, w3p}, wmb, partial);
  } else {  // K1's tensor-core kernel (tiles_mma.cuh) on the uniform weight plane
    err = prepare<K1MmaSmem>(k1_tiles_mma<R>);
    if (err != cudaSuccess) return err;
    k1_tiles_mma<R><<<dim3((B + TILE_NS - 1) / TILE_NS, n_tiles), NT, sizeof(K1MmaSmem), st>>>(
        gamma, T, B, D, M, X, w, wmb, partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k9_sum_spans<<<(B + 127) / 128, 128, 0, st>>>(partial, n_tiles, B, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, int span, int G,
                       int n_blocks, Weights w, const float* W1f, const float* wmb,
                       const float* ct, float* xs_scr, unsigned int* mk_scr, float* xb_scr,
                       __nv_bfloat16* planes, float* dgamma, cudaStream_t st) {
  if constexpr (R == F32) {  // CUDA-core FMAs (TF32 is barred)
    const cudaError_t err = prepare<TSmem>(k10_dgamma<R>);
    if (err != cudaSuccess) return err;
    k10_dgamma<R><<<n_blocks, NT, sizeof(TSmem), st>>>(
        gamma, T, B, D, M, X, span, G * ((B + NS - 1) / NS), w, W1f, ct,
        reinterpret_cast<float4*>(xs_scr), reinterpret_cast<uint4*>(mk_scr),
        reinterpret_cast<float4*>(xb_scr), dgamma);
    return cudaGetLastError();
  } else {  // tensor cores (onepass_mma.cuh)
    return launch_onepass<R>(t_prep_planes, k10_mma<R>, gamma, T, B, D, M, X, span, G,
                             n_blocks, w, W1f, wmb, ct, reinterpret_cast<float4*>(xs_scr),
                             reinterpret_cast<uint4*>(mk_scr), planes, dgamma, st);
  }
}

template <int R>
cudaError_t launch_fwd_any(const float* gamma, int T, int B, int M, int span, int G,
                           int n_blocks, const AnyArgs& a, float* partial, float* out,
                           cudaStream_t st) {
  cudaError_t err = prepare<TSmemAny>(k9_energy_spans_any<R>);
  if (err != cudaSuccess) return err;
  const int n_items = G * ((B + NS - 1) / NS);
  k9_energy_spans_any<R><<<n_blocks, NT, sizeof(TSmemAny), st>>>(gamma, T, B, M, span, n_items,
                                                                 a, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k9_sum_spans<<<(B + 127) / 128, 128, 0, st>>>(partial, G, B, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_any(const float* gamma, int T, int B, int M, int span, int G,
                           int n_blocks, const AnyArgs& a, const float* W1f, const float* ct,
                           float* xs_scr, float* xb_scr, float* dgamma, cudaStream_t st) {
  cudaError_t err = prepare<TSmemAny>(k10_dgamma_any<R>);
  if (err != cudaSuccess) return err;
  const int n_items = G * ((B + NS - 1) / NS);
  k10_dgamma_any<R><<<n_blocks, NT, sizeof(TSmemAny), st>>>(
      gamma, T, B, M, span, n_items, a, W1f, ct, reinterpret_cast<float4*>(xs_scr),
      reinterpret_cast<float4*>(xb_scr), dgamma);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Curve rows a span's chunk adds (its halo rows aside) in the kernel that
// this rung, decoder and direction (bwd: K10) run: the tensor-core K10's
// tiles own 31 of their 32 rows, every other kernel's chunks 32.
int vlg_t_chunk_rows(int rung, int L, const int* widths, int bwd) {
  Decoder d;
  if (L != 3 || !make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  return bwd && rung != F32 && fixed_shape(d) && d.D <= DT ? TILE_KR : RC;
}

// Scratch sizes of K10 per block, in 32-bit words: decoder outputs, masks
// (the fixed decode's), the chunk's xbar.
int vlg_t_scratch_words(int M, int X, int which) {
  if (which == 0) return (int)onepass_xs_words(M, X);
  if (which == 1) return (int)onepass_mk_words(M);
  return (X + 7) / 8 * NT * 4;
}

// 32-bit words of the tensor-core K10's prepared weight planes (all of them,
// not per block).
int vlg_t_plane_words(int M) { return (int)onepass_plane_words(M); }

// Rows of K9's (rows, B) partial-energy buffer in the kernel that this rung
// and decoder run, with G spans per spline in the generic kernels.
int vlg_t_fwd_rows(int rung, int T, int G, int L, const int* widths) {
  Decoder d;
  if (L != 3 || !make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  return k9_tiles(rung, T, G, fixed_shape(d) && d.D <= DT);
}

// The decoder as arrays, as vlg_energy_fwd (energy_expected.cu); three
// layers.  K9 on the production decoder takes wmb, the uniform (M, B)
// weight plane, and at float32 `scratch` of vlg_f32_scratch_words floats
// (K1's float32 kernel); the generic kernels' scratch (any_scr for K10) is
// vlg_any_head_words(3) + n_blocks x vlg_any_scratch_words(3, widths, n)
// words, n = 1 for K9 and 2 M for K10 (every decoder's masks of two
// chunks).  K10 at a reduced rung on the production decoder takes the
// uniform weight plane too (K2's body) and `planes` of vlg_t_plane_words.
int vlg_energy_t_fwd(int rung, const float* gamma, int T, int B, int M, int span, int G,
                     int n_blocks, int L, const int* widths, const float* const* Ws,
                     const float* const* bs, const float* wmb, float* partial, float* out,
                     void* scratch, void* stream) {
  Decoder d;
  if (L != 3 || !make_decoder(L, widths, Ws, bs, d) || d.D > DT)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 1, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d) ? launch_fwd<R>(gamma, T, B, D, M, X, fixed_weights(d), wmb,
                                          static_cast<float*>(scratch), partial, out, st)
                          : launch_fwd_any<R>(gamma, T, B, M, span, G, n_blocks, a, partial,
                                              out, st);
  });
}

int vlg_energy_t_bwd(int rung, const float* gamma, int T, int B, int M, int span, int G,
                     int n_blocks, int L, const int* widths, const float* const* Ws,
                     const float* const* bs, const float* W1f, const float* wmb,
                     const float* ct, float* xs_scr, unsigned int* mk_scr, float* xb_scr,
                     void* any_scr, float* dgamma, void* planes, void* stream) {
  Decoder d;
  if (L != 3 || !make_decoder(L, widths, Ws, bs, d) || d.D > DT)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, any_scr, 2 * M, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    return fixed_shape(d) ? launch_bwd<R>(gamma, T, B, D, M, X, span, G, n_blocks,
                                          fixed_weights(d), W1f, wmb, ct, xs_scr, mk_scr, xb_scr,
                                          static_cast<__nv_bfloat16*>(planes), dgamma, st)
                          : launch_bwd_any<R>(gamma, T, B, M, span, G, n_blocks, a, W1f, ct,
                                              xs_scr, xb_scr, dgamma, st);
  });
}

}  // extern "C"
