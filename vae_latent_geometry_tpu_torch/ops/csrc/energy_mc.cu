// Monte-Carlo (sampled) ensemble curve energy and its gradient, for sm_90a
// (H100).
//
// Replaces the Pallas TPU kernels of
// vae_latent_geometry_tpu/ops/energy_mc_pallas.py:
//   K5  _fwd_kernel      (:473)  -> mc_fwd_fma (float32) or mc_tiles_mma
//       (f32x3, f32x2, bfloat16; K1's tiles, tiles_mma.cuh), + mc_sum_tiles,
//       planes given
//   K6  _bwd_kernel      (:548)  -> mc_select_planes + mc_chain_onepass
//       (f32x3, f32x2, bfloat16, S <= mc_onepass_cap; onepass_mma.cuh) or
//       mc_select_mma + mc_chain_mma (above the cap), mc_segments (writing
//       differences) + mc_chain (float32)
//   K7  _fwd_kernel_rng  (:166)  -> K5 with the draws made in the kernel
//   K8  _bwd_kernel_rng  (:235)  -> K6 with the draws made in the kernel
//
// Function.  The decoder ensemble is M ReLU MLPs D -> 128 -> 128 -> X applied
// to every curve point gamma[t, b, :] (T, B, D).  Sample s of S draws, per
// segment t and spline b, a decoder d1[s,t,b] for the segment's left end
// (point t) and d2[s,t,b] for its right end (point t+1):
//   diff_s(t) = x_{d2[s,t,b]}(t+1) - x_{d1[s,t,b]}(t)
//   K5/K7: E_b = (1/S) sum_s sum_t ||diff_s(t)||^2
//   K6/K8: dgamma for a per-spline cotangent ct_b:
//       dx_m(t) = (2/S) ct_b sum_s ([d2[s,t-1,b] = m] diff_s(t-1)
//                                   - [d1[s,t,b] = m] diff_s(t)),
//       back-propagated through the ReLU masks of decoder m's decode.
// Point 0 has no left segment and point T-1 no right one.  Any S >= 1: the
// backward kernels stage the draws in sweeps of at most SMAX (CUDA cores)
// or SMAX_MMA (tensor cores) samples.
//
// Draws.  K5/K6 read int32 planes d1, d2 (S, T-1, B).  K7/K8 make them:
// Philox4x32-10 keyed by the step's 64-bit seed, counter (t, b, j / 4, 0)
// for plane j in [0, 2S) (d1 planes first), output word j % 4; then, as the
// TPU kernels map bits to a decoder, u = (bits >> 8) * 2^-24 and
// d = floor(u * kmax_b) in fp32, with kmax_b the spline's count of active
// decoders.  A draw depends on (seed, plane, t, b) alone, so forward and
// backward see the same draws whatever their tiling, and the planes can be
// reproduced outside the kernel bit for bit (philox_draws in
// ops/energy_mc_fused.py): K7 equals K5 on those planes exactly.
//
// Selection is exact: a selected endpoint is copied from its decoder's output
// by a predicated update, never formed as a weighted sum, so diff_s(t) is the
// fp32 difference of two decoder outputs whichever decoder comes first.
//
// Work (counted from the code, per point per decoder): the float32 decode is
// 46 kFLOP at D=2, X=50 (energy_expected.cu), i.e. 1.8e11 FLOP per K5 call at
// T=2000, B=200, M=10.  K6 at f32x2 is one two-pass decode (two above the
// one-decode route's cap) plus a single-pass chain.  The index planes (6.4
// MB at S=2) and the two-pass routes' planes of endpoints or differences
// (320 or 160 MB at S=2, written and read once) are small beside that: all
// four kernels are bound by operations, not bytes, on this card.
//
// Design for Hopper.  The TPU kernels stream T in chunks inside one program
// with a one-row carry; here blocks run in no order.  mc_segments (the
// float32 backward's first pass, and on the generic decode the forward
// too) gives each group of 16 threads a run of 8 consecutive t-rows of one
// spline, so that the 7 segments inside the run are formed in the thread's
// own registers (the 8th row is the next run's first: 8 rows decoded per 7
// segments).  A tile is 4 splines x 4 runs = 28 segments per spline.  The
// draws of the tile are staged in shared memory once; per decoder (weights
// staged one at a time, decode_common.cuh) each thread updates its
// difference registers where a draw names that decoder.  Two samples are
// held per decode sweep (56 registers); more samples take further sweeps.
// Energies go to an (n_tiles, B) buffer of per-tile partial sums that a
// second launch adds in a fixed order: no float atomics, repeated runs are
// bitwise identical.  At the reduced rungs the forward is mc_tiles_mma on
// the tensor cores instead (below): K1's tiles of 32 rows x 4 splines,
// every drawn decoder decoded once a sweep of samples, the differences in
// shared memory.
// The backward is two launches.  At float32: mc_segments writes the S
// difference planes (S, T-1, B, X), then mc_chain re-decodes each decoder
// per tile of 128 points, gathers dx from the planes and runs the masked
// chain.  At the reduced rungs, up to mc_onepass_cap samples (3 at X = 50),
// K2's one-pass body decodes each (point, decoder) once (mc_chain_onepass
// after mc_select_planes, below).  Above the cap both passes run on the
// tensor cores (mma.sync m16n8k16 bf16, decode_mma.cuh) over flat tiles of
// 128 points of the (T*B) curve, a warp's 16 points in the C-fragment
// layout:
// mc_select_mma copies, where a draw names the decoder, the decoded point
// into the endpoint planes L_s(t) = x_{d1[s,t]}(t) and R_s(t) =
// x_{d2[s,t-1]}(t) (2S, T, B, X; no accumulators, no halo rows), and
// mc_chain_mma forms dx in registers from diff_s(t) = R_s(t+1) - L_s(t),
// the same single fp32 subtraction as mc_segments', in the same per-sample
// order, then runs chain_mma.  Both decode, so this route decodes twice.
//
// At float32 the forward is mc_fwd_fma on decode_f32.cuh instead: selective
// decode (only the (point, decoder) pairs that the draws name, 3.44 of 10 a
// point at S=2), the differences of every sample in shared memory, so one
// decode of a point serves all its samples (below).
//
// Any decoder.  The kernels above take the production shape D <= 4 -> 128 ->
// 128 -> X <= 64; every other decoder (2 to 6 layers, hidden widths up to
// 512, X <= 128) takes mc_segments_any and mc_chain_any: the same bodies
// (segments_body, chain_body) over the generic decode of decode_any.cuh, in
// persistent blocks, one sample per decode sweep (8 output columns a thread
// leave no registers for a second).

#include <algorithm>
#include <cmath>

#include "decode_any.cuh"
#include "decode_common.cuh"
#include "decode_f32.cuh"
#include "decode_mma.cuh"
#include "onepass_mma.cuh"
#include "tiles_mma.cuh"

namespace {

constexpr int MC_COLS = 4;                       // splines per tile
constexpr int MC_RUN = 8;                        // t-rows a thread group decodes
constexpr int MC_SEGS = MC_RUN - 1;              // segments it owns
constexpr int MC_RUNS = TP / MC_RUN / MC_COLS;   // runs per spline per tile
constexpr int MC_TILE_SEGS = MC_RUNS * MC_SEGS;  // segments per spline per tile
constexpr int SMAX = 8;                          // samples a backward sweep stages

template <class Base>
struct McSmemOf : Base {
  int idx[2 * SMAX * TP];   // the tile's draws, -1 where there is no segment
  float red[TP];            // mc_segments: energy of the segment after point p
};
using McSmem = McSmemOf<DecodeSmem>;
using McSmemAny = McSmemOf<AnySmem>;

// The tensor-core pair's: one decoder's bf16 planes and the sweep's draws,
// of up to SMAX_MMA samples (the planes leave room for more than SMAX).
constexpr int SMAX_MMA = 32;
struct McMmaSmem : MmaSmem {
  int idx[2 * SMAX_MMA * TP];
};

// Where the draws come from: planes in device memory (d1 != nullptr) or the
// counter-based generator.
struct Draws {
  const int *d1, *d2;       // (S, T-1, B)
  const float* kmax;        // (B,) active decoders per spline
  uint32_t key0, key1;      // the step's seed
  int b_base;               // global index of spline 0 (the draws' counter)
};

__device__ uint32_t philox4x32_10(uint32_t k0, uint32_t k1, uint32_t c0, uint32_t c1,
                                  uint32_t c2, uint32_t c3, int word) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c2 = hi0 ^ c3 ^ k1;
    c1 = lo1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return word == 0 ? c0 : word == 1 ? c1 : word == 2 ? c2 : c3;
}

// Decoder drawn for the left (side 0) or right (side 1) end of segment t of
// spline b in sample smp.
__device__ int draw(const Draws& dr, int S, int T, int B, int side, int smp, int t, int b) {
  if (dr.d1 != nullptr)
    return (side ? dr.d2 : dr.d1)[((size_t)smp * (T - 1) + t) * B + b];
  const int j = side * S + smp;
  const uint32_t bits = philox4x32_10(dr.key0, dr.key1, (uint32_t)t, (uint32_t)(b + dr.b_base),
                                      (uint32_t)(j >> 2), 0u, j & 3);
  const float k = dr.kmax[b];
  const float u = __fmul_rn((float)(bits >> 8), 1.f / 16777216.f);
  return min((int)floorf(__fmul_rn(u, k)), (int)k - 1);
}

// Stage the draws of samples s0 .. s0+sw-1 (sw <= CAP) for the backward's
// tile of TP points from p0 of the flattened (T*B) curve: idx[(side * CAP +
// k) * TP + p] holds, for sample s0 + k, d1 of the segment after point p
// (side 0) or d2 of the segment before it (side 1); -1 where there is none.
template <int CAP>
__device__ void stage_draws(int* idx, const Draws& dr, int S, int T, int B, int p0, int s0,
                            int sw) {
  const int N = T * B;
  for (int e = threadIdx.x; e < 2 * sw * TP; e += NT) {
    const int p = e % TP, q = e / TP, side = q / sw, k = q % sw;
    const int pg = p0 + p, t = pg / B, b = pg % B;
    int v = -1;
    if (pg < N && side == 0 && t < T - 1) v = draw(dr, S, T, B, 0, s0 + k, t, b);
    if (pg < N && side == 1 && t > 0) v = draw(dr, S, T, B, 1, s0 + k, t - 1, b);
    idx[(side * CAP + k) * TP + p] = v;
  }
}

// f(s0, sw) for each sweep of sw <= CAP samples from s0.  Where S <= CAP the
// caller staged the draws once, before its decoder loop; else each sweep
// stages its own, between barriers.
template <int CAP, class F>
__device__ __forceinline__ void for_sweeps(int* idx, const Draws& dr, int S, int T, int B,
                                           int p0, F&& f) {
  for (int s0 = 0; s0 < S; s0 += CAP) {
    const int sw = min(CAP, S - s0);
    if (S > CAP) {
      __syncthreads();
      stage_draws<CAP>(idx, dr, S, T, B, p0, s0, sw);
      __syncthreads();
    }
    f(s0, sw);
  }
}

// Pass 1 of both directions.  Tile (by: segments t0..t0+27, bx: splines
// b0..b0+3).  diffs == nullptr: per-tile partial energies -> partial[by * B
// + b]; else the difference planes -> diffs.  P::SLOTS samples per decode
// sweep.
template <int R, class P>
__device__ __forceinline__ void segments_body(McSmemOf<typename P::Smem>& s,
                                              const typename P::Ctx& c, int bx, int by,
                                              const float* __restrict__ gamma, int T, int B,
                                              int D, int M, int X, int S, Draws dr,
                                              float* __restrict__ partial,
                                              float* __restrict__ diffs) {
  constexpr int NJ = P::NJX, SLOTS = P::SLOTS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = by * MC_TILE_SEGS, b0 = bx * MC_COLS;
  // point p = run * 8 + i: row i of run (p / 8), which is run (p / 8) /
  // MC_COLS of spline b0 + (p / 8) % MC_COLS
  load_points_by<P>(s, c, gamma, D, [&](int p) {
    const int run = p / MC_RUN, i = p % MC_RUN;
    const int t = min(t0 + (run / MC_COLS) * MC_SEGS + i, T - 1);
    const int b = min(b0 + run % MC_COLS, B - 1);
    return (size_t)t * B + b;
  });
  if (tid < TP) s.red[tid] = 0.f;
  const int tb = t0 + (ty / MC_COLS) * MC_SEGS;   // this thread's first row
  const int b = b0 + ty % MC_COLS;                // and its spline
  for (int s0 = 0; s0 < S; s0 += SLOTS) {
    __syncthreads();
    // stage the sweep's draws: idx[(side * SLOTS + slot) * TP + p] for the
    // segment from point p to point p + 1
    for (int e = tid; e < 2 * SLOTS * TP; e += NT) {
      const int p = e % TP, q = e / TP, side = q / SLOTS, smp = s0 + q % SLOTS;
      const int run = p / MC_RUN, i = p % MC_RUN;
      const int tt = t0 + (run / MC_COLS) * MC_SEGS + i, bb = b0 + run % MC_COLS;
      const bool ok = i < MC_SEGS && tt < T - 1 && bb < B && smp < S;
      s.idx[e] = ok ? draw(dr, S, T, B, side, smp, tt, bb) : -1;
    }
    float diff[SLOTS][MC_SEGS][NJ];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
#pragma unroll
      for (int i = 0; i < MC_SEGS; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) diff[k][i][j] = 0.f;
    for (int m = 0; m < M; ++m) {
      float x[8][NJ];
      typename P::Masks mk;
      P::template decode<R>(s, c, m, D, X, x, mk);
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
#pragma unroll
        for (int i = 0; i < MC_SEGS; ++i) {
          const int p = ty * MC_RUN + i;
          const bool lo = s.idx[k * TP + p] == m;
          const bool hi = s.idx[(SLOTS + k) * TP + p] == m;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (hi) diff[k][i][j] = __fadd_rn(diff[k][i][j], x[i + 1][j]);
            if (lo) diff[k][i][j] = __fsub_rn(diff[k][i][j], x[i][j]);
          }
        }
    }
    if (diffs != nullptr) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
#pragma unroll
        for (int i = 0; i < MC_SEGS; ++i) {
          if (s0 + k >= S || tb + i >= T - 1 || b >= B) continue;
          float* row = diffs + (((size_t)(s0 + k) * (T - 1) + tb + i) * B + b) * X;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (tx + 16 * j < X) row[tx + 16 * j] = diff[k][i][j];
        }
    } else {
      // features >= X decode to zero, so their differences are zero
#pragma unroll
      for (int i = 0; i < MC_SEGS; ++i) {
        float q = 0.f;
#pragma unroll
        for (int k = 0; k < SLOTS; ++k)
#pragma unroll
          for (int j = 0; j < NJ; ++j) q += diff[k][i][j] * diff[k][i][j];
        q = sum16(q);
        if (tx == 0) s.red[ty * MC_RUN + i] += q;
      }
    }
  }
  __syncthreads();
  if (diffs == nullptr && tid < MC_COLS && b0 + tid < B) {
    float e = 0.f;
    for (int run = 0; run < MC_RUNS; ++run)
      for (int i = 0; i < MC_SEGS; ++i) e += s.red[(run * MC_COLS + tid) * MC_RUN + i];
    partial[(size_t)by * B + b0 + tid] = e;
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_segments(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
            Weights w, Draws dr, float* __restrict__ partial, float* __restrict__ diffs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  segments_body<R, FixedDecode>(*reinterpret_cast<McSmem*>(smem_raw), FixedDecode::Ctx{w},
                                blockIdx.x, blockIdx.y, gamma, T, B, D, M, X, S, dr, partial,
                                diffs);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_segments_any(const float* __restrict__ gamma, int T, int B, int M, int S, AnyArgs a,
                Draws dr, float* __restrict__ partial, float* __restrict__ diffs, int gx,
                int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McSmemAny& s = *reinterpret_cast<McSmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    segments_body<R, AnyDecode>(s, c, item % gx, item / gx, gamma, T, B, D, M, X, S, dr,
                                partial, diffs);
    __syncthreads();
  }
}

// K5/K7, pass 1, at float32 on the production decoder: selective decode.
// A block owns `segs` consecutive segments of ONE spline (rows t0 .. t0 +
// segs) and samples s0 .. s0 + sw - 1 of the S.  It stages those draws,
// marks the decoders they name, and for each marked decoder m lists the rows
// that need it (decoder m at row r where d1[s, t0+r] = m or d2[s, t0+r-1] =
// m: at most 2S of M) by a ballot prefix sum, then decodes only those rows,
// in chunks of 64 (decode_f32.cuh; the next decoder's list is built inside
// the chunk that is its decoder's last).  Each decoded point goes straight
// from the registers of its layer-3 tile into the per-sample differences in
// shared memory, diff[k][r][n] for sample s0 + k, 4 features a lane: first
// every -x_{d1}(t) update, then, after a barrier, every +x_{d2}(t+1) one,
// so each element is written by one lane at a time.  Each
// element receives exactly one subtraction and one addition from 0, so it
// ends as fl(R - L) whichever decoder comes first: the differences equal
// mc_segments' bit for bit, and one decode of a point serves every sample.
// The sum of squares over the block goes, in a fixed order, to partial[(z *
// gridDim.y + y) * B + b]; mc_sum_tiles adds the rows.  Tile and sweep sizes
// come from mc_f32_tile: about 56 expected rows per decoder list, as many
// segments as the differences leave room for.
constexpr int MCF_RMAX = NT;     // rows per tile: one per thread in the list scan
constexpr int MCF_SEGMIN = 16;   // fewer segments per tile: split the samples

using McLane = F32Lane<2>;
constexpr int MCF_FC = F32Smem<2>::FC;

struct McF32Smem : F32Smem<2> {
  float g[MCF_RMAX * DMAX];      // the tile's points
  int list[2][MCF_RMAX];         // rows of the current and the next decoder
  int wcnt[2][NT / 32];          // their warps' counts
  float red[NT / 32];
};
// dynamic tail: float diff[sw][segs][XP]; int idx[2][sw][segs]; uint32_t
// used[(M + 31) / 32].  XP = X rounded up to 4: a lane updates 4 features
// at a time; the padding features decode to 0 and stay 0.

struct McTile {
  int segs, sw, n_t, n_s;
  size_t smem;
};

size_t mc_f32_fixed(int M) { return sizeof(McF32Smem) + 4 * (size_t)((M + 31) / 32); }

McTile mc_f32_tile(int T, int M, int X, int S) {
  const size_t budget = SMEM_MAX - mc_f32_fixed(M);
  const double per = 4.0 * ((X + 3) & ~3) + 8.0;  // bytes per sample and segment
  // share of (row, decoder) pairs drawn with uniform decoder counts
  const double p = M > 1 ? 1.0 - std::pow(1.0 - 1.0 / M, 2.0 * S) : 1.0;
  int segs = std::min(MCF_RMAX - 1, std::max(1, (int)(56.0 / p)));
  segs = std::min(segs, std::max(MCF_SEGMIN, (int)(budget / (S * per))));
  segs = std::max(1, std::min(segs, T - 1));
  McTile t;
  t.segs = segs;
  t.sw = std::min(S, (int)(budget / (segs * per)));
  t.n_t = (T - 1 + segs - 1) / segs;
  t.n_s = (S + t.sw - 1) / t.sw;
  t.smem = mc_f32_fixed(M) + 4 * (size_t)t.sw * segs * (2 + ((X + 3) & ~3));
  return t;
}

__device__ __forceinline__ int next_used(const uint32_t* used, int m, int M) {
  for (int j = m + 1; j < M; ++j)
    if ((used[j >> 5] >> (j & 31)) & 1u) return j;
  return -1;
}

// The rows of the tile that need decoder m: row r (thread r) where a staged
// draw names it; before(): the warp's count, after() (past a barrier): the
// row at its offset.
struct McList {
  const int* idx;
  int* list;
  int* wcnt;
  int m, sw, segs;
  bool on;
  uint32_t ballot;
  __device__ void before() {
    if (!on) return;
    const int r = threadIdx.x;
    bool need = false;
    for (int k = 0; k < sw; ++k) {
      if (r < segs) need |= idx[k * segs + r] == m;
      if (r >= 1 && r <= segs) need |= idx[(sw + k) * segs + r - 1] == m;
    }
    ballot = __ballot_sync(0xffffffffu, need);
    if ((threadIdx.x & 31) == 0) wcnt[threadIdx.x >> 5] = __popc(ballot);
  }
  __device__ void after() {
    if (!on) return;
    const int lane = threadIdx.x & 31;
    if (!((ballot >> lane) & 1u)) return;
    int off = __popc(ballot & ((1u << lane) - 1u));
    for (int v = 0; v < (int)(threadIdx.x >> 5); ++v) off += wcnt[v];
    list[off] = threadIdx.x;
  }
};

__device__ __forceinline__ int list_len(const int* wcnt) {
  int n = 0;
  for (int v = 0; v < NT / 32; ++v) n += wcnt[v];
  return n;
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_fwd_fma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
           F32Weights fw, Draws dr, int segs, int sw, float* __restrict__ partial) {
  static_assert(R == F32, "the float32 rung only");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McF32Smem& s = *reinterpret_cast<McF32Smem*>(smem_raw);
  const int XP = (X + 3) & ~3;
  float* diff = reinterpret_cast<float*>(smem_raw + sizeof(McF32Smem));
  int* idx = reinterpret_cast<int*>(diff + sw * segs * XP);
  uint32_t* used = reinterpret_cast<uint32_t*>(idx + 2 * sw * segs);
  const int tid = threadIdx.x, b = blockIdx.x;
  const int t0 = blockIdx.y * segs, s0 = blockIdx.z * sw, nsw = min(sw, S - s0);
  const int rows = segs + 1;
  for (int e = tid; e < (M + 31) / 32; e += NT) used[e] = 0u;
  for (int e = tid; e < sw * segs * XP; e += NT) diff[e] = 0.f;
  for (int e = tid; e < rows * DMAX; e += NT) {
    const int r = e / DMAX, d = e % DMAX;
    s.g[e] = d < D ? gamma[((size_t)min(t0 + r, T - 1) * B + b) * D + d] : 0.f;
  }
  f32_zero_pads(s, X);
  __syncthreads();
  // idx[(side * sw + k) * segs + r]: d1 (side 0) or d2 (side 1) of segment
  // t0 + r in sample s0 + k; -1 past the curve or the samples
  for (int e = tid; e < 2 * sw * segs; e += NT) {
    const int r = e % segs, q = e / segs, side = q / sw, k = q % sw, t = t0 + r;
    const int v = k < nsw && t < T - 1 ? draw(dr, S, T, B, side, s0 + k, t, b) : -1;
    idx[e] = v;
    if (v >= 0 && v < M) atomicOr(&used[v >> 5], 1u << (v & 31));
  }
  __syncthreads();
  const int first = next_used(used, -1, M);
  if (first < 0) {  // no segment in the tile: nothing to sum
    if (tid == 0) partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * B + b] = 0.f;
    return;
  }
  f32_prologue(s, fw, first, D, X);
  McList lst{idx, s.list[0], s.wcnt[0], first, sw, segs, true, 0u};
  lst.before();
  __syncthreads();
  lst.after();
  cp_wait<2>();
  __syncthreads();
  const int p3 = McLane::p3(), n3 = McLane::n3();
  int par = 0;
  for (int m = first; m >= 0;) {
    const int nx = next_used(used, m, M);
    const int* list = s.list[par];
    const int L = list_len(s.wcnt[par]), n_ch = (L + MCF_FC - 1) / MCF_FC;
    for (int ch = 0; ch < n_ch; ++ch) {
      const int n_c = min(MCF_FC, L - MCF_FC * ch);
      const bool last = ch == n_ch - 1;
      McList nl{idx, s.list[par ^ 1], s.wcnt[par ^ 1], nx, sw, segs, last && nx >= 0, 0u};
      float x[McLane::PL3][4];
      f32_decode_chunk(s, fw, s.g, list + MCF_FC * ch, 0, n_c, D, X, par, last ? nx : -1, nl,
                       x);
      const bool live = McLane::live(n_c);
      // -x_m(t) where d1[s, t] = m (the segment after row r) ...
      if (live && n3 < XP)
#pragma unroll
        for (int i = 0; i < McLane::PL3; ++i) {
          const int c = p3 + i;
          if (c >= n_c) break;
          const int r = list[MCF_FC * ch + c];
          if (r >= segs) continue;
          for (int k = 0; k < nsw; ++k)
            if (idx[k * segs + r] == m) {
              float4* q = reinterpret_cast<float4*>(diff + ((size_t)k * segs + r) * XP + n3);
              float4 v = *q;
              v.x = __fsub_rn(v.x, x[i][0]);
              v.y = __fsub_rn(v.y, x[i][1]);
              v.z = __fsub_rn(v.z, x[i][2]);
              v.w = __fsub_rn(v.w, x[i][3]);
              *q = v;
            }
        }
      __syncthreads();
      // ... then +x_m(t+1) where d2[s, t] = m (the segment before row r)
      if (live && n3 < XP)
#pragma unroll
        for (int i = 0; i < McLane::PL3; ++i) {
          const int c = p3 + i;
          if (c >= n_c) break;
          const int r = list[MCF_FC * ch + c];
          if (r < 1) continue;
          for (int k = 0; k < nsw; ++k)
            if (idx[(sw + k) * segs + r - 1] == m) {
              float4* q = reinterpret_cast<float4*>(diff + ((size_t)k * segs + r - 1) * XP + n3);
              float4 v = *q;
              v.x = __fadd_rn(v.x, x[i][0]);
              v.y = __fadd_rn(v.y, x[i][1]);
              v.z = __fadd_rn(v.z, x[i][2]);
              v.w = __fadd_rn(v.w, x[i][3]);
              *q = v;
            }
        }
    }
    par ^= 1;
    m = nx;
  }
  __syncthreads();
  // features >= X and rows past the curve hold no difference
  float e = 0.f;
  for (int i = tid; i < nsw * segs * XP; i += NT) e += diff[i] * diff[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
  if ((tid & 31) == 0) s.red[tid >> 5] = e;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int v = 0; v < NT / 32; ++v) t += s.red[v];
    partial[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * B + b] = t;
  }
}

// K5/K7, pass 2: fixed-order sum of the per-tile partial energies, over S.
__global__ void mc_sum_tiles(const float* __restrict__ partial, int n_tiles, int B, int S,
                             float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float e = 0.f;
  for (int i = 0; i < n_tiles; ++i) e += partial[(size_t)i * B + b];
  out[b] = e / (float)S;
}

// K5/K7 at a reduced rung on the tensor cores (production shape): K1's
// tiles (tiles_mma.cuh; blockIdx.x: splines b0..b0+3, blockIdx.y: rows
// from t0 = 31 y), in sweeps of sw samples.  A sweep stages the draws of
// the tile's 124 segments, marks the decoders they name and decodes each
// marked decoder once (decode_mma<R, true>: an endpoint is ONE decoder's
// output, so the decode's rounding shows as it does at M = 1).  Each
// sample's differences diff_s(t) live in shared memory, and each element
// receives exactly one subtraction, -x_{d1}(t) from the lane that holds
// point t, and one addition, +x_{d2}(t+1) from the lane of point t+1, from
// 0: it ends as fl(R - L) whichever decoder comes first, as in
// mc_fwd_fma; a barrier between a decoder's subtractions and its additions
// keeps two lanes off one element.  After a sweep each segment's squared
// differences are summed in a fixed order (samples, then features) into
// red[p]; after the last, each spline's 31 segments -> partial[blockIdx.y
// * B + b], which mc_sum_tiles adds in a fixed order.  No plane goes to
// device memory; sw (mc_tiles_sweep) is as many samples as the shared
// memory holds, 4 at X = 50.
struct McTilesSmem : MmaSmem {
  float red[TP];              // each segment's sum of squared differences
};
// dynamic tail: float diff[sw][TILE_SEGS][SD]; int idx[2][sw][TILE_SEGS]
// (d1 then d2 of segment p in sample s0 + k, -1 where there is none);
// uint32_t used[(M + 31) / 32].  SD (mc_tiles_stride): X rounded up so
// that the float2 rows of a half-warp's 4 row groups fall in distinct
// banks, and past the decode's padded columns 8 * ceil(X / 8).

__host__ __device__ __forceinline__ int mc_tiles_stride(int X) {
  return 16 * ((X + 7) / 16) + 8;
}
size_t mc_tiles_fixed(int M) { return sizeof(McTilesSmem) + 4 * (size_t)((M + 31) / 32); }
size_t mc_tiles_per_sample(int X) {
  return 4 * (size_t)TILE_SEGS * (mc_tiles_stride(X) + 2);
}
int mc_tiles_sweep(int M, int X, int S) {
  return std::min(S, (int)((SMEM_MAX - mc_tiles_fixed(M)) / mc_tiles_per_sample(X)));
}

// row[8j + 2q + {0, 1}] -= (SUB) or += the lane's row r of x, n8 tiles j < nj.
template <bool SUB>
__device__ __forceinline__ void update_row(float* row, const float (&x)[NJ3][4], int r,
                                           int nj) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ3; ++j)
    if (j < nj) {
      float2& v = *reinterpret_cast<float2*>(row + 8 * j + 2 * q);
      const float a = x[j][2 * r], b = x[j][2 * r + 1];
      v = SUB ? make_float2(__fsub_rn(v.x, a), __fsub_rn(v.y, b))
              : make_float2(__fadd_rn(v.x, a), __fadd_rn(v.y, b));
    }
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_tiles_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
             Weights w, Draws dr, int sw, float* __restrict__ partial) {
  static_assert(R != F32, "float32 keeps mc_fwd_fma");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McTilesSmem& s = *reinterpret_cast<McTilesSmem*>(smem_raw);
  const int SD = mc_tiles_stride(X), nj = (X + 7) / 8;
  float* diff = reinterpret_cast<float*>(smem_raw + sizeof(McTilesSmem));
  int* idx = reinterpret_cast<int*>(diff + (size_t)sw * TILE_SEGS * SD);
  uint32_t* used = reinterpret_cast<uint32_t*>(idx + 2 * sw * TILE_SEGS);
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = (tid >> 5) * 16 + (lane >> 2);      // rows p0, p0 + 8 of the warp's tile
  const int b0 = blockIdx.x * TILE_NS, t0 = blockIdx.y * TILE_KR;
  zero_w3_planes(s);
  load_tile_points(s, gamma, T, B, D, t0, b0);
  if (tid < TP) s.red[tid] = 0.f;
  for (int s0 = 0; s0 < S; s0 += sw) {
    const int nsw = min(sw, S - s0);
    __syncthreads();  // the previous sweep's differences are summed
    for (int e = tid; e < (M + 31) / 32; e += NT) used[e] = 0u;
    for (int e = tid; e < nsw * TILE_SEGS * SD; e += NT) diff[e] = 0.f;
    __syncthreads();
    for (int e = tid; e < 2 * nsw * TILE_SEGS; e += NT) {
      const int p = e % TILE_SEGS, qq = e / TILE_SEGS, side = qq / nsw, k = qq % nsw;
      const int t = t0 + p / TILE_NS, b = b0 + p % TILE_NS;
      const int v = t < T - 1 && b < B ? draw(dr, S, T, B, side, s0 + k, t, b) : -1;
      idx[(side * sw + k) * TILE_SEGS + p] = v;
      if (v >= 0 && v < M) atomicOr(&used[v >> 5], 1u << (v & 31));
    }
    for (int m = 0; m < M; ++m) {
      __syncthreads();  // the draws staged; the previous decoder's additions made
      if (!((used[m >> 5] >> (m & 31)) & 1u)) continue;  // the same for every thread
      stage_weights_mma<R>(s, m, D, X, w);
      __syncthreads();
      float x[NJ3][4];
      uint32_t m1[2], m2[2];
      decode_mma<R, true>(s, D, X, x, m1, m2);
      // -x_m(t) where d1[s, t] = m: the lane's points as left ends ...
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + 8 * r;
        if (p < TILE_SEGS)
          for (int k = 0; k < nsw; ++k)
            if (idx[k * TILE_SEGS + p] == m)
              update_row<true>(diff + ((size_t)k * TILE_SEGS + p) * SD, x, r, nj);
      }
      __syncthreads();
      // ... then +x_m(t+1) where d2[s, t] = m: as right ends
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + 8 * r - TILE_NS;  // the segment before the point
        if (p >= 0)
          for (int k = 0; k < nsw; ++k)
            if (idx[(sw + k) * TILE_SEGS + p] == m)
              update_row<false>(diff + ((size_t)k * TILE_SEGS + p) * SD, x, r, nj);
      }
    }
    __syncthreads();
    // the sweep's squared differences, per segment in a fixed order; the
    // features past X hold 0 - 0
    if (tid < TILE_SEGS) {
      float e = 0.f;
      for (int k = 0; k < nsw; ++k) {
        const float* row = diff + ((size_t)k * TILE_SEGS + tid) * SD;
        for (int n = 0; n < X; ++n) e += row[n] * row[n];
      }
      s.red[tid] += e;
    }
  }
  __syncthreads();
  if (tid < TILE_NS && b0 + tid < B) {
    float e = 0.f;
    for (int r = 0; r < TILE_KR; ++r) e += s.red[r * TILE_NS + tid];
    partial[(size_t)blockIdx.y * B + b0 + tid] = e;
  }
}

// dx[j] (feature tx+16j of point p = (t, b)) -/+= the difference rows of
// samples s0 .. s0+sw-1 where their draws (staged in idx) name decoder m,
// in sample order.
template <int NJ>
__device__ __forceinline__ void gather_dx(float (&dx)[NJ], const int* idx,
                                          const float* __restrict__ diffs, int m, int p, int t,
                                          int b, int s0, int sw, int T, int B, int X) {
  const int tx = threadIdx.x & 15;
  for (int k = 0; k < sw; ++k) {
    const int smp = s0 + k;
    if (idx[k * TP + p] == m) {
      const float* row = diffs + (((size_t)smp * (T - 1) + t) * B + b) * X;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < X) dx[j] = __fsub_rn(dx[j], row[tx + 16 * j]);
    }
    if (idx[(SMAX + k) * TP + p] == m) {
      const float* row = diffs + (((size_t)smp * (T - 1) + t - 1) * B + b) * X;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < X) dx[j] = __fadd_rn(dx[j], row[tx + 16 * j]);
    }
  }
}

// K6/K8 at float32 and on the generic decode, pass 2: per decoder,
// re-decode tile bx of 128 points of the flattened (T*B) curve, gather dx
// from the difference planes and run the masked cotangent chain back to
// dgamma (T*B, D).  The draws are staged once where S <= SMAX, else per
// decoder in sweeps of SMAX samples, dx carried between sweeps in a running
// tile; either way each dx element takes its samples' updates in order.
template <int R, class P>
__device__ __forceinline__ void chain_body(McSmemOf<typename P::Smem>& s,
                                           const typename P::Ctx& c, int bx,
                                           const float* __restrict__ gamma, int T, int B, int D,
                                           int M, int X, int S, Draws dr,
                                           const float* __restrict__ ct,
                                           const float* __restrict__ diffs,
                                           float* __restrict__ dgamma) {
  constexpr int C = CHAIN_RUNG<R>;
  constexpr int NJ = P::NJX;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int N = T * B, p0 = bx * TP;
  const bool one_sweep = S <= SMAX;
  load_points<P>(s, c, gamma, N, D, p0);
  zero_dgamma<P>(s, c, D);
  if (one_sweep) stage_draws<SMAX>(s.idx, dr, S, T, B, p0, 0, S);
  const float two_over_s = 2.f / (float)S;
  for (int m = 0; m < M; ++m) {
    float x[8][NJ];
    typename P::Masks mk;
    P::template decode<R>(s, c, m, D, X, x, mk);  // the outputs are not needed
    // dx -> act[n][p] at the chain rung
    const auto put = [&](int i, const float (&dx)[NJ]) {
      const int p = ty * 8 + i, pg = p0 + p;
      const float sc = pg < N ? __fmul_rn(two_over_s, ct[min(pg, N - 1) % B]) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (tx + 16 * j < X) s.act[(tx + 16 * j) * S_ACT + p] = pack<C>(__fmul_rn(dx[j], sc));
    };
    if (one_sweep) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = ty * 8 + i, pc = min(p0 + p, N - 1);
        float dx[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) dx[j] = 0.f;
        gather_dx(dx, s.idx, diffs, m, p, pc / B, pc % B, 0, S, T, B, X);
        put(i, dx);
      }
    } else {
      float run[8][NJ];
      for_sweeps<SMAX>(s.idx, dr, S, T, B, p0, [&](int s0, int sw) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = ty * 8 + i, pc = min(p0 + p, N - 1);
          float dx[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) dx[j] = s0 == 0 ? 0.f : P::tile(run, c, i, j);
          gather_dx(dx, s.idx, diffs, m, p, pc / B, pc % B, s0, sw, T, B, X);
          if (s0 + sw < S) {
#pragma unroll
            for (int j = 0; j < NJ; ++j) P::tile(run, c, i, j) = dx[j];
          } else {
            put(i, dx);
          }
        }
      });
    }
    __syncthreads();
    P::template chain<C>(s, c, m, D, X, mk);
  }
  __syncthreads();
  store_dgamma<P>(s, c, dgamma, N, D, p0);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_chain(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
         Weights w, Draws dr, const float* __restrict__ ct,
         const float* __restrict__ diffs, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  chain_body<R, FixedDecode>(*reinterpret_cast<McSmem*>(smem_raw), FixedDecode::Ctx{w},
                             blockIdx.x, gamma, T, B, D, M, X, S, dr, ct, diffs, dgamma);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_chain_any(const float* __restrict__ gamma, int T, int B, int M, int S, AnyArgs a, Draws dr,
             const float* __restrict__ ct, const float* __restrict__ diffs,
             float* __restrict__ dgamma, int n_items) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McSmemAny& s = *reinterpret_cast<McSmemAny*>(smem_raw);
  const AnyCtx c = any_begin(s, a);
  const int D = s.dec.D, X = s.dec.X;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    chain_body<R, AnyDecode>(s, c, item, gamma, T, B, D, M, X, S, dr, ct, diffs, dgamma);
    __syncthreads();
  }
}

// The lane's row r (of its two) of a C-fragment tile to a row of X floats.
__device__ __forceinline__ void store_row(float* __restrict__ row, const float (&x)[NJ3][4],
                                          int r, int X) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJ3; ++j) {
    const int n = 8 * j + 2 * q;
    if ((X & 1) == 0) {
      if (n < X) *reinterpret_cast<float2*>(row + n) = make_float2(x[j][2 * r], x[j][2 * r + 1]);
    } else {
      if (n < X) row[n] = x[j][2 * r];
      if (n + 1 < X) row[n + 1] = x[j][2 * r + 1];
    }
  }
}

// Lane columns 8j + 2q + {0, 1} of a row of X floats, zero beyond X or
// where !use (a predicated load: no memory access then).
__device__ __forceinline__ float2 lane_pair(const float* __restrict__ row, int j, bool use,
                                            int X) {
  const int n = 8 * j + 2 * (threadIdx.x & 3);
  if ((X & 1) == 0)
    return use && n < X ? *reinterpret_cast<const float2*>(row + n) : make_float2(0.f, 0.f);
  return make_float2(use && n < X ? row[n] : 0.f, use && n + 1 < X ? row[n + 1] : 0.f);
}

// K6/K8 at a reduced rung, pass 1, on the tensor cores: per decoder, decode
// the warp's 16 points and copy each point's output into the endpoint
// planes ends (2S, T, B, X) where a draw names the decoder: plane s gets
// L_s(t) = x_{d1[s,t]}(t), plane S + s gets R_s(t) = x_{d2[s,t-1]}(t).  An
// entry (side, s, t) with a segment is written by exactly one decoder; L_s
// at t = T-1 and R_s at t = 0 are never written nor read.
template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_select_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
              Weights w, Draws dr, float* __restrict__ ends) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McMmaSmem& s = *reinterpret_cast<McMmaSmem*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int N = T * B, p0 = blockIdx.x * TP;
  const int p = (threadIdx.x >> 5) * 16 + (lane >> 2);  // rows p, p + 8
  zero_w3_planes(s);
  load_points_mma(s, gamma, N, D, p0);
  if (S <= SMAX_MMA) stage_draws<SMAX_MMA>(s.idx, dr, S, T, B, p0, 0, S);
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights_mma<R>(s, m, D, X, w);
    __syncthreads();
    float x[NJ3][4];
    uint32_t m1[2], m2[2];
    decode_mma<R>(s, D, X, x, m1, m2);
    for_sweeps<SMAX_MMA>(s.idx, dr, S, T, B, p0, [&](int s0, int sw) {
      for (int k = 0; k < sw; ++k)
#pragma unroll
        for (int side = 0; side < 2; ++side)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (s.idx[(side * SMAX_MMA + k) * TP + p + 8 * r] == m)
              store_row(ends + ((size_t)(side * S + s0 + k) * N + p0 + p + 8 * r) * X, x, r, X);
    });
  }
}

// K6/K8 at a reduced rung, pass 2, on the tensor cores: per decoder,
// re-decode the tile for its masks, form dx in registers from the endpoint
// planes (each element's updates in mc_chain's order; where a draw does not
// name the decoder the update is by zero, as in the plain version) and run
// the masked chain (chain_mma, single-pass bf16).
template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_chain_mma(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
             Weights w, Draws dr, const float* __restrict__ ct,
             const float* __restrict__ ends, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  McMmaSmem& s = *reinterpret_cast<McMmaSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
  const int N = T * B, p0 = blockIdx.x * TP;
  const int p = (tid >> 5) * 16 + (lane >> 2);  // rows p, p + 8
  zero_w3_planes(s);
  load_points_mma(s, gamma, N, D, p0);
  for (int e = tid; e < TP * DMAX; e += NT) s.dg[e] = 0.f;
  if (S <= SMAX_MMA) stage_draws<SMAX_MMA>(s.idx, dr, S, T, B, p0, 0, S);
  // per row: its point (clamped) and (2/S) ct_b, 0 past the end
  int pc[2];
  float sc[2];
  const float two_over_s = 2.f / (float)S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pg = p0 + p + 8 * r;
    pc[r] = min(pg, N - 1);
    sc[r] = pg < N ? __fmul_rn(two_over_s, ct[pc[r] % B]) : 0.f;
  }
  for (int m = 0; m < M; ++m) {
    __syncthreads();
    stage_weights_mma<R>(s, m, D, X, w);
    __syncthreads();
    float dx[NJ3][4];
    uint32_t m1[2], m2[2];
    decode_mma<R>(s, D, X, dx, m1, m2);  // the outputs are not needed
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dx[j][c] = 0.f;
    for_sweeps<SMAX_MMA>(s.idx, dr, S, T, B, p0, [&](int s0, int sw) {
      for (int k = 0; k < sw; ++k) {
        // the sample's differences at the lane's rows, zero where its draws
        // do not name decoder m: every load of the sample in flight at once
        const float* L = ends + (size_t)(s0 + k) * N * X;
        const float* Rt = ends + (size_t)(S + s0 + k) * N * X;
        const size_t up = (size_t)B * X;
        float cur[2][NJ3][2], prv[2][NJ3][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t row = (size_t)pc[r] * X;
          const bool a = s.idx[k * TP + p + 8 * r] == m;           // d1[s, t]
          const bool b = s.idx[(SMAX_MMA + k) * TP + p + 8 * r] == m;  // d2[s, t-1]
#pragma unroll
          for (int j = 0; j < NJ3; ++j) {
            const float2 rc = lane_pair(Rt + row + up, j, a, X), lc = lane_pair(L + row, j, a, X);
            const float2 rp = lane_pair(Rt + row, j, b, X), lp = lane_pair(L + row - up, j, b, X);
            cur[r][j][0] = __fsub_rn(rc.x, lc.x);
            cur[r][j][1] = __fsub_rn(rc.y, lc.y);
            prv[r][j][0] = __fsub_rn(rp.x, lp.x);
            prv[r][j][1] = __fsub_rn(rp.y, lp.y);
          }
        }
        // dx -= diff_s(t), then += diff_s(t-1): mc_chain's order
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < NJ3; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c)
              dx[j][2 * r + c] = __fadd_rn(__fsub_rn(dx[j][2 * r + c], cur[r][j][c]),
                                           prv[r][j][c]);
      }
    });
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dx[j][c] = 8 * j + 2 * q + (c & 1) < X ? __fmul_rn(dx[j][c], sc[c >> 1]) : 0.f;
    uint32_t a[NK3][4];
    to_a<false>(dx, a);
    chain_mma(s, D, X, a, m1, m2);
  }
  __syncthreads();
  store_dgamma<FixedDecode>(s, FixedDecode::Ctx{}, dgamma, N, D, p0);
}

// K6/K8 at a reduced rung, one decode: the one-pass body of onepass_mma.cuh
// (K2's: tiles of 32 rows x 4 splines, 31 owned, persistent blocks over
// pick_spans' items) with the MC cotangent in place of the expected one.
// Round k stages each decoder once, runs the chain of tile k-1 and decodes
// tile k into the block's scratch (outputs and masks of two tiles of every
// decoder); no accumulator rides along the decode.  As round k starts, every
// decoder's outputs of tile k-1 are in the scratch, and of tile k-2 too
// (its buffer is overwritten by this round's decodes): begin_chain stages the
// draws of tile k-1's segments, slot i for the segment from the point before
// point i (row -1 is tile k-2's row 30) to point i, and forms the S
// difference planes diff_s(slot i) = x_{d2}(point i) - x_{d1}(its left
// neighbour), one fp32 subtraction of two kept outputs, as mc_chain_mma's
// R_s(t+1) - L_s(t).  The chain of decoder m takes
// dx = (2/S) ct_b sum_s (-[d1 names m] diff_s(slot after) + [d2 names m]
// diff_s(slot before)) in mc_chain_mma's order (per sample: subtract, then
// add; zero where a draw names another decoder).  The planes and the draws
// (a dynamic tail of 4 TP (2 + SD) bytes a sample) sit where K2 keeps two
// xbar tiles and the chain's outputs, so S is capped (mc_onepass_cap: 3 at X
// = 50 and at X = 64); above the cap the two-pass pair runs.
struct McOnePassSmem : MmaSmem {
  uint4 mpre[NT];     // the chain's masks of tile k-1, each thread's own
  float cct[TP];      // tile k-1's point: (2/S) ct_b, 0 if not owned
  OnePassRound rd;
};
// dynamic tail: int idx[2][S][TP] (d1, then d2 of slot i; -1 where there is
// no segment); float diff[S][TP][SD] (SD = mc_tiles_stride(X): the float2
// rows of a half-warp's four rows in distinct banks)

inline size_t mc_onepass_per_sample(int X) {
  return 4 * (size_t)TP * (2 + mc_tiles_stride(X));
}
inline size_t mc_onepass_smem(int X, int S) {
  return sizeof(McOnePassSmem) + (size_t)S * mc_onepass_per_sample(X);
}
inline int mc_onepass_cap(int X) {
  return (int)((SMEM_MAX - sizeof(McOnePassSmem)) / mc_onepass_per_sample(X));
}

// The MC energy's cotangent: onepass_body's policy for K6/K8 (ExpectedCot's
// counterpart in onepass_mma.cuh).
struct McCot {
  using Smem = McOnePassSmem;
  Draws dr;
  int S, SD;
  int* idx;
  float* diff;

  __device__ void begin_tile(Smem&, int) const {}
  __device__ void begin_chain(Smem& s, const float* __restrict__ ct, int k, int T, int B, int M,
                              int X, const float4* __restrict__ xs_scr) const {
    const int tid = threadIdx.x;
    const int t1 = s.rd.t0 - TILE_KR;   // tile k-1's row 0
    for (int e = tid; e < 2 * S * TP; e += NT) {
      const int i = e % TP, q = e / TP, side = q / S, smp = q % S;
      const int t = t1 - 1 + i / TILE_NS, b = s.rd.b0 + i % TILE_NS;
      // row -1 is there only where tile k-2 is of the same span
      const bool seg = t >= 0 && t < T - 1 && b < B && (i >= TILE_NS || k > 1);
      idx[e] = seg ? draw(dr, S, T, B, side, smp, t, b) : -1;
    }
    if (tid < TP)
      s.cct[tid] = onepass_owned(s.rd, tid, T, B)
                       ? __fmul_rn(2.f / (float)S, ct[s.rd.b0 + tid % TILE_NS])
                       : 0.f;
    __syncthreads();
    // x of point p, columns 8j + 2q + {0, 1}, in buffer buf: half (p >> 3) & 1
    // of thread (p >> 4) * 32 + (p & 7) * 4 + q's float4 of n8 tile j
    const int nj = (X + 7) / 8, prv = (k & 1) ^ 1;
    const float2* xs =
        reinterpret_cast<const float2*>(xs_scr + (size_t)blockIdx.x * 2 * M * nj * NT);
    const auto at = [&](int buf, int d, int j, int p, int q) {
      return 2 * ((((size_t)buf * M + d) * nj + j) * NT + (p >> 4) * 32 + (p & 7) * 4 + q) +
             ((p >> 3) & 1);
    };
    const int n = S * nj * TP * 4;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      const int q = e & 3, i = (e >> 2) % TP, js = (e >> 2) / TP, j = js % nj, smp = js / nj;
      const int d1 = idx[smp * TP + i], d2 = idx[(S + smp) * TP + i];
      // an index outside [0, M) selects no decoder: its endpoint is 0
      const float2 r = (unsigned)d2 < (unsigned)M ? __ldcg(xs + at(prv, d2, j, i, q))
                                                  : make_float2(0.f, 0.f);
      // the left end: point i - 4 of tile k-1, or row 30 of tile k-2
      const size_t li = i >= TILE_NS ? at(prv, d1, j, i - TILE_NS, q)
                                     : at(k & 1, d1, j, (TILE_KR - 1) * TILE_NS + i, q);
      const float2 l = (unsigned)d1 < (unsigned)M ? __ldcg(xs + li) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(diff + ((size_t)smp * TP + i) * SD + 8 * j + 2 * q) =
          make_float2(__fsub_rn(r.x, l.x), __fsub_rn(r.y, l.y));
    }
  }
  __device__ void fetch(Smem&, int, int, int, const float4* __restrict__, int) const {}
  // dx of decoder m on the lane's rows of tile k-1, packed into A fragments
  __device__ void cotangent(const Smem& s, int m, int, int X, int nj,
                            uint32_t (&a)[NK3][4]) const {
    const int tid = threadIdx.x, lane = tid & 31, q = lane & 3;
    const int p0 = (tid >> 5) * 16 + (lane >> 2);
    float dx[NJ3][4];
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dx[j][c] = 0.f;
    for (int smp = 0; smp < S; ++smp) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pp = p0 + 8 * r;
        // d1 of the segment after point pp (slot pp + 4), d2 of the one before (slot pp)
        const bool after = pp + TILE_NS < TP && idx[smp * TP + pp + TILE_NS] == m;
        const bool before = idx[(S + smp) * TP + pp] == m;
        const float* da = diff + ((size_t)smp * TP + pp + TILE_NS) * SD + 2 * q;
        const float* db = diff + ((size_t)smp * TP + pp) * SD + 2 * q;
#pragma unroll
        for (int j = 0; j < NJ3; ++j) {
          if (j >= nj) continue;
          const float2 cu = after ? *reinterpret_cast<const float2*>(da + 8 * j)
                                  : make_float2(0.f, 0.f);
          const float2 pv = before ? *reinterpret_cast<const float2*>(db + 8 * j)
                                   : make_float2(0.f, 0.f);
          dx[j][2 * r] = __fadd_rn(__fsub_rn(dx[j][2 * r], cu.x), pv.x);
          dx[j][2 * r + 1] = __fadd_rn(__fsub_rn(dx[j][2 * r + 1], cu.y), pv.y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dx[j][c] = 8 * j + 2 * q + (c & 1) < X ? __fmul_rn(dx[j][c], s.cct[p0 + 8 * (c >> 1)])
                                               : 0.f;
    to_a<false>(dx, a);
  }
  __device__ void keep(Smem&, int, int, const float (&x)[NJ3][4], int nj,
                       float4* __restrict__ xm) const {
#pragma unroll
    for (int j = 0; j < NJ3; ++j)
      if (j < nj) xm[(size_t)j * NT] = make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
  }
  __device__ void end_round(Smem&, int) const {}
};

// The bf16 weight planes of the one-decode route (K8's time: the name reads
// as mc_select's), then the body.
__global__ void mc_select_planes(const float* __restrict__ W2, const float* __restrict__ W3,
                                 int M, int X, __nv_bfloat16* __restrict__ planes) {
  prep_planes(W2, W3, M, X, planes);
}

template <int R>
__global__ void __launch_bounds__(NT, 1)
mc_chain_onepass(const float* __restrict__ gamma, int T, int B, int D, int M, int X, int S,
                 int span, int n_items, Weights w, Draws dr, const float* __restrict__ ct,
                 float4* __restrict__ xs_scr, uint4* __restrict__ mk_scr,
                 const __nv_bfloat16* __restrict__ planes, float* __restrict__ dgamma) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* idx = reinterpret_cast<int*>(smem_raw + sizeof(McOnePassSmem));
  const McCot cot{dr, S, mc_tiles_stride(X), idx, reinterpret_cast<float*>(idx + 2 * S * TP)};
  onepass_body<R>(*reinterpret_cast<McOnePassSmem*>(smem_raw), cot, gamma, T, B, D, M, X, span,
                  n_items, w, w.W1, ct, xs_scr, mk_scr, planes, dgamma);
}

int fwd_tiles(int T) { return T > 1 ? (T - 1 + MC_TILE_SEGS - 1) / MC_TILE_SEGS : 1; }

template <int R>
cudaError_t launch_fwd(const float* gamma, int T, int B, int D, int M, int X, int S,
                       Weights w, Draws dr, float* partial, float* out, float* w3p,
                       cudaStream_t st) {
  cudaError_t err;
  int n_tiles;
  if constexpr (R == F32) {  // selective decode on decode_f32.cuh
    if (!f32_aligned(w)) return cudaErrorMisalignedAddress;
    const McTile tl = mc_f32_tile(T, M, X, S);
    if (tl.smem > SMEM_MAX) return cudaErrorInvalidValue;
    err = f32_prepare_w3(w.W3, M, X, w3p, st);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(mc_fwd_fma<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)tl.smem);
    if (err != cudaSuccess) return err;
    mc_fwd_fma<R><<<dim3(B, tl.n_t, tl.n_s), NT, tl.smem, st>>>(
        gamma, T, B, D, M, X, S, F32Weights{w, w3p}, dr, tl.segs, tl.sw, partial);
    n_tiles = tl.n_t * tl.n_s;
    err = cudaGetLastError();
  } else {  // tensor cores, K1's tiles (tiles_mma.cuh)
    const int sw = mc_tiles_sweep(M, X, S);
    const size_t smem = mc_tiles_fixed(M) + sw * mc_tiles_per_sample(X);
    if (sw < 1) return cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(mc_tiles_mma<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    n_tiles = tile_rows(T);
    mc_tiles_mma<R><<<dim3((B + TILE_NS - 1) / TILE_NS, n_tiles), NT, smem, st>>>(
        gamma, T, B, D, M, X, S, w, dr, sw, partial);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  mc_sum_tiles<<<(B + 127) / 128, 128, 0, st>>>(partial, n_tiles, B, S, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_mma(const float* gamma, int T, int B, int D, int M, int X, int S,
                           Weights w, Draws dr, const float* ct, float* ends, float* dgamma,
                           cudaStream_t st) {
  cudaError_t err = prepare<McMmaSmem>(mc_select_mma<R>);
  if (err == cudaSuccess) err = prepare<McMmaSmem>(mc_chain_mma<R>);
  if (err != cudaSuccess) return err;
  const int n_blocks = (T * B + TP - 1) / TP;
  mc_select_mma<R><<<n_blocks, NT, sizeof(McMmaSmem), st>>>(gamma, T, B, D, M, X, S, w, dr,
                                                            ends);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mc_chain_mma<R><<<n_blocks, NT, sizeof(McMmaSmem), st>>>(gamma, T, B, D, M, X, S, w, dr, ct,
                                                           ends, dgamma);
  return cudaGetLastError();
}

// The one-decode route over `scratch`: each block's outputs
// (onepass_xs_words), then each block's masks (onepass_mk_words), then the
// planes (onepass_plane_words); S at most mc_onepass_cap(X).
template <int R>
cudaError_t launch_bwd_onepass(const float* gamma, int T, int B, int D, int M, int X, int S,
                               int span, int G, int n_blocks, Weights w, Draws dr,
                               const float* ct, void* scratch, float* dgamma, cudaStream_t st) {
  if (scratch == nullptr || span < 1 || G < 1 || n_blocks < 1 || S < 1 ||
      S > mc_onepass_cap(X))
    return cudaErrorInvalidValue;
  const size_t smem = mc_onepass_smem(X, S);
  cudaError_t err = cudaFuncSetAttribute(mc_chain_onepass<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  float4* xs = reinterpret_cast<float4*>(words);
  uint4* mk = reinterpret_cast<uint4*>(words + n_blocks * onepass_xs_words(M, X));
  __nv_bfloat16* planes = reinterpret_cast<__nv_bfloat16*>(
      words + n_blocks * (onepass_xs_words(M, X) + onepass_mk_words(M)));
  if (err == cudaSuccess) err = launch_prep(mc_select_planes, w, M, X, n_blocks, planes, st);
  if (err != cudaSuccess) return err;
  mc_chain_onepass<R><<<n_blocks, NT, smem, st>>>(gamma, T, B, D, M, X, S, span,
                                                  G * ((B + TILE_NS - 1) / TILE_NS), w, dr, ct,
                                                  xs, mk, planes, dgamma);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* gamma, int T, int B, int D, int M, int X, int S,
                       Weights w, Draws dr, const float* ct, float* diffs, float* dgamma,
                       cudaStream_t st) {
  static_assert(R == F32, "the reduced rungs run mc_select_mma + mc_chain_mma");
  cudaError_t err = prepare<McSmem>(mc_segments<R>);
  if (err == cudaSuccess) err = prepare<McSmem>(mc_chain<R>);
  if (err != cudaSuccess) return err;
  mc_segments<R><<<dim3((B + MC_COLS - 1) / MC_COLS, fwd_tiles(T)), NT, sizeof(McSmem), st>>>(
      gamma, T, B, D, M, X, S, w, dr, nullptr, diffs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mc_chain<R><<<(T * B + TP - 1) / TP, NT, sizeof(McSmem), st>>>(
      gamma, T, B, D, M, X, S, w, dr, ct, diffs, dgamma);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_segments_any(const float* gamma, int T, int B, int M, int S,
                                const AnyArgs& a, int n_blocks, Draws dr, float* partial,
                                float* diffs, cudaStream_t st) {
  cudaError_t err = prepare<McSmemAny>(mc_segments_any<R>);
  if (err != cudaSuccess) return err;
  const int gx = (B + MC_COLS - 1) / MC_COLS;
  mc_segments_any<R><<<n_blocks, NT, sizeof(McSmemAny), st>>>(gamma, T, B, M, S, a, dr, partial,
                                                              diffs, gx, gx * fwd_tiles(T));
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_fwd_any(const float* gamma, int T, int B, int M, int S, const AnyArgs& a,
                           int n_blocks, Draws dr, float* partial, float* out, cudaStream_t st) {
  cudaError_t err =
      launch_segments_any<R>(gamma, T, B, M, S, a, n_blocks, dr, partial, nullptr, st);
  if (err != cudaSuccess) return err;
  mc_sum_tiles<<<(B + 127) / 128, 128, 0, st>>>(partial, fwd_tiles(T), B, S, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd_any(const float* gamma, int T, int B, int M, int S, const AnyArgs& a,
                           int n_blocks, Draws dr, const float* ct, float* diffs, float* dgamma,
                           cudaStream_t st) {
  cudaError_t err =
      launch_segments_any<R>(gamma, T, B, M, S, a, n_blocks, dr, nullptr, diffs, st);
  if (err == cudaSuccess) err = prepare<McSmemAny>(mc_chain_any<R>);
  if (err != cudaSuccess) return err;
  mc_chain_any<R><<<n_blocks, NT, sizeof(McSmemAny), st>>>(gamma, T, B, M, S, a, dr, ct, diffs,
                                                           dgamma, (T * B + TP - 1) / TP);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Row count of the forward's (n_tiles, B) partial-energy buffer for the
// kernel that vlg_mc_fwd picks at this rung, decoder and sample count.
int vlg_mc_fwd_tiles(int rung, int T, int M, int S, int L, const int* widths) {
  Decoder d;
  if (!make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  if (!fixed_shape(d)) return fwd_tiles(T);
  if (rung != F32) return tile_rows(T);
  const McTile tl = mc_f32_tile(T, M, d.X, S);
  return tl.n_t * tl.n_s;
}

// d1 == nullptr: the draws are made in the kernel from (key0, key1) and kmax
// (K7, K8), for splines b_base .. b_base + B - 1 of the caller's batch; else
// from the planes d1, d2 (K5, K6).  The decoder as arrays, as
// vlg_energy_fwd (energy_expected.cu); the generic kernels' scratch is
// n_blocks x vlg_any_scratch_words(L, widths, 1) words, the forward's at
// float32 on the production shape vlg_f32_scratch_words floats.
int vlg_mc_fwd(int rung, const float* gamma, int T, int B, int M, int S, int L,
               const int* widths, const float* const* Ws, const float* const* bs,
               const int* d1, const int* d2, const float* kmax, unsigned key0, unsigned key1,
               int b_base, float* partial, float* out, void* scratch, int n_blocks,
               void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  const Draws dr{d1, d2, kmax, key0, key1, b_base};
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
        ? launch_fwd<R>(gamma, T, B, D, M, X, S, fixed_weights(d), dr, partial, out,
                        static_cast<float*>(scratch), st)
        : launch_fwd_any<R>(gamma, T, B, M, S, a, n_blocks, dr, partial, out, st);
  });
}

// (B, X) planes of the backward's scratch (`diffs` of vlg_mc_bwd) on the
// two-pass routes: the difference planes (S, T-1, B, X) of the FMA kernels,
// or the endpoint planes (2S, T, B, X) of the tensor-core pair (the
// production shape at a reduced rung); -1 for a decoder the kernels do not
// take.
int vlg_mc_bwd_planes(int rung, int T, int S, int L, const int* widths) {
  Decoder d;
  if (!make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  return rung != F32 && fixed_shape(d) ? 2 * S * T : S * (T - 1);
}

// The most samples the one-decode route takes at output width X.
int vlg_mc_onepass_cap(int X) { return mc_onepass_cap(X); }

// 32-bit words of the one-decode route's scratch: per block (outputs and
// masks of two tiles of M decoders), and of the M decoders' weight planes.
int vlg_mc_block_words(int M, int X) {
  return (int)(onepass_xs_words(M, X) + onepass_mk_words(M));
}

int vlg_mc_plane_words(int M) { return (int)onepass_plane_words(M); }

// span > 0: the one-decode route (a reduced rung on the production shape, S
// <= vlg_mc_onepass_cap(X)), whose `scratch` holds n_blocks x
// vlg_mc_block_words + vlg_mc_plane_words words and whose blocks take the G
// spans of `span` rows per group of four splines; `diffs` is unused there.
// span = 0: the two-pass kernels over the planes `diffs`
// (vlg_mc_bwd_planes), `scratch` the generic kernels' (vlg_mc_fwd's).
int vlg_mc_bwd(int rung, const float* gamma, int T, int B, int M, int S, int span, int G,
               int L, const int* widths, const float* const* Ws, const float* const* bs,
               const int* d1, const int* d2, const float* kmax, unsigned key0, unsigned key1,
               int b_base, const float* ct, float* diffs, float* dgamma, void* scratch,
               int n_blocks, void* stream) {
  Decoder d;
  if (!make_decoder(L, widths, Ws, bs, d)) return cudaErrorInvalidValue;
  const Draws dr{d1, d2, kmax, key0, key1, b_base};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = d.D, X = d.X;
  AnyArgs a{};
  if (span > 0 && (rung == F32 || !fixed_shape(d))) return cudaErrorInvalidValue;
  if (!fixed_shape(d)) {
    const cudaError_t err = any_args(d, scratch, 1, st, a);
    if (err != cudaSuccess) return err;
  }
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    if (!fixed_shape(d))
      return launch_bwd_any<R>(gamma, T, B, M, S, a, n_blocks, dr, ct, diffs, dgamma, st);
    if constexpr (R == F32)  // CUDA-core FMAs (TF32 is barred)
      return launch_bwd<R>(gamma, T, B, D, M, X, S, fixed_weights(d), dr, ct, diffs, dgamma, st);
    else if (span > 0)  // tensor cores, one decode
      return launch_bwd_onepass<R>(gamma, T, B, D, M, X, S, span, G, n_blocks, fixed_weights(d),
                                   dr, ct, scratch, dgamma, st);
    else  // tensor cores, two passes
      return launch_bwd_mma<R>(gamma, T, B, D, M, X, S, fixed_weights(d), dr, ct, diffs, dgamma,
                               st);
  });
}

}  // extern "C"
