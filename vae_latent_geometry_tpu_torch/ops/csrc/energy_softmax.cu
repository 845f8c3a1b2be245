// K1 and K2 for decoders with scVI's softmax head (ops/energy_softmax.py),
// for sm_90a (H100).  Replaces no TPU kernel: the JAX package has no
// softmax-headed decoder.
//
// The decoder: h = ReLU(z W1 + b1) (scVI's eval-mode BatchNorm folded into
// W1, b1 before the call), u = h W2 + b2 over the G genes, x = L softmax(u).
// The wrapper ships W1 (M, D, 128), b1 (M, 128), W2 (M, 128, Gp) and b2
// (M, Gp) padded: hidden units past H are zero, columns past G have zero
// weights and a bias of -inf, so their logits are -inf and their x zero, and
// Gp is a multiple of 128.  W2 comes as the rung's bf16 planes (hi, and lo
// at f32x3) or, at float32, in float; K2 at the reduced rungs takes them,
// and nb, tiled (below).
//
// A block owns 128 curve rows (n = t B + b), 16 a warp, and walks the Gp
// columns in tiles of 64.  The hidden layer is fp32 FMAs in d order,
// straight into the A fragments of the product with W2 (decode_mma.cuh's
// layout); u = h W2 runs the rung's bf16 hi/lo passes on the tensor cores.
// Every row reduction (the log-sum-exp, <s, g>, the variance, the dgamma
// sums) is summed in one fixed order: each lane over its own columns, then
// the quad's four lanes by two shuffles; a repeat is bit for bit the same.
//
//   k1s_rows / k2s_rows[_wg]: pass 1, per decoder the log-sum-exp of each
//     row (an online maximum and sum) -> lse (M, N); pass 2, per strip of
//     64 (K1) or 128 (K2) columns and per decoder, x = L exp(u - lse)
//     summed into xbar (N, Gp) with the spline's decoder weights (K1:
//     centred on decoder 0, the variance -> var (N,)).
//   k2s_chain[_wg]: per decoder, pass 3 <s, g> over the Gp columns, g the
//     cotangent of x; pass 4 du = L s (g - <s, g>), dh = du W2^T, the ReLU
//     mask and dgamma += dh W1^T (fp32).
//
// K1 at every rung and K2 at float32 (k1s_rows, k2s_rows<0>, k2s_chain<0>,
// on rows_body): each tile of W2 is staged with its decoder's W1, b1 and b2
// by cp.async into one of three stages (two at float32); a warp's products
// are mma.sync m16n8k16 (gemm_fwd, gemm_wt); at float32 fp32 FMAs (no TF32).
//
// K2 at the reduced rungs (k2s_rows_wg, k2s_chain_wg) on warpgroup MMA.
// Its bound is the products (164.6 GFLOP at B = 8, 0.17 ms at the bf16
// peak); on mma.sync the route ran at 4% of it, because a warp waited on
// its products before its exponentials and the 8 warps, in step, left the
// tensor cores idle while they ran them.  Here:
//   - Two warpgroups of 64 rows issue wgmma.mma_async with the hidden
//     layer's hi/lo fragments from registers and B = the staged W2 tile
//     (m64n64k16; the chain's du W2^T m64n128k16 from du in registers and
//     the same tile read K-major).  A warpgroup waits for tile i's logits,
//     then issues tile i + 1's k16 step by k16 step, each step followed by
//     the exponentials of one n8 column tile of tile i: the issue of a
//     wgmma stalls until the tensor cores have taken most of what is
//     queued (H100: 16 m64n64k16 take ~420 of their ~660 cycles to issue),
//     so the arithmetic has to sit between the issues to run under them.
//   - One thread of each of four warps starts a stage's bulk copies
//     (cp.async.bulk, the TMA engine) on the stage's mbarrier: W2's planes
//     tiled by the wrapper (a tile one contiguous 16-KB block in the
//     core-matrix layout wgmma reads, energy_softmax.tiled), b2, the row
//     pass's W1 and b1 with a tile that starts a hidden layer, and the
//     chain's nb tiled by k2s_neighbours (the block's rows of a tile one
//     block).  No thread waits on a copy (cp.async's 16-byte copies stalled
//     the issuing threads ~1500 cycles a tile), and the tensor cores read
//     what the copy engine wrote with no proxy fence.  Four stages (three
//     for the chain at f32x3).
//   - Each block starts its walk over the columns at its own tile, so that
//     the blocks do not all read one W2 tile at once.
// What bounds it now (H100, B = 8, f32x2: rows 1.28 ms, chain 1.24 ms):
// the chain reads nb from device memory twice per decoder (2.9 GB a launch,
// ~1 ms at 3 TB/s); pass 2 forms the hidden layer again every second tile,
// with the tensor cores idle (it waits for the products in flight, whose A
// fragments it overwrites), about as long as its two tiles' products; pass
// 1 runs at about its products' time plus ~1000 cycles a tile of waits.

#include "decode_mma.cuh"

namespace {

constexpr int SG = 64;           // columns of a staged tile
constexpr int SRB = 128;         // rows of a block: 8 warps of 16
constexpr int SDMAX = 16;        // widest latent
constexpr int SWH = SG + 8;      // bf16 row stride of a staged W2 plane tile
constexpr int SWF = SG + 4;      // float row stride of a float W2 tile and of du
constexpr int SHF = H + 4;       // float row stride of h at float32
constexpr int NJG = SG / 8;      // n8 tiles of a column tile (8)
constexpr int NKG = SG / 16;     // k16 steps over a column tile (4)
static_assert(NT == 32 * SRB / 16, "a warp owns 16 rows");
// Stages of the copy pipeline: three at the reduced rungs (one barrier a
// tile), two at float32, whose float tiles fill shared memory.
template <int R>
struct Stages {
  static constexpr int N = R == F32 ? 2 : 3;
};

// One stage: the W2 tile (bf16 planes [k][g], or float at float32), then
// W1 [d][k], b1 and the tile's b2, as byte offsets.
template <int R>
struct Stage {
  static constexpr int W1 = R == F32 ? H * SWF * 4 : (R == F32X3 ? 2 : 1) * H * SWH * 2;
  static constexpr int B1 = W1 + SDMAX * H * 4;
  static constexpr int B2 = B1 + H * 4;
  static constexpr int BYTES = B2 + SG * 4;
};

// The stages, the block's points (and the chain's dgamma sums), at
// float32 h (and the chain's du) by rows, and K1's decoder-0 outputs of a
// tile (STATS).
template <int R, bool CHAIN, bool STATS = false>
constexpr int smem_bytes() {
  return Stages<R>::N * Stage<R>::BYTES + SRB * SDMAX * 4 * (CHAIN ? 2 : 1) +
         (R == F32 ? SRB * SHF * 4 + (CHAIN ? SRB * SWF * 4 : 0) : 0) +
         (STATS ? SRB * SWF * 4 : 0);
}

struct SmArgs {
  const float* z;      // (N, D) curve points
  const float* w1;     // (M, D, 128)
  const float* b1;     // (M, 128)
  const void* w2a;     // (M, 128, Gp): the hi plane (bf16), float at float32;
                       // K2 at the reduced rungs: tiled (energy_softmax.tiled)
  const void* w2b;     // the lo plane at f32x3 (tiled for K2)
  const float* b2;     // (M, Gp)
  const float* lib;    // (M,) library sizes
  const float* wmb;    // (M, B) decoder weights of each spline
  const float* ct;     // (B,) cotangents of the energies (chain)
  float* lse;          // (M, N)
  float* xbar;         // (N, Gp)
  float* var;          // (N,) (K1)
  const float* nb;     // (N, Gp) xbar_{t-1} + xbar_{t+1} (chain); K2 at the
                       // reduced rungs: tiled (k2s_neighbours, TR > 0)
  float* dz;           // (N, D) dgamma (chain)
  int N, B, M, D, Gp;
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The copy pipeline over a block's sequence of n tiles: issue(k, stage)
// starts the copies of tile k into a stage.  pipe_start issues the first
// stages; pipe_enter(i) returns tile i's stage once it has landed, after
// issuing the next tile into the stage every thread is done with;
// pipe_leave ends tile i.
template <int R, class Issue>
__device__ __forceinline__ void pipe_start(unsigned char* smem, int n, Issue issue) {
  for (int k = 0; k < Stages<R>::N - 1; ++k) {
    if (k < n) issue(k, smem + k * Stage<R>::BYTES);
    cp_commit_group();
  }
}

template <int R, class Issue>
__device__ __forceinline__ const unsigned char* pipe_enter(unsigned char* smem, int i, int n,
                                                           Issue issue) {
  constexpr int NST = Stages<R>::N;
  if constexpr (NST == 2) {
    if (i + 1 < n) issue(i + 1, smem + ((i + 1) & 1) * Stage<R>::BYTES);
    cp_commit_group();
    cp_wait_one();
    __syncthreads();
  } else {
    cp_wait_one();
    __syncthreads();
    if (i + NST - 1 < n) issue(i + NST - 1, smem + ((i + NST - 1) % NST) * Stage<R>::BYTES);
    cp_commit_group();
  }
  return smem + (i % NST) * Stage<R>::BYTES;
}

template <int R>
__device__ __forceinline__ void pipe_leave() {
  if constexpr (Stages<R>::N == 2) __syncthreads();
}

template <int R>
__device__ __forceinline__ const float* stage_w1(const unsigned char* st) {
  return reinterpret_cast<const float*>(st + Stage<R>::W1);
}
template <int R>
__device__ __forceinline__ const float* stage_b1(const unsigned char* st) {
  return reinterpret_cast<const float*>(st + Stage<R>::B1);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Pass 1 on a tile of logits, the online maximum and sum of exp (mx, se) of
// each of the lane's two rows, in two parts: lse_begin takes the tile's
// maximum (over the quad's 64 columns) into mx and rescales se to it;
// lse_col adds exp(u - mx) of the lane's column pair in n8 tile j.
__device__ __forceinline__ void lse_begin(const float (&u)[NJG][4], float (&mx)[2],
                                          float (&se)[2]) {
  const float NEG_INF = -__int_as_float(0x7f800000);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tm = NEG_INF;
#pragma unroll
    for (int j = 0; j < NJG; ++j) tm = fmaxf(tm, fmaxf(u[j][2 * r], u[j][2 * r + 1]));
    const float mn = fmaxf(mx[r], quad_max(tm));
    se[r] = se[r] * __expf(mx[r] - mn);
    mx[r] = mn;
  }
}
__device__ __forceinline__ void lse_col(const float (&u)[NJG][4], int j, const float (&mx)[2],
                                        float (&se)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    se[r] += __expf(u[j][2 * r] - mx[r]);
    se[r] += __expf(u[j][2 * r + 1] - mx[r]);
  }
}
__device__ __forceinline__ void lse_tile(const float (&u)[NJG][4], float (&mx)[2],
                                         float (&se)[2]) {
  lse_begin(u, mx, se);
#pragma unroll
  for (int j = 0; j < NJG; ++j) lse_col(u, j, mx, se);
}

// The log-sum-exps of decoder m on rows row[0..1] (past N left out), after
// its last tile.
__device__ __forceinline__ void lse_store(const SmArgs& a, int m, const int (&row)[2],
                                          const float (&mx)[2], const float (&se)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = mx[r] + logf(quad_sum(se[r]));
    if ((threadIdx.x & 3) == 0 && row[r] < a.N) a.lse[(size_t)m * a.N + row[r]] = l;
  }
}

// Start the copies of decoder m's columns g0..g0+63 into stage st.
template <int R>
__device__ void stage_tile(unsigned char* st, const SmArgs& a, int m, int g0) {
  const int tid = threadIdx.x;
  if constexpr (R == F32) {
    const float* src = static_cast<const float*>(a.w2a) + (size_t)m * H * a.Gp + g0;
    float* dst = reinterpret_cast<float*>(st);
    for (int e = tid; e < H * SG / 4; e += NT) {
      const int k = e / (SG / 4), c = 4 * (e % (SG / 4));
      cp16(dst + k * SWF + c, src + (size_t)k * a.Gp + c);
    }
  } else {
#pragma unroll
    for (int p = 0; p < (R == F32X3 ? 2 : 1); ++p) {
      const __nv_bfloat16* src =
          static_cast<const __nv_bfloat16*>(p ? a.w2b : a.w2a) + (size_t)m * H * a.Gp + g0;
      __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(st) + p * H * SWH;
      for (int e = tid; e < H * SG / 8; e += NT) {
        const int k = e / (SG / 8), c = 8 * (e % (SG / 8));
        cp16(dst + k * SWH + c, src + (size_t)k * a.Gp + c);
      }
    }
  }
  float* w1 = reinterpret_cast<float*>(st + Stage<R>::W1);
  const float* w1g = a.w1 + (size_t)m * a.D * H;
  for (int e = 4 * tid; e < a.D * H; e += 4 * NT) cp16(w1 + e, w1g + e);
  if (tid < H / 4) {
    cp16(reinterpret_cast<float*>(st + Stage<R>::B1) + 4 * tid, a.b1 + (size_t)m * H + 4 * tid);
  } else if (tid < H / 4 + SG / 4) {
    const int c = 4 * (tid - H / 4);
    cp16(reinterpret_cast<float*>(st + Stage<R>::B2) + c, a.b2 + (size_t)m * a.Gp + g0 + c);
  }
}

// A decoder's hidden layer on the warp's 16 rows (zw: their points, SDMAX a
// row; w1 [d][k], b1 its weights): fp32 FMAs from b1 in d order, ReLU.
// Left as the A fragments of the product with W2 (the rung's hi and lo
// parts) or, at float32, as rows of hw (stride SHF); mk: the ReLU mask in
// the C-fragment layout (mask_bit).
template <int R>
__device__ __forceinline__ void hidden(const float* zw, const float* w1, const float* b1, int D,
                                       uint32_t (&ah)[NK2][4], uint32_t (&al)[NK2][4],
                                       uint32_t (&mk)[2], float* hw) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  mk[0] = mk[1] = 0u;
  float hc[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(&b1[8 * j + 2 * q]);
    hc[j][0] = hc[j][2] = b.x;
    hc[j][1] = hc[j][3] = b.y;
  }
  // d outermost: each unit's sum is still in d order, and a row's D values
  // are read one d at a time
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    const float z0 = zw[gq * SDMAX + d], z1 = zw[(gq + 8) * SDMAX + d];
#pragma unroll
    for (int j = 0; j < NJ2; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(&w1[d * H + 8 * j + 2 * q]);
      hc[j][0] = fmaf(z0, w.x, hc[j][0]);
      hc[j][1] = fmaf(z0, w.y, hc[j][1]);
      hc[j][2] = fmaf(z1, w.x, hc[j][2]);
      hc[j][3] = fmaf(z1, w.y, hc[j][3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ2; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hc[j][c] = fmaxf(hc[j][c], 0.f);
      if (hc[j][c] > 0.f) mk[j >> 3] |= 1u << ((j & 7) * 4 + c);
    }
  }
  if constexpr (R == F32) {
#pragma unroll
    for (int j = 0; j < NJ2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(&hw[(gq + 8 * r) * SHF + 8 * j + 2 * q]) =
            make_float2(hc[j][2 * r], hc[j][2 * r + 1]);
  } else {
    to_a<false>(hc, ah);
    if constexpr (R != BF16) to_a<true>(hc, al);
  }
}

// The logits of the staged tile's 64 columns on the warp's rows, in the
// C-fragment layout: h W2 at the rung, then + b2.
template <int R>
__device__ __forceinline__ void logits(float (&u)[NJG][4], const uint32_t (&ah)[NK2][4],
                                       const uint32_t (&al)[NK2][4], const unsigned char* st,
                                       const float* hw) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < NJG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[j][c] = 0.f;
  if constexpr (R == F32) {
    const float* wf = reinterpret_cast<const float*>(st);
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float h0 = hw[gq * SHF + k], h1 = hw[(gq + 8) * SHF + k];
#pragma unroll
      for (int j = 0; j < NJG; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(&wf[k * SWF + 8 * j + 2 * q]);
        u[j][0] = fmaf(h0, w.x, u[j][0]);
        u[j][1] = fmaf(h0, w.y, u[j][1]);
        u[j][2] = fmaf(h1, w.x, u[j][2]);
        u[j][3] = fmaf(h1, w.y, u[j][3]);
      }
    }
  } else {
    const __nv_bfloat16* wh = reinterpret_cast<const __nv_bfloat16*>(st);
    gemm_fwd<R, NJG>(u, ah, al, wh, wh + H * SWH, SWH, NJG);
  }
  const float* b2 = reinterpret_cast<const float*>(st + Stage<R>::B2);
#pragma unroll
  for (int j = 0; j < NJG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[j][c] = u[j][c] + b2[8 * j + 2 * q + (c & 1)];
}

// Store a tile's values (C-fragment layout) to rows row[0..1] of an
// (N, Gp) buffer from column g0, rows past N left out.
__device__ __forceinline__ void store_tile(float* out, const int (&row)[2], int N, int Gp, int g0,
                                           const float (&v)[NJG][4]) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (row[r] < N)
#pragma unroll
      for (int j = 0; j < NJG; ++j)
        *reinterpret_cast<float2*>(&out[(size_t)row[r] * Gp + g0 + 8 * j + 2 * q]) =
            make_float2(v[j][2 * r], v[j][2 * r + 1]);
}

// The block's points into sz (rows past N clamped, d >= D zero).
__device__ __forceinline__ void load_block_points(float* sz, const SmArgs& a, int r0) {
  for (int e = threadIdx.x; e < SRB * SDMAX; e += NT) {
    const int p = e / SDMAX, d = e % SDMAX;
    sz[e] = d < a.D ? a.z[(size_t)min(r0 + p, a.N - 1) * a.D + d] : 0.f;
  }
}

// xbar (and K1's var) of the block's rows: the row pass of K1 (STATS) and K2.
template <int R, bool STATS>
__device__ __forceinline__ void rows_body(const SmArgs& a) {
  constexpr int NSUB = STATS ? 1 : 2;  // tiles of a pass-2 strip
  const float NEG_INF = -__int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char smem[];
  float* sz = reinterpret_cast<float*>(smem + Stages<R>::N * Stage<R>::BYTES);
  float* sh = sz + SRB * SDMAX;
  float* sx0 = sh + (R == F32 ? SRB * SHF : 0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, q = lane & 3;
  const int N = a.N, B = a.B, M = a.M, Gp = a.Gp, nt = Gp / SG, r0 = blockIdx.x * SRB;
  load_block_points(sz, a, r0);
  const float* zw = sz + warp * 16 * SDMAX;
  float* hw = sh + warp * 16 * SHF;
  float* x0w = sx0 + warp * 16 * SWF;  // K1: decoder 0's x, the lane's own
  int row[2], rc[2], bs[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + warp * 16 + gq + 8 * r;
    rc[r] = min(row[r], N - 1);
    bs[r] = rc[r] % B;
  }
  uint32_t ah[NK2][4], al[NK2][4], mk[2];
  float mx[2], se[2], lse[2], wl[2], L = 0.f;
  float acc[NSUB][NJG][4];
  float sq[2] = {0.f, 0.f}, yb2[2] = {0.f, 0.f};
  // tile i: pass 1 (decoder m = i / nt, tile i % nt), then pass 2 (strip,
  // decoder, tile of the strip)
  const int n1 = M * nt, n = 2 * n1;
  auto tile = [&](int i, int& m, int& t) {
    if (i < n1) {
      m = i / nt;
      t = i % nt;
    } else {
      const int j = i - n1;
      m = (j / NSUB) % M;
      t = (j / (M * NSUB)) * NSUB + j % NSUB;
    }
  };
  auto issue = [&](int k, unsigned char* stage) {
    int m, t;
    tile(k, m, t);
    stage_tile<R>(stage, a, m, t * SG);
  };
  pipe_start<R>(smem, n, issue);
  for (int i = 0; i < n; ++i) {
    const unsigned char* st = pipe_enter<R>(smem, i, n, issue);
    int m, t;
    tile(i, m, t);
    float u[NJG][4];
    if (i < n1) {
      if (t == 0) {
        hidden<R>(zw, stage_w1<R>(st), stage_b1<R>(st), a.D, ah, al, mk, hw);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = NEG_INF;
          se[r] = 0.f;
        }
      }
      logits<R>(u, ah, al, st, hw);
      lse_tile(u, mx, se);
      if (t == nt - 1) lse_store(a, m, row, mx, se);
    } else {
      const int sub = STATS ? 0 : (i - n1) % NSUB;
      if (sub == 0) {
        hidden<R>(zw, stage_w1<R>(st), stage_b1<R>(st), a.D, ah, al, mk, hw);
        __syncwarp();
        L = a.lib[m];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse[r] = a.lse[(size_t)m * N + rc[r]];
          wl[r] = a.wmb[(size_t)m * B + bs[r]];
        }
      }
      logits<R>(u, ah, al, st, hw);
#pragma unroll
      for (int j = 0; j < NJG; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) u[j][c] = L * __expf(u[j][c] - lse[c >> 1]);
      if constexpr (STATS) {
        // centred on decoder 0: y = x - x0, acc = sum_m w_m y; x0 in
        // shared memory, each lane's own elements
        if (m == 0) {
#pragma unroll
          for (int j = 0; j < NJG; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              *reinterpret_cast<float2*>(&x0w[(gq + 8 * r) * SWF + 8 * j + 2 * q]) =
                  make_float2(u[j][2 * r], u[j][2 * r + 1]);
              acc[0][j][2 * r] = acc[0][j][2 * r + 1] = 0.f;
            }
        } else {
          float qs[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NJG; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 x0 =
                  *reinterpret_cast<const float2*>(&x0w[(gq + 8 * r) * SWF + 8 * j + 2 * q]);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float y = u[j][2 * r + e] - (e ? x0.y : x0.x);
                acc[0][j][2 * r + e] = acc[0][j][2 * r + e] + wl[r] * y;
                qs[r] += y * y;
              }
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) sq[r] = sq[r] + wl[r] * qs[r];
        }
        if (m == M - 1) {
#pragma unroll
          for (int j = 0; j < NJG; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 x0 =
                  *reinterpret_cast<const float2*>(&x0w[(gq + 8 * r) * SWF + 8 * j + 2 * q]);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float& v = acc[0][j][2 * r + e];
                yb2[r] += v * v;
                v = (e ? x0.y : x0.x) + v;
              }
            }
          store_tile(a.xbar, row, N, Gp, t * SG, acc[0]);
        }
      } else {
        // one register array per tile of the strip (indexed statically)
#pragma unroll
        for (int s = 0; s < NSUB; ++s)
          if (s == sub) {
#pragma unroll
            for (int j = 0; j < NJG; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[s][j][c] = m == 0 ? wl[c >> 1] * u[j][c]
                                      : acc[s][j][c] + wl[c >> 1] * u[j][c];
            if (m == M - 1) store_tile(a.xbar, row, N, Gp, t * SG, acc[s]);
          }
      }
    }
    pipe_leave<R>();
  }
  if constexpr (STATS) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float v = quad_sum(sq[r]) - quad_sum(yb2[r]);
      if (q == 0 && row[r] < N) a.var[row[r]] = M > 1 ? v : 0.f;
    }
  }
}

template <int R>
__global__ void __launch_bounds__(NT, 1) k1s_rows(const SmArgs a) {
  rows_body<R, true>(a);
}

template <int R>
__global__ void __launch_bounds__(NT, 1) k2s_rows(const SmArgs a) {
  rows_body<R, false>(a);
}

// dgamma of sum_b ct_b E_b on the block's rows: per decoder, pass 3 <s, g>
// over the Gp columns, pass 4 du W2^T, the ReLU mask and dh W1^T.
template <int R>
__global__ void __launch_bounds__(NT, 1) k2s_chain(const SmArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sz = reinterpret_cast<float*>(smem + Stages<R>::N * Stage<R>::BYTES);
  float* sdz = sz + SRB * SDMAX;
  float* sh = sdz + SRB * SDMAX;
  float* sdu = sh + SRB * SHF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, q = lane & 3;
  const int N = a.N, B = a.B, M = a.M, D = a.D, Gp = a.Gp, nt = Gp / SG, r0 = blockIdx.x * SRB;
  load_block_points(sz, a, r0);
  for (int e = tid; e < SRB * SDMAX; e += NT) sdz[e] = 0.f;
  const float* zw = sz + warp * 16 * SDMAX;
  float* hw = sh + warp * 16 * SHF;
  float* duw = sdu + warp * 16 * SWF;
  int row[2], rc[2], bs[2];
  float cnt[2], ctb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = r0 + warp * 16 + gq + 8 * r;
    rc[r] = min(row[r], N - 1);
    bs[r] = rc[r] % B;
    cnt[r] = (float)(rc[r] >= B) + (float)(rc[r] + B < N);
    ctb[r] = a.ct[bs[r]];
  }
  uint32_t ah[NK2][4], al[NK2][4], mk[2];
  float lse[2], sc[2], sg[2], L = 0.f;
  float dh[NJ2][4];
  // tile i: decoder i / (2 nt), pass 3 then pass 4, tile i % nt
  const int n = 2 * M * nt;
  auto issue = [&](int k, unsigned char* stage) {
    stage_tile<R>(stage, a, k / (2 * nt), (k % nt) * SG);
  };
  pipe_start<R>(smem, n, issue);
  for (int i = 0; i < n; ++i) {
    const unsigned char* st = pipe_enter<R>(smem, i, n, issue);
    const int m = i / (2 * nt), chain = (i / nt) & 1, t = i % nt, g0 = t * SG;
    if (!chain && t == 0) {
      hidden<R>(zw, stage_w1<R>(st), stage_b1<R>(st), D, ah, al, mk, hw);
      __syncwarp();
      L = a.lib[m];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse[r] = a.lse[(size_t)m * N + rc[r]];
        sc[r] = 2.f * a.wmb[(size_t)m * B + bs[r]] * ctb[r];
        sg[r] = 0.f;
      }
    }
    if (chain && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) sg[r] = quad_sum(sg[r]);
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dh[j][c] = 0.f;
    }
    // the tile's xbar_{t-1} + xbar_{t+1}, loaded before the product
    float2 nbv[2][NJG];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NJG; ++j)
        nbv[r][j] =
            *reinterpret_cast<const float2*>(&a.nb[(size_t)rc[r] * Gp + g0 + 8 * j + 2 * q]);
    float u[NJG][4];
    logits<R>(u, ah, al, st, hw);
    // s = exp(u - lse); g = 2 w_m ct_b (c_t L s - xbar_{t-1} - xbar_{t+1});
    // pass 3 sums s g, pass 4 leaves du = L s (g - <s, g>) in u
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < NJG; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float s = __expf(u[j][2 * r + e] - lse[r]);
          const float g = sc[r] * (cnt[r] * (L * s) - (e ? nbv[r][j].y : nbv[r][j].x));
          if (chain)
            u[j][2 * r + e] = (L * s) * (g - sg[r]);
          else
            sg[r] += s * g;
        }
      }
    if (chain) {
      if constexpr (R == F32) {
#pragma unroll
        for (int j = 0; j < NJG; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(&duw[(gq + 8 * r) * SWF + 8 * j + 2 * q]) =
                make_float2(u[j][2 * r], u[j][2 * r + 1]);
        __syncwarp();
        const float* wf = reinterpret_cast<const float*>(st);
#pragma unroll 2
        for (int g = 0; g < SG; ++g) {
          const float d0 = duw[gq * SWF + g], d1 = duw[(gq + 8) * SWF + g];
#pragma unroll
          for (int j = 0; j < NJ2; ++j) {
            const float w0 = wf[(8 * j + 2 * q) * SWF + g], w1 = wf[(8 * j + 2 * q + 1) * SWF + g];
            dh[j][0] = fmaf(d0, w0, dh[j][0]);
            dh[j][1] = fmaf(d0, w1, dh[j][1]);
            dh[j][2] = fmaf(d1, w0, dh[j][2]);
            dh[j][3] = fmaf(d1, w1, dh[j][3]);
          }
        }
        __syncwarp();
      } else {
        uint32_t adu[NKG][4];
        to_a<false>(u, adu);
        gemm_wt<NKG>(dh, adu, reinterpret_cast<const __nv_bfloat16*>(st), SWH, NKG);
      }
      if (t == nt - 1) {
        // dgamma[row][d] += sum_k [h > 0] dh[row][k] W1[d][k]: the quad's
        // four lanes hold the row's 128 units
        const float* w1 = reinterpret_cast<const float*>(st + Stage<R>::W1);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int d = 0; d < SDMAX; ++d) {
            if (d >= D) continue;
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < NJ2; ++j)
#pragma unroll
              for (int c = 2 * r; c < 2 * r + 2; ++c)
                if (mask_bit(mk, j, c)) v += dh[j][c] * w1[d * H + 8 * j + 2 * q + (c & 1)];
            v = quad_sum(v);
            if (q == 0) sdz[(warp * 16 + gq + 8 * r) * SDMAX + d] += v;
          }
      }
    }
    pipe_leave<R>();
  }
  __syncthreads();
  for (int e = tid; e < SRB * SDMAX; e += NT) {
    const int p = e / SDMAX, d = e % SDMAX;
    if (r0 + p < N && d < D) a.dz[(size_t)(r0 + p) * D + d] = sdz[e];
  }
}

// ---------------------------------------------------------------------------
// K2 at the reduced rungs: the row pass and the chain on warpgroup MMA
// ---------------------------------------------------------------------------

// A staged W2 plane tile (128 k x 64 columns, bf16) in wgmma's no-swizzle
// layout: core matrices of 8 rows of 16 bytes, each 128 contiguous bytes;
// element (k, g) at byte (k / 8) KG + (g / 8) CM + (k % 8) 16 + (g % 8) 2.
// The forward product reads it N-major (B = W2, columns contiguous), the
// chain's K-major (B = W2^T, the same bytes).  The wrapper ships K2's planes
// at the reduced rungs tiled (energy_softmax.tiled): tile (m, c) is one
// contiguous block in this layout, one bulk copy.
constexpr int CM = 128;           // bytes of a core matrix
constexpr int KG = SG / 8 * CM;   // bytes between groups of 8 k (1024)
constexpr int PLANE = H * SG * 2;  // bytes of a plane tile
constexpr int NBS = SG + 8;       // float row stride of a staged nb tile

// One stage: W2's planes (hi, and lo at f32x3), the tile's b2 and, for the
// chain, the block's 128 rows of nb, or, for the row pass, room for the
// decoder's W1 and b1, copied with the tiles that start a hidden layer
// (pass 2 forms it every second tile); four stages (three for the chain at
// f32x3, whose two planes and nb fill shared memory).  The chain reads W1
// and b1 from global memory (L1): it forms a hidden layer once a decoder.
template <int R, bool CHAIN>
struct WgStage {
  static constexpr int NPL = R == F32X3 ? 2 : 1;
  static constexpr int B2 = NPL * PLANE;
  static constexpr int NB = B2 + SG * 4;  // the chain's nb
  static constexpr int W1 = NB;           // the row pass's W1, then b1
  static constexpr int B1 = W1 + SDMAX * H * 4;
  static constexpr int BYTES = CHAIN ? NB + SRB * NBS * 4 : B1 + H * 4;
  static constexpr int N = CHAIN && R == F32X3 ? 3 : 4;
  // the bytes a stage's copies bring, W1 and b1 left out
  static constexpr uint32_t TX = NB + (CHAIN ? SRB * NBS * 4 : 0);
};

// The stages, the block's points, the chain's dgamma sums and one barrier a
// stage.
template <int R, bool CHAIN>
constexpr int wg_smem_bytes() {
  return WgStage<R, CHAIN>::N * (WgStage<R, CHAIN>::BYTES + 8) +
         SRB * SDMAX * 4 * (CHAIN ? 2 : 1);
}

// A stage's barrier (mbarrier): one arrival, the one that announces the
// stage's bytes; its phase completes when they have landed.
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(b)) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}
// A bulk copy of bytes (a multiple of 16) from global to shared memory,
// completing on barrier b: the copy engine moves it, no thread waits.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(b))
      : "memory");
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery): the tile indices of the wgmma kernels, every step.
struct FastDiv {
  uint32_t d, mul, sh;
  __device__ explicit FastDiv(uint32_t dv) : d(dv), sh(0) {
    while ((1u << sh) < d) ++sh;
    mul = (uint32_t)(((uint64_t)1 << 32) * (((uint64_t)1 << sh) - d) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, mul) + (uint32_t)n) >> sh);
  }
  __device__ __forceinline__ int mod(int n) const { return n - div(n) * (int)d; }
};

// A descriptor of B in shared memory, no swizzle: lbo the byte stride between
// core matrices along K, sbo along N.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin an accumulator's registers here: its reads after a wait stay after it.
template <int NJ>
__device__ __forceinline__ void wg_pin(float (&d)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
}

// d (64 x 64) = A (64 x 16) B (16 x 64) (+ d if acc), bf16 -> fp32, issued
// asynchronously by the warpgroup: A from registers (each warp's mma.sync A
// fragment of its 16 rows), B by descriptor (TB 1: N-major), d in the
// C-fragment layout of each warp's 16 rows (d[j]: columns 8j..8j+7).
template <int TB>
__device__ __forceinline__ void wg_n64(float (&d)[NJG][4], const uint32_t (&a)[4], uint64_t b,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}

// d (64 x 128) = A (64 x 16) B (16 x 128) (+ d if acc); TB 0: B K-major.
template <int TB>
__device__ __forceinline__ void wg_n128(float (&d)[NJ2][4], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
}

// The threads that start a stage's copies: lane 0 of warps 0, 4, 1 and 5,
// one copy each, so that no warp of either warpgroup falls behind by all.
__device__ __forceinline__ bool wg_copier() {
  return (threadIdx.x & 31) == 0 && (threadIdx.x >> 5) % 4 < 2;
}

// Start the copies of decoder m's column tile c into stage st, completing on
// its barrier bar, each by one of the wg_copier threads (the first one
// announces the stage's bytes; a copy may land before that): W2's hi plane;
// b2 and, for the row pass's tiles that start a hidden layer (with_w1), W1
// and b1; the lo plane (f32x3); for the chain, the block's tile of nb (K2's
// tiled nb at the reduced rungs: the block's 128 rows, NBS floats apart,
// zero past N).
template <int R, bool CHAIN>
__device__ __forceinline__ void wg_stage_tile(unsigned char* st, uint64_t* bar, const SmArgs& a,
                                              int m, int c, bool with_w1 = false) {
  using S = WgStage<R, CHAIN>;
  const int nt = a.Gp / SG, role = (threadIdx.x >> 5) % 4 * 2 + (threadIdx.x >> 7);
  const size_t tile = ((size_t)m * nt + c) * PLANE;
  const uint32_t w1_bytes = a.D * H * 4;
  if (role == 0) {
    mbar_expect(bar, S::TX + (with_w1 ? w1_bytes + H * 4 : 0));
    bulk_copy(st, static_cast<const unsigned char*>(a.w2a) + tile, PLANE, bar);
  } else if (role == 1) {
    bulk_copy(st + S::B2, a.b2 + (size_t)m * a.Gp + c * SG, SG * 4, bar);
    if (!CHAIN && with_w1) {
      bulk_copy(st + S::W1, a.w1 + (size_t)m * a.D * H, w1_bytes, bar);
      bulk_copy(st + S::B1, a.b1 + (size_t)m * H, H * 4, bar);
    }
  } else if (role == 2) {
    if constexpr (S::NPL == 2)
      bulk_copy(st + PLANE, static_cast<const unsigned char*>(a.w2b) + tile, PLANE, bar);
  } else if constexpr (CHAIN) {
    bulk_copy(st + S::NB, a.nb + ((size_t)blockIdx.x * nt + c) * SRB * NBS, SRB * NBS * 4, bar);
  }
}

// Issue k16 step kk of the logits u = h W2 of the staged tile on the
// warpgroup's 64 rows: the rung's bf16 products (b2 is added after the
// wait).  wg_logits: all eight steps as one commit group.
template <int R>
__device__ __forceinline__ void wg_logits_k(float (&u)[NJG][4], const uint32_t (&ah)[NK2][4],
                                            const uint32_t (&al)[NK2][4], const unsigned char* st,
                                            int kk) {
  const uint64_t bh = wg_desc(st + 2 * kk * KG, KG, CM);
  wg_n64<1>(u, ah[kk], bh, kk);
  if constexpr (R == F32X2 || R == F32X3) wg_n64<1>(u, al[kk], bh, 1);
  if constexpr (R == F32X3) wg_n64<1>(u, ah[kk], wg_desc(st + PLANE + 2 * kk * KG, KG, CM), 1);
}
template <int R>
__device__ __forceinline__ void wg_logits(float (&u)[NJG][4], const uint32_t (&ah)[NK2][4],
                                          const uint32_t (&al)[NK2][4], const unsigned char* st) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < NK2; ++kk) wg_logits_k<R>(u, ah, al, st, kk);
  wg_commit();
}

__device__ __forceinline__ void add_b2(float (&u)[NJG][4], const unsigned char* b2s) {
  const float* b2 = reinterpret_cast<const float*>(b2s);
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NJG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) u[j][c] = u[j][c] + b2[8 * j + 2 * q + (c & 1)];
}

// The tile walk of the wgmma kernels: FastDivs by nt and M, and where the
// block starts its walk over the columns.  Each block starts at its own
// column tile (strip), rot, so that the blocks do not all read the same W2
// tile at once; each row still sums its columns in one fixed order.
struct Walk {
  FastDiv nt, m;
  int rot, rot2;  // the first column tile, the first strip of pass 2
  __device__ Walk(int nt_, int m_)
      : nt(nt_), m(m_), rot(nt.mod(blockIdx.x)), rot2(rot % (nt_ / 2)) {}
};

// Tile i of K2's row pass: pass 1 (decoder i / nt, the block's t-th column
// tile, t = i % nt), then pass 2 (strip, decoder, tile of the strip) from
// n1 = M nt on; c: its column tile.  True where the tile starts its
// decoder's hidden layer (pass 1's first, each strip's first).
__device__ __forceinline__ bool rows_tile(const Walk& w, int i, int n1, int& m, int& c) {
  const int nt = w.nt.d;
  if (i < n1) {
    m = w.nt.div(i);
    const int t = i - m * nt + w.rot;
    c = t < nt ? t : t - nt;
    return t == w.rot;
  }
  const int j = i - n1, ns = nt / 2, jm = w.m.div(j >> 1);
  const int sp = jm + w.rot2;
  m = (j >> 1) - jm * (int)w.m.d;
  c = 2 * (sp < ns ? sp : sp - ns) + (j & 1);
  return (j & 1) == 0;
}

// A thread's state in k2s_rows_wg: its two rows, the hidden layer's A
// fragments, pass 1's running maxima and sums, pass 2's strip of xbar, and
// the two accumulators of logits that take turns (u[P]: tile i's).
struct RowsWg {
  int row[2], rc[2], bs[2];
  uint32_t ah[NK2][4], al[NK2][4], mk[2];
  float mx[2], se[2], lse[2], wl[2], L;
  float acc[2][NJG][4], u[2][NJG][4];
};

template <int R>
__device__ __forceinline__ void rows_wg_issue(unsigned char* wsm, uint64_t* bars, const Walk& w,
                                              const SmArgs& a, int k) {
  using S = WgStage<R, false>;
  int m, c;
  const bool fresh = rows_tile(w, k, a.M * (int)w.nt.d, m, c);
  wg_stage_tile<R, false>(wsm + (k % S::N) * S::BYTES, bars + k % S::N, a, m, c, fresh);
}

// Tile i of k2s_rows_wg (P = i % 2).  The warpgroup's products of tile i,
// issued during tile i - 1, are waited for; the wg_copier threads start
// the copies of tile i + 3 into the stage tile i - 1 left; then tile i + 1's
// products are issued k16 step by k16 step, each step's wgmma followed by
// the exponentials of one n8 column tile of tile i: a warpgroup's wgmma issue
// stalls until the tensor cores have taken most of what is queued, so the
// tile's arithmetic runs between the issues while the products run.  Every
// tile issues the next tile's products (the last one's read by nobody), so
// no accumulator is in flight on one side of a branch only, and each pass
// has its own copy of the code (PASS 1 or 2).  n1 is even (nt is), so P is
// also tile i's place in its pass-2 strip.
template <int R, int P, int PASS>
__device__ __forceinline__ void rows_wg_tile(RowsWg& s, const Walk& w, const SmArgs& a,
                                             unsigned char* wsm, uint64_t* bars, const float* zw,
                                             int r0, int i) {
  using S = WgStage<R, false>;
  constexpr int NST = S::N;
  const float NEG_INF = -__int_as_float(0x7f800000);
  const int N = a.N, M = a.M, nt = w.nt.d, n1 = M * nt, n = 2 * n1;
  const unsigned char* st = wsm + (i % NST) * S::BYTES;
  const unsigned char* st1 = wsm + ((i + 1) % NST) * S::BYTES;
  wg_wait<0>();
  __syncthreads();
  if (wg_copier() && i + NST - 1 < n) rows_wg_issue<R>(wsm, bars, w, a, i + NST - 1);
  int m1, c1, m, c;
  if (i + 1 < n) {
    mbar_wait(bars + (i + 1) % NST, ((i + 1) / NST) & 1);
    if (rows_tile(w, i + 1, n1, m1, c1))
      hidden<R>(zw, reinterpret_cast<const float*>(st1 + S::W1),
                reinterpret_cast<const float*>(st1 + S::B1), a.D, s.ah, s.al, s.mk, nullptr);
  }
  const bool fresh = rows_tile(w, i, n1, m, c);
  float(&u)[NJG][4] = s.u[P];
  float(&un)[NJG][4] = s.u[1 - P];
  wg_pin(u);
  add_b2(u, st + S::B2);
  wg_fence();
  if constexpr (PASS == 1) {
    if (fresh)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s.mx[r] = NEG_INF;
        s.se[r] = 0.f;
      }
    lse_begin(u, s.mx, s.se);
#pragma unroll
    for (int j = 0; j < NJG; ++j) {
      wg_logits_k<R>(un, s.ah, s.al, st1, j);
      lse_col(u, j, s.mx, s.se);
    }
    wg_commit();
    if (i - m * nt == nt - 1) lse_store(a, m, s.row, s.mx, s.se);
    return;
  }
  if (fresh) {
    s.L = a.lib[m];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s.lse[r] = a.lse[(size_t)m * N + s.rc[r]];
      s.wl[r] = a.wmb[(size_t)m * a.B + s.bs[r]];
    }
  }
#pragma unroll
  for (int j = 0; j < NJG; ++j) {
    wg_logits_k<R>(un, s.ah, s.al, st1, j);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = s.L * __expf(u[j][k] - s.lse[k >> 1]);
      s.acc[P][j][k] = m == 0 ? s.wl[k >> 1] * x : s.acc[P][j][k] + s.wl[k >> 1] * x;
    }
  }
  wg_commit();
  if (m == M - 1) store_tile(a.xbar, s.row, N, a.Gp, c * SG, s.acc[P]);
}

// The shared memory of the wgmma kernels: the stages, then the block's
// points (and the chain's dgamma sums), then the stages' barriers, which
// this initialises before it loads the block's points.
template <int R, bool CHAIN>
__device__ __forceinline__ uint64_t* wg_start(unsigned char* wsm, const SmArgs& a, int r0) {
  using S = WgStage<R, CHAIN>;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(wsm + S::N * S::BYTES + SRB * SDMAX * 4 * (CHAIN ? 2 : 1));
  if (threadIdx.x == 0) {
    for (int k = 0; k < S::N; ++k) mbar_init(bars + k);
    mbar_fence_init();
  }
  load_block_points(reinterpret_cast<float*>(wsm + S::N * S::BYTES), a, r0);
  __syncthreads();
  return bars;
}

// K2's row pass at the reduced rungs: k2s_rows' tiles and arithmetic, each
// warpgroup's next logits issued during this tile's exponentials.
template <int R>
__global__ void __launch_bounds__(NT, 1) k2s_rows_wg(const SmArgs a) {
  using S = WgStage<R, false>;
  constexpr int NST = S::N;
  extern __shared__ __align__(128) unsigned char wsm[];
  const float* sz = reinterpret_cast<const float*>(wsm + NST * S::BYTES);
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2;
  const Walk w(a.Gp / SG, a.M);
  const int n = 2 * a.M * (int)w.nt.d, r0 = blockIdx.x * SRB;
  uint64_t* bars = wg_start<R, false>(wsm, a, r0);
  const float* zw = sz + warp * 16 * SDMAX;
  RowsWg s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s.row[r] = r0 + warp * 16 + gq + 8 * r;
    s.rc[r] = min(s.row[r], a.N - 1);
    s.bs[r] = s.rc[r] % a.B;
  }
#pragma unroll
  for (int j = 0; j < NJG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s.u[0][j][c] = s.u[1][j][c] = 0.f;
  if (wg_copier())
    for (int k = 0; k < NST - 1 && k < n; ++k) rows_wg_issue<R>(wsm, bars, w, a, k);
  mbar_wait(bars, 0);
  hidden<R>(zw, reinterpret_cast<const float*>(wsm + S::W1),
            reinterpret_cast<const float*>(wsm + S::B1), a.D, s.ah, s.al, s.mk, nullptr);
  wg_logits<R>(s.u[0], s.ah, s.al, wsm);
  // tiles in pairs, nothing in flight where a loop branches back
  for (int i = 0; i < n / 2; i += 2) {
    rows_wg_tile<R, 0, 1>(s, w, a, wsm, bars, zw, r0, i);
    rows_wg_tile<R, 1, 1>(s, w, a, wsm, bars, zw, r0, i + 1);
    wg_wait<0>();
  }
  for (int i = n / 2; i < n; i += 2) {
    rows_wg_tile<R, 0, 2>(s, w, a, wsm, bars, zw, r0, i);
    rows_wg_tile<R, 1, 2>(s, w, a, wsm, bars, zw, r0, i + 1);
    wg_wait<0>();
  }
}

// A thread's state in k2s_chain_wg: its two rows, the hidden layer's A
// fragments and ReLU masks (mkn: of the hidden layer formed last, for the
// decoder whose pass 3 comes next; mk: the tile's decoder's), the per-row
// scalars of the passes, dh and the two accumulators of logits.
struct ChainWg {
  int row[2], rc[2], bs[2];
  float cnt[2], ctb[2];
  uint32_t ah[NK2][4], al[NK2][4], mk[2], mkn[2];
  float lse[2], sc[2], sg[2], L;
  float dh[NJ2][4], u[2][NJG][4];
};

// Tile k of the chain: decoder k / (2 nt), the block's t-th column tile.
template <int R>
__device__ __forceinline__ void chain_wg_issue(unsigned char* wsm, uint64_t* bars, const Walk& w,
                                               const SmArgs& a, int k) {
  using S = WgStage<R, true>;
  const int m = w.nt.div(k >> 1), nt = w.nt.d, t = w.nt.mod(k) + w.rot;
  wg_stage_tile<R, true>(wsm + (k % S::N) * S::BYTES, bars + k % S::N, a, m,
                         t < nt ? t : t - nt);
}

// Tile i of k2s_chain_wg (decoder i / (2 nt), PASS 3 then 4, the block's
// t-th column tile, t = i % nt; P = i % 2), as rows_wg_tile.  Pass 4 also
// issues du W2^T on the same staged tile, read K-major, with du's bf16 A
// fragments from registers (each k16 step once its two column tiles are
// done) and dh (64 x 128) accumulated in registers; the next tile waits
// for it before the tile's stage is given back.
template <int R, int P, int PASS>
__device__ __forceinline__ void chain_wg_tile(ChainWg& s, const Walk& w, const SmArgs& a,
                                              unsigned char* wsm, uint64_t* bars,
                                              const float* zw, int r0, int i) {
  using S = WgStage<R, true>;
  constexpr int NST = S::N;
  constexpr bool chain = PASS == 4;
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int D = a.D, nt = w.nt.d, n = 2 * a.M * nt;
  const unsigned char* st = wsm + (i % NST) * S::BYTES;
  const unsigned char* st1 = wsm + ((i + 1) % NST) * S::BYTES;
  wg_wait<0>();
  __syncthreads();
  if (wg_copier() && i + NST - 1 < n) chain_wg_issue<R>(wsm, bars, w, a, i + NST - 1);
  const int m = w.nt.div(i >> 1), t = i - 2 * m * nt - (chain ? nt : 0);
  if (i + 1 < n) {
    mbar_wait(bars + (i + 1) % NST, ((i + 1) / NST) & 1);
    if (chain && t == nt - 1) {
      const int m1 = m + 1;
      if (m1 < a.M)
        hidden<R>(zw, a.w1 + (size_t)m1 * D * H, a.b1 + (size_t)m1 * H, D, s.ah, s.al, s.mkn,
                  nullptr);
    }
  }
  if (!chain && t == 0) {
    s.L = a.lib[m];
    s.mk[0] = s.mkn[0];
    s.mk[1] = s.mkn[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s.lse[r] = a.lse[(size_t)m * a.N + s.rc[r]];
      s.sc[r] = 2.f * a.wmb[(size_t)m * a.B + s.bs[r]] * s.ctb[r];
      s.sg[r] = 0.f;
    }
  }
  if (chain && t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) s.sg[r] = quad_sum(s.sg[r]);
  float(&u)[NJG][4] = s.u[P];
  float(&un)[NJG][4] = s.u[1 - P];
  wg_pin(u);
  add_b2(u, st + S::B2);
  // s = exp(u - lse); g = 2 w_m ct_b (c_t L s - xbar_{t-1} - xbar_{t+1});
  // pass 3 sums s g, pass 4 leaves du = L s (g - <s, g>) in u
  const float* nbw = reinterpret_cast<const float*>(st + S::NB) + (warp * 16 + gq) * NBS + 2 * q;
  wg_fence();
#pragma unroll
  for (int j = 0; j < NJG; ++j) {
    wg_logits_k<R>(un, s.ah, s.al, st1, j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 nb = *reinterpret_cast<const float2*>(nbw + 8 * r * NBS + 8 * j);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float sm = __expf(u[j][2 * r + e] - s.lse[r]);
        const float g = s.sc[r] * (s.cnt[r] * (s.L * sm) - (e ? nb.y : nb.x));
        if constexpr (chain)
          u[j][2 * r + e] = (s.L * sm) * (g - s.sg[r]);
        else
          s.sg[r] += sm * g;
      }
    }
    if constexpr (chain) {
      if (j & 1) {
        uint32_t adu[4];
        adu[0] = bf16x2(u[j - 1][0], u[j - 1][1]);
        adu[1] = bf16x2(u[j - 1][2], u[j - 1][3]);
        adu[2] = bf16x2(u[j][0], u[j][1]);
        adu[3] = bf16x2(u[j][2], u[j][3]);
        wg_fence();
        wg_n128<0>(s.dh, adu, wg_desc(st + (j - 1) * CM, CM, KG), t > 0 || j > 1);
      }
    }
  }
  wg_commit();
}

// dgamma[row][d] += sum_k [h > 0] dh[row][k] W1[d][k] of decoder m (its
// masks mk), dh complete: the quad's four lanes hold the row's 128 units.
__device__ __forceinline__ void chain_wg_dz(const ChainWg& s, const SmArgs& a, float* sdz,
                                            int m) {
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const int D = a.D;
  const float* w1 = a.w1 + (size_t)m * D * H;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < SDMAX; ++d) {
      if (d >= D) continue;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NJ2; ++j)
#pragma unroll
        for (int c = 2 * r; c < 2 * r + 2; ++c)
          if (mask_bit(s.mk, j, c)) v += s.dh[j][c] * w1[d * H + 8 * j + 2 * q + (c & 1)];
      v = quad_sum(v);
      if (q == 0) sdz[(warp * 16 + gq + 8 * r) * SDMAX + d] += v;
    }
}

// K2's chain at the reduced rungs: k2s_chain's tiles and arithmetic on
// warpgroup MMA (chain_wg_tile).
template <int R>
__global__ void __launch_bounds__(NT, 1) k2s_chain_wg(const SmArgs a) {
  using S = WgStage<R, true>;
  constexpr int NST = S::N;
  extern __shared__ __align__(128) unsigned char wsm[];
  const float* sz = reinterpret_cast<const float*>(wsm + NST * S::BYTES);
  float* sdz = reinterpret_cast<float*>(wsm + NST * S::BYTES) + SRB * SDMAX;
  const int tid = threadIdx.x, warp = tid >> 5, gq = (tid & 31) >> 2;
  const int N = a.N, B = a.B, D = a.D, r0 = blockIdx.x * SRB;
  const Walk w(a.Gp / SG, a.M);
  const int nt = w.nt.d, n = 2 * a.M * nt;
  for (int e = tid; e < SRB * SDMAX; e += NT) sdz[e] = 0.f;
  uint64_t* bars = wg_start<R, true>(wsm, a, r0);
  const float* zw = sz + warp * 16 * SDMAX;
  ChainWg s;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    s.row[r] = r0 + warp * 16 + gq + 8 * r;
    s.rc[r] = min(s.row[r], N - 1);
    s.bs[r] = s.rc[r] % B;
    s.cnt[r] = (float)(s.rc[r] >= B) + (float)(s.rc[r] + B < N);
    s.ctb[r] = a.ct[s.bs[r]];
  }
#pragma unroll
  for (int j = 0; j < NJG; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s.u[0][j][c] = s.u[1][j][c] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ2; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s.dh[j][c] = 0.f;
  if (wg_copier())
    for (int k = 0; k < NST - 1 && k < n; ++k) chain_wg_issue<R>(wsm, bars, w, a, k);
  mbar_wait(bars, 0);
  hidden<R>(zw, a.w1, a.b1, D, s.ah, s.al, s.mkn, nullptr);
  wg_logits<R>(s.u[0], s.ah, s.al, wsm);
  // per decoder pass 3, then pass 4, in tile pairs, nothing in flight where
  // a loop branches back; then the decoder's dgamma from the finished dh
  for (int i = 0; i < n;) {
    for (const int e = i + nt; i < e; i += 2) {
      chain_wg_tile<R, 0, 3>(s, w, a, wsm, bars, zw, r0, i);
      chain_wg_tile<R, 1, 3>(s, w, a, wsm, bars, zw, r0, i + 1);
      wg_wait<0>();
    }
    for (const int e = i + nt; i < e; i += 2) {
      chain_wg_tile<R, 0, 4>(s, w, a, wsm, bars, zw, r0, i);
      chain_wg_tile<R, 1, 4>(s, w, a, wsm, bars, zw, r0, i + 1);
      wg_wait<0>();
    }
    wg_pin(s.dh);
    chain_wg_dz(s, a, sdz, w.nt.div(i >> 1) - 1);
  }
  __syncthreads();
  for (int e = tid; e < SRB * SDMAX; e += NT) {
    const int p = e / SDMAX, d = e % SDMAX;
    if (r0 + p < N && d < D) a.dz[(size_t)(r0 + p) * D + d] = sdz[e];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool valid(const SmArgs& a, int rung) {
  return a.N >= 1 && a.B >= 1 && a.M >= 1 && a.D >= 1 && a.D <= SDMAX && a.Gp >= 2 * SG &&
         a.Gp % (2 * SG) == 0 && aligned16(a.w1) && aligned16(a.b1) && aligned16(a.w2a) &&
         aligned16(a.b2) && (rung != F32X3 || (a.w2b != nullptr && aligned16(a.w2b)));
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// K1's (stats 1) or K2's (stats 0) row pass: lse (M, N), xbar (N, Gp) and,
// for K1, var (N,).  Weights padded as the header says, W2's planes tiled
// for K2 at the reduced rungs; D <= 16, Gp a multiple of 128.
int vlg_softmax_rows(int rung, int stats, const float* z, const float* w1, const float* b1,
                     const void* w2a, const void* w2b, const float* b2, const float* lib,
                     const float* wmb, float* lse, float* xbar, float* var, int N, int B, int M,
                     int D, int Gp, void* stream) {
  const SmArgs a{z, w1, b1, w2a, w2b, b2, lib, wmb, nullptr, lse, xbar, var, nullptr, nullptr,
                 N, B, M, D, Gp};
  if (!valid(a, rung)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + SRB - 1) / SRB;
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    // K2 at the reduced rungs on warpgroup MMA; K1 at every rung and K2 at
    // float32 (no tensor cores) on rows_body
    int bytes = smem_bytes<R, false, true>();
    auto kernel = k1s_rows<R>;
    if (!stats) {
      if constexpr (R == F32) {
        bytes = smem_bytes<R, false>();
        kernel = k2s_rows<R>;
      } else {
        bytes = wg_smem_bytes<R, false>();
        kernel = k2s_rows_wg<R>;
      }
    }
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, NT, bytes, st>>>(a);
    return cudaGetLastError();
  });
}

// K2's chain: dgamma (N, D) from the row pass's lse and the neighbour sums
// nb of its xbar ((N, Gp) at float32, tiled at the reduced rungs, as W2's
// planes), ct (B,) the energies' cotangents.
int vlg_softmax_chain(int rung, const float* z, const float* w1, const float* b1,
                      const void* w2a, const void* w2b, const float* b2, const float* lib,
                      const float* wmb, const float* ct, const float* lse, const float* nb,
                      float* dz, int N, int B, int M, int D, int Gp, void* stream) {
  const SmArgs a{z, w1, b1, w2a, w2b, b2, lib, wmb, ct, const_cast<float*>(lse), nullptr,
                 nullptr, nb, dz, N, B, M, D, Gp};
  if (!valid(a, rung)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (N + SRB - 1) / SRB;
  return by_rung(rung, [&](auto r) {
    constexpr int R = decltype(r)::value;
    int bytes = smem_bytes<R, true>();
    auto kernel = k2s_chain<F32>;
    if constexpr (R != F32) {
      bytes = wg_smem_bytes<R, true>();
      kernel = k2s_chain_wg<R>;
    }
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, NT, bytes, st>>>(a);
    return cudaGetLastError();
  });
}

}  // extern "C"
