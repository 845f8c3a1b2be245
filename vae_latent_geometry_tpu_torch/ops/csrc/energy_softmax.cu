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
// at f32x3) or, at float32, in float.
//
// A block owns 128 curve rows (n = t B + b), 16 a warp, and walks the Gp
// columns in tiles of 64.  Each tile of W2 is staged with its decoder's W1,
// b1 and b2 by cp.async into one of three shared-memory stages (two at
// float32) while another one is computed on, one barrier a tile.  A warp's
// rows and columns are mma.sync m16n8k16 fragments (decode_mma.cuh): the
// hidden layer is computed in fp32 FMAs, in d order, straight into the A
// fragments of the product with W2; u = h W2 runs the rung's bf16 hi/lo
// passes on the tensor cores (gemm_fwd), and the chain's du W2^T single-pass
// bf16 (gemm_wt) from the same staged tile.  At float32 both products are
// fp32 FMAs from h, du and a float tile in shared memory (no TF32).
//
// Every row reduction (the log-sum-exp, <s, g>, the variance, the dgamma
// sums) is summed in one fixed order: each lane over its own columns, then
// the quad's four lanes by two shuffles; a repeat is bit for bit the same.
//
//   k1s_rows / k2s_rows: pass 1, per decoder the log-sum-exp of each row
//     (an online maximum and sum) -> lse (M, N); pass 2, per strip of 64
//     (K1) or 128 (K2) columns and per decoder, x = L exp(u - lse) summed
//     into xbar (N, Gp) with the spline's decoder weights (K1: centred on
//     decoder 0, the variance -> var (N,)).
//   k2s_chain: per decoder, pass 3 <s, g> over the Gp columns, g the
//     cotangent of x; pass 4 du = L s (g - <s, g>), dh = du W2^T, the ReLU
//     mask and dgamma += dh W1^T (fp32).
//
// What bounds it: the products with W2, 99.5% of the decoder's multiply-adds
// at scVI's 10-128-2000.  Each pass forms u again from the staged tile (K2:
// four times per point and decoder, and du W2^T once), in exchange for no
// (M, N, G) buffer; pass 2 forms the hidden layer again per strip and
// decoder (10 -> 128: 1/13 of a 128-column strip's product at f32x2).  At
// 255 registers a thread (h's fragments, a tile's logits and the strip's
// or the chain's accumulators) a block of 8 warps fills an SM, so a tile's
// products and its exponentials and row sums overlap only across warps:
// on the H100 a pass over the tiles takes about three times what its
// mma.sync products alone would.

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
  const void* w2a;     // (M, 128, Gp): the hi plane (bf16), float at float32
  const void* w2b;     // the lo plane at f32x3
  const float* b2;     // (M, Gp)
  const float* lib;    // (M,) library sizes
  const float* wmb;    // (M, B) decoder weights of each spline
  const float* ct;     // (B,) cotangents of the energies (chain)
  float* lse;          // (M, N)
  float* xbar;         // (N, Gp)
  float* var;          // (N,) (K1)
  const float* nb;     // (N, Gp) xbar_{t-1} + xbar_{t+1} (chain)
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

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
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

// The staged decoder's hidden layer on the warp's 16 rows (zw: their
// points, SDMAX a row): fp32 FMAs from b1 in d order, ReLU.
// Left as the A fragments of the product with W2 (the rung's hi and lo
// parts) or, at float32, as rows of hw (stride SHF); mk: the ReLU mask in
// the C-fragment layout (mask_bit).
template <int R>
__device__ __forceinline__ void hidden(const float* zw, const unsigned char* st, int D,
                                       uint32_t (&ah)[NK2][4], uint32_t (&al)[NK2][4],
                                       uint32_t (&mk)[2], float* hw) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
  const float* w1 = reinterpret_cast<const float*>(st + Stage<R>::W1);
  const float* b1 = reinterpret_cast<const float*>(st + Stage<R>::B1);
  float zr[2][SDMAX];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int d = 0; d < SDMAX; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(&zw[(gq + 8 * r) * SDMAX + d]);
      zr[r][d] = v.x;
      zr[r][d + 1] = v.y;
      zr[r][d + 2] = v.z;
      zr[r][d + 3] = v.w;
    }
  mk[0] = mk[1] = 0u;
  float hc[NJ2][4];
#pragma unroll
  for (int j = 0; j < NJ2; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(&b1[8 * j + 2 * q]);
    hc[j][0] = hc[j][2] = b.x;
    hc[j][1] = hc[j][3] = b.y;
#pragma unroll
    for (int d = 0; d < SDMAX; ++d)
      if (d < D) {
        const float2 w = *reinterpret_cast<const float2*>(&w1[d * H + 8 * j + 2 * q]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          hc[j][c] = fmaf(zr[c >> 1][d], c & 1 ? w.y : w.x, hc[j][c]);
        }
      }
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
        hidden<R>(zw, st, a.D, ah, al, mk, hw);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = NEG_INF;
          se[r] = 0.f;
        }
      }
      logits<R>(u, ah, al, st, hw);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tm = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJG; ++j) tm = fmaxf(tm, fmaxf(u[j][2 * r], u[j][2 * r + 1]));
        const float mn = fmaxf(mx[r], quad_max(tm));
        float s = se[r] * __expf(mx[r] - mn);
#pragma unroll
        for (int j = 0; j < NJG; ++j) {
          s += __expf(u[j][2 * r] - mn);
          s += __expf(u[j][2 * r + 1] - mn);
        }
        se[r] = s;
        mx[r] = mn;
      }
      if (t == nt - 1)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float l = mx[r] + logf(quad_sum(se[r]));
          if (q == 0 && row[r] < N) a.lse[(size_t)m * N + row[r]] = l;
        }
    } else {
      const int sub = STATS ? 0 : (i - n1) % NSUB;
      if (sub == 0) {
        hidden<R>(zw, st, a.D, ah, al, mk, hw);
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
      hidden<R>(zw, st, D, ah, al, mk, hw);
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
// for K1, var (N,).  Weights padded as the header says; D <= 16, Gp a
// multiple of 128.
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
    const int bytes = stats ? smem_bytes<R, false, true>() : smem_bytes<R, false>();
    auto kernel = stats ? k1s_rows<R> : k2s_rows<R>;
    const cudaError_t err = allow_smem(kernel, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, NT, bytes, st>>>(a);
    return cudaGetLastError();
  });
}

// K2's chain: dgamma (N, D) from the row pass's lse and the neighbour sums
// nb (N, Gp) of its xbar, ct (B,) the energies' cotangents.
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
    constexpr int bytes = smem_bytes<R, true>();
    const cudaError_t err = allow_smem(k2s_chain<R>, bytes);
    if (err != cudaSuccess) return err;
    k2s_chain<R><<<blocks, NT, bytes, st>>>(a);
    return cudaGetLastError();
  });
}

}  // extern "C"
