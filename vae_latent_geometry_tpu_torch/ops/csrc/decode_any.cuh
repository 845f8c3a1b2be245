// The decode of a decoder of any depth and widths, for sm_90a (H100): the
// second decode policy of the energy kernels' bodies, beside FixedDecode
// (decode_common.cuh), which keeps the production shape D <= 4 -> 128 -> 128 ->
// X <= 64.
//
// A decoder here is L >= 2 ReLU layers width[0] = D -> width[1] -> ... ->
// width[L] = X, of any depth, any hidden width and any D, with X up to
// XMAX_ANY: every decoder the JAX package's kernels take
// (vae_latent_geometry_tpu/ops/energy_pallas.py:237-246 loop over
// n_layers).  A wider output is run by the wrappers in column slices of at
// most XMAX_ANY (every energy and dgamma is a sum over output features).  The
// rungs are decode_common.cuh's: operands packed by pack<R>, fp32 FMAs on the
// CUDA cores, fp32 accumulation; the chain runs at CHAIN_RUNG<R>; no TF32.
//
// Where the fixed decode keeps a layer in shared memory and its ReLU masks in
// registers, a 512-wide layer of 128 points (256 KB) fits neither, so:
//   - Activations.  A layer's output goes to a per-block scratch in device
//     memory, two planes [unit][point] of the widest hidden layer that the
//     layers use in turn (256 KB each at 512 units; the blocks are
//     persistent, one per SM, so the scratch is 132 blocks' worth and stays
//     mostly in the 50 MB L2).
//   - Products.  Each product runs in column tiles of 128 units; per tile it
//     walks the input rows in chunks of KC, staging the rows and the packed
//     weight chunk in shared memory, and reuses decode_common.cuh's
//     register-tiled gemm (8 points x 8 units a thread).  The point tile and
//     the thread map are the fixed decode's, so the kernel bodies' own logic
//     is shared; only the output has 8 columns a thread (X <= 128).
//   - Masks.  Per hidden layer and column tile, each thread's 64 mask bits
//     go to a mask area in the scratch, one uint2 per thread (the chain
//     produces the same (point, unit) positions, so it reads its own bits).
//     A body that keeps several decoders' masks asks for several areas.
//   - The description.  The decoder's widths and per-layer pointers are
//     copied by the entry point into the head of the scratch (any_args), and
//     the kernels read them from there, so no depth is capped by a fixed
//     array; shared memory keeps only the pointers to them.
//   - Latents.  Up to DMAX = 4 the tile's points and dgamma accumulators sit
//     in shared memory as in the fixed decode; a wider D keeps them, D floats
//     a point, in two areas of the block's scratch.
#pragma once

#include <cstring>
#include <vector>

#include "decode_common.cuh"

namespace {

constexpr int XMAX_ANY = 128;            // widest output (of one column slice)
constexpr int NJA = XMAX_ANY / 16;       // output columns a thread holds
constexpr int CT = 128;                  // units per column tile
constexpr int KC = 32;                   // input rows per staged chunk
constexpr int S_WC = CT + 1;             // odd stride: conflict-free reads

// A decoder ensemble: layer l maps width[l] -> width[l + 1] with weights
// W[l] (M, width[l], width[l + 1]) and biases b[l] (M, width[l + 1]).  The
// arrays are the entry point's on the host, the copy in the scratch's head
// on the device.
struct Decoder {
  int L, D, X;               // layers, width[0], width[L]
  const int* width;          // L + 1
  const float* const* W;     // L
  const float* const* b;     // L
};

__host__ __device__ inline int col_tiles(int w) { return (w + CT - 1) / CT; }

__host__ __device__ inline int widest_hidden(const Decoder& d) {
  int w = 0;
  for (int l = 1; l < d.L; ++l) w = d.width[l] > w ? d.width[l] : w;
  return w;
}

// uint2 words of one mask area: every hidden layer's column tiles, one per
// thread.
__host__ __device__ inline int mask_area_words(const Decoder& d) {
  int t = 0;
  for (int l = 1; l < d.L; ++l) t += col_tiles(d.width[l]);
  return t * NT;
}

// A thread's private tile of 64 floats in the scratch: where a kernel body
// keeps, with the generic decode, a running register tile that would not
// fit beside the decode's (K4's sum of cotangents, the MC chain's running dx).
constexpr int PRIV_WORDS = 8 * NJA * NT;

// Floats a point of the tile's points and of its dgamma accumulators: in
// shared memory (DMAX) up to D = DMAX, else in the scratch (D).
__host__ __device__ inline int g_stride(int D) { return D > DMAX ? D : DMAX; }

// 32-bit words of the areas of one block's scratch: the activation planes,
// n_areas mask areas, the points and dgamma of a D > DMAX, the private tiles.
inline size_t any_scratch_words(const Decoder& d, int n_areas) {
  const int D = d.D;
  return 2 * (size_t)widest_hidden(d) * S_ACT + 2 * (size_t)n_areas * mask_area_words(d) +
         (D > DMAX ? 2 * (size_t)TP * D : 0) + PRIV_WORDS;
}

// 32-bit words of the scratch's head: the decoder's weight and bias
// pointers and its widths, rounded to 16 bytes.
inline size_t any_head_words(int L) { return ((size_t)4 * L + L + 1 + 3) / 4 * 4; }

// The decoder the fixed kernels take: they keep it, every other shape takes
// the kernels on this header.
inline bool fixed_shape(const Decoder& d) {
  return d.L == 3 && d.D <= DMAX && d.width[1] == H && d.width[2] == H && d.X <= XMAX;
}

// What the generic decode keeps in shared memory; a kernel's own struct
// derives from it (act stays first: its rows are read as 16-byte vectors).
struct AnySmem {
  uint32_t act[XMAX_ANY * S_ACT];  // the output cotangent dx[n][p] (chain rung)
  uint32_t ia[KC * S_ACT];         // staged input rows of a product
  uint32_t wc[KC * S_WC];          // staged weight chunk [k][n], packed
  float g[TP * DMAX];              // the tile's curve points (D <= DMAX)
  float dg[TP * DMAX];             // dgamma accumulators of the chain (D <= DMAX)
  Decoder dec;
};

// acc[i][j] = sum_k in[k][p_i] * W'(k, n0 + tx + 16 j) at rung R over K
// input rows (in: [row][point], stride S_ACT, in shared or device memory),
// p_i = ty * 8 + i; W'(k, n) = W[k * ldw + n], or W[n * ldw + k] when TRANS
// (the chain's W^T), zero for n >= N.
template <int R, bool TRANS>
__device__ void gemm_any(AnySmem& s, const uint32_t* in, const float* W, int ldw, int K, int n0,
                         int N, float (&acc)[8][NJA]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJA; ++j) acc[i][j] = 0.f;
  // the rows come from shared memory (the output cotangent) or a plane of
  // the scratch, and the weights from the decoder's arrays, whose pointers
  // the kernel reads from device memory: the loads say which space they use
  const bool in_global = __isGlobal(in);
  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    for (int e = tid; e < kc * (TP / 4); e += NT) {
      const int kk = e / (TP / 4), q = e % (TP / 4);
      const uint4* row = reinterpret_cast<const uint4*>(in + (size_t)(k0 + kk) * S_ACT) + q;
      reinterpret_cast<uint4*>(s.ia + kk * S_ACT)[q] = in_global ? __ldcg(row) : *row;
    }
    for (int e = tid; e < kc * CT; e += NT) {
      const int kk = TRANS ? e % kc : e / CT, nn = TRANS ? e / kc : e % CT, n = n0 + nn;
      const size_t at = TRANS ? (size_t)n * ldw + k0 + kk : (size_t)(k0 + kk) * ldw + n;
      s.wc[kk * S_WC + nn] = n < N ? pack<R>(__ldg(W + at)) : 0u;
    }
    __syncthreads();
    gemm<R, NJA, false, 1>(s.ia, s.wc, S_WC, kc, acc);   // 64 FMAs a k-step: no unroll
  }
}

// Write a thread's 8 points x 8 units of a layer (units n0 + tx + 16 j < N)
// to the plane out[unit][point] at rung R.
template <int R>
__device__ __forceinline__ void put_tile(uint32_t* out, int n0, int N, const float (&h)[8][NJA]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < NJA; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    uint4* row = reinterpret_cast<uint4*>(out + (size_t)n * S_ACT + ty * 8);
    row[0] = make_uint4(pack<R>(h[0][j]), pack<R>(h[1][j]), pack<R>(h[2][j]), pack<R>(h[3][j]));
    row[1] = make_uint4(pack<R>(h[4][j]), pack<R>(h[5][j]), pack<R>(h[6][j]), pack<R>(h[7][j]));
  }
}

// The ReLU of a tile in place, its mask bits (bit i * 8 + j) to *mk.
__device__ __forceinline__ void relu_tile(float (&h)[8][NJA], uint2* mk) {
  uint32_t m[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJA; ++j) {
      h[i][j] = fmaxf(h[i][j], 0.f);
      const int bit = i * 8 + j;
      if (h[i][j] > 0.f) m[bit >> 5] |= 1u << (bit & 31);
    }
  *mk = make_uint2(m[0], m[1]);
}

// The per-block state of the generic decode: the two activation planes, the
// mask areas and the private tiles of this block's scratch.
struct AnyCtx {
  uint32_t* planes;    // plane i at planes + i * plane_words
  size_t plane_words;
  uint2* masks;
  int area;            // uint2 words per mask area
  float* priv;         // [64][NT]: element e of thread t at priv[e * NT + t]
  __device__ uint32_t* plane(int i) const { return planes + i * plane_words; }
  // D > DMAX: the tile's points [p][d] and their dgamma accumulators, just
  // below the private tiles (computed, so that no register holds them)
  __device__ float* gx(int D) const { return priv - 2 * TP * D; }
  __device__ float* dgx(int D) const { return priv - TP * D; }
};

// Kernel arguments of the generic instantiations.
struct AnyArgs {
  Decoder dec;         // its arrays in the scratch's head
  uint32_t* scratch;   // n_blocks x block_words, after the head
  size_t block_words;
  int n_areas;
};

// At kernel start: the decoder to shared memory, this block's scratch.
__device__ AnyCtx any_begin(AnySmem& s, const AnyArgs& a) {
  if (threadIdx.x == 0) s.dec = a.dec;
  __syncthreads();
  uint32_t* base = a.scratch + blockIdx.x * a.block_words;
  AnyCtx c;
  c.planes = base;
  c.plane_words = (size_t)widest_hidden(s.dec) * S_ACT;
  c.masks = reinterpret_cast<uint2*>(base + 2 * c.plane_words);
  c.area = mask_area_words(s.dec);
  c.priv = reinterpret_cast<float*>(base + a.block_words - PRIV_WORDS);
  return c;
}

// Decode the tile's points (s.g) with decoder m.  x[i][j]: the output at
// point ty*8+i, feature tx+16j (zero for features >= X); the hidden layers'
// masks go to mask area `area`.  Ends with every thread past a barrier.
template <int R>
__device__ void decode_any(AnySmem& s, const AnyCtx& c, int m, int area, float (&x)[8][NJA]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Decoder& d = s.dec;
  const int L = d.L, D = d.D;
  uint2* mk = c.masks + (size_t)area * c.area + threadIdx.x;
  float h[8][NJA];
  __syncthreads();   // the body's writes of the points

  // layer 0: D -> width[1], fp32 FMAs from the points
  {
    const int N = d.width[1];
    const float* W = d.W[0] + (size_t)m * D * N;
    const float* b = d.b[0] + (size_t)m * N;
    for (int n0 = 0; n0 < N; n0 += CT, mk += NT) {
      if (D <= DMAX) {   // the points in shared memory
#pragma unroll
        for (int j = 0; j < NJA; ++j) {
          const int n = n0 + tx + 16 * j;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float v = 0.f;
            if (n < N) {
              v = __ldg(b + n);
              for (int dd = 0; dd < D; ++dd)
                v = v + s.g[(ty * 8 + i) * DMAX + dd] * __ldg(W + dd * N + n);
            }
            h[i][j] = v;
          }
        }
      } else {           // D > DMAX: in the block's scratch
        const float* g = c.gx(D);
#pragma unroll
        for (int j = 0; j < NJA; ++j) {
          const int n = n0 + tx + 16 * j;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float v = 0.f;
            if (n < N) {
              v = __ldg(b + n);
              for (int dd = 0; dd < D; ++dd) v = v + g[(ty * 8 + i) * D + dd] * __ldg(W + dd * N + n);
            }
            h[i][j] = v;
          }
        }
      }
      relu_tile(h, mk);
      put_tile<R>(c.plane(0), n0, N, h);
    }
  }
  // hidden layers 1 .. L-2, the planes in turn
  for (int l = 1; l + 1 < L; ++l) {
    const int K = d.width[l], N = d.width[l + 1];
    const float* W = d.W[l] + (size_t)m * K * N;
    const float* b = d.b[l] + (size_t)m * N;
    for (int n0 = 0; n0 < N; n0 += CT, mk += NT) {
      gemm_any<R, false>(s, c.plane((l - 1) & 1), W, N, K, n0, N, h);
#pragma unroll
      for (int j = 0; j < NJA; ++j) {
        const int n = n0 + tx + 16 * j;
        const float bn = n < N ? __ldg(b + n) : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) h[i][j] = h[i][j] + bn;
      }
      relu_tile(h, mk);
      put_tile<R>(c.plane(l & 1), n0, N, h);
    }
  }
  // output layer L-1: width[L-1] -> X, no ReLU
  {
    const int K = d.width[L - 1], X = d.X;
    const float* W = d.W[L - 1] + (size_t)m * K * X;
    const float* b = d.b[L - 1] + (size_t)m * X;
    gemm_any<R, false>(s, c.plane((L - 2) & 1), W, X, K, 0, X, x);
#pragma unroll
    for (int j = 0; j < NJA; ++j) {
      const int n = tx + 16 * j;
      const float bn = n < X ? __ldg(b + n) : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i][j] = x[i][j] + bn;
    }
  }
  __syncthreads();
}

// The masked cotangent chain of decoder m at rung C.  On entry s.act[n][p]
// holds the packed output cotangent dx (features n < X) and every thread has
// passed a __syncthreads() since writing it; mask area `area` holds this
// tile's masks of decoder m's decode.  Adds the decoder's dgamma, through
// W1 (M, D, width[1]) (the shipped first layer, or float32 W1), to s.dg.
template <int C>
__device__ void chain_any(AnySmem& s, const AnyCtx& c, int m, int area, const float* W1) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const Decoder& d = s.dec;
  const int L = d.L, D = d.D;
  const uint2* mk_area = c.masks + (size_t)area * c.area + threadIdx.x;
  float q[8][DMAX];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int dd = 0; dd < DMAX; ++dd) q[i][dd] = 0.f;
  const uint32_t* in = s.act;
  int off = 0;                                  // mask tiles before hidden layer l-1
  for (int l = 1; l + 1 < L; ++l) off += col_tiles(d.width[l]);
  for (int l = L - 1; l >= 1; --l) {            // dh_{l-1} = (dh_l W[l]^T) * mask_{l-1}
    const int N = d.width[l], K = d.width[l + 1];
    const float* W = d.W[l] + (size_t)m * N * K;
    uint32_t* out = c.plane((L - 1 - l) & 1);
    for (int t = 0, n0 = 0; n0 < N; ++t, n0 += CT) {
      float acc[8][NJA];
      gemm_any<C, true>(s, in, W, K, K, n0, N, acc);
      const uint2 mw = mk_area[(size_t)(off + t) * NT];
      const uint32_t mb[2] = {mw.x, mw.y};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJA; ++j) {
          const int bit = i * 8 + j;
          if (!((mb[bit >> 5] >> (bit & 31)) & 1u)) acc[i][j] = 0.f;
        }
      if (l > 1) {
        put_tile<C>(out, n0, N, acc);
      } else if (D > DMAX) {     // this tile's share of each dgamma, summed over tx
        const float* w1 = W1 + (size_t)m * D * N;
        for (int dd = 0; dd < D; ++dd) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float v = 0.f;
#pragma unroll
            for (int j = 0; j < NJA; ++j) {
              const int n = n0 + tx + 16 * j;
              if (n < N) v += acc[i][j] * __ldg(w1 + dd * N + n);
            }
            v = sum16(v);
            if (tx == 0) c.dgx(D)[(ty * 8 + i) * D + dd] += v;
          }
        }
      } else {
        const float* w1 = W1 + (size_t)m * D * N;
#pragma unroll
        for (int j = 0; j < NJA; ++j) {
          const int n = n0 + tx + 16 * j;
          if (n >= N) continue;
#pragma unroll
          for (int dd = 0; dd < DMAX; ++dd) {
            if (dd >= D) continue;
            const float w = __ldg(w1 + dd * N + n);
#pragma unroll
            for (int i = 0; i < 8; ++i) q[i][dd] += acc[i][j] * w;
          }
        }
      }
    }
    in = out;
    if (l > 1) off -= col_tiles(d.width[l - 1]);
  }
  if (D > DMAX) return;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int dd = 0; dd < DMAX; ++dd) {
      if (dd >= D) continue;
      const float v = sum16(q[i][dd]);
      if (tx == 0) s.dg[(ty * 8 + i) * DMAX + dd] += v;
    }
}

// The generic decode as a policy of the kernel bodies (FixedDecode's
// counterpart): 8 output columns a thread, masks in scratch areas.
struct AnyDecode {
  static constexpr int NJX = NJA;
  static constexpr int XM = XMAX_ANY;
  static constexpr int SLOTS = 1;    // MC samples per decode sweep
  using Smem = AnySmem;
  using Ctx = AnyCtx;
  struct Masks {
    int area = 0;
  };
  __device__ static void use_area(Masks& mk, int area) { mk.area = area; }
  template <int R>
  __device__ static void decode(Smem& s, const Ctx& c, int m, int, int, float (&x)[8][NJX],
                                Masks& mk) {
    decode_any<R>(s, c, m, mk.area, x);
  }
  template <int C>
  __device__ static void chain(Smem& s, const Ctx& c, int m, int, int, const Masks& mk) {
    chain_any<C>(s, c, m, mk.area, s.dec.W[0]);
  }
  template <int R>
  __device__ static void restage(Smem&, const Ctx&, int, int, int) {}
  // element (i, j) of a running tile: in the block's scratch
  template <int NJ>
  __device__ static float& tile(float (&)[8][NJ], const Ctx& c, int i, int j) {
    return c.priv[(i * NJ + j) * NT + threadIdx.x];
  }
  // the tile's points and dgamma accumulators, g_stride(D) floats a point
  __device__ static float* points(Smem& s, const Ctx& c, int D) { return D > DMAX ? c.gx(D) : s.g; }
  __device__ static float* dgs(Smem& s, const Ctx& c, int D) { return D > DMAX ? c.dgx(D) : s.dg; }
  __device__ static int gstride(int D) { return g_stride(D); }
};

// The decoder given to an entry point as arrays (L layers, widths[0..L],
// per-layer weight and bias pointers, which may be null where only the
// shape is asked for); false if the kernels do not take it.
inline bool make_decoder(int L, const int* widths, const float* const* Ws,
                         const float* const* bs, Decoder& d) {
  if (L < 2) return false;
  d = Decoder{L, widths[0], widths[L], widths, Ws, bs};
  if (d.X > XMAX_ANY) return false;
  for (int l = 0; l <= L; ++l)
    if (d.width[l] < 1) return false;
  return true;
}

// The generic kernels' arguments: the decoder's arrays copied into the head
// of `scratch` on stream st (from the host, before the call returns), the
// blocks' areas after it.
inline cudaError_t any_args(const Decoder& d, void* scratch, int n_areas, cudaStream_t st,
                            AnyArgs& a) {
  const int L = d.L;
  uint32_t* head = static_cast<uint32_t*>(scratch);
  std::vector<uint32_t> buf(5 * L + 1);
  memcpy(buf.data(), d.W, sizeof(void*) * L);
  memcpy(buf.data() + 2 * L, d.b, sizeof(void*) * L);
  memcpy(buf.data() + 4 * L, d.width, sizeof(int) * (L + 1));
  const cudaError_t err = cudaMemcpyAsync(head, buf.data(), sizeof(uint32_t) * buf.size(),
                                          cudaMemcpyHostToDevice, st);
  a.dec = Decoder{L, d.D, d.X, reinterpret_cast<const int*>(head + 4 * L),
                  reinterpret_cast<const float* const*>(head),
                  reinterpret_cast<const float* const*>(head + 2 * L)};
  a.scratch = head + any_head_words(L);
  a.block_words = any_scratch_words(d, n_areas);
  a.n_areas = n_areas;
  return err;
}

inline Weights fixed_weights(const Decoder& d) {
  return Weights{d.W[0], d.b[0], d.W[1], d.b[1], d.W[2], d.b[2]};
}

}  // namespace

extern "C" {

// 32-bit words of one block's scratch for the generic kernels with n_areas
// mask areas; 0 for the fixed shape (its kernels take none), -1 for a
// decoder the kernels do not take.  The scratch is n_blocks times this plus
// vlg_any_head_words(L).
int vlg_any_scratch_words(int L, const int* widths, int n_areas) {
  Decoder d;
  if (!make_decoder(L, widths, nullptr, nullptr, d)) return -1;
  return fixed_shape(d) ? 0 : (int)any_scratch_words(d, n_areas);
}

int vlg_any_head_words(int L) { return (int)any_head_words(L); }

}  // extern "C"
