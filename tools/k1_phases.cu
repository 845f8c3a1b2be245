// K1's float32 forward kernel before k1_fwd_fma replaced it
// (k1_energy_tiles<0> of energy_expected.cu over decode_common.cuh's
// decode_tile<0>), with thread 0 of every block stamping clock64() after each
// barrier: where a block's cycles go, summed over blocks.  A one-off for
// tools/fwd_kernels.py --split, built against a checkout's csrc/ with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -I <checkout>/vae_latent_geometry_tpu_torch/ops/csrc -o lib.so k1_phases.cu
// The stamps add one barrier after the statistics update per decoder.
//
// Phases (k1_phases' counters):
//   0 load the tile's points          4 layer-2 epilogue (bias, ReLU, store)
//   1 stage W2/W3/W1/biases           5 layer-3 product and output
//   2 layer 1 (+ its barrier)         6 running statistics (ybar, sqy)
//   3 layer-2 product                 7 segment energies and the partial sum

#include "decode_common.cuh"

namespace {

constexpr int K1_COLS = 4;
constexpr int K1_ROWS = TP / K1_COLS;
constexpr int K1_SEGS = K1_ROWS - 1;
constexpr int NPH = 8;

struct Smem : DecodeSmem {
  float xs[TP * (XMAX + 1)];
  float red[TP];
  float red2[TP];
};

struct Stamp {
  unsigned long long* cyc;
  long long t;
  __device__ void mark(int ph) {
    if (threadIdx.x == 0) {
      const long long now = clock64();
      atomicAdd(cyc + ph, (unsigned long long)(now - t));
      t = now;
    }
  }
};

__device__ void decode_stamped(DecodeSmem& s, int D, float (&x)[8][4], Stamp& st) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      float h = s.b1[k];
      for (int d = 0; d < D; ++d) h = h + s.g[p * DMAX + d] * s.w1[d * H + k];
      h = fmaxf(h, 0.f);
      s.act[k * S_ACT + p] = __float_as_uint(h);
    }
  }
  __syncthreads();
  st.mark(2);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  gemm<F32, 8, false>(s.act, s.w2, S_W2, H, acc);
  __syncthreads();
  st.mark(3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s.act[k * S_ACT + ty * 8 + i] = __float_as_uint(fmaxf(acc[i][j] + s.b2[k], 0.f));
  }
  __syncthreads();
  st.mark(4);
  float acc3[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc3[i][j] = 0.f;
  gemm<F32, 4, false>(s.act, s.w3, S_W3, H, acc3);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = acc3[i][j] + s.b3[tx + 16 * j];
  __syncthreads();
  st.mark(5);
}

__global__ void __launch_bounds__(NT, 1)
k1_stamped(const float* __restrict__ gamma, int T, int B, int D, int M, int X, Weights w,
           const float* __restrict__ wmb, float* __restrict__ partial,
           unsigned long long* cyc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  Stamp st{cyc, clock64()};
  constexpr int SX = XMAX + 1;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bx = blockIdx.x, by = blockIdx.y;
  const int t0 = by * K1_SEGS, b0 = bx * K1_COLS;
  for (int e = tid; e < TP * DMAX; e += NT) {
    const int p = e / DMAX, d = e % DMAX;
    const int t = min(t0 + p / K1_COLS, T - 1), b = min(b0 + p % K1_COLS, B - 1);
    s.g[e] = d < D ? gamma[((size_t)t * B + b) * D + d] : 0.f;
  }
  __syncthreads();
  st.mark(0);
  float ybar[8][4], sqy[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sqy[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ybar[i][j] = 0.f;
  }
  for (int m = 0; m < M; ++m) {
    float x[8][4];
    stage_weights<F32>(s, m, D, X, w);
    __syncthreads();
    st.mark(1);
    decode_stamped(s, D, x, st);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = ty * 8 + i;
      if (m == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s.xs[p * SX + tx + 16 * j] = x[i][j];
      } else {
        const float wm = wmb[(size_t)m * B + min(b0 + p % K1_COLS, B - 1)];
        float q = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float y = x[i][j] - s.xs[p * SX + tx + 16 * j];
          ybar[i][j] = ybar[i][j] + wm * y;
          q += y * y;
        }
        sqy[i] = sqy[i] + wm * q;
      }
    }
    __syncthreads();
    st.mark(6);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int p = ty * 8 + i;
    float v = sqy[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
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
  __syncthreads();
  st.mark(7);
}

}  // namespace

extern "C" {

int k1_phases_count() { return NPH; }

// One stamped K1 launch at float32 (the production decoder D -> 128 -> 128
// -> X): cycles by phase, summed over blocks, added to cyc[0..NPH).
int k1_phases(const float* gamma, int T, int B, int D, int M, int X, const float* W1,
              const float* b1, const float* W2, const float* b2, const float* W3,
              const float* b3, const float* wmb, float* partial, unsigned long long* cyc,
              void* stream) {
  cudaError_t err = prepare<Smem>(k1_stamped);
  if (err != cudaSuccess) return err;
  const int n_tiles = T > 1 ? (T - 1 + K1_SEGS - 1) / K1_SEGS : 1;
  dim3 grid((B + K1_COLS - 1) / K1_COLS, n_tiles);
  k1_stamped<<<grid, NT, sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      gamma, T, B, D, M, X, Weights{W1, b1, W2, b2, W3, b3}, wmb, partial, cyc);
  return cudaGetLastError();
}

}  // extern "C"
