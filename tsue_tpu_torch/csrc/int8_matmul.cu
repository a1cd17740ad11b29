// Weight-only int8 matrix product for decode: out = (x @ float(w8)) * scale.
//
// Replaces the Pallas kernel tsue_tpu/ops/quant.py:96 (_int8_kernel, launched
// by _int8_matmul_impl at :110).  x is (M, K) fp32 with few rows (the decode
// batch, M <= 128), w8 is (K, N) int8 stored row-major, scale (N,) fp32 is one
// scale per output column.  Both factors are fp32 with the weight dequantised
// to fp32, as the JAX package promotes (quant.py:91), and the scale is
// applied once to the finished dot product.
//
// What bounds it on an H100: at M = 16 the product does 2 flops per weight
// byte, far below the card's ridge, so it is a stream of the K*N weight bytes
// (3.35 TB/s).  The design keeps that stream coalesced and wide enough:
//   - a CTA (8 warps) owns 16 rows of x and 128 output columns; each lane owns
//     4 consecutive columns, so a warp reads 128 contiguous weight bytes (one
//     cache line) per K row and keeps 16 x 4 fp32 accumulators in registers;
//   - the 8 warps take interleaved K rows; x is staged in shared memory in
//     chunks of 256 K rows and read there as a broadcast;
//   - when N gives too few column tiles to fill the card, K is split over
//     grid.z; each split writes its partial sums, and a second kernel adds
//     them in a fixed order and applies the scale, so results do not depend
//     on scheduling;
//   - the 8 warps' partial sums are added in shared memory in warp order.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/quant.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;     // rows of x per CTA; grid.y covers M
constexpr int kCols = 128;    // output columns per CTA, 4 per lane
constexpr int kChunk = 256;   // K rows of x staged in shared memory per pass
constexpr size_t kSmem = (size_t)(kRows * kChunk + kWarps * kRows * kCols) * sizeof(float);

__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w8,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ partial, int M, int K, int N,
                   int k_per_split) {
  extern __shared__ float smem[];
  float* xs = smem;                      // [kRows][kChunk]
  float* red = smem + kRows * kChunk;    // [kWarps][kRows][kCols]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kCols + lane * 4;
  const int m0 = blockIdx.y * kRows;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const bool cols_in = n0 < N;           // N % 4 == 0: all 4 columns or none

  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int kn = min(kChunk, k_end - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk, m = m0 + r;
      xs[i] = (m < M && c < kn) ? x[(size_t)m * K + kc + c] : 0.f;
    }
    __syncthreads();
    if (cols_in) {
      const int8_t* wp = w8 + (size_t)kc * N + n0;
#pragma unroll 8
      for (int kk = warp; kk < kn; kk += kWarps) {
        const char4 w = *reinterpret_cast<const char4*>(wp + (size_t)kk * N);
        const float w0 = w.x, w1 = w.y, w2 = w.z, w3 = w.w;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r * kChunk + kk];
          acc[r][0] += xv * w0;
          acc[r][1] += xv * w1;
          acc[r][2] += xv * w2;
          acc[r][3] += xv * w3;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * kRows + r) * kCols + lane * 4 + j] = acc[r][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int r = i / kCols, c = i % kCols;
    const int m = m0 + r, n = blockIdx.x * kCols + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + r) * kCols + c];
    if (partial != nullptr)
      partial[((size_t)split * M + m) * N + n] = s;
    else
      out[(size_t)m * N + n] = s * scale[n];
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     float* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * total + i];
  out[i] = s * scale[i % N];
}

}  // namespace

extern "C" {

// Number of K splits the launcher uses for an (M, K, N) product; the caller
// allocates a (splits, M, N) fp32 scratch when it is above 1.
int int8_matmul_splits(int M, int K, int N) {
  const int tiles = ((N + kCols - 1) / kCols) * ((M + kRows - 1) / kRows);
  int splits = (2 * 132 + tiles - 1) / tiles;         // about two CTAs per SM
  const int by_bytes = K / (8 * M);                   // partials <= weights / 2
  if (splits > by_bytes) splits = by_bytes;
  const int by_chunk = (K + kWarps - 1) / kWarps;     // >= 1 K row per warp
  if (splits > by_chunk) splits = by_chunk;
  if (splits < 1) splits = 1;
  const int per = (K + splits - 1) / splits;
  return (K + per - 1) / per;
}

// Returns a cudaError_t (0 on success).  x (M, K) fp32, w8 (K, N) int8 with
// N % 4 == 0 and a 4-byte aligned base, scale (N,) fp32, out (M, N) fp32,
// partial a (splits, M, N) fp32 scratch when splits > 1 (else unused).
int int8_matmul(const float* x, const int8_t* w8, const float* scale,
                float* out, float* partial, int M, int K, int N,
                cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int splits = int8_matmul_splits(M, K, N);
  const int per = (K + splits - 1) / splits;
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows, splits);
  int8_matmul_kernel<<<grid, kThreads, kSmem, stream>>>(
      x, w8, scale, out, splits > 1 ? partial : nullptr, M, K, N, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * N;
  splitk_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      partial, scale, out, M, N, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
