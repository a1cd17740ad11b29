// The Llama MLP's down-projection with its activation fused in:
//   out = (silu(g) * u) @ W,   silu(g) = sigmoid(g) * g
// without ever writing the (M, K) product silu(g) * u to memory.
//
// Replaces the Pallas kernel tsue_tpu/ops/fused.py:176 (_swiglu_kernel,
// launched by _swiglu_fwd_impl at :207).  g and u are (M, K) fp32, W is
// (K, N) fp32, out (M, N) fp32.  The activation is the Pallas kernel's form,
// sigmoid(g) * g with sigmoid = 1 / (1 + expf(-g)) (expf, not __expf), then
// times u; the product accumulates in fp32 FMAs (no TF32).
//
// What bounds it on an H100: at the training shapes (M = 16 * 528, K = 8192,
// N = 2048) the product does 2 * M * N * K = 283.5 GFLOP on about 0.69 GB
// of operands, far above the card's ridge, so the fp32 FMA rate bounds it
// (67 TFLOP/s: 4.23 ms).  The design is a plain register-tiled SGEMM whose
// A-tile prologue computes the activation:
//   - a CTA of 256 threads owns a 128 x 128 output tile and walks K in steps
//     of 8; each thread keeps an 8 x 8 micro-tile of sums in registers;
//   - each step, a thread loads one float4 of g and one of u (row m, four
//     consecutive k) and one float4 of W; it forms silu(g) * u in registers
//     and stores the A-tile transposed in shared memory (rows padded by 4
//     floats, so the transposed stores do not collide on a bank); the
//     activation product exists only there;
//   - the tiles are double-buffered: the next step's global loads are in
//     flight while the current step's 8 x 64 FMAs run;
//   - K is walked in one fixed order by one CTA (no split-K, no atomics), so
//     a repeated call gives bit-identical results;
//   - M and N tails are predicated (rows past M read zeros, columns past N
//     are neither read nor written; N % 4 == 0); K % 8 == 0 (the wrapper
//     asks K % 128 == 0, as the JAX package's dispatch does).
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLdA = BM + 4;        // padded row of the transposed A-tile

__device__ __forceinline__ float swiglu(float g, float u) {
  const float sg = 1.0f / (1.0f + expf(-g));
  return (sg * g) * u;
}

__global__ void __launch_bounds__(kThreads, 2)
swiglu_matmul_kernel(const float* __restrict__ g, const float* __restrict__ u,
                     const float* __restrict__ w, float* __restrict__ out,
                     int M, int K, int N) {
  __shared__ __align__(16) float As[2][BK][kLdA];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // A loads: row tid / 2 of the tile, k quad (tid % 2) * 4
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const bool a_ok = m0 + a_row < M;
  const size_t a_off = (size_t)(a_ok ? m0 + a_row : 0) * K + a_k;
  const float* gp = g + a_off;
  const float* up = u + a_off;
  // W loads: k row tid / 32 of the tile, column quad (tid % 32) * 4
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const bool b_ok = n0 + b_n < N;
  const float* wp = w + (size_t)b_k * N + (b_ok ? n0 + b_n : 0);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ga = zero, ua = zero, wb = zero;
  auto load = [&](int k0) {
    if (a_ok) {
      ga = *reinterpret_cast<const float4*>(gp + k0);
      ua = *reinterpret_cast<const float4*>(up + k0);
    }
    if (b_ok) wb = *reinterpret_cast<const float4*>(wp + (size_t)k0 * N);
  };
  auto store = [&](int buf) {
    As[buf][a_k + 0][a_row] = swiglu(ga.x, ua.x);
    As[buf][a_k + 1][a_row] = swiglu(ga.y, ua.y);
    As[buf][a_k + 2][a_row] = swiglu(ga.z, ua.z);
    As[buf][a_k + 3][a_row] = swiglu(ga.w, ua.w);
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = wb;
  };

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * 64 + tx * 4;
      if (n >= N) continue;
      *reinterpret_cast<float4*>(out + (size_t)m * N + n) =
          make_float4(acc[i][h * 4 + 0], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                      acc[i][h * 4 + 3]);
    }
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  g, u (M, K), w (K, N) and out
// (M, N), all fp32, contiguous and 16-byte aligned, with K % 8 == 0 and
// N % 4 == 0.
int swiglu_matmul(const float* g, const float* u, const float* w, float* out,
                  int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  swiglu_matmul_kernel<<<grid, kThreads, 0, stream>>>(g, u, w, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
