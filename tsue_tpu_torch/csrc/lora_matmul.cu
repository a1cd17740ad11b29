// The LoRA product in one kernel:
//   out = x @ W + scale * round(x @ A) @ B
// without writing the (M, r) product xA to memory.
//
// Replaces the Pallas kernel tsue_tpu/ops/lora.py:32 (_lora_kernel,
// launched by lora_matmul at :49).  x (M, K), W (K, N), A (K, r), B (r, N)
// and out (M, N), all fp32 or all bf16; every product sums in fp32 FMAs (no
// TF32, no tensor cores: fp32 semantics), and round() takes xA to x's dtype
// before the second product, as the Pallas kernel does (lora.py:36; the
// identity in fp32).  The output is rounded to x's dtype.
//
// What bounds it on an H100: at the stage-1 shapes (M = 16 * 528 = 8448,
// K = 2048, N = 2048 for q_proj and 512 for v_proj, r = 8) the base product
// is 70.9 / 17.7 GFLOP on under 0.2 GB: the fp32 FMA rate bounds it (67
// TFLOP/s: 1.06 / 0.27 ms).  The design is the register-tiled SGEMM of
// csrc/swiglu_matmul.cu with the adapter folded in:
//   - a CTA of 256 threads owns a 128 x 128 output tile and walks K in steps
//     of 8, double-buffered; each thread keeps an 8 x 8 micro-tile of sums;
//   - each step also stages the adapter's rows A[k0:k0+8, :r] in shared
//     memory, and every thread adds the step's terms of r/2 entries of its
//     tile's xA (128 x r) from the x tile already in shared memory, so xA
//     costs 2 * 128 * r FMAs per step against the base's 2 * 128 * 128 and
//     no memory traffic;
//   - the epilogue rounds xA, stages it and B[:, n0:n0+128] in shared
//     memory, and adds scale * xA @ B to each sum before the store;
//   - M, N and K tails are predicated (any sizes); x and W are read four
//     elements at a time where K % 4 == 0, N % 4 == 0 and the pointers are
//     aligned, element by element otherwise;
//   - K is walked in one fixed order by one CTA (no split-K), so a repeated
//     call gives bit-identical results.  xA is recomputed by each of the N /
//     128 column tiles of a row block, as the Pallas kernel recomputes it per
//     column block.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/lora.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8;
constexpr int kThreads = 256;       // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLdA = BM + 4;        // padded row of the transposed x tile
constexpr int kMaxR = 16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// four consecutive vector loads as fp32
__device__ __forceinline__ float4 vec4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 vec4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// p[0..3] as fp32, zeros from p[rem] on (rem = elements left in the row)
template <typename T, bool kVec>
__device__ __forceinline__ float4 load4(const T* p, int rem) {
  if (kVec && rem >= 4) return vec4(p);
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = i < rem ? to_f(p[i]) : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
lora_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int M, int K, int N, int r,
                   float scale) {
  __shared__ __align__(16) float As[2][BK][kLdA];   // x tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];     // W tile
  __shared__ float Ls[2][BK][kMaxR];                // A[k0:k0+8, :r]
  __shared__ float XA[BM][kMaxR + 1];               // round(x @ A) of the tile
  __shared__ float Rs[kMaxR][BN];                   // B[:r, n0:n0+128]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // x loads: row tid / 2 of the tile, k quad (tid % 2) * 4
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const bool a_ok = m0 + a_row < M;
  const T* xp = x + (size_t)(a_ok ? m0 + a_row : 0) * K + a_k;
  // W loads: k row tid / 32 of the tile, column quad (tid % 32) * 4
  const int b_k = tid >> 5, b_n = (tid & 31) * 4;
  const int n_rem = N - (n0 + b_n);
  const T* wp = w + (size_t)b_k * N + (n_rem > 0 ? n0 + b_n : 0);
  // A loads: thread tid < 8 * r takes A[k0 + tid / r, tid % r]
  const bool l_ok = tid < BK * r;
  const int l_k = l_ok ? tid / r : 0, l_j = l_ok ? tid - l_k * r : 0;
  // xA sums: row tid % 128 of the tile, ranks tid / 128 + 2q (q < r / 2)
  const int xa_row = tid & (BM - 1), xa_j0 = tid >> 7;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float xacc[kMaxR / 2];
#pragma unroll
  for (int q = 0; q < kMaxR / 2; ++q) xacc[q] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv = zero, wv = zero;
  float lv = 0.f;
  auto load = [&](int k0) {
    xv = a_ok ? load4<T, kVec>(xp + k0, K - k0 - a_k) : zero;
    wv = (k0 + b_k < K && n_rem > 0)
             ? load4<T, kVec>(wp + (size_t)k0 * N, n_rem) : zero;
    lv = (l_ok && k0 + l_k < K) ? to_f(a[(size_t)(k0 + l_k) * r + l_j]) : 0.f;
  };
  auto store = [&](int buf) {
    As[buf][a_k + 0][a_row] = xv.x;
    As[buf][a_k + 1][a_row] = xv.y;
    As[buf][a_k + 2][a_row] = xv.z;
    As[buf][a_k + 3][a_row] = xv.w;
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_n]) = wv;
    if (l_ok) Ls[buf][l_k][l_j] = lv;
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
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      const float xk = As[buf][kk][xa_row];
#pragma unroll
      for (int q = 0; q < kMaxR / 2; ++q) {
        // the rank index is uniform across a warp: no divergence
        if (xa_j0 + 2 * q < r)
          xacc[q] = fmaf(xk, Ls[buf][kk][xa_j0 + 2 * q], xacc[q]);
      }
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }

  // epilogue: xA rounded to x's dtype, B's columns of the tile
#pragma unroll
  for (int q = 0; q < kMaxR / 2; ++q) {
    const int j = xa_j0 + 2 * q;
    if (j < r) XA[xa_row][j] = to_f(from_f<T>(xacc[q]));
  }
  for (int i = tid; i < r * BN; i += kThreads) {
    const int q = i / BN, n = i - q * BN;
    Rs[q][n] = n0 + n < N ? to_f(b[(size_t)q * N + n0 + n]) : 0.f;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mi = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
    const int m = m0 + mi;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ni = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      const int n = n0 + ni;
      if (n >= N) continue;
      float d = 0.f;
      for (int q = 0; q < r; ++q) d = fmaf(XA[mi][q], Rs[q][ni], d);
      out[(size_t)m * N + n] = from_f<T>(acc[i][j] + scale * d);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* out, int M, int K, int N, int r, float scale,
           cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = K % 4 == 0 && N % 4 == 0 &&
                   (uintptr_t)x % align == 0 && (uintptr_t)w % align == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (vec)
    lora_matmul_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, wt, at, bt, ot, M, K, N, r, scale);
  else
    lora_matmul_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, at, bt, ot, M, K, N, r, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for a rank
// outside 1..16 or an unknown dtype.  x (M, K), w (K, N), a (K, r), b (r, N)
// and out (M, N), contiguous, all fp32 (dtype 0) or all bf16 (dtype 1).
int lora_matmul(const void* x, const void* w, const void* a, const void* b,
                void* out, int M, int K, int N, int r, float scale, int dtype,
                cudaStream_t stream) {
  if (r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, a, b, out, M, K, N, r, scale, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, out, M, K, N, r, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
