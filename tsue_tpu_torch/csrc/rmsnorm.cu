// One-pass RMSNorm over the last axis:
//   out[m, :] = x[m, :] * rsqrt(mean(x[m, :]^2) + eps) * scale
//
// Replaces the Pallas kernel tsue_tpu/ops/fused.py:96 (_rmsnorm_kernel,
// launched by _rmsnorm_fwd_impl at :109).  x and out are (M, K) fp32, scale
// is (K,) fp32; the statistics are fp32, as in the JAX package's
// rmsnorm_ref, and the product is taken in the same order: (x * r) * scale.
//
// What bounds it on an H100: a row reduction with a handful of flops per
// element, so it is a stream of the bytes: x read once and out written once,
// 2 * M * K * 4 bytes (at M = 16 * 528, K = 2048: 138 MB, 0.041 ms at
// 3.35 TB/s).  The design keeps each row in registers between its two uses:
//   - one CTA of 256 threads per row; each thread loads its share of the row
//     with 16-byte loads (up to kMaxVec float4 per thread, so K <= 8192) and
//     keeps it in registers;
//   - the sum of squares is reduced by warp shuffles, then across the 8
//     warps in shared memory, in a fixed order;
//   - the scale and the write use the registers, so x is read from memory
//     once.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;   // float4 per thread: K <= kThreads * 4 * kMaxVec

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
               float* __restrict__ out, int K, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const int K4 = K / 4;
  const float4* xr = reinterpret_cast<const float4*>(x + (size_t)blockIdx.x * K);
  float4* outr = reinterpret_cast<float4*>(out + (size_t)blockIdx.x * K);
  const float4* s4 = reinterpret_cast<const float4*>(scale);

  float4 v[kMaxVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < K4) {
      v[i] = xr[c];
      ss += v[i].x * v[i].x + v[i].y * v[i].y + v[i].z * v[i].z +
            v[i].w * v[i].w;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    inv_rms = rsqrtf(total / (float)K + eps);
  }
  __syncthreads();
  const float r = inv_rms;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < K4) {
      const float4 s = s4[c];
      float4 o;
      o.x = v[i].x * r * s.x;
      o.y = v[i].y * r * s.y;
      o.z = v[i].z * r * s.z;
      o.w = v[i].w * r * s.w;
      outr[c] = o;
    }
  }
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int rmsnorm_max_k() { return kThreads * 4 * kMaxVec; }

// Returns a cudaError_t (0 on success).  x, out (M, K) fp32 and scale (K,)
// fp32, all 16-byte aligned, with K % 4 == 0 and K <= rmsnorm_max_k().
int rmsnorm(const float* x, const float* scale, float* out, int M, int K,
            float eps, cudaStream_t stream) {
  rmsnorm_kernel<<<M, kThreads, 0, stream>>>(x, scale, out, K, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
