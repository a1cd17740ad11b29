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
//
// bf16: x (and so out) and the scale may each be bf16, as the Pallas
// kernel takes them (fused.py:96-100): the elements are widened to fp32 as
// they load, the statistics and the products stay fp32, and the output is
// rounded to x's dtype.  bf16 rows load 8 bytes (four elements) a thread a
// step; the fp32 kernel is the same code with 16-byte loads, as before.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVec = 8;   // 4-vectors per thread: K <= kThreads * 4 * kMaxVec

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float4 load4(const float* p, int c) {
  return reinterpret_cast<const float4*>(p)[c];
}
__device__ __forceinline__ float4 load4(const bf16* p, int c) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[c];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, int c, float4 v) {
  reinterpret_cast<float4*>(p)[c] = v;
}
__device__ __forceinline__ void store4(bf16* p, int c, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  reinterpret_cast<uint2*>(p)[c] = u;
}

template <typename XT, typename ST>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
               XT* __restrict__ out, int K, float eps) {
  __shared__ float warp_sums[kWarps];
  __shared__ float inv_rms;
  const int K4 = K / 4;
  const XT* xr = x + (size_t)blockIdx.x * K;
  XT* outr = out + (size_t)blockIdx.x * K;

  float4 v[kMaxVec];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVec; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < K4) {
      v[i] = load4(xr, c);
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
      const float4 s = load4(scale, c);
      float4 o;
      o.x = v[i].x * r * s.x;
      o.y = v[i].y * r * s.y;
      o.z = v[i].z * r * s.z;
      o.w = v[i].w * r * s.w;
      store4(outr, c, o);
    }
  }
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int rmsnorm_max_k() { return kThreads * 4 * kMaxVec; }

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for an
// unknown dtype code.  x, out (M, K) and scale (K,), 16-byte aligned, with
// K % 4 == 0 and K <= rmsnorm_max_k(); x_bf16 / scale_bf16: 0 fp32, 1 bf16
// (out takes x's dtype).
int rmsnorm(const void* x, const void* scale, void* out, int M, int K,
            float eps, int x_bf16, int scale_bf16, cudaStream_t stream) {
  if ((x_bf16 | scale_bf16) & ~1) return (int)cudaErrorInvalidValue;
  auto go = [&](auto* xt, auto* st) {
    using XT = std::remove_const_t<std::remove_pointer_t<decltype(xt)>>;
    rmsnorm_kernel<<<M, kThreads, 0, stream>>>(xt, st, static_cast<XT*>(out),
                                               K, eps);
  };
  if (x_bf16) {
    if (scale_bf16) go(static_cast<const bf16*>(x), static_cast<const bf16*>(scale));
    else go(static_cast<const bf16*>(x), static_cast<const float*>(scale));
  } else {
    if (scale_bf16) go(static_cast<const float*>(x), static_cast<const bf16*>(scale));
    else go(static_cast<const float*>(x), static_cast<const float*>(scale));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
