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
// rounded to x's dtype.  fp32 x, over either scale, takes the kernel above
// ("row"); bf16 x takes a multi-row stream ("bf16_stream",
// rmsnorm_bf16_kernel):
//   - bound on an H100 at (8448, 2048): 69.2 MB of x and out, 0.0207 ms;
//     the row form it replaces took 0.0405 ms (a CTA of 8-byte loads and
//     two barriers a row, the scale re-read for every row);
//   - a persistent grid (the CTAs the card holds at once, 264 at K =
//     2048) of 256-thread CTAs striding over the rows; one to eight warps
//     own a row by K (two at 2048), each lane holding at most four 16-byte
//     vectors of x (about 100 registers: two CTAs an SM; eight vectors, at
//     198 registers and one CTA an SM, took 0.0313 ms);
//   - the lane's slice of the scale is loaded once into registers (bf16
//     pairs, or fp32) for all the CTA's rows; the next row's loads are
//     issued before this row's sum and store;
//   - the sum of squares: the lane's elements in order, a butterfly over
//     the warp, the row's warps in order through shared memory; the last
//     bit of an output may differ from the row form's, not the function;
//   - on an H100 80GB HBM3 at 700 W (chip_smoke.py's bf16 row,
//     bits_vs_source.py): 0.0295-0.0302 ms, 68-70% of its bound
//     (F.rms_norm bf16 0.0328-0.0329);
//   - ptxas (sm_90a): 40 (K <= 256), 58-60 (512), 102-106 registers
//     (1024 up), no spills, 32 bytes of shared memory past 1024.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

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

// ---- the bf16 form: a multi-row stream ("bf16_stream") ---------------------

// The lane's slice of the scale, eight elements a 16-byte vector of x,
// held in registers for all the CTA's rows: bf16 pairs or fp32.
template <typename ST>
struct ScaleSlice;
template <>
struct ScaleSlice<bf16> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* s, int c) {
    v = __ldg(reinterpret_cast<const uint4*>(s) + c);
  }
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(&v)[e]);
  }
};
template <>
struct ScaleSlice<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const float* s, int c) {
    lo = __ldg(reinterpret_cast<const float4*>(s) + 2 * c);
    hi = __ldg(reinterpret_cast<const float4*>(s) + 2 * c + 1);
  }
  __device__ __forceinline__ float get(int e) const {
    const float4& h = e < 4 ? lo : hi;
    const int k = e & 3;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

__device__ __forceinline__ float bf_at(const uint4& u, int e) {
  return __bfloat162float(reinterpret_cast<const bf16*>(&u)[e]);
}

// WPR warps own a row (K <= 1024: one; 2048: two; 4096: four; 8192: the
// CTA's eight), VPT 16-byte vectors (8 bf16) a lane; the CTA's kWarps / WPR
// rows a step, the grid's
// CTAs striding over the rows, the next row's loads issued before this
// row's sum and store.  The sum of squares: each lane's elements in order,
// then a butterfly over the warp (every lane gets the same sum), then the
// row's warps in order through shared memory.
template <int VPT, int WPR, typename ST>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bf16_kernel(const bf16* __restrict__ x, const ST* __restrict__ scale,
                    bf16* __restrict__ out, int M, int K, float eps) {
  constexpr int GR = kWarps / WPR;        // rows a CTA step
  constexpr int LPR = 32 * WPR;           // lanes a row
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K8 = K / 8;
  const int c0 = (warp % WPR) * 32 + lane;   // vector i: c0 + LPR i
  ScaleSlice<ST> sc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (c0 + LPR * i < K8) sc[i].load(scale, c0 + LPR * i);
  auto load = [&](int row, uint4 (&v)[VPT]) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = c0 + LPR * i;
      v[i] = row < M && c < K8 ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  const int nblk = (M + GR - 1) / GR, step = gridDim.x * GR;
  int row = blockIdx.x * GR + warp / WPR;
  uint4 cur[VPT];
  load(row, cur);
  // rb is the CTA's: the loop and its barriers are uniform over the CTA
  for (int rb = blockIdx.x; rb < nblk; rb += gridDim.x, row += step) {
    uint4 nxt[VPT];
    load(row + step, nxt);
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) ss = fmaf(bf_at(cur[i], e), bf_at(cur[i], e), ss);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (WPR > 1) {
      if (lane == 0) part[warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += part[warp / WPR * WPR + w];
      __syncthreads();     // part is free for the next row
    }
    const float r = rsqrtf(ss / (float)K + eps);
    if (row < M) {
      uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * K);
#pragma unroll
      for (int i = 0; i < VPT; ++i) {
        const int c = c0 + LPR * i;
        if (c >= K8) continue;
        uint4 u;
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(
              bf_at(cur[i], 2 * e) * r * sc[i].get(2 * e),
              bf_at(cur[i], 2 * e + 1) * r * sc[i].get(2 * e + 1));
          w[e] = *reinterpret_cast<const uint32_t*>(&p);
        }
        orow[c] = u;
      }
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) cur[i] = nxt[i];
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int VPT, int WPR, typename ST>
struct Rows {
  static constexpr int vpt = VPT, wpr = WPR;
  static int per_sm() {   // CTAs an SM holds, asked once
    static int n = -1;
    if (n < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, rmsnorm_bf16_kernel<VPT, WPR, ST>, kThreads, 0) !=
                     cudaSuccess)
      n = -1;
    return n;
  }
  static void launch(const void* x, const void* s, void* out, int M, int K,
                     float eps, int ctas, cudaStream_t st) {
    rmsnorm_bf16_kernel<VPT, WPR, ST><<<ctas, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const ST*>(s),
        static_cast<bf16*>(out), M, K, eps);
  }
};

// f(Rows<...>{}) of the split for K: vectors a lane and warps a row.  At
// most 4 vectors a lane (about 100 registers: two CTAs an SM); wider rows
// take more warps, up to the CTA's 8 at K = 8192.
template <typename ST, typename F>
bool rows_dispatch(int K, F&& f) {
  if (K <= 256) f(Rows<1, 1, ST>{});
  else if (K <= 512) f(Rows<2, 1, ST>{});
  else if (K <= 1024) f(Rows<4, 1, ST>{});
  else if (K <= 2048) f(Rows<4, 2, ST>{});
  else if (K <= 4096) f(Rows<4, 4, ST>{});
  else if (K <= 8192) f(Rows<4, 8, ST>{});
  else return false;
  return true;
}
static_assert(4 * kWarps * 32 * 8 == kThreads * 4 * kMaxVec,
              "the bf16 split reaches the fp32 kernel's widest row");

enum Form { kRow = 0, kBf16Stream = 1 };

// The launch of a call: {form, warps a row, 16-byte vectors a lane, CTAs};
// fp32 x: one CTA of kThreads a row.  cudaErrorInvalidValue for what the
// kernels do not take.
int make_plan(int M, int K, int x_bf16, int scale_bf16, int* plan) {
  if ((x_bf16 | scale_bf16) & ~1 || M < 1 || K < 1 ||
      K > kThreads * 4 * kMaxVec || K % (x_bf16 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  if (!x_bf16) {
    plan[0] = kRow;
    plan[1] = kWarps;
    plan[2] = (K / 4 + kThreads - 1) / kThreads;
    plan[3] = M;
    return 0;
  }
  int per = -1;
  auto go = [&](auto rows) {
    using R = decltype(rows);
    plan[1] = R::wpr;
    plan[2] = R::vpt;
    per = R::per_sm();
  };
  if (scale_bf16) rows_dispatch<bf16>(K, go);
  else rows_dispatch<float>(K, go);
  if (per < 1 || sm_count() < 1) return (int)cudaErrorInvalidConfiguration;
  const int rows = kWarps / plan[1];
  plan[0] = kBf16Stream;
  plan[3] = std::min((M + rows - 1) / rows, sm_count() * per);
  return 0;
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int rmsnorm_max_k() { return kThreads * 4 * kMaxVec; }

// The plan of a call, as rmsnorm() launches it, into plan[4]: form (0
// "row", 1 "bf16_stream"), warps a row, 16-byte vectors a lane (fp32: a
// thread's float4 steps), CTAs.  Returns 0, cudaErrorInvalidValue for
// what the kernels do not take, or the error of the occupancy query.
int rmsnorm_plan(int M, int K, int x_bf16, int scale_bf16, int* plan) {
  return make_plan(M, K, x_bf16, scale_bf16, plan);
}

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for an
// unknown dtype code or a shape the kernels do not take.  x, out (M, K)
// and scale (K,), 16-byte aligned, with K % 4 == 0 (bf16 x: K % 8 == 0)
// and K <= rmsnorm_max_k(); x_bf16 / scale_bf16: 0 fp32, 1 bf16 (out
// takes x's dtype).
int rmsnorm(const void* x, const void* scale, void* out, int M, int K,
            float eps, int x_bf16, int scale_bf16, cudaStream_t stream) {
  int plan[4];
  const int err = make_plan(M, K, x_bf16, scale_bf16, plan);
  if (err != 0) return err;
  if (x_bf16) {   // the stream; fp32 x: one CTA a row
    auto go = [&](auto rows) {
      decltype(rows)::launch(x, scale, out, M, K, eps, plan[3], stream);
    };
    if (scale_bf16) rows_dispatch<bf16>(K, go);
    else rows_dispatch<float>(K, go);
  } else if (scale_bf16) {
    rmsnorm_kernel<<<M, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const bf16*>(scale),
        static_cast<float*>(out), K, eps);
  } else {
    rmsnorm_kernel<<<M, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), K, eps);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
