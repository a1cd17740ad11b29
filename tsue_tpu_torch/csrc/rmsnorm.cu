// One-pass RMSNorm over the last axis:
//   out[m, :] = x[m, :] * rsqrt(mean(x[m, :]^2) + eps) * scale
//
// Replaces the Pallas kernel tsue_tpu/ops/fused.py:96 (_rmsnorm_kernel,
// launched by _rmsnorm_fwd_impl at :109).  x and out are (M, K), scale is
// (K,); x (and so out) and the scale may each be fp32 or bf16, as the
// Pallas kernel takes them (fused.py:96-100).  The elements are widened to
// fp32 as they load, the statistics are fp32, as in the JAX package's
// rmsnorm_ref, the product is taken in the same order, (x * r) * scale,
// and the output is rounded to x's dtype.
//
// What bounds it on an H100: a row reduction with a handful of flops per
// element, so it is a stream of the bytes: x read once and out written once
// (fp32 at M = 16 * 528, K = 2048: 138 MB, 0.041 ms at 3.35 TB/s; bf16:
// 69.2 MB, 0.0207 ms).  One kernel, a multi-row stream, for both dtypes of
// x: "fp32_stream" and "bf16_stream" (rmsnorm_plan names the form):
//   - a persistent grid (the CTAs the card holds at once) of 256-thread
//     CTAs striding over the rows; a row is read as 16-byte vectors (4
//     fp32 or 8 bf16 elements), one to eight warps own a row by its count
//     of vectors (fp32 at K = 2048: 512 vectors, four warps a row, two rows
//     a CTA step), each lane holding at most four vectors up to 1024 of
//     them (eight at fp32 K = 8192);
//   - the lane's slice of the scale is loaded once into registers for all
//     the CTA's rows; the next row's loads are issued before this row's sum
//     and store, so a row's bytes are in flight while the last is reduced;
//   - the sum of squares: the lane's elements in order, a butterfly over
//     the warp (every lane gets the same sum), the row's warps in order
//     through shared memory.  The order depends on K alone, so a row's
//     bits do not depend on M or on the grid;
//   - ptxas (sm_90a): fp32 x 31 (K <= 128), 43 (256), 64 (512 to 4096:
//     four CTAs an SM) and 127 registers (8192: two); bf16 x 40, 58-60 and
//     102-106; no spills, 32 bytes of shared memory past one warp a row.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8192;   // the widest row: 2048 fp32 vectors, 8 a lane

using bf16 = __nv_bfloat16;

// Elements of x in a 16-byte vector: 4 fp32 or 8 bf16.
template <typename T>
constexpr int kPerVec = 16 / (int)sizeof(T);

template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int e) {
  if constexpr (sizeof(T) == 4)
    return __uint_as_float(reinterpret_cast<const uint32_t*>(&u)[e]);
  else
    return __bfloat162float(reinterpret_cast<const bf16*>(&u)[e]);
}

// A vector of fp32 results rounded to x's dtype.
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&o)[kPerVec<T>]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      w[e] = __float_as_uint(o[e]);
    } else {
      const __nv_bfloat162 p = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
      w[e] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  return u;
}

// The scale's N elements beside a vector of x, held as they lie (bf16
// pairs or fp32 words) for all the CTA's rows.
template <typename ST, int N>
struct ScaleSlice {
  static constexpr int kWords = N * (int)sizeof(ST) / 4;   // 2, 4 or 8
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const ST* s, int c) {
    const ST* p = s + (size_t)c * N;
    if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(w) = __ldg(reinterpret_cast<const uint2*>(p));
    } else {
#pragma unroll
      for (int j = 0; j < kWords / 4; ++j)
        reinterpret_cast<uint4*>(w)[j] =
            __ldg(reinterpret_cast<const uint4*>(p) + j);
    }
  }
  __device__ __forceinline__ float get(int e) const {
    if constexpr (sizeof(ST) == 4) return __uint_as_float(w[e]);
    else return __bfloat162float(reinterpret_cast<const bf16*>(w)[e]);
  }
};

// x and out are touched once: the loads and stores need no cache's keep
__device__ __forceinline__ uint4 load_once(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ void store_once(uint4* p, uint4 v) { *p = v; }

// WPR warps own a row, VPT 16-byte vectors a lane; the CTA's kWarps / WPR
// rows a step, the grid's CTAs striding over the rows.
template <typename XT, int VPT, int WPR, typename ST>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const XT* __restrict__ x, const ST* __restrict__ scale,
               XT* __restrict__ out, int M, int K, float eps) {
  constexpr int N = kPerVec<XT>;
  constexpr int GR = kWarps / WPR;        // rows a CTA step
  constexpr int LPR = 32 * WPR;           // lanes a row
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KV = K / N;                   // vectors a row
  const int c0 = (warp % WPR) * 32 + lane;   // vector i: c0 + LPR i
  ScaleSlice<ST, N> sc[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (c0 + LPR * i < KV) sc[i].load(scale, c0 + LPR * i);
  auto load = [&](int row, uint4 (&v)[VPT]) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = c0 + LPR * i;
      v[i] = row < M && c < KV ? load_once(xr + c)
                               : make_uint4(0u, 0u, 0u, 0u);
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
      for (int e = 0; e < N; ++e)
        ss = fmaf(elem<XT>(cur[i], e), elem<XT>(cur[i], e), ss);
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
        if (c >= KV) continue;
        float o[N];
#pragma unroll
        for (int e = 0; e < N; ++e)
          o[e] = elem<XT>(cur[i], e) * r * sc[i].get(e);
        store_once(orow + c, pack<XT>(o));
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

template <typename XT, int VPT, int WPR, typename ST>
struct Rows {
  static constexpr int vpt = VPT, wpr = WPR;
  static int per_sm() {   // CTAs an SM holds, asked once
    static int n = -1;
    if (n < 0 && cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                     &n, rmsnorm_kernel<XT, VPT, WPR, ST>, kThreads, 0) !=
                     cudaSuccess)
      n = -1;
    return n;
  }
  static void launch(const void* x, const void* s, void* out, int M, int K,
                     float eps, int ctas, cudaStream_t st) {
    rmsnorm_kernel<XT, VPT, WPR, ST><<<ctas, kThreads, 0, st>>>(
        static_cast<const XT*>(x), static_cast<const ST*>(s),
        static_cast<XT*>(out), M, K, eps);
  }
};

// f(Rows<...>{}) of the split for K: vectors a lane and warps a row, by the
// row's count of 16-byte vectors.  At most 4 vectors a lane up to 1024 a
// row; wider rows take more warps, up to the CTA's 8; fp32 at K = 8192
// (2048 vectors) takes 8 a lane.
template <typename XT, typename ST, typename F>
bool rows_dispatch(int K, F&& f) {
  const int kv = K / kPerVec<XT>;
  if (kv <= 32) f(Rows<XT, 1, 1, ST>{});
  else if (kv <= 64) f(Rows<XT, 2, 1, ST>{});
  else if (kv <= 128) f(Rows<XT, 4, 1, ST>{});
  else if (kv <= 256) f(Rows<XT, 4, 2, ST>{});
  else if (kv <= 512) f(Rows<XT, 4, 4, ST>{});
  else if (kv <= 1024) f(Rows<XT, 4, 8, ST>{});
  else if constexpr (sizeof(XT) == 4) {
    if (kv > 2048) return false;
    f(Rows<XT, 8, 8, ST>{});
  } else {
    return false;
  }
  return true;
}

template <typename F>
bool dispatch(int K, int x_bf16, int scale_bf16, F&& f) {
  if (x_bf16)
    return scale_bf16 ? rows_dispatch<bf16, bf16>(K, f)
                      : rows_dispatch<bf16, float>(K, f);
  return scale_bf16 ? rows_dispatch<float, bf16>(K, f)
                    : rows_dispatch<float, float>(K, f);
}

enum Form { kFp32Stream = 0, kBf16Stream = 1 };

// The launch of a call: {form, warps a row, 16-byte vectors a lane, CTAs}.
// cudaErrorInvalidValue for what the kernel does not take.
int make_plan(int M, int K, int x_bf16, int scale_bf16, int* plan) {
  if ((x_bf16 | scale_bf16) & ~1 || M < 1 || K < 1 || K > kMaxK ||
      K % (x_bf16 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  int per = -1;
  dispatch(K, x_bf16, scale_bf16, [&](auto rows) {
    using R = decltype(rows);
    plan[1] = R::wpr;
    plan[2] = R::vpt;
    per = R::per_sm();
  });
  if (per < 1 || sm_count() < 1) return (int)cudaErrorInvalidConfiguration;
  const int rows = kWarps / plan[1];
  plan[0] = x_bf16 ? kBf16Stream : kFp32Stream;
  plan[3] = std::min((M + rows - 1) / rows, sm_count() * per);
  return 0;
}

}  // namespace

extern "C" {

// The widest row the kernel takes.
int rmsnorm_max_k() { return kMaxK; }

// The plan of a call, as rmsnorm() launches it, into plan[4]: form (0
// "fp32_stream", 1 "bf16_stream"), warps a row, 16-byte vectors a lane,
// CTAs.  Returns 0, cudaErrorInvalidValue for what the kernel does not
// take, or the error of the occupancy query.
int rmsnorm_plan(int M, int K, int x_bf16, int scale_bf16, int* plan) {
  return make_plan(M, K, x_bf16, scale_bf16, plan);
}

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for an
// unknown dtype code or a shape the kernel does not take.  x, out (M, K)
// and scale (K,), 16-byte aligned, with K % 4 == 0 (bf16 x: K % 8 == 0)
// and K <= rmsnorm_max_k(); x_bf16 / scale_bf16: 0 fp32, 1 bf16 (out
// takes x's dtype).
int rmsnorm(const void* x, const void* scale, void* out, int M, int K,
            float eps, int x_bf16, int scale_bf16, cudaStream_t stream) {
  int plan[4];
  const int err = make_plan(M, K, x_bf16, scale_bf16, plan);
  if (err != 0) return err;
  dispatch(K, x_bf16, scale_bf16, [&](auto rows) {
    decltype(rows)::launch(x, scale, out, M, K, eps, plan[3], stream);
  });
  return (int)cudaGetLastError();
}

}  // extern "C"
