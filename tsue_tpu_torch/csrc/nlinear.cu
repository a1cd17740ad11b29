// NLinear in one pass: for each row b and channel c,
//   out[b, c, o] = sum_t (x[b, c, t] - x[b, c, Ti-1]) * w[c, t, o]
//                  + bias[c, o] + x[b, c, Ti-1]
//
// Replaces the Pallas kernel tsue_tpu/ops/nlinear.py:31 (_nlinear_kernel,
// launched by nlinear_fused at :46).  x (B, C, Ti), w (C, Ti, To), bias
// (C, To) and out (B, C, To), all fp32; the sum over t runs in fp32 in
// order, then the bias and the last step are added, as the Pallas kernel
// does (dot, + b, + last).
//
// What bounds it on an H100: latency, not bytes or operations.  At the
// LTSF's shapes (C = 64, Ti = 18, To <= 30, B = 16 or 160) the call moves
// 0.1 to 1.5 MB and does at most 11 MFLOP, under a microsecond of either,
// while a launch alone costs about 5 us and every first touch of a cold L2
// line a DRAM round trip.  So the design is one wave of small CTAs whose
// inputs arrive in one round trip, before any arithmetic:
//   - a CTA takes a group of cg channels and a block of bb rows: the grid
//     is (C / cg, B / bb), rounded up, which fills the card at B = 16 (cg
//     2, bb 4: 128 CTAs) and keeps several CTAs a SM at B = 160;
//   - it stages only its channels' slice of w (cg, Ti, To) and bias (cg,
//     To), and its rows' (cg, Ti) slices of x, in shared memory: every copy
//     is issued before the CTA waits, once.  Two copy forms (the wrapper's
//     plan, ops/nlinear.py:nlinear_plan, names one):
//       bulk  one thread issues Hopper's 1-D bulk copies (cp.async.bulk,
//             one for w's slice, one for bias's, one a row of x) completing
//             on one mbarrier; it needs 16-byte aligned addresses and sizes
//             in multiples of 16 bytes, which the plan checks (aligned
//             bases, C % cg == 0, cg * Ti and cg * To multiples of 4);
//       cp4   every thread issues 4-byte cp.async copies, all in flight
//             before one cp.async.wait_all: any shape, any 4-byte offset;
//   - each thread then owns outputs (row, channel, o), consecutive threads
//     on consecutive o (conflict-free shared reads, coalesced stores), and
//     runs the arithmetic in one fixed order: x - last, fmaf over t
//     ascending, + bias, + last, so both copy forms give the same bits.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/nlinear.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSmem = 232448;  // the dynamic shared memory a CTA may ask
constexpr int kBarBytes = 16;     // the mbarrier, padded: the staged arrays
                                  // start 16-byte aligned
enum Form { kBulk = 0, kCp4 = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One 1-D bulk copy of `bytes` (a multiple of 16) from global src to
// shared dst (both 16-byte aligned), reported to bar as `bytes`
// transferred.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

template <int kForm>
__global__ void __launch_bounds__(kMaxThreads)
nlinear_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int B, int C, int Ti, int To, int cg, int bb) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int c0 = blockIdx.x * cg, b0 = blockIdx.y * bb;
  const int nc = min(cg, C - c0), nb = min(bb, B - b0);
  float* ws = reinterpret_cast<float*>(smem + kBarBytes);  // (nc, Ti, To)
  float* bs = ws + nc * Ti * To;                            // (nc, To)
  float* xs = bs + nc * To;                                 // (nb, nc, Ti)
  const float* wg = w + (size_t)c0 * Ti * To;
  const float* bg = bias + (size_t)c0 * To;
  if (kForm == kBulk) {
    // the plan guarantees nc == cg and every size below a multiple of 16
    // bytes, so every offset in shared and global memory is 16-aligned
    const uint32_t w_bytes = nc * Ti * To * 4, b_bytes = nc * To * 4,
                   x_bytes = nc * Ti * 4;
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // the one arrival, expecting every byte of the 2 + nb copies below:
      // w_bytes + b_bytes + nb * x_bytes
      mbar_arrive_tx(bar, w_bytes + b_bytes + nb * x_bytes);
      bulk_load(ws, wg, w_bytes, bar);                       // w_bytes
      bulk_load(bs, bg, b_bytes, bar);                       // b_bytes
      for (int r = 0; r < nb; ++r)                           // x_bytes each
        bulk_load(xs + r * nc * Ti, x + ((size_t)(b0 + r) * C + c0) * Ti,
                  x_bytes, bar);
    }
    mbar_wait(bar, 0);
  } else {
    for (int i = threadIdx.x; i < nc * Ti * To; i += blockDim.x)
      cp4(ws + i, wg + i);
    for (int i = threadIdx.x; i < nc * To; i += blockDim.x)
      cp4(bs + i, bg + i);
    for (int i = threadIdx.x; i < nb * nc * Ti; i += blockDim.x) {
      const int r = i / (nc * Ti);
      cp4(xs + i, x + ((size_t)(b0 + r) * C + c0) * Ti + (i - r * nc * Ti));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const int per_row = nc * To;
  for (int i = threadIdx.x; i < nb * per_row; i += blockDim.x) {
    const int r = i / per_row, k = i - r * per_row;
    const int j = k / To, o = k - j * To;
    const float* xr = xs + (r * nc + j) * Ti;
    const float* wc = ws + j * Ti * To + o;
    const float last = xr[Ti - 1];
    float acc = 0.f;
    for (int t = 0; t < Ti - 1; ++t) acc = fmaf(xr[t] - last, wc[t * To], acc);
    out[((size_t)(b0 + r) * C + c0) * To + k] = (acc + bs[j * To + o]) + last;
  }
}

template <int kForm>
int launch(const float* x, const float* w, const float* bias, float* out,
           int B, int C, int Ti, int To, int cg, int bb, int threads,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nlinear_kernel<kForm>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((C + cg - 1) / cg, (B + bb - 1) / bb);
  nlinear_kernel<kForm><<<grid, threads, smem, stream>>>(
      x, w, bias, out, B, C, Ti, To, cg, bb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory of a CTA of cg channels and bb rows.
long long nlinear_smem(int Ti, int To, int cg, int bb) {
  return kBarBytes +
         4LL * cg * ((long long)Ti * To + To + (long long)bb * Ti);
}

// Returns a cudaError_t (0 on success).  x (B, C, Ti), w (C, Ti, To), bias
// (C, To), out (B, C, To), all fp32 and contiguous; form 0 (bulk) or 1
// (cp4), cg channels and bb rows a CTA, `threads` a CTA (a multiple of 32,
// at most 256), as ops/nlinear.py:nlinear_plan gives them.  A launch the
// plan could not have named returns cudaErrorInvalidValue and runs nothing.
int nlinear(const float* x, const float* w, const float* bias, float* out,
            int B, int C, int Ti, int To, int form, int cg, int bb,
            int threads, cudaStream_t stream) {
  const long long smem = nlinear_smem(Ti, To, cg, bb);
  if (B < 1 || C < 1 || Ti < 1 || To < 1 || cg < 1 || bb < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      smem > kMaxSmem || (B + bb - 1) / bb > 65535)
    return (int)cudaErrorInvalidValue;
  if (form == kBulk) {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
    if (!aligned || C % cg || (cg * Ti) % 4 || (cg * To) % 4)
      return (int)cudaErrorInvalidValue;
    return launch<kBulk>(x, w, bias, out, B, C, Ti, To, cg, bb, threads,
                         (size_t)smem, stream);
  }
  if (form == kCp4)
    return launch<kCp4>(x, w, bias, out, B, C, Ti, To, cg, bb, threads,
                        (size_t)smem, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
