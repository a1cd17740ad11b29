// The LoRA product in one kernel:
//   out = x @ W + scale * round(x @ A) @ B
// without writing the (M, r) product xA to memory.
//
// Replaces the Pallas kernel tsue_tpu/ops/lora.py:32 (_lora_kernel,
// launched by lora_matmul at :49).  x (M, K), W (K, N), A (K, r), B (r, N)
// and out (M, N), all fp32 or all bf16, any r >= 1; every product sums in
// fp32, and round() takes xA to x's dtype before the second product, as the
// Pallas kernel does (lora.py:36; the identity in fp32).  The output is the
// sum plus scale * delta, rounded to x's dtype.  K is walked in one fixed
// order by one CTA (no split-K), so a repeated call gives bit-identical
// results.  Each call is one launch.
//
// What bounds it on an H100: at the stage-1 shapes (M = 16 * 528 = 8448,
// K = 2048, N = 2048 for q_proj and 512 for v_proj, r = 8) the base product
// is 70.9 / 17.7 GFLOP on under 0.2 GB, so the tensor cores' rate does:
// bf16 at 989 TFLOP/s (0.072 / 0.018 ms), fp32 as three TF32 products at
// 495 (0.43 / 0.11 ms).  Three forms; the caller names one
// (ops/lora.py:lora_matmul_plan picks it by shape):
//
//   - the tensor-core forms, for rows of x and W that are multiples of 16
//     bytes and 16-byte aligned bases (TMA's terms).  A persistent grid, one
//     CTA of 384 threads per SM, each walking 128 x 256 output tiles.  Its
//     producer warpgroup keeps a ring of x (128 x K step) and W (K step x
//     256) tiles full by TMA, 128-byte swizzled, through full/empty
//     mbarriers, running into the next tile's stages while the consumers
//     finish a tile, and stages the adapter's rows of each stage beside
//     them from registers loaded stages ahead.  Two consumer warpgroups own
//     64 output rows each (128 fp32 sums a thread; setmaxnreg moves the
//     producer's registers to them).  The adapter sits in the tile: xA is
//     summed from the x tiles already in shared memory and never leaves the
//     CTA; the epilogue adds scale * round(xA) @ B[:, tile];
//   - bf16 (wgmma): a 4-stage ring of 64 K positions (50 KB a stage); each
//     16 K positions one m64n256k16 wgmma (x K-major, W N-major through the
//     transpose bit) and one m64n16k16 for xA against A's rows staged
//     transposed and zero-padded to 16 ranks (6% more tensor work).  The
//     epilogue rounds xA to bf16 in registers, where each warp's m64n16
//     sums are the A fragment of an m16n8k16 mma.sync, adds its products
//     with B (staged transposed) and stores through shared memory, 64
//     bytes of a row at a time;
//   - fp32 (3xTF32 on wgmma): each factor is split into big (its tf32 bits)
//     and small (the rest), and small * big + big * small + big * big run
//     as m64n256k8 wgmmas (small * small, 2^-22 relative, is dropped).
//     tf32 wgmma takes only K-major operands and W is N-major, so each
//     stage of a 2-stage ring of 32 K positions the consumers re-stage x's
//     halves and W's, transposed, in shared memory and run the products
//     from there.  xA is summed by the producer warpgroup in fp32 FMAs (a
//     row a thread), exact as the plain version; the epilogue adds
//     scale * xA @ B by fp32 FMAs;
//   - the SIMT form, the kernel's first, for every other shape: a CTA of 256
//     threads owns a 128 x 128 tile and walks K in steps of 8,
//     double-buffered through registers, each thread an 8 x 8 micro-tile of
//     fp32 FMA sums; each step also stages A's rows and adds the step's
//     terms of the tile's xA from the x tile in shared memory; the epilogue
//     rounds xA and adds scale * xA @ B.  M, N and K tails are predicated.
//     It takes any rank: the ranks go in blocks of 16, the first with the
//     x @ W walk, each further one in one more walk over x and A alone (W
//     is not read again); the tile's sums stay in registers throughout and
//     gain scale * round(xA_block) @ B_block after each walk, so a call of
//     rank 16 or less computes what it did.  Ranks above 16 take this form
//     (lora_matmul_plan); the tensor-core forms take 16 or less.
//
// In the tensor-core forms, M, N and K tails are TMA's zero fill (reads past
// the tensor arrive as zeros) and masked stores.  xA is recomputed by each of
// the N / 256 column tiles of a row block, as the Pallas kernel recomputes it
// per column block.  Plain C interface, loaded with ctypes by
// tsue_tpu_torch/ops/lora.py.
#include <cuda.h>            // CUtensorMap and its enums (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- the SIMT form --------------------------------------------------------

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
lora_simt_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ out, int M, int K, int N, int r,
                   float scale) {
  __shared__ __align__(16) float As[2][BK][kLdA];   // x tile, transposed
  __shared__ __align__(16) float Bs[2][BK][BN];     // W tile
  __shared__ float Ls[2][BK][kMaxR];                // A[k0:k0+8, j0:j0+rb]
  __shared__ float XA[BM][kMaxR + 1];               // round(x @ A) of the tile
  __shared__ float Rs[kMaxR][BN];                   // B[j0:j0+rb, n0:n0+128]
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
  // the ranks go in blocks of kMaxR: ranks j0 .. j0 + rb - 1
  int j0 = 0, rb = r < kMaxR ? r : kMaxR;
  // A loads: thread tid < 8 * rb takes A[k0 + tid / rb, j0 + tid % rb]
  bool l_ok = false;
  int l_k = 0, l_j = 0;
  // xA sums: row tid % 128 of the tile, ranks j0 + tid / 128 + 2q
  const int xa_row = tid & (BM - 1), xa_j0 = tid >> 7;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  float xacc[kMaxR / 2];

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xv = zero, wv = zero;
  float lv = 0.f;

  // One walk over K: the rank block's xA sums and, on the first walk
  // (kW), the x @ W sums; later walks read x and A only.
  auto walk = [&](auto with_w) {
    constexpr bool kW = decltype(with_w)::value;
    l_ok = tid < BK * rb;
    l_k = l_ok ? tid / rb : 0;
    l_j = l_ok ? tid - l_k * rb : 0;
#pragma unroll
    for (int q = 0; q < kMaxR / 2; ++q) xacc[q] = 0.f;
    auto load = [&](int k0) {
      xv = a_ok ? load4<T, kVec>(xp + k0, K - k0 - a_k) : zero;
      if constexpr (kW)
        wv = (k0 + b_k < K && n_rem > 0)
                 ? load4<T, kVec>(wp + (size_t)k0 * N, n_rem) : zero;
      lv = (l_ok && k0 + l_k < K)
               ? to_f(a[(size_t)(k0 + l_k) * r + j0 + l_j]) : 0.f;
    };
    auto store = [&](int buf) {
      As[buf][a_k + 0][a_row] = xv.x;
      As[buf][a_k + 1][a_row] = xv.y;
      As[buf][a_k + 2][a_row] = xv.z;
      As[buf][a_k + 3][a_row] = xv.w;
      if constexpr (kW)
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
        if constexpr (kW) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&As[buf][kk][64 + ty * 4]);
          const float4 b0 =
              *reinterpret_cast<const float4*>(&Bs[buf][kk][tx * 4]);
          const float4 b1 =
              *reinterpret_cast<const float4*>(&Bs[buf][kk][64 + tx * 4]);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
        const float xk = As[buf][kk][xa_row];
#pragma unroll
        for (int q = 0; q < kMaxR / 2; ++q) {
          // the rank index is uniform across a warp: no divergence
          if (xa_j0 + 2 * q < rb)
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

    // the block's xA rounded to x's dtype, B's rows j0.. of the tile, and
    // acc += scale * xA @ B
#pragma unroll
    for (int q = 0; q < kMaxR / 2; ++q) {
      const int j = xa_j0 + 2 * q;
      if (j < rb) XA[xa_row][j] = to_f(from_f<T>(xacc[q]));
    }
    for (int i = tid; i < rb * BN; i += kThreads) {
      const int q = i / BN, n = i - q * BN;
      Rs[q][n] = n0 + n < N ? to_f(b[(size_t)(j0 + q) * N + n0 + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int mi = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ni = (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
        float d = 0.f;
        for (int q = 0; q < rb; ++q) d = fmaf(XA[mi][q], Rs[q][ni], d);
        acc[i][j] = acc[i][j] + scale * d;
      }
    }
    // As, Ls, XA and Rs are free for the next walk
    __syncthreads();
  };

  walk(std::true_type{});
  for (j0 = kMaxR; j0 < r; j0 += kMaxR) {
    rb = r - j0 < kMaxR ? r - j0 : kMaxR;
    walk(std::false_type{});
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
      if (n >= N) continue;
      out[(size_t)m * N + n] = from_f<T>(acc[i][j]);
    }
  }
}

// ---- the tensor-core forms ----------------------------------------------

constexpr int kTM = 128;            // output rows of a CTA
constexpr int kTN = 256;            // output columns of a CTA
constexpr int kConsumers = 256;     // two warpgroups of 64 output rows each
constexpr int kTcThreads = kConsumers + 128;  // and the producer warpgroup
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 <= 65536 (the
// launch gives each of the 384 threads 168; the fp32 producer sums 16 xA
// values a thread)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kRowBytes = 128;      // one swizzled row: 64 bf16 or 32 fp32
constexpr int kXBytes = kTM * kRowBytes;      // the x tile of a stage
constexpr int kWBytes = kTN * kRowBytes;      // the W tile of a stage

// The per-dtype layout of a stage: x (kTM rows of kK K values) and W (kK
// rows of kTN columns, as kTN / kBoxN boxes of kBoxN columns) land by TMA
// with the 128-byte swizzle (16-byte chunk c of row i stored at chunk c ^ (i
// % 8)); the adapter's A rows k0..k0+kK are staged by the producer warpgroup.
template <typename T> struct Tc;
template <> struct Tc<__nv_bfloat16> {
  static constexpr int kStages = 4;   // the ring's depth
  static constexpr int kK = 64;       // K positions a stage
  static constexpr int kBoxN = 64;    // W columns a TMA box
  // A^T (16 ranks x 64 K, zero-padded), K-major and swizzled like x
  static constexpr int kABytes = 16 * kRowBytes;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct Tc<float> {
  static constexpr int kStages = 2;   // more would not leave room for
                                      // the re-staged halves
  static constexpr int kK = 32;
  static constexpr int kBoxN = 32;
  static constexpr int kALd = 24;     // A (32 K x 16 ranks), rows padded
  static constexpr int kABytes = 32 * kALd * 4;
  static constexpr CUtensorMapDataType kType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <typename T>
constexpr int kStageBytes = kXBytes + kWBytes + Tc<T>::kABytes;
// The epilogue's tiles, past the ring (which the producer is filling with
// the next tile's stages meanwhile): bf16 B^T (kTN columns of 16 ranks,
// rows padded to 48 bytes); fp32 the producer's xA (kTM x 16, rows padded
// to 17 floats) and B (16 x kTN), rounded up to 1024 bytes so that the
// re-staged halves past them start on a swizzle atom.  The bf16 tile is
// also each consumer warp's slot for staging its 16 x 32 output blocks.
constexpr int kBtBytes = 48, kXaLd = 17;
constexpr int kSlotLd = 80;         // bf16 output rows staged for a store
constexpr int kXaBytes = kTM * kXaLd * 4;
constexpr int kSlotBytes = kConsumers / 32 * 16 * kSlotLd;
template <typename T>
constexpr int kEpiBytes =
    sizeof(T) == 4                  ? (kXaBytes + 16 * kTN * 4 + 1023) & ~1023
    : kTN * kBtBytes > kSlotBytes ? kTN * kBtBytes
                                  : kSlotBytes;
// fp32: the halves the consumers re-stage each stage (x big and small, W^T
// big and small: kTN rows of 32 K values), past the epilogue's tiles
template <typename T>
constexpr int kRestageBytes = sizeof(T) == 4 ? 2 * kXBytes + 2 * kWBytes : 0;
template <typename T>
constexpr int kTcSmem = Tc<T>::kStages * kStageBytes<T> + kEpiBytes<T> +
                        kRestageBytes<T> + 1024;   // + alignment
static_assert(kStageBytes<float> % 1024 == 0 &&
              kStageBytes<__nv_bfloat16> % 1024 == 0,
              "each stage's TMA tiles must stay 1024-byte aligned");
// sw128_desc sets no base offset: a swizzled wgmma operand (fp32's
// re-staged halves) must start on a 1024-byte atom, or the tensor cores
// read chunk c of a row from another chunk
static_assert((Tc<float>::kStages * kStageBytes<float> + kEpiBytes<float>) %
                      1024 == 0 &&
                  kXBytes % 1024 == 0 && kWBytes % 1024 == 0,
              "fp32's re-staged halves must stay 1024-byte aligned");

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// One TMA copy of a box at (c0 innermost, c1) into shared memory, reported
// to bar; parts of the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}
// Shared-memory writes (of this thread, or of others, observed through a
// barrier) become visible to the tensor cores' (async proxy) reads after it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The two consumer warpgroups alone (the producer warpgroup does not take
// part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: lbo and
// sbo in bytes (K-major: sbo = 1024 between 8-row groups, lbo unused;
// N-major: lbo between 64-column blocks, sbo = 1024 between 8-K-row groups).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads of wgmma accumulators above the
// wait that completes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 256, fp32) += A (64 x 16, smem) * B (16 x 256, smem, N-major)
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 16, fp32) += A (64 x 16, smem) * B (16 x 16, smem, K-major)
__device__ __forceinline__ void wgmma_m64n16_ss(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, N-major)
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// c = a (16 x 16, bf16) * b (16 x 8, bf16), fp32 sums, registers only.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p,
                                              bool ok) {
  return ok ? __bfloat16_as_ushort(*p) : 0u;
}

// fp32 -> (big, small) for the tensor cores: big keeps the 11 significant
// bits a tf32 operand holds (the rest masked off), small = x - big exactly,
// of which the mma uses the leading bits.  (Copied from lmhead_topk.cu.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
// The producer warpgroup's part of a stage: the adapter's rows A[k0:k0+kK,
// :r], zero-padded to 16 ranks and past K, 8 bf16 or 4 fp32 values a
// thread, loaded into registers stages ahead of their store.  bf16:
// transposed (rank-major, K contiguous) and swizzled like the x tile, the B
// operand of a K-major m64n16k16 wgmma; thread p takes rank p / 8 at K
// positions 8 (p % 8) .. + 8, one 16-byte chunk.  fp32: K-major rows of kALd
// floats; thread p takes row p / 4, ranks 4 (p % 4) .. + 4.  The stores are
// plain (generic) stores: the bf16 consumers order them before their wgmma
// reads with fence.proxy.async after the stage's full barrier, since the
// fence in a producer thread would also wait for its prefetch loads.
__device__ __forceinline__ void load_adapter(uint32_t (&v)[4],
                                             const __nv_bfloat16* a, int k0,
                                             int K, int r, int p) {
  const int j = p >> 3, k = k0 + (p & 7) * 8;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat16* q = a + (size_t)(k + 2 * e) * r + j;
    v[e] = bf16_bits(q, j < r && k + 2 * e < K) |
           bf16_bits(q + r, j < r && k + 2 * e + 1 < K) << 16;
  }
}
__device__ __forceinline__ void load_adapter(uint32_t (&v)[4],
                                             const float* a, int k0, int K,
                                             int r, int p) {
  const int k = k0 + (p >> 2), j = (p & 3) * 4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = __float_as_uint(j + e < r && k < K ? a[(size_t)k * r + j + e]
                                              : 0.f);
}
template <typename T>
__device__ __forceinline__ void store_adapter(uint8_t* dst,
                                              const uint32_t (&v)[4], int p) {
  uint8_t* at;
  if constexpr (sizeof(T) == 2) {
    const int j = p >> 3;
    at = dst + j * kRowBytes + (((p & 7) ^ (j & 7)) << 4);
  } else {
    at = dst + (p >> 2) * Tc<float>::kALd * 4 + (p & 3) * 16;
  }
  *reinterpret_cast<uint4*>(at) = make_uint4(v[0], v[1], v[2], v[3]);
}

// fp32: the producer warpgroup's thread p sums xA of tile row p over a
// stage, in fp32 FMAs (exact fp32, as the plain version), from the x tile
// and the adapter's rows already in the ring; ranks in fours up to r, R (8
// or 16) sums a thread.
template <int R>
__device__ __forceinline__ void sum_xa(float (&xa)[R], const uint8_t* st,
                                       int r, int p) {
  constexpr int kALd = Tc<float>::kALd;
  const float* as = reinterpret_cast<const float*>(st + kXBytes + kWBytes);
#pragma unroll 1
  for (int c = 0; c < kRowBytes / 16; ++c) {
    const float4 xv = *reinterpret_cast<const float4*>(
        st + p * kRowBytes + ((c ^ (p & 7)) << 4));
    const float xk[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ar = as + (c * 4 + e) * kALd;
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        if (4 * q >= r) break;
        const float4 av = *reinterpret_cast<const float4*>(ar + 4 * q);
        xa[4 * q] = fmaf(xk[e], av.x, xa[4 * q]);
        xa[4 * q + 1] = fmaf(xk[e], av.y, xa[4 * q + 1]);
        xa[4 * q + 2] = fmaf(xk[e], av.z, xa[4 * q + 2]);
        xa[4 * q + 3] = fmaf(xk[e], av.w, xa[4 * q + 3]);
      }
    }
  }
}

// A consumer warp is done with the stage of this CTA's k step g (counted
// over all its tiles): one arrival on the stage's empty barrier.  Only for
// stages that a later k step refills (g + S < total).
template <int S>
__device__ __forceinline__ void release(uint64_t* empty, int g, int total,
                                        int lane) {
  __syncwarp();
  if (g + S < total && lane == 0) mbar_arrive(&empty[g % S]);
}

// The tiles of a CTA: tiles cta, cta + ctas, ..., column tiles fastest, so
// the CTAs at work at one time share rows of x.
struct Work {
  int cta, ctas, tiles_n, tiles, nk, total;
  __device__ int m0(int tile) const { return tile / tiles_n * kTM; }
  __device__ int n0(int tile) const { return tile % tiles_n * kTN; }
};

// The bf16 consumers: warpgroup wg owns output rows wg * 64 .. + 64 of the
// tile and all kTN columns (kTN / 2 fp32 sums a thread).  Each 16-deep step
// of a stage is one m64n<kTN>k16 wgmma (x from the ring, K-major; W from the
// ring, N-major through the transpose bit) and one m64n16k16 for the
// adapter's xA (64 x 16 sums a warpgroup, ranks past r zero).  A stage is
// released once the next stage's products are issued and its own are done.
__device__ __forceinline__ void consume_bf16(
    uint8_t* smem, uint64_t* full, uint64_t* empty, const __nv_bfloat16* b,
    __nv_bfloat16* out, int M, int N, int r, float scale, const Work& wk) {
  constexpr int kK = Tc<__nv_bfloat16>::kK, S = Tc<__nv_bfloat16>::kStages;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  uint8_t* ep = smem + S * kStageBytes<__nv_bfloat16>;
  int g = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    float acc[kTN / 2], xa[8];
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) xa[i] = 0.f;
    for (int kt = 0; kt < wk.nk; ++kt, ++g) {
      const int s = g % S;
      mbar_wait(&full[s], (g / S) & 1);
      fence_proxy_async();            // the producer's A^T rows, for wgmma
      const uint32_t xs = smem_u32(smem + s * kStageBytes<__nv_bfloat16>) +
                          wg * 64 * kRowBytes;
      const uint32_t ws = xs - wg * 64 * kRowBytes + kXBytes;
      const uint32_t as = ws + kWBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        const uint64_t da = sw128_desc(xs + kk * 32, 16, 1024);
        wgmma_m64n256_ss(acc, da,
                         sw128_desc(ws + kk * 16 * kRowBytes, kK * kRowBytes,
                                    1024));
        wgmma_m64n16_ss(xa, da, sw128_desc(as + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) release<S>(empty, g - 1, wk.total, lane);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
    release<S>(empty, g - 1, wk.total, lane);

    // epilogue: B[:16, n0:n0+kTN] transposed (a row of 16 ranks a column,
    // zero past r and N, rows padded to 48 bytes: no bank conflicts); then
    // xA rounded to bf16 in registers, where each warp's m64n16 sums are
    // laid out as the A fragment of an m16n8k16 mma.sync, times each
    // 8-column block of it: the block's sums come out where the
    // warpgroup's accumulators of those columns are, and are added as
    // acc + scale * d.
    consumers_sync();                 // the previous tile's B^T is read
    for (int n = tid; n < kTN; n += kConsumers) {
      const bool in = n0 + n < N;
      uint32_t pk[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const __nv_bfloat16* p = b + (size_t)(2 * e) * N + n0 + n;
        pk[e] = bf16_bits(p, in && 2 * e < r) |
                bf16_bits(p + N, in && 2 * e + 1 < r) << 16;
      }
      uint4* row = reinterpret_cast<uint4*>(ep + n * kBtBytes);
      row[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      row[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
    consumers_sync();
    const uint32_t af[4] = {pack_bf16(xa[0], xa[1]), pack_bf16(xa[2], xa[3]),
                            pack_bf16(xa[4], xa[5]),
                            pack_bf16(xa[6], xa[7])};
    const uint8_t* bt = ep + (lane >> 2) * kBtBytes + (lane & 3) * 4;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const uint8_t* p = bt + j * 8 * kBtBytes;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, af, *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 16));
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j * 4 + e] += scale * d[e];
    }

    // sums (n8 block j, i, e) of a thread: row 16 * warp + lane / 4 + 8i,
    // column 8j + 2 (lane % 4) + e.  Stored 32 columns at a time through
    // the warp's slot of the B^T tile (16 rows of 80 bytes: no bank
    // conflicts), so each lane writes 16 bytes and a row's 64 bytes are
    // whole sectors; N % 8 == 0, so 8 columns are in or out whole.
    consumers_sync();                 // every warp is done with B^T
    const int warp = (tid >> 5) & 7, row0 = m0 + wg * 64 + (warp & 3) * 16;
    uint8_t* slot = ep + warp * 16 * kSlotLd;
#pragma unroll
    for (int c = 0; c < kTN / 32; ++c) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = c * 4 + jj;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<uint32_t*>(slot + ((lane >> 2) + 8 * i) *
                                                  kSlotLd +
                                       jj * 16 + (lane & 3) * 4) =
              pack_bf16(acc[j * 4 + 2 * i], acc[j * 4 + 2 * i + 1]);
      }
      __syncwarp();
      const int col = n0 + c * 32 + (lane & 3) * 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = (lane >> 2) + 8 * h;
        const uint4 v = *reinterpret_cast<const uint4*>(
            slot + rl * kSlotLd + (lane & 3) * 16);
        if (row0 + rl < M && col < N)
          *reinterpret_cast<uint4*>(out + (size_t)(row0 + rl) * N + col) = v;
      }
      __syncwarp();
    }
  }
}

// D (64 x 256, fp32) += A (64 x 8, tf32) * B (8 x 256, tf32), both from
// shared memory, K-major
__device__ __forceinline__ void wgmma_tf32_m64n256(float (&d)[128], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The fp32 consumers, 3xTF32 on wgmma.  tf32 wgmma takes only K-major
// operands, and W arrives N-major, so each stage both warpgroups re-stage
// the x tile's big and small halves (K-major as TMA laid them) and the W
// tile's, transposed to K-major (4 x 4 blocks through registers), release
// the ring stage, and run three m64n256k8 wgmmas a k8 step (small * big, big
// * small, big * big) from shared memory, warpgroup wg owning rows wg * 64
// .. + 64 and all kTN columns.  The epilogue adds scale * xA @ B (xA from
// the producer warpgroup, sum_xa) by fp32 FMAs into the sums.
__device__ __forceinline__ void consume_f32(
    uint8_t* smem, uint64_t* full, uint64_t* empty, const float* b,
    float* out, int M, int N, int r, float scale, const Work& wk) {
  constexpr int kK = Tc<float>::kK, S = Tc<float>::kStages;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  uint8_t* ep = smem + S * kStageBytes<float>;
  const float* xas = reinterpret_cast<const float*>(ep);
  float* bsm = reinterpret_cast<float*>(ep + kXaBytes);
  uint8_t* xb = ep + kEpiBytes<float>;   // x big, x small, W^T big, small
  uint8_t* xsm = xb + kXBytes;
  uint8_t* wbt = xsm + kXBytes;
  uint8_t* wst = wbt + kWBytes;
  int gk = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < wk.nk; ++kt, ++gk) {
      const int s = gk % S;
      mbar_wait(&full[s], (gk / S) & 1);
      const uint8_t* st = smem + s * kStageBytes<float>;
      consumers_sync();                 // the last step's wgmmas are done
#pragma unroll
      for (int i = 0; i < 4; ++i) {     // x: chunk c of the 128 x 32 tile
        const int c = tid + i * kConsumers;
        const float4 v = *reinterpret_cast<const float4*>(st + c * 16);
        uint32_t bg[4], sm[4];
        split_tf32(v.x, bg[0], sm[0]);
        split_tf32(v.y, bg[1], sm[1]);
        split_tf32(v.z, bg[2], sm[2]);
        split_tf32(v.w, bg[3], sm[3]);
        *reinterpret_cast<uint4*>(xb + c * 16) =
            make_uint4(bg[0], bg[1], bg[2], bg[3]);
        *reinterpret_cast<uint4*>(xsm + c * 16) =
            make_uint4(sm[0], sm[1], sm[2], sm[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {     // W: 4 x 4 blocks (k 4kb.., n 4nb..)
        const int kb = tid & 7, nb = (tid >> 3) + 32 * h;
        float v[4][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * kb + e;
          const float4 w4 = *reinterpret_cast<const float4*>(
              st + kXBytes + (nb >> 3) * kK * kRowBytes + k * kRowBytes +
              (((nb & 7) ^ (k & 7)) << 4));
          v[e][0] = w4.x; v[e][1] = w4.y; v[e][2] = w4.z; v[e][3] = w4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = 4 * nb + i;
          uint32_t bg[4], sm[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e][i], bg[e], sm[e]);
          const int off = n * kRowBytes + ((kb ^ (n & 7)) << 4);
          *reinterpret_cast<uint4*>(wbt + off) =
              make_uint4(bg[0], bg[1], bg[2], bg[3]);
          *reinterpret_cast<uint4*>(wst + off) =
              make_uint4(sm[0], sm[1], sm[2], sm[3]);
        }
      }
      fence_proxy_async();
      consumers_sync();
      release<S>(empty, gk, wk.total, lane);
      const uint32_t ab = smem_u32(xb) + wg * 64 * kRowBytes;
      const uint32_t as = smem_u32(xsm) + wg * 64 * kRowBytes;
      const uint32_t bb = smem_u32(wbt), bs = smem_u32(wst);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
        wgmma_tf32_m64n256(acc, sw128_desc(as + kk * 32, 16, 1024),
                           sw128_desc(bb + kk * 32, 16, 1024));
        wgmma_tf32_m64n256(acc, sw128_desc(ab + kk * 32, 16, 1024),
                           sw128_desc(bs + kk * 32, 16, 1024));
        wgmma_tf32_m64n256(acc, sw128_desc(ab + kk * 32, 16, 1024),
                           sw128_desc(bb + kk * 32, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }

    consumers_sync();                 // the previous tile's B is read
    for (int i = tid; i < r * kTN; i += kConsumers) {
      const int q = i / kTN, n = i % kTN;
      bsm[i] = n0 + n < N ? b[(size_t)q * N + n0 + n] : 0.f;
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(kTcThreads) : "memory");
    const int rl = wg * 64 + warp * 16 + g;
    for (int q = 0; q < r; ++q) {
      const float x0 = scale * xas[rl * kXaLd + q];
      const float x1 = scale * xas[(rl + 8) * kXaLd + q];
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j) {
        const float2 bv =
            *reinterpret_cast<const float2*>(bsm + q * kTN + j * 8 + 2 * t);
        acc[j * 4] = fmaf(x0, bv.x, acc[j * 4]);
        acc[j * 4 + 1] = fmaf(x0, bv.y, acc[j * 4 + 1]);
        acc[j * 4 + 2] = fmaf(x1, bv.x, acc[j * 4 + 2]);
        acc[j * 4 + 3] = fmaf(x1, bv.y, acc[j * 4 + 3]);
      }
    }
    if (tile + wk.ctas < wk.tiles)
      asm volatile("bar.arrive 3, %0;\n" ::"n"(kTcThreads) : "memory");
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
      }
    }
  }
}

// A persistent kernel: each CTA walks its 128 x 256 output tiles (Work).
// The producer warpgroup keeps the kStages-deep ring of x and W tiles full
// by TMA and stages the adapter's rows beside them, running into the next
// tile's stages while the consumers finish a tile; the two consumer
// warpgroups run the products and the epilogue.  The producer warpgroup
// gives registers to the consumers (setmaxnreg).  Each
// k step passes two mbarriers a stage: full (the TMA bytes, one arrival with
// the byte count and one from each producer warp once its adapter part is
// written) and empty (see release).  R bounds the rank: 16, or 8 for an fp32
// product of r <= 8, whose producer keeps 8 xA sums a thread, not 16: on an
// H100 at r = 8 that takes the fp32 q_proj product from 1.13 to 0.91 ms,
// though ptxas spills 24 bytes of it (lora_variants.py, f32_r16).
template <typename T, int R>
__global__ void __launch_bounds__(kTcThreads, 1)
lora_tc_kernel(const __grid_constant__ CUtensorMap tx,
               const __grid_constant__ CUtensorMap tw,
               const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ out, int M, int K, int N, int r,
               float scale) {
  constexpr int kK = Tc<T>::kK, S = Tc<T>::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  Work wk;
  wk.cta = blockIdx.x;
  wk.ctas = gridDim.x;
  wk.tiles_n = (N + kTN - 1) / kTN;
  wk.tiles = wk.tiles_n * ((M + kTM - 1) / kTM);
  wk.nk = (K + kK - 1) / kK;
  wk.total = (wk.tiles - wk.cta + wk.ctas - 1) / wk.ctas * wk.nk;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1 + 4);     // the byte count, each producer warp
      // the consumer warps, and in fp32 the producer warps, which read the
      // stage's x and A tiles for xA
      mbar_init(&empty[s], kConsumers / 32 + (sizeof(T) == 4 ? 4 : 0));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kConsumers;
    // adapter rows in registers kPre k steps ahead (bf16: the ring's depth,
    // so a tile's first stages do not wait on their loads; fp32, whose
    // stages take longer, one)
    constexpr int kPre = sizeof(T) == 2 ? S : 1;
    uint32_t pre[kPre][4];
#pragma unroll
    for (int u = 0; u < kPre; ++u)
      load_adapter(pre[u], a, (u % wk.nk) * kK, K, r, p);
    float xa[R];                      // fp32: xA of tile row p
#pragma unroll
    for (int j = 0; j < R; ++j) xa[j] = 0.f;
    for (int g0 = 0; g0 < wk.total + S - 1; g0 += S) {
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const int g = g0 + u;         // stage u
        uint8_t* st = smem + u * kStageBytes<T>;
        if (g < wk.total) {
          mbar_wait(&empty[u], ((g / S) & 1) ^ 1);
          if (p == 0) {
            const int tile = wk.cta + g / wk.nk * wk.ctas;
            const int m0 = wk.m0(tile), n0 = wk.n0(tile);
            const int k0 = g % wk.nk * kK;
            mbar_arrive_tx(&full[u], kXBytes + kWBytes);
            tma_load(st, &tx, k0, m0, &full[u]);
#pragma unroll
            for (int j = 0; j < kTN / Tc<T>::kBoxN; ++j)
              tma_load(st + kXBytes + j * kK * kRowBytes, &tw,
                       n0 + j * Tc<T>::kBoxN, k0, &full[u]);
          }
          store_adapter<T>(st + kXBytes + kWBytes, pre[u % kPre], p);
          __syncwarp();
          if ((p & 31) == 0) mbar_arrive(&full[u]);
          load_adapter(pre[u % kPre], a, (g + kPre) % wk.nk * kK, K, r, p);
        }
        if constexpr (sizeof(T) == 4) {
          // xA of the step S - 1 behind: its stage is not refilled before
          // this warp has read it
          const int gx = g - (S - 1), ux = (u + 1) % S;
          if (gx >= 0 && gx < wk.total) {
            mbar_wait(&full[ux], (gx / S) & 1);
            sum_xa(xa, smem + ux * kStageBytes<T>, r, p);
            __syncwarp();
            if (gx + S < wk.total && (p & 31) == 0) mbar_arrive(&empty[ux]);
            if (gx % wk.nk == wk.nk - 1) {      // a tile's xA is whole
              if (gx >= wk.nk)                  // the last one is read
                asm volatile("bar.sync 3, %0;\n" ::"n"(kTcThreads)
                             : "memory");
              float* xo = reinterpret_cast<float*>(
                              smem + S * kStageBytes<T>) + p * kXaLd;
#pragma unroll
              for (int j = 0; j < 16; ++j) {
                xo[j] = j < R ? xa[j] : 0.f;
                if (j < R) xa[j] = 0.f;
              }
              asm volatile("bar.arrive 2, %0;\n" ::"n"(kTcThreads)
                           : "memory");
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if constexpr (sizeof(T) == 2)
    consume_bf16(smem, full, empty, b, out, M, N, r, scale, wk);
  else
    consume_f32(smem, full, empty, b, out, M, N, r, scale, wk);
}

// ---- launch ---------------------------------------------------------------

template <typename T>
int launch_simt(const void* x, const void* w, const void* a, const void* b,
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
    lora_simt_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        xt, wt, at, bt, ot, M, K, N, r, scale);
  else
    lora_simt_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        xt, wt, at, bt, ot, M, K, N, r, scale);
  return (int)cudaGetLastError();
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: reached through the
// runtime, so the library links nothing beyond it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D row-major (rows, cols) tensor as TMA boxes of (box_rows, box_cols)
// with the 128-byte swizzle; false if the driver refuses it (a base not
// 16-byte aligned, a row not a multiple of 16 bytes).
template <typename T>
bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols,
                int box_rows, int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, Tc<T>::kType, 2, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs of the tensor-core form the card holds at once (once per dtype,
// with the kernel's shared memory set up), or 0 on an error: the persistent
// grid is that many, or one a tile where there are fewer tiles.
template <typename T, int R>
int resident_ctas() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(lora_tc_kernel<T, R>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmem<T>) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, lora_tc_kernel<T, R>, kTcThreads, kTcSmem<T>) !=
            cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    n = sms * per_sm;
  }
  return n;
}

template <typename T, int R>
int launch_tc(const void* x, const void* w, const void* a, const void* b,
              void* out, int M, int K, int N, int r, float scale,
              cudaStream_t stream) {
  // the form's terms (tsue_tpu_torch/ops/lora.py:lora_matmul_plan): rows
  // of x and W multiples of 16 bytes, bases 16-byte aligned
  if ((K * sizeof(T)) % 16 || (N * sizeof(T)) % 16 ||
      (uintptr_t)x % 16 || (uintptr_t)w % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!tensor_map<T>(&tx, x, M, K, kTM, Tc<T>::kK) ||
      !tensor_map<T>(&tw, w, K, N, Tc<T>::kK, Tc<T>::kBoxN))
    return (int)cudaErrorInvalidValue;
  const int resident = resident_ctas<T, R>();
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (N + kTN - 1) / kTN * ((M + kTM - 1) / kTM);
  lora_tc_kernel<T, R><<<tiles < resident ? tiles : resident, kTcThreads,
                      kTcSmem<T>, stream>>>(
      tx, tw, static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<T*>(out), M, K, N, r, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* w, const void* a, const void* b,
           void* out, int M, int K, int N, int r, float scale, int form,
           cudaStream_t stream) {
  if (form == 0)
    return launch_simt<T>(x, w, a, b, out, M, K, N, r, scale, stream);
  if constexpr (sizeof(T) == 4) {
    if (form == 1 && r <= 8)
      return launch_tc<T, 8>(x, w, a, b, out, M, K, N, r, scale, stream);
  }
  if (form == 1)
    return launch_tc<T, 16>(x, w, a, b, out, M, K, N, r, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for a rank
// below 1, a rank above 16 in a tensor-core form, an unknown dtype or form,
// or a shape or base the form does not take.  x (M, K), w (K, N), a (K, r), b (r, N) and out (M, N),
// contiguous, all fp32 (dtype 0) or all bf16 (dtype 1).  form 0 is the SIMT
// form, form 1 the tensor-core form of the dtype (bf16 wgmma, fp32 3xTF32);
// the caller picks it (lora_matmul_plan), and no form stands in for another.
int lora_matmul(const void* x, const void* w, const void* a, const void* b,
                void* out, int M, int K, int N, int r, float scale, int dtype,
                int form, cudaStream_t stream) {
  if (r < 1 || (form != 0 && r > kMaxR)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(x, w, a, b, out, M, K, N, r, scale, form, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, a, b, out, M, K, N, r, scale, form,
                                 stream);
  return (int)cudaErrorInvalidValue;
}

// The CTAs that the tensor-core form of a dtype (0 fp32, 1 bf16) keeps on
// the card at once: its persistent grid is that many, or one a tile where
// there are fewer tiles.  Negative on an error.
int lora_matmul_ctas(int dtype) {
  const int n = dtype == 0 ? resident_ctas<float, 16>()
              : dtype == 1 ? resident_ctas<__nv_bfloat16, 16>() : 0;
  return n > 0 ? n : -1;
}

}  // extern "C"
