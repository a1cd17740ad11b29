// Weight-only int8 matrix product for decode: out = (x @ float(w8)) * scale.
//
// Replaces the Pallas kernel tsue_tpu/ops/quant.py:96 (_int8_kernel, launched
// by _int8_matmul_impl at :110).  x is (M, K) fp32 with few rows (the decode
// batch, M <= 128), w8 is (K, N) int8 stored row-major, scale (N,) fp32 is one
// scale per output column.  Both factors are fp32 with the weight dequantised
// to fp32, as the JAX package promotes (quant.py:91), and the scale is
// applied once to the finished dot product.
//
// What bounds it on an H100 (3.35 TB/s; 67 TFLOP/s fp32 on the CUDA cores):
// at M = 16 each weight byte feeds 16 multiply-adds, so in fp32 FMAs one
// decoder layer's seven products (60.8 MB of int8) need 29.0 us of
// arithmetic against 18.2 us of bytes, and an FMA kernel also pays for
// converting every weight and reading x for every FMA.  This kernel does
// the products on the tensor cores instead, exactly:
//   - an int8 weight is exact in bf16; x is split into three bf16 terms by
//     truncation, x = hi + mid + lo (8 significant bits each, 24 in all, so
//     the split is exact); every product of a term and a weight is exact in
//     fp32, and mma.sync.m16n8k16 (bf16 in, fp32 accumulate) adds them.  The
//     bound is then the weight stream's 18.2 us a layer;
//   - M = 16 is one m16 tile: a CTA owns 16 rows of x (grid.y covers M) and
//     CT = 256 or 128 columns; each of its 4 warps takes 16 of every stage's
//     64 K rows, so one set of x fragments (three terms) feeds all the
//     column tiles of the warp;
//   - weights reach shared memory through a 4-stage cp.async ring, 16-byte
//     copies with neighbouring threads on neighbouring columns (4-byte
//     copies when N % 16 != 0); a stage is 64 K rows (16 KB at CT = 256), so
//     three stages are in flight under the arithmetic of the fourth, and two
//     CTAs an SM keep ~96 KB in flight.  Rows are padded by 16 bytes so the
//     fragment reads below hit 32 distinct banks; rows past K and columns
//     past N are zero-filled;
//   - a thread's B fragment (k = 2q, 2q+1, 2q+8, 2q+9 of one column) sits in
//     four rows: it reads one 32-bit word of each, covering four columns,
//     and builds the four columns' fragments with byte permutes: each byte,
//     biased to b + 128, becomes the low mantissa byte of 2^23, one fp32
//     subtraction leaves b, and its upper half is b in bf16.  No conversion
//     unit is used (16 results a clock an SM).  So column tile j of a warp's
//     32-column group holds columns 4t + j, t = 0..7;
//   - the warps' partial tiles are added in warp order through the drained
//     ring; K is split across the CTAs of a thread block cluster (up to 8)
//     when the column tiles alone would leave SMs idle.  Each rank's partial
//     tile stays in its shared memory; after a cluster barrier each rank
//     adds a slice of the tile over all ranks in rank order through
//     distributed shared memory, applies the scale and writes the output.
//     One launch, no device-memory scratch, no atomics: a repeated call is
//     bit-identical.
// The plan (int8_matmul_plan) picks the column tile and the K split from the
// shape and from how many clusters the card can hold at once
// (cudaOccupancyMaxActiveClusters), so every wave is whole.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernel phase, L2 flushed,
// M = 16): one layer's seven products 0.132 ms (the split-K FMA kernel it
// replaces took 0.352; bytes bound 0.019), the int8 LM head 0.151 ms (0.716;
// bound 0.081).  About 5.5 us of each launch's time is the timer's own
// floor (chip_smoke.py prints it), so the four small products sit near
// their fixed costs.
//
// ptxas (nvcc -Xptxas -v, sm_90a), with the dynamic shared memory a launch
// asks for (the bf16 forms: either output type):
//   int8_matmul_kernel<8, float>  243 registers, no spills, 103.0 KB (2 CTAs
//                                 an SM)
//   int8_matmul_kernel<4, float>  219 registers, no spills,  62.5 KB
//   int8_matmul_kernel<8, bf16>   212 registers, no spills, 103.0 KB
//   int8_matmul_kernel<4, bf16>   146 registers, no spills,  62.5 KB
//
// The bf16 form (a bf16 model's decode: tsue_tpu/ops/quant.py:97-101 with
// x_ref bf16).  x is bf16; every product of an x value and an int8 weight is
// exact in fp32, so x is the one-term case of the split above: the same
// ring, fragments and tensor-core products with one term, x staged in shared
// memory as it lies (bf16), the sums fp32, the scale applied to the finished
// dot product and the result rounded once to the output type, bf16 (a
// projection) or fp32 (the LM head).  The plan is the fp32 form's: the same
// shared memory a CTA, so the same clusters fit.  On an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 14, L2 flushed, M = 16): one layer's seven
// products 0.113 ms (bytes bound 0.019), the LM head with an fp32 output
// 0.130 ms (bound 0.081); within one bf16 ulp of the plain version.
//
// C interface (loaded with ctypes by tsue_tpu_torch/ops/quant.py):
// int8_matmul_plan(M, K, N, field) reports the launch plan, and
// int8_matmul(...) returns cudaGetLastError() after the one launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 16;        // rows of x per CTA: one m16 tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKC = 16 * kWarps; // K rows per stage, 16 a warp
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kXS = kKC + 8;     // floats per staged row of x (padded)
constexpr int kMaxCluster = 8;   // portable cluster size

// A CTA of NG 32-column groups.
template <int NG>
struct Tile {
  static constexpr int CT = 32 * NG;               // columns per CTA
  static constexpr int WS = CT + 16;               // bytes per staged K row
  static constexpr int W_BYTES = kKC * WS;
  static constexpr int STAGE = W_BYTES + kRows * kXS * 4;
  static constexpr int RING = kStages * STAGE;
  static constexpr int RS = CT + 4;                // floats per reduced row
  static constexpr int SMEM = RING + (kRows + 1) * CT * 4;   // + tile, scale
  static_assert(kWarps * kRows * RS * 4 <= RING, "reduction fits the ring");
  // the bf16 form stages x rows of kXS bf16 in the fp32 form's x space:
  // 16-byte aligned rows for its 16-byte copies, 4-byte aligned fragments
  static_assert((kXS * 2) % 16 == 0 && kKC % 8 == 0, "bf16 x rows tile");
  static_assert(W_BYTES % 16 == 0 && STAGE % 16 == 0, "aligned x space");
};

// An fp32 value in out's type: itself, or rounded to bf16 (to nearest even).
template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>) return v;
  else return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>   // all but the newest N groups of this thread landed
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two fp32 values -> three bf16x2 terms (low half the first value), by
// truncation: a = hi + mid + lo exactly.
__device__ __forceinline__ void split3(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const uint32_t ha = __float_as_uint(a) & 0xffff0000u;
  const uint32_t hb = __float_as_uint(b) & 0xffff0000u;
  const float ra = a - __uint_as_float(ha), rb = b - __uint_as_float(hb);
  const uint32_t ma = __float_as_uint(ra) & 0xffff0000u;
  const uint32_t mb = __float_as_uint(rb) & 0xffff0000u;
  const float sa = ra - __uint_as_float(ma), sb = rb - __uint_as_float(mb);
  hi = __byte_perm(ha, hb, 0x7632);
  mid = __byte_perm(ma, mb, 0x7632);
  lo = __byte_perm(__float_as_uint(sa), __float_as_uint(sb), 0x7632);
}

// Byte j of a biased word (b + 128) -> b as fp32 bits, exactly: 2^23 + b +
// 128 minus 2^23 + 128.  Its upper half is b in bf16.
template <int J>
__device__ __forceinline__ uint32_t byte_f32(uint32_t u) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | J)) - 8388736.f);
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Column tile J of a 32-column group: B fragment of column 4g + J from the
// four biased rows, then the TERMS terms' products, smallest first.
template <int J, int TERMS>
__device__ __forceinline__ void tile(float* c, const uint32_t (&a)[3][4],
                                     const uint32_t (&r)[4]) {
  const uint32_t b0 = __byte_perm(byte_f32<J>(r[0]), byte_f32<J>(r[1]),
                                  0x7632);
  const uint32_t b1 = __byte_perm(byte_f32<J>(r[2]), byte_f32<J>(r[3]),
                                  0x7632);
#pragma unroll
  for (int t = TERMS - 1; t >= 0; --t) mma(c, a[t], b0, b1);
}

// XT: x's type (fp32: three bf16 terms; bf16: one), OT: out's type.
template <int NG, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads, 2)
int8_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w8,
                   const float* __restrict__ scale, OT* __restrict__ out,
                   int M, int K, int N, int k_per_rank) {
  using T = Tile<NG>;
  constexpr bool XB = std::is_same_v<XT, __nv_bfloat16>;
  constexpr int TERMS = XB ? 1 : 3;
  constexpr int XV = 16 / sizeof(XT);   // x elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / C) * T::CT, m0 = blockIdx.y * kRows;
  const int k_begin = min(K, rank * k_per_rank);
  const int k_end = min(K, k_begin + k_per_rank);
  const int nst = (k_end - k_begin + kKC - 1) / kKC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const bool w16 = N % 16 == 0;
  const bool x16 = K % XV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  auto load_stage = [&](int st) {
    unsigned char* ws = smem + (st % kStages) * T::STAGE;
    XT* xs = reinterpret_cast<XT*>(ws + T::W_BYTES);
    const int k0 = k_begin + st * kKC;
    if (w16) {
      constexpr int CPR = T::CT / 16;   // 16-byte chunks per K row
      for (int i = tid; i < kKC * CPR; i += kThreads) {
        const int r = i / CPR, c = (i % CPR) * 16;
        const bool ok = k0 + r < k_end && n0 + c < N;
        cp16(ws + r * T::WS + c, ok ? w8 + (size_t)(k0 + r) * N + n0 + c : w8,
             ok ? 16 : 0);
      }
    } else {
      constexpr int CPR = T::CT / 4;
      for (int i = tid; i < kKC * CPR; i += kThreads) {
        const int r = i / CPR, c = (i % CPR) * 4;
        const bool ok = k0 + r < k_end && n0 + c < N;
        cp4(ws + r * T::WS + c, ok ? w8 + (size_t)(k0 + r) * N + n0 + c : w8,
            ok ? 4 : 0);
      }
    }
    if (x16) {
      for (int i = tid; i < kRows * kKC / XV; i += kThreads) {
        const int r = i / (kKC / XV), c = (i % (kKC / XV)) * XV;
        const int k = k0 + c;
        const int bytes = m0 + r < M ? (int)sizeof(XT) *
                                           max(0, min(XV, k_end - k))
                                     : 0;
        cp16(xs + r * kXS + c, bytes ? x + (size_t)(m0 + r) * K + k : x,
             bytes);
      }
    } else if constexpr (XB) {   // no 2-byte cp.async: plain loads
      for (int i = tid; i < kRows * kKC; i += kThreads) {
        const int r = i / kKC, c = i % kKC;
        const bool ok = m0 + r < M && k0 + c < k_end;
        xs[r * kXS + c] = ok ? x[(size_t)(m0 + r) * K + k0 + c]
                             : __float2bfloat16_rn(0.f);
      }
    } else {
      for (int i = tid; i < kRows * kKC; i += kThreads) {
        const int r = i / kKC, c = i % kKC;
        const bool ok = m0 + r < M && k0 + c < k_end;
        cp4(xs + r * kXS + c, ok ? x + (size_t)(m0 + r) * K + k0 + c : x,
            ok ? 4 : 0);
      }
    }
  };

  float acc[NG][4][4];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  // the CTA's scales ride with the first stage, so the epilogue reads them
  // from shared memory
  float* sc = reinterpret_cast<float*>(smem + T::RING) + kRows * T::CT;
  for (int i = tid * 4; i < T::CT; i += 4 * kThreads) {
    const int bytes = 4 * max(0, min(4, N - n0 - i));
    cp16(sc + i, bytes ? scale + n0 + i : scale, bytes);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nst) load_stage(st);
    cp_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_wait<kStages - 2>();
    __syncthreads();   // stage st landed; the slot of st - 1 is free
    if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
    cp_commit();
    const unsigned char* ws = smem + (st % kStages) * T::STAGE;
    // this warp's 16 K rows: x fragments, TERMS terms
    const int kw = warp * 16;
    uint32_t a[3][4];
    if constexpr (XB) {   // bf16 pairs as they lie
      const XT* xs = reinterpret_cast<const XT*>(ws + T::W_BYTES);
      const XT* x0 = xs + g * kXS + kw + 2 * q;
      const XT* x1 = x0 + 8 * kXS;
      a[0][0] = *reinterpret_cast<const uint32_t*>(x0);
      a[0][1] = *reinterpret_cast<const uint32_t*>(x1);
      a[0][2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
      a[0][3] = *reinterpret_cast<const uint32_t*>(x1 + 8);
    } else {
      const float* xs = reinterpret_cast<const float*>(ws + T::W_BYTES);
      const float* x0 = xs + g * kXS + kw + 2 * q;
      const float* x1 = x0 + 8 * kXS;
      const float2 v0 = *reinterpret_cast<const float2*>(x0);
      const float2 v1 = *reinterpret_cast<const float2*>(x1);
      const float2 v2 = *reinterpret_cast<const float2*>(x0 + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(x1 + 8);
      split3(v0.x, v0.y, a[0][0], a[1][0], a[2][0]);
      split3(v1.x, v1.y, a[0][1], a[1][1], a[2][1]);
      split3(v2.x, v2.y, a[0][2], a[1][2], a[2][2]);
      split3(v3.x, v3.y, a[0][3], a[1][3], a[2][3]);
    }
    const unsigned char* wr = ws + (kw + 2 * q) * T::WS + 4 * g;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      uint32_t r[4];
      r[0] = *reinterpret_cast<const uint32_t*>(wr + 32 * i) ^ 0x80808080u;
      r[1] = *reinterpret_cast<const uint32_t*>(wr + T::WS + 32 * i) ^
             0x80808080u;
      r[2] = *reinterpret_cast<const uint32_t*>(wr + 8 * T::WS + 32 * i) ^
             0x80808080u;
      r[3] = *reinterpret_cast<const uint32_t*>(wr + 9 * T::WS + 32 * i) ^
             0x80808080u;
      tile<0, TERMS>(acc[i][0], a, r);
      tile<1, TERMS>(acc[i][1], a, r);
      tile<2, TERMS>(acc[i][2], a, r);
      tile<3, TERMS>(acc[i][3], a, r);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the warps' partial tiles, added in warp order through the drained ring:
  // tile j's (row g, column t) is column 32 i + 4 t + j, so a thread's c0 of
  // tiles 0..3 are columns 32 i + 8 q + 0..3 and its c1 columns + 4..7
  float* red = reinterpret_cast<float*>(smem);            // [warp][row][RS]
  float* fin = reinterpret_cast<float*>(smem + T::RING);  // [row][CT]
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    float* r0 = red + (warp * kRows + g) * T::RS + 32 * i + 8 * q;
    float* r1 = r0 + 8 * T::RS;
    *reinterpret_cast<float4*>(r0) = make_float4(
        acc[i][0][0], acc[i][1][0], acc[i][2][0], acc[i][3][0]);
    *reinterpret_cast<float4*>(r0 + 4) = make_float4(
        acc[i][0][1], acc[i][1][1], acc[i][2][1], acc[i][3][1]);
    *reinterpret_cast<float4*>(r1) = make_float4(
        acc[i][0][2], acc[i][1][2], acc[i][2][2], acc[i][3][2]);
    *reinterpret_cast<float4*>(r1 + 4) = make_float4(
        acc[i][0][3], acc[i][1][3], acc[i][2][3], acc[i][3][3]);
  }
  __syncthreads();
  for (int e = tid; e < kRows * T::CT; e += kThreads) {
    const int off = (e / T::CT) * T::RS + e % T::CT;
    float s = red[off];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * kRows * T::RS + off];
    fin[e] = s;
  }

  // the cluster's ranks added in rank order: rank r finishes a slice
  cluster.sync();
  const int total = min(kRows, M - m0) * T::CT;
  for (int e = rank * kThreads + tid; e < total; e += C * kThreads) {
    const int n = n0 + e % T::CT;
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)   // all loads in flight at once
      v[r] = r < C ? cluster.map_shared_rank(fin, r)[e] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) s += v[r];
    if (n < N)
      out[(size_t)(m0 + e / T::CT) * N + n] =
          from_f32<OT>(s * sc[e % T::CT]);
  }
  cluster.sync();   // no rank leaves while another reads its tile
}

// The kernels, by 32-column groups a CTA.  The plan is made for the fp32
// form; the other forms ask for the same shared memory.
constexpr int kGroups[] = {8, 4};
constexpr int kConfigs = 2;
typedef __nv_bfloat16 bf16;

const void* kernel_of(int cfg) {
  return cfg == 0 ? reinterpret_cast<const void*>(
                        &int8_matmul_kernel<8, float, float>)
                  : reinterpret_cast<const void*>(
                        &int8_matmul_kernel<4, float, float>);
}
int smem_of(int cfg) { return cfg == 0 ? Tile<8>::SMEM : Tile<4>::SMEM; }

// The shared-memory limit of one form's kernel, set at its first launch.
template <int NG, typename XT, typename OT>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_kernel<NG, XT, OT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<NG>::SMEM);
  done = err == cudaSuccess;
  return err;
}

// Clusters of c CTAs of a kernel that the card holds at once (its GPCs
// decide); asked once and kept.  0 when CUDA cannot say.
int resident_clusters(int cfg, int c) {
  static int cache[kConfigs][kMaxCluster + 1] = {};
  static bool set_up = false;
  if (!set_up) {
    for (int k = 0; k < kConfigs; ++k)
      if (cudaFuncSetAttribute(kernel_of(k),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_of(k)) != cudaSuccess)
        return 0;
    set_up = true;
  }
  if (cache[cfg][c] == 0) {
    cudaLaunchConfig_t lc = {};
    lc.gridDim = dim3((unsigned)c, 1, 1);
    lc.blockDim = dim3(kThreads, 1, 1);
    lc.dynamicSmemBytes = (size_t)smem_of(cfg);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    lc.attrs = attr;
    lc.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, kernel_of(cfg), &lc) !=
            cudaSuccess || n < 1) {
      cudaGetLastError();
      return 0;
    }
    cache[cfg][c] = n;
  }
  return cache[cfg][c];
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

struct Plan {
  int cfg, cluster, ctas, k_per_rank;
};

// The plan with the least modelled time.  A wave holds as many clusters as
// the card can place, and it takes (CTAs on the busiest SM) x (weights a
// CTA streams).  K is split over c ranks (a cluster) to give idle SMs work;
// every rank but the last gets whole stages.
Plan make_plan(int M, int K, int N) {
  const int R = (M + kRows - 1) / kRows;
  const int sms = sm_count();
  const int blocks = (K + kKC - 1) / kKC;
  Plan best = {0, 0, 0, 0};
  double best_t = 0.0;
  for (int cfg = 0; cfg < kConfigs; ++cfg) {
    const int ct = 32 * kGroups[cfg];
    const int tiles = (N + ct - 1) / ct * R;
    for (int c = 1; c <= kMaxCluster; ++c) {
      if (c > 1 && c > blocks) break;
      const int cap = resident_clusters(cfg, c);
      if (cap < 1 || sms < 1) continue;
      const int per = (blocks + c - 1) / c * kKC;
      const long waves = (tiles + cap - 1) / cap;
      const long in_wave = (long)(tiles < cap ? tiles : cap) * c;
      const long per_sm = (in_wave + sms - 1) / sms;
      const double t = (double)waves * per_sm * ct * (per > 0 ? per : 1);
      if (best.cluster == 0 || t < best_t) {
        best = {cfg, c, tiles * c, per};
        best_t = t;
      }
    }
  }
  return best;
}

template <int NG, typename XT, typename OT>
int launch(const Plan& p, const void* x, const int8_t* w8,
           const float* scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  const cudaError_t set = configure<NG, XT, OT>();
  if (set != cudaSuccess) return static_cast<int>(set);
  const int R = (M + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.ctas / R), (unsigned)R, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Tile<NG>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_matmul_kernel<NG, XT, OT>, static_cast<const XT*>(x), w8,
      scale, static_cast<OT*>(out), M, K, N, p.k_per_rank);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int launch_form(const Plan& p, const void* x, const int8_t* w8,
                const float* scale, void* out, int M, int K, int N,
                cudaStream_t stream) {
  return p.cfg == 0
             ? launch<8, XT, OT>(p, x, w8, scale, out, M, K, N, stream)
             : launch<4, XT, OT>(p, x, w8, scale, out, M, K, N, stream);
}

}  // namespace

extern "C" {

// The launch plan of an (M, K, N) product: field 0 the cluster size (the K
// split), 1 the CTAs, 2 the columns a CTA, 3 the K rows a rank; -1 for
// another field, -2 when CUDA could not place the kernel.
int int8_matmul_plan(int M, int K, int N, int field) {
  const Plan p = make_plan(M, K, N);
  if (p.cluster == 0) return -2;
  switch (field) {
    case 0: return p.cluster;
    case 1: return p.ctas;
    case 2: return 32 * kGroups[p.cfg];
    case 3: return p.k_per_rank;
    default: return -1;
  }
}

// Returns a cudaError_t (0 on success), -2 when CUDA could not place the
// kernel, -1 for a form it does not have.  x (M, K) fp32 (x_bf16 = 0) or
// bf16 (x_bf16 = 1) with 1 <= M <= 128, w8 (K, N) int8 with N % 4 == 0 and
// a 16-byte aligned base, scale (N,) fp32, out (M, N) fp32 (out_bf16 = 0)
// or bf16 (out_bf16 = 1, bf16 x only).
int int8_matmul(const void* x, const int8_t* w8, const float* scale,
                void* out, int M, int K, int N, int x_bf16, int out_bf16,
                cudaStream_t stream) {
  const Plan p = make_plan(M, K, N);
  if (p.cluster == 0) return -2;
  if (!x_bf16)
    return out_bf16 ? -1
                    : launch_form<float, float>(p, x, w8, scale, out, M, K,
                                                N, stream);
  return out_bf16
             ? launch_form<bf16, bf16>(p, x, w8, scale, out, M, K, N, stream)
             : launch_form<bf16, float>(p, x, w8, scale, out, M, K, N,
                                        stream);
}

}  // extern "C"
