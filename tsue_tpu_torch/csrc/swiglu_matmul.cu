// The Llama MLP's down-projection with its activation fused in:
//   out = (silu(g) * u) @ W,   silu(g) = g / (1 + expf(-g))
// without ever writing the (M, K) product h = silu(g) * u to memory.
//
// Replaces the Pallas kernel tsue_tpu/ops/fused.py:176 (_swiglu_kernel,
// launched by _swiglu_fwd_impl at :194 through pl.pallas_call at :207).  g
// and u are (M, K) fp32, W is (K, N) fp32, out (M, N) fp32.  The activation
// takes expf, not __expf, as PyTorch's silu on the card, and divides by the
// hardware reciprocal (2 ulp).
//
// What bounds it on an H100: at the training shapes (M = 16 * 528 = 8448,
// K = 8192, N = 2048) the product is 2 * M * N * K = 283.5 GFLOP on 0.69 GB
// of operands.  In fp32 it runs on the tensor cores as three TF32 products
// (3xTF32: each factor split into big, its tf32 bits, and small, the exact
// rest; small * big + big * small + big * big, small * small dropped), so
// the TF32 rate bounds it: 3 * 283.5 / 495 TFLOP/s = 1.718 ms (fp32 FMAs on
// the CUDA cores: 4.231 ms; bytes: 0.206 ms).
//
// Design (one form; ops/fused.py:swiglu_matmul_plan names it, "tf32x3"):
//   - tf32 wgmma takes a shared-memory operand only K-major, and W is
//     N-major.  A pre-pass kernel, launched by the same entry point, writes
//     W^T's big and small halves once a call into a (2, N, K) scratch (W
//     is an input, not the intermediate the fusion keeps on chip);
//   - the product is a persistent grid, one CTA of 384 threads per SM, each
//     walking 128 x 256 output tiles: tiles cta, cta + ctas, ..., column
//     tiles fastest, so the CTAs at work at one time share row blocks of g
//     and u (8 column tiles a row block) and all of W's column blocks in L2,
//     and move through K roughly in step;
//   - one thread of the producer warpgroup keeps a 2-stage ring full by TMA
//     (128-byte swizzle): a stage is 32 K positions of g and u (128 x 32
//     each) and of W^T's halves (256 x 32 each), 96 KB; it runs into the
//     next tile's stages while the consumers finish a tile;
//   - two consumer warpgroups own 64 output rows each (128 fp32 sums a
//     thread; setmaxnreg moves the producer's registers to them).  Each
//     stage a thread reads its g and u values from the ring straight into
//     the register layout of a tf32 wgmma A fragment, forms h in registers,
//     splits it, and issues small * W_big, big * W_small and big * W_big
//     with A from registers: h exists only there;
//     (Forming h in the producer warpgroup's three idle warps instead, its
//     halves written back over g and u, was slower: they became the pole);
//   - the tensor cores' fp32 sums truncate: summed over K = 8192 in one
//     accumulator they drift to 2.7 times the tolerance (swiglu_variants.py,
//     no_promote).  So a stage's products run in two column chunks of 128
//     (m64n128k8), each summed from zero by the tensor cores and then added
//     to the thread's fp32 sums on the CUDA cores, rounded to nearest;
//   - the division is __fdividef: the IEEE division's slow-path branch kept
//     the activation from overlapping (swiglu_variants.py, ieee_div);
//   - K is walked in one fixed order by one CTA (no split-K, no atomics),
//     so a repeated call gives bit-identical results.  M and N tails are
//     TMA's zero fill (silu(0) * 0 = 0) and masked stores; K % 32 == 0 (the
//     wrapper asks K % 128 == 0, as the JAX package's dispatch does).
// ptxas (sm_90a, CUDA 12.8): swiglu_tc_kernel 168 registers a thread at
// launch (setmaxnreg: 40 producer, 232 consumer), no spills, 32 bytes of
// static shared memory (the mbarriers) and 197,632 dynamic (the ring);
// split_wt_kernel 18 registers, 4,224 bytes, no spills.
//
// The bf16 form ("bf16_mma", swiglu_matmul_bf16): g, u, W and out bf16, the
// Pallas kernel's function in those dtypes (fused.py:176-191): silu in fp32
// rounded to bf16, times u rounded to bf16 (h), then h @ W on the bf16
// tensor cores with fp32 sums, the output rounded to bf16.  A simple
// kernel: one CTA of 256 threads (8 warps, 2 x 4) a 128 x 256 output tile,
// K in steps of 32 through two shared-memory buffers (54 KB), the next
// step's g, u and W loaded into registers while the tensor cores run the
// current one.  The loading threads form h (16 elements each, two at a
// time) and store it row-major, an A fragment register one 32-bit load
// (rows padded to 40 elements: no bank conflicts); W's tile is stored as
// it lies, K-major rows of 256 columns padded to 264 (16-byte stores,
// conflict-free), and ldmatrix.trans turns it into B fragments, two n8
// tiles a call.  Each warp owns 64 x 64 outputs: 4 x 8 m16n8 tiles, 128
// fp32 sums a thread.  h is formed once per 256 output columns, 8 times
// over at N = 2048.  A first design with 128 x 128 tiles formed it twice
// as often, with an IEEE division, and stored W transposed through 16-way
// bank conflicts; on an H100 80GB HBM3 at 700 W it took 3.82 ms at the
// training shape, and 2.44 ms with the conflicts gone: the activation's
// instructions outnumbered the mma's.  K is walked in one fixed order: a repeated call is
// bit-identical.  M and N tails load zeros and are masked at the store; K %
// 32 == 0, N % 8 == 0, 16-byte aligned bases.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/fused.py.
#include <cuda.h>            // CUtensorMap and its enums (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 128;            // output rows of a CTA
constexpr int kTN = 256;            // output columns of a CTA
constexpr int kCN = 128;            // columns of a chunk of promoted sums
constexpr int kK = 32;              // K positions a stage
constexpr int kStages = 2;          // the ring's depth
constexpr int kConsumers = 256;     // two warpgroups of 64 output rows each
constexpr int kThreads = kConsumers + 128;    // and the producer warpgroup
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 384 x 168
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRowBytes = 128;      // one swizzled row: 32 fp32
constexpr int kGBytes = kTM * kRowBytes;      // the g tile (and the u tile)
constexpr int kWBytes = kTN * kRowBytes;      // a W^T half's tile
constexpr int kStageBytes = 2 * kGBytes + 2 * kWBytes;
constexpr int kSmem = kStages * kStageBytes + 1024;   // + alignment
// sw128_desc sets no base offset: a swizzled wgmma operand must start on a
// 1024-byte atom, or the tensor cores read chunk c of a row from another
// chunk
static_assert(kGBytes % 1024 == 0 && kWBytes % 1024 == 0 &&
                  kStageBytes % 1024 == 0,
              "every tile of a stage must start on a 1024-byte atom");
static_assert(kSmem <= 232448, "the ring must fit in a block's shared memory");
static_assert(kCN == 128 && kTN % kCN == 0 && kCN * kRowBytes % 1024 == 0,
              "a chunk is one m64n128 wgmma wide and starts on an atom");

constexpr int kT = 32;              // the pre-pass's 32 x 32 tiles

// fp32 -> (big, small) for the tensor cores: big keeps the 11 significant
// bits a tf32 operand holds (the rest masked off), small = x - big exactly,
// of which the mma uses the leading bits.  (Copied from lmhead_topk.cu.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// silu(g) * u: expf, not __expf; the division by the hardware reciprocal
// (__fdividef, within 2 ulp), which has no slow-path branch to stall on
__device__ __forceinline__ float swiglu(float g, float u) {
  return __fdividef(g, 1.0f + expf(-g)) * u;
}

// W (K, N) -> W^T's halves wb, ws (N, K), through a 32 x 32 tile in shared
// memory (a row padded by one float: no bank conflicts either way).
__global__ void __launch_bounds__(256)
split_wt_kernel(const float* __restrict__ w, uint32_t* __restrict__ wb,
                uint32_t* __restrict__ ws, int K, int N) {
  __shared__ float tile[kT][kT + 1];
  const int n0 = blockIdx.x * kT, k0 = blockIdx.y * kT;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int i = ty; i < kT; i += 8)
    tile[i][tx] = n0 + tx < N ? w[(size_t)(k0 + i) * N + n0 + tx] : 0.f;
  __syncthreads();
#pragma unroll
  for (int i = ty; i < kT; i += 8) {
    if (n0 + i >= N) break;
    uint32_t big, small;
    split_tf32(tile[tx][i], big, small);
    const size_t at = (size_t)(n0 + i) * K + k0 + tx;
    wb[at] = big;
    ws[at] = small;
  }
}

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

// A wgmma shared-memory descriptor of a 128-byte-swizzled K-major operand:
// sbo = 1024 bytes between 8-row groups (lbo unused).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(16 >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
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

// D (64 x 128, fp32) = A (64 x 8, tf32, registers) * B (8 x 128, tf32,
// shared memory, K-major) + (acc ? D : 0).  A's fragment, per warp w of the
// warpgroup and lane l (g = l / 4, t = l % 4): a[0] (row 16w + g, k t),
// a[1] (row + 8, k t), a[2] (row, k t + 4), a[3] (row + 8, k t + 4).
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The tiles of a CTA: tiles cta, cta + ctas, ..., column tiles fastest.
struct Work {
  int cta, ctas, tiles_n, tiles, nk, total;
  __device__ int m0(int tile) const { return tile / tiles_n * kTM; }
  __device__ int n0(int tile) const { return tile % tiles_n * kTN; }
};

// A consumer warp is done with the stage of this CTA's k step g (counted
// over all its tiles): one arrival on the stage's empty barrier.  Only for
// stages that a later k step refills (g + kStages < total).
__device__ __forceinline__ void release(uint64_t* empty, int g, int total,
                                        int lane) {
  __syncwarp();
  if (g + kStages < total && lane == 0) mbar_arrive(&empty[g % kStages]);
}

// The consumers: warpgroup wg owns output rows wg * 64 .. + 64 of the tile
// and all kTN columns.  Thread (warp w, lane l) of it forms h at tile rows
// r = wg * 64 + 16 w + l / 4 and r + 8, K positions l % 4 (+ 4) of each
// 8-deep step, straight from the ring's g and u: a wgmma A fragment.  Row
// r of a ring tile holds 16-byte chunk c at chunk c ^ (r % 8), and r % 8 =
// l / 4.  A stage's products run in kTN / kCN column chunks, each summed
// from zero by the tensor cores and then added to the thread's fp32 sums
// on the CUDA cores (rounded to nearest), in one fixed order.
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, float* out, int M,
                                        int N, const Work& wk) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g8 = lane >> 2, t = lane & 3;
  const int rl = wg * 64 + warp * 16 + g8;
  const int a_off = rl * kRowBytes + t * 4;
  float part[kCN / 2] = {};
  int gk = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    float sum[kTN / 2];
#pragma unroll
    for (int i = 0; i < kTN / 2; ++i) sum[i] = 0.f;
    for (int kt = 0; kt < wk.nk; ++kt, ++gk) {
      const int s = gk % kStages;
      mbar_wait(&full[s], (gk / kStages) & 1);
      const uint8_t* st = smem + s * kStageBytes;
      uint32_t ab[kK / 8][4], as[kK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int off = a_off + (e & 1) * 8 * kRowBytes +
                          (((2 * kk + (e >> 1)) ^ g8) << 4);
          const float gv = *reinterpret_cast<const float*>(st + off);
          const float uv =
              *reinterpret_cast<const float*>(st + kGBytes + off);
          split_tf32(swiglu(gv, uv), ab[kk][e], as[kk][e]);
        }
      }
      const uint32_t wb = smem_u32(st + 2 * kGBytes), ws = wb + kWBytes;
#pragma unroll
      for (int q = 0; q < kTN / kCN; ++q) {
        // chunk q: tile columns q * kCN .., rows of the W^T tiles
        const uint32_t cb = wb + q * kCN * kRowBytes;
        const uint32_t cs = ws + q * kCN * kRowBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kK / 8; ++kk) {
          wgmma_tf32_rs(part, as[kk], sw128_desc(cb + kk * 32), kk > 0);
          wgmma_tf32_rs(part, ab[kk], sw128_desc(cs + kk * 32), 1);
          wgmma_tf32_rs(part, ab[kk], sw128_desc(cb + kk * 32), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < kCN / 2; ++i) sum[q * kCN / 2 + i] += part[i];
      }
      release(empty, gk, wk.total, lane);
    }

    // sums (n8 block j, e) of a thread: row rl + 8 (e / 2), column 8j +
    // 2t + e % 2; N % 4 == 0, so a pair of columns is in or out whole
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
              make_float2(sum[j * 4 + 2 * h], sum[j * 4 + 2 * h + 1]);
      }
    }
  }
}

// A persistent kernel: each CTA walks its 128 x 256 output tiles (Work).
// One thread of the producer warpgroup keeps the ring full by TMA, running
// into the next tile's stages while the consumers finish a tile; the rest
// of the warpgroup only gives its registers to the consumers (setmaxnreg).
// Each k step passes two mbarriers a stage: full (the TMA bytes) and empty
// (see release).
__global__ void __launch_bounds__(kThreads, 1)
swiglu_tc_kernel(const __grid_constant__ CUtensorMap tg,
                 const __grid_constant__ CUtensorMap tu,
                 const __grid_constant__ CUtensorMap twb,
                 const __grid_constant__ CUtensorMap tws,
                 float* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  Work wk;
  wk.cta = blockIdx.x;
  wk.ctas = gridDim.x;
  wk.tiles_n = (N + kTN - 1) / kTN;
  wk.tiles = wk.tiles_n * ((M + kTM - 1) / kTM);
  wk.nk = K / kK;
  wk.total = (wk.tiles - wk.cta + wk.ctas - 1) / wk.ctas * wk.nk;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                 // the byte count
      mbar_init(&empty[s], kConsumers / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {
      for (int g = 0; g < wk.total; ++g) {
        const int s = g % kStages;
        mbar_wait(&empty[s], ((g / kStages) & 1) ^ 1);
        const int tile = wk.cta + g / wk.nk * wk.ctas;
        const int m0 = wk.m0(tile), n0 = wk.n0(tile), k0 = g % wk.nk * kK;
        uint8_t* st = smem + s * kStageBytes;
        mbar_arrive_tx(&full[s], kStageBytes);
        tma_load(st, &tg, k0, m0, &full[s]);
        tma_load(st + kGBytes, &tu, k0, m0, &full[s]);
        tma_load(st + 2 * kGBytes, &twb, k0, n0, &full[s]);
        tma_load(st + 2 * kGBytes + kWBytes, &tws, k0, n0, &full[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  consume(smem, full, empty, out, M, N, wk);
}

// ---- launch ---------------------------------------------------------------

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

// A row-major fp32 (rows, K) tensor as TMA boxes of box_rows x kK with the
// 128-byte swizzle; false if the driver refuses it (a base not 16-byte
// aligned, a row not a multiple of 16 bytes).
bool tensor_map(CUtensorMap* map, const void* base, int rows, int K,
                int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)kK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs the card holds at once (asked once, with the kernel's shared memory
// set up), or 0 on an error: the persistent grid is that many, or one a
// tile where there are fewer tiles.
int resident_ctas();

// ---- the bf16 form ---------------------------------------------------------

using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;
constexpr int kBM = 128, kBN = 256, kBK = 32;   // CTA tile, K a step
constexpr int kBThreads = 256;                   // 8 warps, 2 x 4
constexpr int kLd = kBK + 8;                     // padded h row (elements)
constexpr int kLdW = kBN + 8;                    // padded W row (elements)
constexpr int kHBuf = kBM * kLd, kWBuf = kBK * kLdW;   // elements a buffer
constexpr int kBSmem = 2 * (kHBuf + kWBuf) * 2;        // bytes, two buffers
static_assert(kLd % 8 == 0 && kLdW % 8 == 0 && kHBuf % 8 == 0,
              "16-byte stores and ldmatrix rows need 16-byte aligned rows");

// silu(g) in fp32 (the hardware exp and reciprocal: the value is rounded
// to bf16 next, which their 2-ulp fp32 error almost never moves), rounded
// to bf16, times u in bf16 (one rounding of the exact product)
__device__ __forceinline__ uint32_t swiglu2(uint32_t g2, uint32_t u2) {
  const float2 g = __bfloat1622float2(*reinterpret_cast<const bf162*>(&g2));
  const bf162 s = __floats2bfloat162_rn(__fdividef(g.x, 1.0f + __expf(-g.x)),
                                        __fdividef(g.y, 1.0f + __expf(-g.y)));
  const bf162 h = __hmul2(s, *reinterpret_cast<const bf162*>(&u2));
  return *reinterpret_cast<const uint32_t*>(&h);
}

__global__ void __launch_bounds__(kBThreads, 1)
swiglu_bf16_kernel(const bf16* __restrict__ g, const bf16* __restrict__ u,
                   const bf16* __restrict__ w, bf16* __restrict__ out, int M,
                   int K, int N) {
  extern __shared__ __align__(16) bf16 sm[];
  bf16* hs = sm;                    // [2][kBM][kLd]: h, row-major [m][k]
  bf16* ws = sm + 2 * kHBuf;        // [2][kBK][kLdW]: W, row-major [k][n]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 64;

  // loads of a step: g and u rows tid / 4 and + 64 (8 elements at
  // (tid % 4) * 8), W rows tid / 32 + 8 i (8 columns at (tid % 32) * 8)
  const int ar = tid >> 2, ak = (tid & 3) * 8;
  const int bk = tid >> 5, bn = (tid & 31) * 8;
  uint4 rg[2], ru[2], rw[4];
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + ar + 64 * i;
      const size_t at = (size_t)m * K + k0 + ak;
      rg[i] = m < M ? *reinterpret_cast<const uint4*>(g + at) : z4;
      ru[i] = m < M ? *reinterpret_cast<const uint4*>(u + at) : z4;
    }
    const int n = n0 + bn;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rw[i] = n < N ? *reinterpret_cast<const uint4*>(
                          w + (size_t)(k0 + bk + 8 * i) * N + n)
                    : z4;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 h;
      h.x = swiglu2(rg[i].x, ru[i].x);
      h.y = swiglu2(rg[i].y, ru[i].y);
      h.z = swiglu2(rg[i].z, ru[i].z);
      h.w = swiglu2(rg[i].w, ru[i].w);
      *reinterpret_cast<uint4*>(hs + buf * kHBuf + (ar + 64 * i) * kLd + ak) =
          h;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(ws + buf * kWBuf + (bk + 8 * i) * kLdW + bn) =
          rw[i];
  };

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int fr = lane >> 2, fc = (lane & 3) * 2;   // fragment row, column
  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
    const bf16* hb = hs + buf * kHBuf;
    const bf16* wb = ws + buf * kWBuf;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bf16* r0 = hb + (wm + 16 * i + fr) * kLd + kk + fc;
        const bf16* r1 = r0 + 8 * kLd;
        a[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[i][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
      }
      // B fragments of n8 tiles 2p and 2p + 1: lanes 0-15 address the 16 k
      // rows at the first tile's 8 columns, lanes 16-31 at the second's
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bf16* src =
            wb + (kk + (lane & 15)) * kLdW + wn + 16 * p + 8 * (lane >> 4);
        const uint32_t addr =
            static_cast<uint32_t>(__cvta_generic_to_shared(src));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0, %1, %2, %3}, [%4];\n"
            : "=r"(b[2 * p][0]), "=r"(b[2 * p][1]), "=r"(b[2 * p + 1][0]),
              "=r"(b[2 * p + 1][1])
            : "r"(addr));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+f"(acc[i][j][0]), "+f"(acc[i][j][1]), "+f"(acc[i][j][2]),
                "+f"(acc[i][j][3])
              : "r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]),
                "r"(b[j][0]), "r"(b[j][1]));
    }
    if (more) {
      // the other buffer was last read before the previous barrier
      store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * i + fr + 8 * h;
        const int n = n0 + wn + 8 * j + fc;
        if (m >= M || n >= N) continue;
        *reinterpret_cast<bf162*>(out + (size_t)m * N + n) =
            __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

int resident_ctas() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaFuncSetAttribute(swiglu_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem) != cudaSuccess ||
        cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, swiglu_tc_kernel, kThreads, kSmem) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    n = sms * per_sm;
  }
  return n;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success), or cudaErrorInvalidValue for a
// shape or base the kernel does not take.  g, u (M, K), w (K, N), wt (2, N,
// K: the scratch for W^T's halves) and out (M, N), all fp32, contiguous and
// 16-byte aligned, with M, N > 0, K % 32 == 0 and N % 4 == 0.  Two
// launches: the pre-pass, then the product.
int swiglu_matmul(const float* g, const float* u, const float* w, float* wt,
                  float* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kK || N % 4 ||
      (uintptr_t)g % 16 || (uintptr_t)u % 16 || (uintptr_t)wt % 16)
    return (int)cudaErrorInvalidValue;
  uint32_t* wb = reinterpret_cast<uint32_t*>(wt);
  uint32_t* ws = wb + (size_t)N * K;
  split_wt_kernel<<<dim3((N + kT - 1) / kT, K / kT), 256, 0, stream>>>(
      w, wb, ws, K, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tg, tu, twb, tws;
  if (!tensor_map(&tg, g, M, K, kTM) || !tensor_map(&tu, u, M, K, kTM) ||
      !tensor_map(&twb, wb, N, K, kTN) || !tensor_map(&tws, ws, N, K, kTN))
    return (int)cudaErrorInvalidValue;
  const int resident = resident_ctas();
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (N + kTN - 1) / kTN * ((M + kTM - 1) / kTM);
  swiglu_tc_kernel<<<tiles < resident ? tiles : resident, kThreads, kSmem,
                     stream>>>(tg, tu, twb, tws, out, M, K, N);
  return (int)cudaGetLastError();
}

// The bf16 form: g, u (M, K), w (K, N) and out (M, N), bf16, contiguous
// and 16-byte aligned, with M, N > 0, K % 32 == 0 and N % 8 == 0; one
// launch, one CTA a 128 x 256 output tile.  Returns a cudaError_t, or
// cudaErrorInvalidValue for a shape or base it does not take.
int swiglu_matmul_bf16(const void* g, const void* u, const void* w,
                       void* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % kBK || N % 8 ||
      (uintptr_t)g % 16 || (uintptr_t)u % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        swiglu_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  swiglu_bf16_kernel<<<grid, kBThreads, kBSmem, stream>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(u),
      static_cast<const bf16*>(w), static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// The CTAs the product keeps on the card at once: its persistent grid is
// that many, or one a tile where there are fewer tiles.  Negative on an
// error.
int swiglu_matmul_ctas() {
  const int n = resident_ctas();
  return n > 0 ? n : -1;
}

}  // extern "C"
