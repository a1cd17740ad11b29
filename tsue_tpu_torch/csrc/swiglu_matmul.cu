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
// The bf16 form ("bf16_wgmma", swiglu_matmul_bf16): g, u, W and out bf16,
// the Pallas kernel's function in those dtypes (fused.py:176-191): silu in
// fp32 rounded to bf16, times u rounded to bf16 (h), then h @ W on the bf16
// tensor cores with fp32 sums, the output rounded to bf16.
//   - bound on an H100 at the training shape: 283.5 GFLOP at 989 TFLOP/s =
//     0.287 ms (bytes 0.104 ms);
//   - the fp32 form's shape: a persistent grid of 384-thread CTAs, 128 x
//     256 output tiles, two consumer warpgroups of 64 rows (setmaxnreg),
//     h formed in registers as the A fragment of m64n256k16 bf16 wgmmas
//     with A from registers, 128 fp32 sums a thread;
//   - W needs no pre-pass: 16-bit wgmma takes an MN-major (transposed) B
//     from shared memory, so W's rows land as they lie, four TMA boxes of
//     64 columns a stage, read through sw128_mn_desc (its own offsets, not
//     sw128_desc's);
//   - two TMA rings, each kept full by one producer thread: g and u (64 K
//     positions, 32 KB a stage, three deep) and W (32 KB a stage, four
//     deep).  A g and u stage goes back as soon as h is formed, a W stage
//     once its products are done: with one ring of 64 KB stages (three
//     deep) a stage was held through the next stage's activation;
//   - stage s + 1's activation overlaps stage s's asynchronous wgmmas
//     (two fragment buffers, wgmma.wait_group 1);
//   - where its time goes (swiglu_variants.py --dtype bfloat16): the copies
//     alone take most of it (the g and u tiles are read 8 times over at N =
//     2048, W 66 times, ~4.4 GB from L2), then the products, then the
//     activation, formed 8 times over (silu by the hardware exp and
//     reciprocal: one rounding to bf16 follows);
//   - the tensor cores sum all of K in fp32 accumulators, no promotion:
//     at the training shape the outputs keep the plain version's bits and
//     its share of the tolerance against an fp64 product (chip_smoke.py's
//     bf16 row), against a bf16 tolerance of 2^-7;
//   - K is walked in one fixed order by one CTA: a repeated call is
//     bit-identical.  M and N tails are TMA's zero fill and masked stores;
//     a W box wholly past N is not loaded; K % 128 == 0, N % 8 == 0,
//     16-byte aligned bases;
//   - on an H100 80GB HBM3 at 700 W at the training shape: 0.608-0.611 ms
//     (the earlier mma.sync form 1.457-1.471, the plain version 1.019,
//     cuBLAS's bf16 h @ w alone 0.349); alone, the copies take 0.541, the
//     products 0.325, the copies and products without the activation
//     0.501 (swiglu_variants.py --dtype bfloat16).  A 2-CTA cluster
//     sharing g and u by TMA multicast was right but slower on the card,
//     as was the same schedule launched in clusters without multicast;
//   - ptxas (sm_90a, CUDA 12.8): swiglu_bf16_kernel 168 registers a thread
//     at launch (setmaxnreg: 40 producer, 232 consumer), no spills, 112
//     bytes of static shared memory (the mbarriers) and 230,400 dynamic
//     (the two rings).
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
constexpr int kBK = 64;             // K positions a stage: one 128-byte row
constexpr int kGStages = 3;         // the g and u ring's depth
constexpr int kWStages = 4;         // the W ring's depth
constexpr int kBRowBytes = kBK * 2;           // a g or u tile's row
constexpr int kBGBytes = kTM * kBRowBytes;    // the g tile (and the u tile)
constexpr int kWBoxN = 64;          // W columns a TMA box: one 128-byte row
constexpr int kWRowBytes = kWBoxN * 2;
constexpr int kWBoxBytes = kBK * kWRowBytes;  // kBK rows of W, 64 columns
constexpr int kWBoxes = kTN / kWBoxN;
constexpr int kGStageBytes = 2 * kBGBytes;           // g, then u
constexpr int kWStageBytes = kWBoxes * kWBoxBytes;   // W's four boxes
constexpr int kBSmem = kGStages * kGStageBytes + kWStages * kWStageBytes +
                       1024;                          // + alignment
static_assert(kBRowBytes == 128 && kWRowBytes == 128,
              "a TMA box row is one 128-byte swizzle row");
static_assert(kBGBytes % 1024 == 0 && kWBoxBytes % 1024 == 0 &&
                  kGStageBytes % 1024 == 0 && kWStageBytes % 1024 == 0,
              "every tile and W box of a stage starts on a 1024-byte atom");
static_assert(16 * kWRowBytes % 1024 == 0,
              "a k16 step of W starts on a 1024-byte atom");
static_assert((kWBoxBytes >> 4) < (1 << 14) && (1024 >> 4) < (1 << 14),
              "the descriptor's byte offsets are 14-bit fields of 16 bytes");
static_assert(kBSmem <= 232448, "the ring must fit in a block's shared memory");
static_assert(kTN == 256 && kTN % kWBoxN == 0,
              "a warpgroup's products are one m64n256 wgmma wide");

// A wgmma descriptor of a 128-byte-swizzled MN-major (transposed) 16-bit B
// operand: W's rows as they lie, K rows of 64 columns a box.  Unlike
// sw128_desc's K-major operand both offsets count: the leading byte offset
// steps from one 64-column box to the next along N (kWBoxBytes), the stride
// byte offset from one 8-row group of K to the next (8 x 128 bytes).
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(kWBoxBytes >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

// D (64 x 256, fp32) = A (64 x 16, bf16, registers) * B (16 x 256, bf16,
// shared memory, MN-major: the last immediate, imm-trans-b, is 1) + (acc ?
// D : 0).  A's fragment, per warp w of the warpgroup and lane l (g = l / 4,
// t = l % 4), two bf16 a register: a[0] (row 16w + g, k 2t, 2t + 1), a[1]
// (row + 8, k 2t ..), a[2] (row, k 2t + 8 ..), a[3] (row + 8, k 2t + 8 ..).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

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

// A consumer warp is done with the stage of k step g of a bf16 ring of
// `stages` (see release).
template <int stages>
__device__ __forceinline__ void release_bf16(uint64_t* empty, int g,
                                             int total, int lane) {
  __syncwarp();
  if (g + stages < total && lane == 0) mbar_arrive(&empty[g % stages]);
}

// The consumers of the bf16 form: warpgroup wg owns output rows wg * 64 ..
// + 64 of the tile and all kTN columns, 128 fp32 sums a thread.  Thread
// (warp w, lane l) forms h at tile rows r = wg * 64 + 16 w + l / 4 and r +
// 8, K pairs 2 (l % 4) (+ 8) of each k16 step, straight from the ring's g
// and u (row r holds 16-byte chunk c at chunk c ^ (r % 8), r % 8 = l / 4):
// a bf16 wgmma A fragment.  The g and u stage goes back to the producer
// as soon as h is formed, the W stage once its products are done.  Steps
// alternate between two fragment buffers, so step s + 1's activation runs
// while step s's products are in flight (wgmma.wait_group 1).  The tensor
// cores sum all of K in the accumulators (no promotion: see the note atop
// the file).
__device__ __forceinline__ void consume_bf16(uint8_t* gring, uint8_t* wring,
                                             uint64_t* full_g,
                                             uint64_t* empty_g,
                                             uint64_t* full_w,
                                             uint64_t* empty_w, bf16* out,
                                             int M, int N, const Work& wk) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int warp = (tid >> 5) & 3, g8 = lane >> 2, t = lane & 3;
  const int rl = wg * 64 + warp * 16 + g8;
  const int a_off = rl * kBRowBytes + t * 4;
  float acc[kTN / 2];
  uint32_t a[2][kBK / 16][4];
  int gk = 0;
  for (int tile = wk.cta; tile < wk.tiles; tile += wk.ctas) {
    const int m0 = wk.m0(tile), n0 = wk.n0(tile);
    for (int kt = 0; kt < wk.nk; kt += 2) {   // nk is even (K % 128 == 0)
#pragma unroll
      for (int b = 0; b < 2; ++b, ++gk) {
        const int s = gk % kGStages;
        mbar_wait(&full_g[s], (gk / kGStages) & 1);
        const uint8_t* st = gring + s * kGStageBytes;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int off = a_off + (e & 1) * 8 * kBRowBytes +
                            (((2 * kk + (e >> 1)) ^ g8) << 4);
            a[b][kk][e] = swiglu2(
                *reinterpret_cast<const uint32_t*>(st + off),
                *reinterpret_cast<const uint32_t*>(st + kBGBytes + off));
          }
        }
        release_bf16<kGStages>(empty_g, gk, wk.total, lane);
        const int sw = gk % kWStages;
        mbar_wait(&full_w[sw], (gk / kWStages) & 1);
        const uint32_t wb = smem_u32(wring + sw * kWStageBytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_bf16_rs(acc, a[b][kk], sw128_mn_desc(wb + kk * 16 * kWRowBytes),
                        kt + b + kk > 0);
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's products are done
        if (kt + b > 0) release_bf16<kWStages>(empty_w, gk - 1, wk.total, lane);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release_bf16<kWStages>(empty_w, gk - 1, wk.total, lane);

    // sums (n8 block j, e) of a thread: row rl + 8 (e / 2), column 8j +
    // 2t + e % 2; N % 8 == 0, so a pair of columns is in or out whole
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
      const int col = n0 + j * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + rl + 8 * h;
        if (row < M)
          *reinterpret_cast<bf162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(acc[j * 4 + 2 * h], acc[j * 4 + 2 * h + 1]);
      }
    }
  }
}

// The bf16 form's persistent kernel, shaped as swiglu_tc_kernel, with two
// TMA rings (128-byte swizzle): g and u, 64 K positions of 128 rows each a
// stage (32 KB, kGStages deep), and W as it lies, 64 K rows of 256 columns
// in four boxes of 64 a stage (32 KB, kWStages deep).  One thread of the
// producer warpgroup keeps each ring full; the two consumer warpgroups form
// h in registers and run the products.  A W box wholly past N is not
// loaded (its columns are never stored).
__global__ void __launch_bounds__(kThreads, 1)
swiglu_bf16_kernel(const __grid_constant__ CUtensorMap tg,
                   const __grid_constant__ CUtensorMap tu,
                   const __grid_constant__ CUtensorMap tw,
                   bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_g[kGStages], empty_g[kGStages];
  __shared__ __align__(8) uint64_t full_w[kWStages], empty_w[kWStages];
  uint8_t* gring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* wring = gring + kGStages * kGStageBytes;
  const int tid = threadIdx.x;
  Work wk;
  wk.cta = blockIdx.x;
  wk.ctas = gridDim.x;
  wk.tiles_n = (N + kTN - 1) / kTN;
  wk.tiles = wk.tiles_n * ((M + kTM - 1) / kTM);
  wk.nk = K / kBK;
  wk.total = (wk.tiles - wk.cta + wk.ctas - 1) / wk.ctas * wk.nk;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(&full_g[s], 1);                 // the byte count
      mbar_init(&empty_g[s], kConsumers / 32);  // each consumer warp
    }
#pragma unroll
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full_w[s], 1);
      mbar_init(&empty_w[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {            // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kConsumers) {          // warp 8: the g and u ring
      for (int g = 0; g < wk.total; ++g) {
        const int s = g % kGStages;
        mbar_wait(&empty_g[s], ((g / kGStages) & 1) ^ 1);
        const int tile = wk.cta + g / wk.nk * wk.ctas;
        const int m0 = wk.m0(tile), k0 = g % wk.nk * kBK;
        uint8_t* st = gring + s * kGStageBytes;
        mbar_arrive_tx(&full_g[s], kGStageBytes);
        tma_load(st, &tg, k0, m0, &full_g[s]);
        tma_load(st + kBGBytes, &tu, k0, m0, &full_g[s]);
      }
    } else if (tid == kConsumers + 32) {   // warp 9: the W ring
      for (int g = 0; g < wk.total; ++g) {
        const int s = g % kWStages;
        mbar_wait(&empty_w[s], ((g / kWStages) & 1) ^ 1);
        const int tile = wk.cta + g / wk.nk * wk.ctas;
        const int n0 = wk.n0(tile), k0 = g % wk.nk * kBK;
        const int boxes = min(kWBoxes, (N - n0 + kWBoxN - 1) / kWBoxN);
        uint8_t* st = wring + s * kWStageBytes;
        mbar_arrive_tx(&full_w[s], boxes * kWBoxBytes);
        for (int i = 0; i < boxes; ++i)
          tma_load(st + i * kWBoxBytes, &tw, n0 + i * kWBoxN, k0, &full_w[s]);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  consume_bf16(gring, wring, full_g, empty_g, full_w, empty_w, out, M, N, wk);
}

// A row-major bf16 (rows, cols) tensor as TMA boxes of box_rows x 64
// columns with the 128-byte swizzle; false if cuTensorMapEncodeTiled
// refuses it.
bool tensor_map_bf16(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// CTAs of `kernel` the card holds at once with `smem` bytes of dynamic
// shared memory (set up here), or 0 on an error.
int occupancy_ctas(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return sms * per_sm;
}

int resident_ctas_bf16() {
  static int n = 0;
  if (n == 0) n = occupancy_ctas((const void*)swiglu_bf16_kernel, kBSmem);
  return n;
}

int resident_ctas() {
  static int n = 0;
  if (n == 0) n = occupancy_ctas((const void*)swiglu_tc_kernel, kSmem);
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
// and 16-byte aligned, with M, N > 0, K % 128 == 0 and N % 8 == 0; one
// launch of the persistent bf16 kernel.  Returns a cudaError_t, or
// cudaErrorInvalidValue for a shape or base it does not take.
int swiglu_matmul_bf16(const void* g, const void* u, const void* w,
                       void* out, int M, int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % (2 * kBK) || N % 8 ||
      (uintptr_t)g % 16 || (uintptr_t)u % 16 || (uintptr_t)w % 16 ||
      (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tg, tu, tw;
  if (!tensor_map_bf16(&tg, g, M, K, kTM) ||
      !tensor_map_bf16(&tu, u, M, K, kTM) ||
      !tensor_map_bf16(&tw, w, K, N, kBK))
    return (int)cudaErrorInvalidValue;
  const int resident = resident_ctas_bf16();
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const int tiles = (N + kTN - 1) / kTN * ((M + kTM - 1) / kTM);
  swiglu_bf16_kernel<<<tiles < resident ? tiles : resident, kThreads, kBSmem,
                       stream>>>(tg, tu, tw, static_cast<bf16*>(out), M, K, N);
  return (int)cudaGetLastError();
}

// The CTAs the product keeps on the card at once: its persistent grid is
// that many, or one a tile where there are fewer tiles.  Negative on an
// error.
int swiglu_matmul_ctas() {
  const int n = resident_ctas();
  return n > 0 ? n : -1;
}

// The same for the bf16 form's persistent grid.
int swiglu_matmul_bf16_ctas() {
  const int n = resident_ctas_bf16();
  return n > 0 ? n : -1;
}

}  // extern "C"
