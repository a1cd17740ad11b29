// Fused LM head and exact top-128 of the processed logits.
//
// Replaces the Pallas kernel tsue_tpu/ops/lmhead_topk.py:133
// (_head_topk_kernel, launched for the tied fp32 (V, D) head at :243 and for
// the int8 (D, V) head at :289).  For each batch row b and vocab entry v:
//   logit = h[b] . w[v]               (tied head: w (V, D) fp32), or
//   logit = (h[b] . w8[:, v]) * scale[v]   (int8 head: w8 (D, V) int8)
//   if mask[b, v] & 1 and penalty != 1: logit = logit > 0 ? logit / penalty
//                                                         : logit * penalty
//   if mask[b, v] & 2: logit = -1e9
// and the output is the 128 largest processed logits of each row with their
// indices, ordered by (value desc, index asc): a stable descending sort of
// the processed logits, truncated to 128.  The (B, V) logits never reach
// device memory.
//
// This is a new design for the card, not a port of the TPU's 128-lane
// bitonic leaderboard.  Each (value, index) pair becomes one 64-bit key,
// (order-preserving bits of the value) << 32 | (0xFFFFFFFF - index), so the
// required order is plain descending order of the keys and ties need no
// second comparison.  One CTA per 1024-column vocab tile computes, for 16
// batch rows at a time, the tile's processed logits, writes their keys to
// shared memory, sorts each 128-key segment with a bitonic network and
// merges the 8 segments of a row down to the row's top 128 of the tile;
// head_merge (one CTA per batch row) then merges the per-tile lists, 127 at
// a time into a running top 128.  Merging two sorted lists keeps max(A[j],
// B[127 - j]) and re-sorts that bitonic sequence with 7 half-cleaner steps,
// so every step is a fixed network: the result does not depend on thread
// scheduling, and a repeated call is bit-identical.
//
// The two forms differ in how a tile's logits are computed.
//
// int8 head (head_tile_topk_i8; the form generation runs with int8
// weights).  What bounds it on an H100: the weight stream, 263 MB at D
// 2048, V 128256, over 3.35 TB/s = 0.079 ms, plus the 8.2 MB mask.  In
// fp32 FMAs on the CUDA cores its 4.2 G multiply-adds would need 0.125 ms,
// and each FMA group would also pay a conversion and a shared load, so the
// products run on the tensor cores,
// exactly, with the scheme of csrc/int8_matmul.cu (its helpers are copied
// below, not shared: the build cache keys on this one file):
//   - an int8 weight is exact in bf16, and h splits by truncation into three
//     bf16 terms of 8 significant bits each, h = hi + mid + lo exactly (24
//     bits in all).  Every product of a term and a weight is exact in fp32,
//     and mma.sync.m16n8k16 (bf16 in, fp32 accumulate) adds them.  The split
//     is exact for finite h; h is a decode hidden state, so it is finite.
//     On integer inputs every partial sum is an exact integer, so the keys
//     equal the plain version's bit for bit;
//   - the 16 batch rows of a pass are one m16 tile.  Each of the CTA's 16
//     warps owns 64 of the tile's columns (2 groups of 32, each 4 n8 tiles)
//     for all of D, so its 32 fp32 accumulators a thread hold finished dot
//     products: no reduction across warps, no scratch (four 256-column
//     sub-tiles with K split across warps would need a 48-64 KB reduction
//     buffer, which does not fit beside the keys);
//   - the weights reach shared memory through a cp.async ring of 16-byte
//     copies, neighbouring threads on neighbouring columns (4-byte copies
//     when V % 16 != 0).  A stage is 32 K rows (two k16 steps) of the
//     whole tile, 32 KB of weights and the 16 x 32 slice of h; rows are
//     padded by 16 bytes so the fragment reads hit 32 distinct banks; rows
//     past D and columns past V are zero-filled.  The keys are written only
//     after the last stage, so the ring shares their 128 KB: 3 stages, two
//     (70 KB) in flight under the arithmetic of the third.  One barrier a
//     stage; 16-row stages (7 in the 128 KB) were 3% slower;
//   - a thread's B fragment (k = 2q, 2q+1, 2q+8, 2q+9 of one column) sits in
//     four rows: it reads one 32-bit word of each, covering four columns,
//     and builds the four columns' fragments with byte permutes: each byte,
//     biased to b + 128, becomes the low mantissa byte of 2^23, one fp32
//     subtraction leaves b, and its upper half is b in bf16.  So n8 tile j
//     of a 32-column group holds columns 4t + j, t = 0..7;
//   - the epilogue applies scale, then the penalty and the ban in the plain
//     version's order, and writes the keys over the drained ring;
//   - 512 threads, not 256: the selection's networks run on the CTA's
//     threads and take about half as long with twice as many, while the
//     product keeps its time (64 columns a warp fit the 128 registers a
//     thread that 512 threads leave).
// B > 16 runs the tile once per group of 16 rows.  126 tiles at V 128256:
// one CTA an SM (128 KB of shared memory), one wave, one round of
// head_merge.  Tried on the card and slower (sources not kept): a producer
// warp feeding the ring through mbarriers, with cp.async or with bulk
// copies (TMA) of the 1 KB rows, instead of the block-wide barrier a stage.
// head_variants.py times the other shapes tried.
//
// fp32 tied head (head_tile_topk_tied<float>; the form generation runs with the
// fused head alone).  What bounds it: the weight stream, 1.05 GB of fp32
// (V, D) rows at D 2048, V 128256, over 3.35 TB/s = 0.316 ms.  The same
// shape as the int8 form (512 threads, 16 warps each owning 64 columns of
// the tile for all of D, 32 accumulators a thread, the ring in the keys'
// space), with:
//   - the products on the tensor cores in 3xTF32: each factor splits into
//     big (its leading 11 bits, the rest masked off) and small = x - big,
//     and mma.sync.m16n8k8 (tf32 in, fp32 accumulate) adds small.big,
//     big.small and big.big; small.small (2^-22 relative) is dropped.  On
//     integer inputs small is 0 and every partial sum an exact integer, so
//     the keys equal the plain version's bit for bit;
//   - the (V, D) rows staged as they lie, unpadded: a stage is 16 D
//     positions of the tile's 1024 rows (64 KB) and of h's 16 rows.  An
//     m16n8k8 B fragment is a column of w, i.e. a row of the tile, so no
//     transpose is needed: lane (g, q) reads one float4 of its row at 4 q
//     and one of rows g, g + 8 of h, and uses its floats 2 s, 2 s + 1 as
//     the slots q, q + 4 of k8 step s in A and B alike (the sum over a
//     stage's 16 positions is the same in any slot order).  A quarter warp
//     reads two 64-byte rows: 32 distinct banks, no padding;
//   - 16-byte cp.async copies with an L2 prefetch of the 128-byte line
//     around each (.L2::128B): a stage reads 64 bytes of each row, rows
//     8 KB apart, and without the hint device memory served those pieces
//     at 1.9 TB/s; the row's next stage finds its half of the line in L2.
//     3 stages (195 KB), one barrier a stage, rows past V and positions
//     past D zero-filled.
// head_variants.py, on an H100 80GB HBM3 at 700 W (L2 flushed, B 16, V
// 128256, D 2048, min of two rounds, two calls): the whole 0.519-0.523 ms
// (chip_smoke.py: 0.518-0.522; the FMA form it replaces 0.954-0.967, its
// plain version 0.80-0.82, cuBLAS's fp32 product alone 0.506-0.510); the
// tile kernel without its selection 0.392-0.395, its copies alone
// 0.379-0.381 (2.8 TB/s), its arithmetic alone 0.152-0.154; the selection
// and merge 0.127-0.128.  Tried and slower: no L2 hint 0.699-0.704
// (copies alone 0.564), .L2::256B 0.535-0.537, 8 D positions a stage (3
// or 6 stages) 0.547-0.555, 256 threads with 128 columns a warp
// 0.600-0.608; 2 stages of 16 took the same 0.519-0.524.
//
// On the same card the int8 form 0.285-0.288 ms in chip_smoke.py's kernel
// phase (the FMA form it replaced took 0.547; bytes bound 0.081).
// head_variants.py puts 0.153-0.157 in its product (its copies alone
// 0.108, its arithmetic alone 0.113), 0.105 in the tile's selection and
// 0.028 in head_merge; the unfused int8 product (csrc/int8_matmul.cu) takes
// 0.151.  With 256 threads the product took 0.147-0.150 and the whole
// 0.348-0.354.
//
// ptxas (nvcc -Xptxas -v, sm_90a), with the dynamic shared memory a launch
// asks for:
//   head_tile_topk_i8<float>    122 registers, no spills, 128.0 KB (512
//                               threads)
//   head_tile_topk_i8<bf16>     100 registers, no spills, 128.0 KB
//   head_tile_topk_tied<float>  109 registers, no spills, 195.0 KB (512
//                               threads)
//   head_tile_topk_tied<bf16>   108 registers, no spills, 195.0 KB
//   head_merge                   32 registers, no spills, 128.0 KB (1024
//                               threads)
//
// The bf16 forms (a bf16 model's decode: the Pallas kernel casts the weight
// to h's dtype and sums in fp32, tsue_tpu/ops/lmhead_topk.py:163-170):
//   - the int8 head with bf16 h is the one-term case of the int8 form's
//     split: h staged as it lies (bf16 rows of kXS elements in the fp32
//     form's space), one tensor-core product a k16 step instead of three;
//   - the tied bf16 head (head_tile_topk_tied<bf16>: a bf16 (V, D) weight
//     and bf16 h) is the fp32 tied form's layout with bf16 rows: a stage is
//     32 D positions (the same 64 bytes of each row), a lane reads 16 bytes
//     of its row at 16 q and uses its four words 2 s, 2 s + 1 as the k16
//     step s's slots (2q, 2q+1) and (2q+8, 2q+9) in A and B alike (with
//     the fp32 form's 8-position stages: 16 positions, 8 bytes a lane), and
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) takes the place of the
//     3xTF32 products: a bf16 product is exact in fp32.
// The selection, the merge and the keys are the fp32 forms'.  On an H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 14, L2 flushed, B 16, D 2048, V
// 128256): the int8 form with bf16 h 0.256 ms (bytes bound 0.081), the tied
// bf16 form 0.331 ms (bytes bound 0.159; cuBLAS's bf16 product and
// torch.topk together take 0.265-0.266); both equal to the plain version,
// indices and values, on exact inputs with ties.
//
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/lmhead_topk.py:
// lmhead_topk_plan(form, field) reports a form's layout, lmhead_topk(...)
// launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 1024;            // vocab columns per CTA
constexpr int kRows = 16;              // batch rows per pass over the tile
constexpr int kSeg = 128;              // output width = segment length
constexpr int kMergeThreads = 1024;
constexpr int kMergeSegs = 128;        // segments held by head_merge
constexpr int kKeyBytes = kRows * kTile * (int)sizeof(u64);   // 128 KB
constexpr float kBanned = -1e9f;

constexpr int kMaxSmem = 232448;       // a block's limit on the H100

// int8 form: 64 columns a warp, 32 K rows a stage, the ring in the keys'
// space
constexpr int kI8Threads = 512;
constexpr int kWarpCols = kTile / (kI8Threads / 32);
constexpr int kGroups = kWarpCols / 32;
constexpr int kKS = 32;                 // K rows per stage, k16 steps
constexpr int kWS = kTile + 16;         // bytes per staged weight row
constexpr int kXS = kKS + 8;            // floats per staged row of h
constexpr int kWBytes = kKS * kWS;
constexpr int kStageBytes = kWBytes + kRows * kXS * 4;
constexpr int kStages = kKeyBytes / kStageBytes;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kI8Smem = kRingBytes > kKeyBytes ? kRingBytes : kKeyBytes;
static_assert(kStages >= 3, "the ring holds at least three stages");
static_assert(kKS % 16 == 0 && kGroups >= 1, "whole k16 steps and groups");
// bf16 h: rows of kXS bf16 in the fp32 h space, 16-byte copies of 8
static_assert((kXS * 2) % 16 == 0 && kKS % 8 == 0 && kWBytes % 16 == 0,
              "bf16 h rows tile");

// fp32 tied form: 64 columns a warp (8 n8 tiles), kF32KS D positions a
// stage, the ring in (and past) the keys' space
constexpr int kF32Threads = 512;
constexpr int kF32WarpCols = kTile / (kF32Threads / 32);
constexpr int kF32NTiles = kF32WarpCols / 8;
constexpr int kF32KS = 16;              // D positions a stage
constexpr int kF32Stages = 3;
constexpr int kF32Vec = kF32KS / 4;     // floats a lane reads of a staged row
constexpr int kF32Steps = kF32KS / 8;   // k8 steps a stage
constexpr int kF32StageBytes = (kTile + kRows) * kF32KS * 4;
constexpr int kF32RingBytes = kF32Stages * kF32StageBytes;
constexpr int kF32Smem = kF32RingBytes > kKeyBytes ? kF32RingBytes
                                                   : kKeyBytes;
static_assert(kF32KS == 8 || kF32KS == 16, "conflict-free reads need 8 or 16");
static_assert(kF32Stages >= 2 && kF32Smem <= kMaxSmem, "the ring fits");
static_assert(kF32NTiles >= 1, "whole n8 tiles a warp");
// the tied bf16 form: the same bytes a row a stage, twice the positions; a
// lane reads a quarter of a row's stage, two words a k16 step
constexpr int kRowBytes = kF32KS * 4;   // bytes of a row a stage
constexpr int kB16KS = kRowBytes / 2;   // D positions a stage
constexpr int kB16Words = kRowBytes / 16;   // words a lane reads of a row
static_assert(kB16KS % 16 == 0 && kB16Words % 2 == 0,
              "whole k16 steps a stage, two words each a lane");

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  if (f == 0.f) f = 0.f;               // -0 and +0 are one value
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ u64 make_key(float v, int idx) {
  return ((u64)ordered_bits(v) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)idx);
}

// The penalty, then the ban, of one logit with token state m.
__device__ __forceinline__ float processed(float val, int m, float penalty) {
  if (penalty != 1.f && (m & 1))
    val = val > 0.f ? val / penalty : val * penalty;
  if (m & 2) val = kBanned;
  return val;
}

// Sort every 128-key segment of keys[0, n) descending (n % 128 == 0).
__device__ void sort_segments(u64* keys, int n) {
  for (int k = 2; k <= kSeg; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int partner = i ^ j;
        if (partner <= i) continue;
        const bool desc = ((i & (kSeg - 1)) & k) == 0;
        const u64 a = keys[i], b = keys[partner];
        if (desc ? (a < b) : (a > b)) {
          keys[i] = b;
          keys[partner] = a;
        }
      }
      __syncthreads();
    }
  }
}

// In each group of `group` consecutive sorted segments (group a power of 2
// dividing nseg), leave the group's 128 largest keys, sorted descending, in
// the group's first segment.
__device__ void merge_segments(u64* keys, int nseg, int group) {
  for (int s = 1; s < group; s <<= 1) {
    const int work = nseg / (2 * s) * kSeg;
    for (int i = threadIdx.x; i < work; i += blockDim.x) {
      const int pr = i / kSeg, j = i % kSeg;
      u64* a = keys + (size_t)pr * 2 * s * kSeg;
      const u64* b = a + (size_t)s * kSeg;
      const u64 x = a[j], y = b[kSeg - 1 - j];
      a[j] = x > y ? x : y;
    }
    __syncthreads();
    for (int d = kSeg / 2; d > 0; d >>= 1) {
      for (int i = threadIdx.x; i < work; i += blockDim.x) {
        const int pr = i / kSeg, j = i % kSeg;
        if (j & d) continue;
        u64* a = keys + (size_t)pr * 2 * s * kSeg;
        const u64 x = a[j], y = a[j + d];
        if (x < y) {
          a[j] = y;
          a[j + d] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The selection of a pass: sort and merge the tile's keys, then write each
// valid row's top 128 of the tile to its candidate slot.
__device__ void select_tile(u64* keys, u64* __restrict__ cand, int b0, int B,
                            int tile, int n_tiles) {
  sort_segments(keys, kRows * kTile);
  merge_segments(keys, kRows * kTile / kSeg, kTile / kSeg);
  for (int i = threadIdx.x; i < kRows * kSeg; i += blockDim.x) {
    const int r = i / kSeg, j = i % kSeg, b = b0 + r;
    if (b < B)
      cand[((size_t)b * n_tiles + tile) * kSeg + j] = keys[r * kTile + j];
  }
}

// ---- the int8 form's product (helpers as in csrc/int8_matmul.cu) --------

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
__device__ __forceinline__ void col_tile(float* c, const uint32_t (&a)[3][4],
                                         const uint32_t (&r)[4]) {
  const uint32_t b0 = __byte_perm(byte_f32<J>(r[0]), byte_f32<J>(r[1]),
                                  0x7632);
  const uint32_t b1 = __byte_perm(byte_f32<J>(r[2]), byte_f32<J>(r[3]),
                                  0x7632);
#pragma unroll
  for (int t = TERMS - 1; t >= 0; --t) mma(c, a[t], b0, b1);
}

// HT: h's type (fp32: three bf16 terms; bf16: one).
template <typename HT>
__global__ void __launch_bounds__(kI8Threads, 1)
head_tile_topk_i8(const HT* __restrict__ h, const int8_t* __restrict__ w8,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ mask, float penalty,
                  u64* __restrict__ cand, int B, int D, int V, int n_tiles) {
  constexpr bool HB = std::is_same_v<HT, bf16>;
  constexpr int TERMS = HB ? 1 : 3;
  constexpr int HV = 16 / sizeof(HT);   // h elements a 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring during the product, the keys [kRows][kTile] after it
  u64* keys = reinterpret_cast<u64*>(smem_raw);
  const int tile = blockIdx.x, v0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wc = warp * kWarpCols;      // the warp's first column
  const bool w16 = V % 16 == 0;
  const int nst = (D + kKS - 1) / kKS;

  for (int b0 = 0; b0 < B; b0 += kRows) {
    auto load_stage = [&](int st) {
      unsigned char* ws = smem_raw + (st % kStages) * kStageBytes;
      HT* xs = reinterpret_cast<HT*>(ws + kWBytes);
      const int k0 = st * kKS;
      if (w16) {
        constexpr int CPR = kTile / 16;   // 16-byte chunks per K row
        for (int i = tid; i < kKS * CPR; i += kI8Threads) {
          const int r = i / CPR, c = (i % CPR) * 16;
          const bool ok = k0 + r < D && v0 + c < V;
          cp16(ws + r * kWS + c, ok ? w8 + (size_t)(k0 + r) * V + v0 + c : w8,
               ok ? 16 : 0);
        }
      } else {
        constexpr int CPR = kTile / 4;
        for (int i = tid; i < kKS * CPR; i += kI8Threads) {
          const int r = i / CPR, c = (i % CPR) * 4;
          const bool ok = k0 + r < D && v0 + c < V;
          cp4(ws + r * kWS + c, ok ? w8 + (size_t)(k0 + r) * V + v0 + c : w8,
              ok ? 4 : 0);
        }
      }
      for (int i = tid; i < kRows * kKS / HV; i += kI8Threads) {
        const int r = i / (kKS / HV), c = (i % (kKS / HV)) * HV;
        const int k = k0 + c;
        const int bytes =
            b0 + r < B ? (int)sizeof(HT) * max(0, min(HV, D - k)) : 0;
        cp16(xs + r * kXS + c, bytes ? h + (size_t)(b0 + r) * D + k : h,
             bytes);
      }
    };

    float acc[kGroups][4][4];
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      }
    }

    __syncthreads();   // the previous pass's keys were read out
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nst) load_stage(st);
      cp_commit();
    }
    for (int st = 0; st < nst; ++st) {
      cp_wait<kStages - 2>();
      __syncthreads();   // stage st landed; the slot of st - 1 is free
      if (st + kStages - 1 < nst) load_stage(st + kStages - 1);
      cp_commit();
      const unsigned char* ws = smem_raw + (st % kStages) * kStageBytes;
      const HT* xs = reinterpret_cast<const HT*>(ws + kWBytes);
#pragma unroll 1   // unrolled, the two steps' fragments spill
      for (int kk = 0; kk < kKS; kk += 16) {
        uint32_t a[3][4];   // the k16 step's h fragment, TERMS terms
        const HT* x0 = xs + g * kXS + kk + 2 * q;
        const HT* x1 = x0 + 8 * kXS;
        if constexpr (HB) {   // bf16 pairs as they lie
          a[0][0] = *reinterpret_cast<const uint32_t*>(x0);
          a[0][1] = *reinterpret_cast<const uint32_t*>(x1);
          a[0][2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
          a[0][3] = *reinterpret_cast<const uint32_t*>(x1 + 8);
        } else {
          const float2 f0 = *reinterpret_cast<const float2*>(x0);
          const float2 f1 = *reinterpret_cast<const float2*>(x1);
          const float2 f2 = *reinterpret_cast<const float2*>(x0 + 8);
          const float2 f3 = *reinterpret_cast<const float2*>(x1 + 8);
          split3(f0.x, f0.y, a[0][0], a[1][0], a[2][0]);
          split3(f1.x, f1.y, a[0][1], a[1][1], a[2][1]);
          split3(f2.x, f2.y, a[0][2], a[1][2], a[2][2]);
          split3(f3.x, f3.y, a[0][3], a[1][3], a[2][3]);
        }
        const unsigned char* wr = ws + (kk + 2 * q) * kWS + wc + 4 * g;
#pragma unroll
        for (int i = 0; i < kGroups; ++i) {
          uint32_t r[4];
          r[0] = *reinterpret_cast<const uint32_t*>(wr + 32 * i) ^
                 0x80808080u;
          r[1] = *reinterpret_cast<const uint32_t*>(wr + kWS + 32 * i) ^
                 0x80808080u;
          r[2] = *reinterpret_cast<const uint32_t*>(wr + 8 * kWS + 32 * i) ^
                 0x80808080u;
          r[3] = *reinterpret_cast<const uint32_t*>(wr + 9 * kWS + 32 * i) ^
                 0x80808080u;
          col_tile<0, TERMS>(acc[i][0], a, r);
          col_tile<1, TERMS>(acc[i][1], a, r);
          col_tile<2, TERMS>(acc[i][2], a, r);
          col_tile<3, TERMS>(acc[i][3], a, r);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // the ring drained: its space becomes the keys

    // processed logits -> keys.  Tile j's (row g, column t) of group i is
    // column 32 i + 4 t + j, so a thread's c0 of tiles 0..3 are columns
    // 32 i + 8 q + 0..3 of row g and its c1 columns + 4..7 (c2, c3: row
    // g + 8).  Columns past V and rows past B key to 0 and sort last.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half, b = b0 + r;
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int c = wc + 32 * i + 8 * q;
        u64 k8[8];
#pragma unroll
        for (int c4 = 0; c4 < 2; ++c4) {
          const int v = v0 + c + 4 * c4;   // V % 4 == 0: all 4 or none
          const bool in = b < B && v < V;
          float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
          int4 m4 = make_int4(0, 0, 0, 0);
          if (in) {
            s4 = __ldg(reinterpret_cast<const float4*>(scale + v));
            if (mask != nullptr)
              m4 = __ldg(reinterpret_cast<const int4*>(
                  mask + (size_t)b * V + v));
          }
          const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
          const int mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float val = acc[i][j][2 * half + c4] * sv[j];
            k8[4 * c4 + j] = in ? make_key(processed(val, mv[j], penalty),
                                           v + j)
                                : 0ull;
          }
        }
        ulonglong2* dst = reinterpret_cast<ulonglong2*>(keys + r * kTile + c);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = make_ulonglong2(k8[2 * j], k8[2 * j + 1]);
      }
    }
    __syncthreads();
    select_tile(keys, cand, b0, B, tile, n_tiles);
  }
}

// ---- the fp32 tied form -------------------------------------------------

// fp32 -> (big, small) for the tensor cores: big keeps the 11 significant
// bits a tf32 operand holds (the rest masked off), small = x - big exactly,
// of which the mma uses the leading bits.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 16-byte copy of a row of w that also asks L2 for the 128-byte line
// around it: a stage reads kF32KS * 4 = 64 bytes of each of the tile's
// rows, D * 4 bytes apart, so device memory serves whole lines and the
// row's next stage finds its half of the line in L2.
__device__ __forceinline__ void cp16_w(void* dst, const void* src,
                                       int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(src), "r"(bytes));
}

// kB16Words consecutive words of a staged bf16 row (16 or 8 bytes).
__device__ __forceinline__ void lds_words(uint32_t (&w)[kB16Words],
                                          const unsigned char* p) {
  if constexpr (kB16Words == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

// kF32Vec consecutive floats of a staged row (16 or 8 bytes).
__device__ __forceinline__ void lds_vec(float (&v)[kF32Vec], const float* p) {
  if constexpr (kF32Vec == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  }
}

// WT: the weight's and h's type.  fp32: 3xTF32 products, kF32KS positions a
// stage; bf16: one bf16 product a k16 step, kB16KS positions a stage.  A
// stage holds the same 64 bytes of each row either way.
template <typename WT>
__global__ void __launch_bounds__(kF32Threads, 1)
head_tile_topk_tied(const WT* __restrict__ h, const WT* __restrict__ w,
                    const int32_t* __restrict__ mask, float penalty,
                    u64* __restrict__ cand, int B, int D, int V, int n_tiles) {
  constexpr bool WB = std::is_same_v<WT, bf16>;
  constexpr int KS = kRowBytes / (int)sizeof(WT);   // D positions a stage
  constexpr int EV = 16 / (int)sizeof(WT);          // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring during the product, the keys [kRows][kTile] after it
  u64* keys = reinterpret_cast<u64*>(smem_raw);
  const int tile = blockIdx.x, v0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wc = warp * kF32WarpCols;   // the warp's first column
  const int nst = (D + KS - 1) / KS;
  constexpr int CPR = kRowBytes / 16;   // 16-byte chunks a row a stage

  for (int b0 = 0; b0 < B; b0 += kRows) {
    // stage st: w[v0 + r, k0:k0 + KS] as row r of the tile (the rows as
    // they lie, unpadded), then h[b0 + r, k0:k0 + KS]; zero past V, B and D
    // (D % EV == 0: a 16-byte chunk is all in or all out)
    auto load_stage = [&](int st) {
      WT* ws = reinterpret_cast<WT*>(smem_raw +
                                     (st % kF32Stages) * kF32StageBytes);
      WT* xs = ws + kTile * KS;
      const int k0 = st * KS;
      for (int i = tid; i < kTile * CPR; i += kF32Threads) {
        const int r = i / CPR, c = (i % CPR) * EV;
        const bool ok = v0 + r < V && k0 + c < D;
        cp16_w(ws + r * KS + c,
               ok ? w + (size_t)(v0 + r) * D + k0 + c : w, ok ? 16 : 0);
      }
      for (int i = tid; i < kRows * CPR; i += kF32Threads) {
        const int r = i / CPR, c = (i % CPR) * EV;
        const bool ok = b0 + r < B && k0 + c < D;
        cp16(xs + r * KS + c, ok ? h + (size_t)(b0 + r) * D + k0 + c : h,
             ok ? 16 : 0);
      }
    };

    float acc[kF32NTiles][4];
#pragma unroll
    for (int t = 0; t < kF32NTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
    }

    __syncthreads();   // the previous pass's keys were read out
    for (int st = 0; st < kF32Stages - 1; ++st) {
      if (st < nst) load_stage(st);
      cp_commit();
    }
    for (int st = 0; st < nst; ++st) {
      cp_wait<kF32Stages - 2>();
      __syncthreads();   // stage st landed; the slot of st - 1 is free
      if (st + kF32Stages - 1 < nst) load_stage(st + kF32Stages - 1);
      cp_commit();
      const unsigned char* ws =
          smem_raw + (st % kF32Stages) * kF32StageBytes;
      const unsigned char* xs = ws + kTile * kRowBytes;
      if constexpr (WB) {
        // Lane (g, q) reads the q-th quarter of a staged row, kB16Words
        // words of two positions each.  k16 step s gives words 2 s and
        // 2 s + 1 the slots (2q, 2q+1) and (2q+8, 2q+9) of A (rows g, g + 8
        // of h) and of B (row wc + 8 t + g of w) alike, so the steps sum
        // the stage's kB16KS positions once each.
        constexpr int QB = kRowBytes / 4;   // bytes a lane reads of a row
        uint32_t h0[kB16Words], h1[kB16Words];
        lds_words(h0, xs + g * kRowBytes + QB * q);
        lds_words(h1, xs + (g + 8) * kRowBytes + QB * q);
        const unsigned char* wr = ws + (wc + g) * kRowBytes + QB * q;
#pragma unroll
        for (int t = 0; t < kF32NTiles; ++t) {
          uint32_t wv[kB16Words];
          lds_words(wv, wr + 8 * t * kRowBytes);
#pragma unroll
          for (int s = 0; s < kB16Words / 2; ++s) {
            const uint32_t a[4] = {h0[2 * s], h1[2 * s], h0[2 * s + 1],
                                   h1[2 * s + 1]};
            mma(acc[t], a, wv[2 * s], wv[2 * s + 1]);
          }
        }
      } else {
        // Lane (g, q) reads positions kF32Vec q .. + kF32Vec - 1 of the
        // stage; k8 step s gives positions kF32Vec q + 2 s and + 1 the
        // fragment slots q and q + 4 of A (rows g, g + 8 of h) and of B
        // (row wc + 8 t + g of w: n8 tile t, column g) alike, so each step
        // sums 8 distinct positions and the steps cover the stage.
        const float* xf = reinterpret_cast<const float*>(xs);
        float x0[kF32Vec], x1[kF32Vec];
        lds_vec(x0, xf + g * kF32KS + kF32Vec * q);
        lds_vec(x1, xf + (g + 8) * kF32KS + kF32Vec * q);
        uint32_t ab[kF32Steps][4], as[kF32Steps][4];   // h's big, small
#pragma unroll
        for (int s = 0; s < kF32Steps; ++s) {
          split_tf32(x0[2 * s], ab[s][0], as[s][0]);
          split_tf32(x1[2 * s], ab[s][1], as[s][1]);
          split_tf32(x0[2 * s + 1], ab[s][2], as[s][2]);
          split_tf32(x1[2 * s + 1], ab[s][3], as[s][3]);
        }
        const float* wr = reinterpret_cast<const float*>(ws) +
                          (wc + g) * kF32KS + kF32Vec * q;
#pragma unroll
        for (int t = 0; t < kF32NTiles; ++t) {
          float wv[kF32Vec];
          lds_vec(wv, wr + 8 * t * kF32KS);
#pragma unroll
          for (int s = 0; s < kF32Steps; ++s) {
            uint32_t bb0, bs0, bb1, bs1;
            split_tf32(wv[2 * s], bb0, bs0);
            split_tf32(wv[2 * s + 1], bb1, bs1);
            mma_tf32(acc[t], as[s], bb0, bb1);   // the small terms first
            mma_tf32(acc[t], ab[s], bs0, bs1);
            mma_tf32(acc[t], ab[s], bb0, bb1);
          }
        }
      }
    }
    cp_wait<0>();
    __syncthreads();   // the ring drained: its space becomes the keys

    // processed logits -> keys.  n8 tile t's c0, c1 are columns
    // wc + 8 t + 2 q, + 1 of row g and c2, c3 the same of row g + 8 (the
    // same accumulator layout for m16n8k8 tf32 and m16n8k16 bf16).
    // Columns past V and rows past B key to 0 and sort last.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half, b = b0 + r;
#pragma unroll
      for (int t = 0; t < kF32NTiles; ++t) {
        const int c = wc + 8 * t + 2 * q, v = v0 + c;
        const bool in = b < B && v < V;   // V % 4 == 0: both or neither
        int2 m2 = make_int2(0, 0);
        if (in && mask != nullptr)
          m2 = __ldg(reinterpret_cast<const int2*>(mask + (size_t)b * V + v));
        const float l0 = processed(acc[t][2 * half], m2.x, penalty);
        const float l1 = processed(acc[t][2 * half + 1], m2.y, penalty);
        const u64 k0 = in ? make_key(l0, v) : 0ull;
        const u64 k1 = in ? make_key(l1, v + 1) : 0ull;
        *reinterpret_cast<ulonglong2*>(keys + r * kTile + c) =
            make_ulonglong2(k0, k1);
      }
    }
    __syncthreads();
    select_tile(keys, cand, b0, B, tile, n_tiles);
  }
}

__global__ void __launch_bounds__(kMergeThreads)
head_merge(const u64* __restrict__ cand, float* __restrict__ vals,
           int32_t* __restrict__ idx, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* keys = reinterpret_cast<u64*>(smem_raw);     // [kMergeSegs][kSeg]
  const int b = blockIdx.x;
  const u64* src = cand + (size_t)b * n_tiles * kSeg;
  int next = 0;
  for (int round = 0; round == 0 || next < n_tiles; ++round) {
    // slot 0 carries the running top 128 after the first round
    const int first = round == 0 ? 0 : 1;
    const int take = min(kMergeSegs - first, n_tiles - next);
    for (int i = threadIdx.x; i < (kMergeSegs - first) * kSeg;
         i += kMergeThreads) {
      const int k = i / kSeg, j = i % kSeg;
      keys[(first + k) * kSeg + j] =
          k < take ? src[(size_t)(next + k) * kSeg + j] : 0ull;
    }
    next += take;
    __syncthreads();
    merge_segments(keys, kMergeSegs, kMergeSegs);
  }
  for (int j = threadIdx.x; j < kSeg; j += kMergeThreads) {
    const u64 k = keys[j];
    vals[(size_t)b * kSeg + j] = from_ordered_bits((uint32_t)(k >> 32));
    idx[(size_t)b * kSeg + j] = (int32_t)(0xFFFFFFFFu - (uint32_t)k);
  }
}

// A kernel's shared-memory limit, set at its first launch only.
template <auto Kernel>
cudaError_t configure(int smem) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

constexpr int kMergeSmem = kMergeSegs * kSeg * (int)sizeof(u64);

// The tile kernel of a form, then head_merge.
template <auto Kernel, typename... Args>
int launch(int n_tiles, int threads, int smem, cudaStream_t stream,
           const u64* cand, float* vals, int32_t* idx, int B, Args... args) {
  cudaError_t err = configure<Kernel>(smem);
  if (err == cudaSuccess) err = configure<head_merge>(kMergeSmem);
  if (err != cudaSuccess) return (int)err;
  Kernel<<<n_tiles, threads, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<B, kMergeThreads, kMergeSmem, stream>>>(cand, vals, idx,
                                                       n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The layout of one form (0: the int8 form, with fp32 or bf16 h; 1: the
// tied fp32 form; 2: the tied bf16 form): field 0 the vocab columns a CTA
// (the tile), 1 the columns a warp owns, 2 the K (= D) positions a stage of
// the cp.async ring, 3 the ring's stages, 4 the tile kernel's dynamic shared
// memory, 5 its threads; -1 for another field or form.
int lmhead_topk_plan(int form, int field) {
  if (form < 0 || form > 2) return -1;
  const bool tied = form != 0;
  switch (field) {
    case 0: return kTile;
    case 1: return tied ? kF32WarpCols : kWarpCols;
    case 2: return form == 2 ? kB16KS : tied ? kF32KS : kKS;
    case 3: return tied ? kF32Stages : kStages;
    case 4: return tied ? kF32Smem : kI8Smem;
    case 5: return tied ? kF32Threads : kI8Threads;
    default: return -1;
  }
}

// Returns a cudaError_t (0 on success).  h (B, D) fp32 (bf16_in = 0) or
// bf16 (bf16_in = 1); exactly one of w (V, D) in h's type or (w8 (D, V)
// int8, scale (V,) fp32); mask (B, V) int32 or null; cand a (B, ceil(V /
// 1024), 128) 64-bit scratch; vals (B, 128) fp32 and idx (B, 128) int32
// out.  Needs V >= 128, V % 4 == 0, D % 4 == 0 (D % 8 == 0 for bf16 h) and
// 16-byte aligned bases.
int lmhead_topk(const void* h, const void* w, const int8_t* w8,
                const float* scale, const int32_t* mask, float penalty,
                void* cand, float* vals, int32_t* idx, int B, int D, int V,
                int bf16_in, cudaStream_t stream) {
  const int n = (V + kTile - 1) / kTile;
  u64* c = static_cast<u64*>(cand);
  if (w8 != nullptr) {
    if (bf16_in)
      return launch<head_tile_topk_i8<bf16>>(
          n, kI8Threads, kI8Smem, stream, c, vals, idx, B,
          static_cast<const bf16*>(h), w8, scale, mask, penalty, c, B, D, V,
          n);
    return launch<head_tile_topk_i8<float>>(
        n, kI8Threads, kI8Smem, stream, c, vals, idx, B,
        static_cast<const float*>(h), w8, scale, mask, penalty, c, B, D, V,
        n);
  }
  if (bf16_in)
    return launch<head_tile_topk_tied<bf16>>(
        n, kF32Threads, kF32Smem, stream, c, vals, idx, B,
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), mask,
        penalty, c, B, D, V, n);
  return launch<head_tile_topk_tied<float>>(
      n, kF32Threads, kF32Smem, stream, c, vals, idx, B,
      static_cast<const float*>(h), static_cast<const float*>(w), mask,
      penalty, c, B, D, V, n);
}

}  // extern "C"
