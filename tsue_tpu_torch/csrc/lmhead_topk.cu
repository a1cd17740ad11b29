// Fused LM head and exact top-128 of the processed logits.
//
// Replaces the Pallas kernel tsue_tpu/ops/lmhead_topk.py:133
// (_head_topk_kernel, launched for the tied (V, D) head in h's dtype at :243
// and for the int8 (D, V) head at :289).  For each batch row b and vocab
// entry v:
//   logit = h[b] . w[v]               (tied head: w (V, D) in h's type), or
//   logit = (h[b] . w8[:, v]) * scale[v]   (int8 head: w8 (D, V) int8)
//   if mask[b, v] & 1 and penalty != 1: logit = logit > 0 ? logit / penalty
//                                                         : logit * penalty
//   if mask[b, v] & 2: logit = -1e9
// summed in fp32, and the output is the 128 largest processed logits of each
// row with their indices, ordered by (value desc, index asc): a stable
// descending sort of the processed logits, truncated to 128.  The (B, V)
// logits never reach device memory.
//
// This is a new design for the card, not a port of the TPU's 128-lane
// bitonic leaderboard.  Each (value, index) pair becomes one 64-bit key,
// (order-preserving bits of the value) << 32 | (0xFFFFFFFF - index), so the
// required order is plain descending order of the keys, ties need no second
// comparison, and the keys are distinct: any exact selection keeps the same
// 128.  One CTA per 1024-column vocab tile computes, for 16 batch rows at a
// time, the tile's processed logits into shared memory; then each of its 16
// warps selects one row's top 128 of the tile (select_tile) and head_merge
// (one CTA per batch row) selects the row's top 128 of the tiles' lists.
//
// The selection (all forms).  In the tile, warp r takes row r: it holds the
// row's 1024 32-bit ordered values in registers, 32 a lane, and finds the 128th
// largest value t by its bits, from the top: for each bit it counts the values
// at or above t with the bit set (a warp-wide __reduce_add_sync) and keeps the
// bit if 128 or more are, stopping as soon as exactly 128 lie at or above t
// (about 17 bits for random logits, at most 32).  It gathers those 128 as keys
// into the row's first 1 KB (each lane's at its offset in the warp; with ties
// at t, by ballots column by column, the lowest indices first) and writes them
// to the tile's list: the two largest first when the merge reads only two of
// each list (86 tiles or more), else sorted.  head_merge, one CTA of 1024
// threads a row, takes a round of 128 lists: the 128th largest of a pool of
// each list's leading keys (two of each at 126 lists) is a lower bound on the
// round's 128th key; the keys at or above it (about 150 of 16128 on random
// logits) are gathered and each is ranked by 4 threads, the 128 of rank below
// 128 landing in order.  Rows with many ties at the bound (more than 1024
// survivors, e.g. every logit banned) take a block-wide search by bits. Every
// step is a count, a rank or a fixed network, so a repeated call is
// bit-identical; a shared counter hands out slots and decides nothing.  The
// sorting network it replaces (every tile's 16 x 1024 keys in 128-key bitonic
// segments merged 8 to 1: 52 block barriers over 128 KB of keys; head_merge 56
// more over 126 x 128) took about 40% of each form's time. Tried on the card
// (head_variants.py, H100 80GB HBM3 at 700.00 W, device time of head_merge a
// call): the old merge 25.4-25.5 us; a block-wide search by bits over 64-bit
// keys 22-26 us; two warp-wide searches 26 us; two warp-wide bitonic sorts 30.5
// us (a warp alone stalls on every dependent step); ranks, one thread a key,
// 11.2 us; ranks split over 4 threads 8.95-9.3 us (launch 1.1, loads 1.5, the
// bound 2.6, the rest 4). A filter by the largest of the tiles' 128th keys
// keeps 12.3k-13.5k of 16128 candidates (each tile's 128th key sits near the
// same quantile), so the pool's bound is used.  Two bits a step in the tile's
// search gave nothing; gathering by offsets and writing the two largest first
// in place of ballots and a sort took the int8 form from 0.177 to 0.173 ms.
//
// The forms differ in how a tile's logits are computed.
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
//     equal the plain version's bit for bit.  bf16 h is the one-term case:
//     h staged as it lies (bf16 rows of kXS elements in the fp32 form's
//     space), one tensor-core product a k16 step;
//   - the 16 batch rows of a pass are one m16 tile.  Each of the CTA's 16
//     warps owns 64 of the tile's columns (2 groups of 32, each 4 n8 tiles)
//     for all of D, so its 32 fp32 accumulators a thread hold finished dot
//     products: no reduction across warps, no scratch;
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
//   - 512 threads: 16 warps, one a row for the selection, 64 columns a
//     warp in the product (they fit the 128 registers a thread that 512
//     threads leave).
// B > 16 runs the tile once per group of 16 rows.  126 tiles at V 128256:
// one CTA an SM, one wave, one round of head_merge.  Tried on the card and
// slower (sources not kept): a producer warp feeding the ring through
// mbarriers, with cp.async or with bulk copies (TMA) of the 1 KB rows,
// instead of the block-wide barrier a stage.  head_variants.py times the
// other shapes tried.
//
// fp32 tied head (head_tile_topk_tied; the form generation runs with the
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
// Measured with the sorting network (head_variants.py on an H100 80GB HBM3 at
// 700 W, L2 flushed, B 16, V 128256, D 2048, min of two rounds): the whole
// 0.519-0.523 ms (cuBLAS's fp32 product alone 0.506-0.510); the tile kernel
// without its selection 0.392-0.395, its copies alone 0.379-0.381 (2.8 TB/s),
// its arithmetic alone 0.152-0.154; the selection and merge 0.127-0.128.  Tried
// and slower: no L2 hint 0.699-0.704 (copies alone 0.564), .L2::256B
// 0.535-0.537, 8 D positions a stage (3 or 6 stages) 0.547-0.555, 256 threads
// with 128 columns a warp 0.600-0.608; 2 stages of 16 took the same
// 0.519-0.524.  The int8 form: its product 0.153-0.157 (copies alone 0.108,
// arithmetic alone 0.113), the tile's selection 0.105 and head_merge 0.028;
// with 256 threads the product took 0.147-0.150.
//
// Tied bf16 head (head_tile_topk_tied_bf16: a bf16 (V, D) weight and bf16
// h; a bf16 model's decode with the fused head, where the Pallas kernel
// casts the weight to h's dtype and sums in fp32,
// tsue_tpu/ops/lmhead_topk.py:163-170).  What bounds it: the weight stream,
// 525 MB at D 2048, V 128256, over 3.35 TB/s = 0.157 ms.  Its own layout,
// so that device memory serves whole lines without an L2 hint:
//   - the tile's 1024 rows are streamed as 4 chunks of 256 rows; a stage is
//     64 D positions of the chunk's rows and of h's 16 rows, one 128-byte
//     line each (34 KB): two TMA boxes with the 128-byte swizzle (piece c
//     of row r at c ^ (r & 7), so the fragment reads touch 32 distinct
//     banks), zeros past V, B and D; the stages of all chunks and passes
//     form one sequence, so the ring runs on across a chunk's end;
//   - a 17th warp's first thread issues the boxes, on two mbarriers a stage
//     (full: the bytes landed; empty: all 16 consumer warps have read it):
//     no block barrier a stage;
//   - each consumer warp owns 16 rows of every chunk (two n8 tiles): lane
//     (g, q) reads the pieces 2 q and 2 q + 1 (positions 16 q .. 16 q + 15)
//     of its rows and of rows g, g + 8 of h, releases the stage, and its 8
//     words feed the slots (2q, 2q+1) and (2q+8, 2q+9) of four
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) in A and B alike; a
//     bf16 product is exact in fp32;
//   - at a chunk's last stage each warp writes the chunk's processed logits
//     as 32-bit ordered values (64 KB for the pass; the selection keys them
//     with their column; the mask is read at the chunk's first stage), so
//     the ring lies beside them: 4 stages, up to 136 KB in flight an SM.
// On an H100 80GB HBM3 at 700.00 W (head_variants.py, L2 flushed, B 16, D 2048,
// V 128256, penalty and ban, min of two rounds; old, new, new, old against the
// source with the sorting network and the 64-byte stages): the int8 form
// 0.2886, 0.1742, 0.1758, 0.2881 ms; the int8 form with bf16 h 0.2542, 0.1435,
// 0.1443, 0.2554; the tied fp32 form 0.5169, 0.4101, 0.4106, 0.5174; the tied
// bf16 form 0.3292, 0.2085, 0.2063, 0.3296 (cuBLAS bf16 h @ W^T and torch.topk
// together 0.2666-0.2668 in chip_smoke.py).  The first three forms give the old
// source's bits.  The tied bf16 form's copies alone 0.1803-0.1812 ms (2.91
// TB/s), its product alone 0.1872-0.1896, its tile kernel 0.1965.  Tried and
// slower: the same layout on 16-byte cp.async, 8 threads a line and a block
// barrier a stage, 0.2245 against 0.2139 (copies alone 0.1872 against 0.1809);
// boxes of 128 rows, 8 stages, 0.2114 against 0.2063; 3 stages 0.2055 against
// 0.2063, within the spread.
//
// ptxas (nvcc -Xptxas -v, sm_90a), with the dynamic shared memory a launch
// asks for (select_tile is a function of its own):
//   head_tile_topk_i8<float>    125 registers, no spills, 128.0 KB (512
//                               threads)
//   head_tile_topk_i8<bf16>     107 registers, no spills, 128.0 KB
//   head_tile_topk_tied         111 registers, no spills, 195.0 KB (512
//                               threads)
//   head_tile_topk_tied_bf16     96 registers, no spills, 201.0 KB and 64
//                               bytes of mbarriers (544 threads)
//   head_merge                   64 registers, 8 bytes spilled, 11.3 KB
//                               static (1024 threads)
//
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/lmhead_topk.py:
// lmhead_topk_plan(form, field) reports a form's layout, lmhead_topk(...)
// launches.
#include <cuda.h>            // CUtensorMap and its enums (no driver link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef unsigned long long u64;
typedef __nv_bfloat16 bf16;

constexpr int kTile = 1024;            // vocab columns per CTA
constexpr int kRows = 16;              // batch rows per pass over the tile
constexpr int kSeg = 128;              // output width
constexpr int kKeyBytes = kRows * kTile * (int)sizeof(u64);   // 128 KB
constexpr float kBanned = -1e9f;

constexpr int kMaxSmem = 232448;       // a block's limit on the H100

// the selection: one warp a batch row of the pass, so every tile kernel
// runs kRows warps; 32 values a lane
constexpr int kSelThreads = kRows * 32;
constexpr int kLaneKeys = kTile / 32;
// head_merge: one CTA a batch row, 16 keys a thread (8 pairs), 128 lists a
// round; a pool of 128 to 256 leading keys of the lists for the bound, and
// up to kSurvMax keys above it, each ranked by one thread
constexpr int kMergeThreads = 1024;
constexpr int kMergeKeys = 16;
constexpr int kMergeLists = kMergeThreads * kMergeKeys / kSeg;
constexpr int kPairLanes = kSeg / 2;    // threads a list's pairs span
constexpr int kPoolKeys = 256;
constexpr int kSurvMax = kMergeThreads;
static_assert(kMergeLists == 128 && kSeg == 128,
              "a round merges 128 lists; 4 keys a lane sort 128");
static_assert(kMergeThreads % kPairLanes == 0 &&
                  kPoolKeys == 2 * kMergeLists && kPoolKeys <= kMergeThreads,
              "a thread holds one pair of each of its lists; the pool, two "
              "keys a list at 128 lists, one a thread");

// int8 form: 64 columns a warp, 32 K rows a stage, the ring in the keys'
// space
constexpr int kI8Threads = kSelThreads;
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
constexpr int kF32Threads = kSelThreads;
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

// tied bf16 form: a stage is one 128-byte line (64 D positions) of each of
// a chunk's 256 vocab rows and of h's 16 rows, two TMA boxes; each of the
// kRows consumer warps owns 16 rows of every chunk (two n8 tiles); one more
// warp feeds the ring; the ring lies beside the pass's 32-bit ordered
// values
constexpr int kB16Consumers = kSelThreads;
constexpr int kB16Threads = kB16Consumers + 32;
constexpr int kB16KS = 64;              // D positions a stage
constexpr int kLine = kB16KS * (int)sizeof(bf16);   // bytes of a row a stage
constexpr int kB16Rows = 256;           // vocab rows a stage (a chunk)
constexpr int kB16Chunks = kTile / kB16Rows;
constexpr int kB16WarpRows = kB16Rows / (kB16Consumers / 32);
constexpr int kB16NTiles = kB16WarpRows / 8;
constexpr int kB16WBytes = kB16Rows * kLine;
constexpr int kB16StageBytes = kB16WBytes + kRows * kLine;
constexpr int kValBytes = kRows * kTile * (int)sizeof(uint32_t);
constexpr int kAlign = 1024;            // the 128-byte swizzle's period
constexpr int kB16Static = 1024;        // kept for the static mbarriers
constexpr int kB16Stages =
    (kMaxSmem - kB16Static - kAlign - kValBytes) / kB16StageBytes;
constexpr int kB16Smem = kAlign + kB16Stages * kB16StageBytes + kValBytes;
static_assert(kLine == 128, "a stage reads whole 128-byte lines: one "
              "128-byte-swizzled TMA box row");
static_assert(kLine / 16 == 8 && kB16KS % 16 == 0 && kB16KS / 16 == 4,
              "8 pieces of 16 bytes a line (the swizzle's 8-row period); "
              "a lane's 8 words feed the stage's 4 k16 steps");
static_assert(kTile % kB16Rows == 0 && kB16WarpRows % 8 == 0 &&
                  kRows % 8 == 0 && kB16Rows <= 256 && kRows <= 256,
              "whole chunks a tile; whole n8 tiles a warp; rows in groups of "
              "8, as the swizzle permutes them; TMA boxes of 256 rows at "
              "most");
static_assert(kB16WBytes % kAlign == 0 && kB16StageBytes % kAlign == 0,
              "every box starts on the swizzle's 1024-byte period");
static_assert(kB16Stages >= 3 && kB16Smem + kB16Static <= kMaxSmem &&
                  16 * kB16Stages <= kB16Static,
              "three stages at least beside the values and the mbarriers");

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  if (f == 0.f) f = 0.f;               // -0 and +0 are one value
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ u64 key_of(uint32_t ordered, int idx) {
  return ((u64)ordered << 32) | (u64)(0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ u64 make_key(float v, int idx) {
  return key_of(ordered_bits(v), idx);
}

// The penalty, then the ban, of one logit with token state m.
__device__ __forceinline__ float processed(float val, int m, float penalty) {
  if (penalty != 1.f && (m & 1))
    val = val > 0.f ? val / penalty : val * penalty;
  if (m & 2) val = kBanned;
  return val;
}

// Sort the warp's 32 N keys descending, N a lane (key N lane + i in x[i]):
// a bitonic network, its steps of distance N and more on shuffles, the
// rest in registers.
template <int N>
__device__ __forceinline__ void warp_sort(u64 (&x)[N], int lane) {
#pragma unroll
  for (int k = 2; k <= 32 * N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int e = N * lane + i;
        const bool desc = (e & k) == 0;
        if (j >= N) {
          const u64 y = __shfl_xor_sync(0xffffffffu, x[i], j / N);
          const bool keep_max = ((e & j) == 0) == desc;
          x[i] = keep_max ? (x[i] > y ? x[i] : y) : (x[i] < y ? x[i] : y);
        } else if ((i & j) == 0) {
          const u64 a = x[i], b = x[i | j];
          if (desc ? a < b : a > b) {
            x[i] = b;
            x[i | j] = a;
          }
        }
      }
    }
  }
}

// ---- the selection ------------------------------------------------------

// The ordered value of column col of a pass's row: the int8 and tied fp32
// forms store keys (0 past V), whose upper word it is, the tied bf16 form
// the values (0 past V).  Every real value is above 0.
__device__ __forceinline__ uint32_t value_at(const u64* row, int col) {
  return reinterpret_cast<const uint32_t*>(row)[2 * col + 1];
}
__device__ __forceinline__ uint32_t value_at(const uint32_t* row, int col) {
  return row[col];
}

// The selection of a pass: warp r writes the top 128 keys of row r's 1024
// columns to the row's candidate slot of the tile.  The 128th largest
// value t is found by its bits, from the top, one warp-wide count a bit,
// stopping as soon as exactly 128 values lie at or above t (about 17 bits
// for random logits, at most 32).  Then the values at or above t are keyed
// with their columns and gathered into the row's first 1 KB, which the warp
// has read: each lane's at its offset in the warp when they are exactly
// 128, else by ballots, column by column, taking of the values equal to t
// the first in column order (the lowest indices, which the key order puts
// first).  The merge reads a list's leading keys for its bound: m of them,
// m the round's 256 / lists; where m <= 2 (86 tiles or more) the slot holds
// the two largest keys first and the others after them in slot order, else
// all 128 sorted descending.  No block barrier: rows past B return at once.
// A function of its own: inlined, its registers and the product's share
// one allocation, and the tied fp32 form spilled (12 us more a call).
template <typename K>
__device__ __noinline__ void select_tile(K* keys, u64* __restrict__ cand,
                                         int b0, int B, int v0, int V,
                                         int tile, int n_tiles) {
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (b0 + r >= B) return;
  K* row = keys + r * kTile;
  uint32_t val[kLaneKeys];   // columns 32 j + lane
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) val[j] = value_at(row, 32 * j + lane);
  uint32_t t = 0;
  bool exact = false;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t c = t | (1u << bit);
    int n = 0;
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) n += val[j] >= c;
    n = __reduce_add_sync(0xffffffffu, n);
    if (n >= kSeg) {
      t = c;
      if (n == kSeg) {
        exact = true;
        break;
      }
    }
  }
  u64* buf = reinterpret_cast<u64*>(row);
  __syncwarp();   // the row was read out
  if (exact) {
    unsigned mine = 0;   // bit j: column 32 j + lane is taken
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) mine |= (val[j] >= t ? 1u : 0u) << j;
    const int cnt = __popc(mine);
    int at = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, at, d);
      if (lane >= d) at += o;
    }
    at -= cnt;
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      if (mine >> j & 1u) {
        const int v = v0 + 32 * j + lane;
        buf[at++] = v < V ? key_of(val[j], v) : 0ull;
      }
    }
  } else {
    int n = 0;
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) n += val[j] > t;
    const int need = kSeg - __reduce_add_sync(0xffffffffu, n);
    const unsigned below = (1u << lane) - 1u;
    int base = 0, ties = 0;
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      const bool eq = val[j] == t;
      const unsigned me = __ballot_sync(0xffffffffu, eq);
      const bool sel = val[j] > t || (eq && ties + __popc(me & below) < need);
      const unsigned ms = __ballot_sync(0xffffffffu, sel);
      if (sel) {
        const int v = v0 + 32 * j + lane;
        buf[base + __popc(ms & below)] = v < V ? key_of(val[j], v) : 0ull;
      }
      base += __popc(ms);
      ties += __popc(me);
    }
  }
  __syncwarp();
  u64 x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = buf[4 * lane + i];
  u64* dst = cand + ((size_t)(b0 + r) * n_tiles + tile) * kSeg;
  if (kPoolKeys / min(n_tiles, kMergeLists) > 2) {
    warp_sort(x, lane);
    ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst + 4 * lane);
    d2[0] = make_ulonglong2(x[0], x[1]);
    d2[1] = make_ulonglong2(x[2], x[3]);
    return;
  }
  // the two largest keys k1 > k2 (a tile has 4 real columns at least, so
  // both are distinct and nonzero) to slots 0 and 1
  u64 k1 = x[0], k2 = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (x[i] > k1) {
      k2 = k1;
      k1 = x[i];
    } else if (x[i] > k2) {
      k2 = x[i];
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const u64 o1 = __shfl_xor_sync(0xffffffffu, k1, d);
    const u64 o2 = __shfl_xor_sync(0xffffffffu, k2, d);
    const u64 lo = k1 < o1 ? k1 : o1, hi2 = k2 > o2 ? k2 : o2;
    k1 = k1 > o1 ? k1 : o1;
    k2 = lo > hi2 ? lo : hi2;
  }
  int i1 = -1, i2 = -1;   // where this lane holds them
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (x[i] == k1) i1 = i;
    if (x[i] == k2) i2 = i;
  }
  const int l1 = __ffs(__ballot_sync(0xffffffffu, i1 >= 0)) - 1;
  const int l2 = __ffs(__ballot_sync(0xffffffffu, i2 >= 0)) - 1;
  const int p1 = 4 * l1 + __shfl_sync(0xffffffffu, i1, l1);
  const int p2 = 4 * l2 + __shfl_sync(0xffffffffu, i2, l2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * lane + i;
    dst[p == p1 ? 0 : p == p2 ? 1 : p + 2 - (p1 < p) - (p2 < p)] = x[i];
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
    // g + 8).  Columns past V and rows past B key to 0.
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
    select_tile(keys, cand, b0, B, v0, V, tile, n_tiles);
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

__global__ void __launch_bounds__(kF32Threads, 1)
head_tile_topk_tied(const float* __restrict__ h, const float* __restrict__ w,
                    const int32_t* __restrict__ mask, float penalty,
                    u64* __restrict__ cand, int B, int D, int V,
                    int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring during the product, the keys [kRows][kTile] after it
  u64* keys = reinterpret_cast<u64*>(smem_raw);
  const int tile = blockIdx.x, v0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wc = warp * kF32WarpCols;   // the warp's first column
  const int nst = (D + kF32KS - 1) / kF32KS;
  constexpr int CPR = kF32KS / 4;       // 16-byte chunks a row a stage

  for (int b0 = 0; b0 < B; b0 += kRows) {
    // stage st: w[v0 + r, k0:k0 + kF32KS] as row r of the tile (the rows
    // as they lie, unpadded), then h[b0 + r, k0:k0 + kF32KS]; zero past V,
    // B and D (D % 4 == 0: a 16-byte chunk is all in or all out)
    auto load_stage = [&](int st) {
      float* ws = reinterpret_cast<float*>(smem_raw +
                                           (st % kF32Stages) * kF32StageBytes);
      float* xs = ws + kTile * kF32KS;
      const int k0 = st * kF32KS;
      for (int i = tid; i < kTile * CPR; i += kF32Threads) {
        const int r = i / CPR, c = (i % CPR) * 4;
        const bool ok = v0 + r < V && k0 + c < D;
        cp16_w(ws + r * kF32KS + c,
               ok ? w + (size_t)(v0 + r) * D + k0 + c : w, ok ? 16 : 0);
      }
      for (int i = tid; i < kRows * CPR; i += kF32Threads) {
        const int r = i / CPR, c = (i % CPR) * 4;
        const bool ok = b0 + r < B && k0 + c < D;
        cp16(xs + r * kF32KS + c, ok ? h + (size_t)(b0 + r) * D + k0 + c : h,
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
      const float* ws = reinterpret_cast<const float*>(
          smem_raw + (st % kF32Stages) * kF32StageBytes);
      const float* xs = ws + kTile * kF32KS;
      // Lane (g, q) reads positions kF32Vec q .. + kF32Vec - 1 of the
      // stage; k8 step s gives positions kF32Vec q + 2 s and + 1 the
      // fragment slots q and q + 4 of A (rows g, g + 8 of h) and of B
      // (row wc + 8 t + g of w: n8 tile t, column g) alike, so each step
      // sums 8 distinct positions and the steps cover the stage.
      float x0[kF32Vec], x1[kF32Vec];
      lds_vec(x0, xs + g * kF32KS + kF32Vec * q);
      lds_vec(x1, xs + (g + 8) * kF32KS + kF32Vec * q);
      uint32_t ab[kF32Steps][4], as[kF32Steps][4];   // h's big, small
#pragma unroll
      for (int s = 0; s < kF32Steps; ++s) {
        split_tf32(x0[2 * s], ab[s][0], as[s][0]);
        split_tf32(x1[2 * s], ab[s][1], as[s][1]);
        split_tf32(x0[2 * s + 1], ab[s][2], as[s][2]);
        split_tf32(x1[2 * s + 1], ab[s][3], as[s][3]);
      }
      const float* wr = ws + (wc + g) * kF32KS + kF32Vec * q;
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
    cp_wait<0>();
    __syncthreads();   // the ring drained: its space becomes the keys

    // processed logits -> keys.  n8 tile t's c0, c1 are columns
    // wc + 8 t + 2 q, + 1 of row g and c2, c3 the same of row g + 8.
    // Columns past V and rows past B key to 0.
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
    select_tile(keys, cand, b0, B, v0, V, tile, n_tiles);
  }
}

// ---- the tied bf16 form -------------------------------------------------

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
// The consumer warps' own barrier (the producer warp does not take part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kB16Consumers) : "memory");
}

// The two 16-byte pieces at byte offsets p0 and p1 of a staged line, as 8
// words.
__device__ __forceinline__ void lds_line(uint32_t (&x)[8],
                                         const unsigned char* line, int p0,
                                         int p1) {
  const uint4 a = *reinterpret_cast<const uint4*>(line + p0);
  const uint4 b = *reinterpret_cast<const uint4*>(line + p1);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

// tw: w (V, D) as boxes of 64 positions x 256 rows, th: h (B, D) as boxes
// of 64 x 16, both with the 128-byte swizzle (piece c of box row r lands
// at piece c ^ (r & 7)).  The last warp's first thread keeps the ring full,
// one stage after another across the chunks and the passes, each stage on
// two mbarriers: full (the boxes' bytes landed) and empty (every consumer
// warp has read it).
__global__ void __launch_bounds__(kB16Threads, 1)
head_tile_topk_tied_bf16(const __grid_constant__ CUtensorMap tw,
                         const __grid_constant__ CUtensorMap th,
                         const int32_t* __restrict__ mask, float penalty,
                         u64* __restrict__ cand, int B, int D, int V,
                         int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kB16Stages], empty[kB16Stages];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~uintptr_t(kAlign - 1));
  // the pass's ordered values [kRows][kTile], after the ring
  uint32_t* vals =
      reinterpret_cast<uint32_t*>(ring + kB16Stages * kB16StageBytes);
  const int tile = blockIdx.x, v0 = tile * kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nk = (D + kB16KS - 1) / kB16KS;   // stages a chunk
  const int nst = kB16Chunks * nk;            // stages a pass
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kB16Stages; ++s) {
      mbar_init(&full[s], 1);                   // the boxes' bytes
      mbar_init(&empty[s], kB16Consumers / 32);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kB16Consumers / 32) {   // the producer warp
    if (lane == 0) {
      int g = 0;   // stages issued
      for (int b0 = 0; b0 < B; b0 += kRows) {
        for (int st = 0; st < nst; ++st, ++g) {
          const int s = g % kB16Stages;
          mbar_wait(&empty[s], ((g / kB16Stages) & 1) ^ 1);
          unsigned char* ws = ring + s * kB16StageBytes;
          const int k0 = (st % nk) * kB16KS;
          mbar_arrive_tx(&full[s], kB16StageBytes);
          tma_load(ws, &tw, k0, v0 + (st / nk) * kB16Rows, &full[s]);
          tma_load(ws + kB16WBytes, &th, k0, b0, &full[s]);
        }
      }
    }
    return;
  }

  const int g = lane / 4, q = lane % 4;
  // Lane (g, q) reads the logical pieces 2 q and 2 q + 1 (positions 16 q
  // .. 16 q + 15 of the stage) of rows whose index is g mod 8
  const int p0 = ((2 * q) ^ g) << 4, p1 = ((2 * q + 1) ^ g) << 4;
  int gs = 0;   // stages consumed
  for (int b0 = 0; b0 < B; b0 += kRows) {
    float acc[kB16NTiles][4];
    int2 mk[2][kB16NTiles];   // the chunk's mask, read ahead of its epilogue
    for (int st = 0; st < nst; ++st, ++gs) {
      const int chunk = st / nk, kst = st % nk, s = gs % kB16Stages;
      // n8 tile t's c0, c1 are columns cc + 8 t, + 1 of row g and c2, c3
      // the same of row g + 8
      const int cc = chunk * kB16Rows + warp * kB16WarpRows + 2 * q;
      if (kst == 0) {
#pragma unroll
        for (int t = 0; t < kB16NTiles; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int b = b0 + g + 8 * half, v = v0 + cc + 8 * t;
            mk[half][t] = make_int2(0, 0);
            if (b < B && v < V && mask != nullptr)
              mk[half][t] = __ldg(reinterpret_cast<const int2*>(
                  mask + (size_t)b * V + v));
          }
        }
      }
      mbar_wait(&full[s], (gs / kB16Stages) & 1);
      const unsigned char* ws = ring + s * kB16StageBytes;
      const unsigned char* xs = ws + kB16WBytes;
      // k16 step s gives words 2 s and 2 s + 1 of the lane's 8 the slots
      // (2q, 2q+1) and (2q+8, 2q+9) of A (rows g, g + 8 of h) and of B
      // (row 16 warp + 8 t + g of the chunk: n8 tile t, column g) alike,
      // so the four steps sum the stage's 64 positions once each.
      uint32_t x0[8], x1[8], wv[kB16NTiles][8];
      lds_line(x0, xs + g * kLine, p0, p1);
      lds_line(x1, xs + (g + 8) * kLine, p0, p1);
#pragma unroll
      for (int t = 0; t < kB16NTiles; ++t)
        lds_line(wv[t], ws + (warp * kB16WarpRows + 8 * t + g) * kLine, p0,
                 p1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage was read
#pragma unroll
      for (int t = 0; t < kB16NTiles; ++t) {
#pragma unroll
        for (int k = 0; k < kB16KS / 16; ++k) {
          const uint32_t a[4] = {x0[2 * k], x1[2 * k], x0[2 * k + 1],
                                 x1[2 * k + 1]};
          mma(acc[t], a, wv[t][2 * k], wv[t][2 * k + 1]);
        }
      }
      if (kst == nk - 1) {
        // the chunk's processed logits -> ordered values; columns past V
        // and rows past B hold 0
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = g + 8 * half, b = b0 + r;
#pragma unroll
          for (int t = 0; t < kB16NTiles; ++t) {
            const int c = cc + 8 * t, v = v0 + c;
            const bool in = b < B && v < V;   // V % 4 == 0: both or neither
            const int2 m2 = mk[half][t];
            const float l0 = processed(acc[t][2 * half], m2.x, penalty);
            const float l1 = processed(acc[t][2 * half + 1], m2.y, penalty);
            *reinterpret_cast<uint2*>(vals + r * kTile + c) = make_uint2(
                in ? ordered_bits(l0) : 0u, in ? ordered_bits(l1) : 0u);
          }
        }
      }
    }
    consumers_sync();   // every chunk's values are written
    select_tile(vals, cand, b0, B, v0, V, tile, n_tiles);
    consumers_sync();   // the values were read out
  }
}

// ---- the merge ----------------------------------------------------------

// The rank of key i of keys[0, n) in shared memory (the keys above it),
// counted by T neighbouring threads of a warp, thread `part` over the
// part-th slice; every lane of the warp calls it.  Equal keys share a rank.
template <int T>
__device__ __forceinline__ int rank_of(const u64* keys, int n, int i,
                                       int part) {
  const u64 x = i < n ? keys[i] : 0ull;
  int r = 0;
  const int hi = (part + 1) * n / T;
#pragma unroll 4
  for (int k = part * n / T; k < hi; ++k) r += keys[k] > x;
  if (T >= 2) r += __shfl_xor_sync(0xffffffffu, r, 1);
  if (T >= 4) r += __shfl_xor_sync(0xffffffffu, r, 2);
  return r;
}

// Keys [0, n) of sur, distinct: each of rank below 128 to top[rank].
template <int T>
__device__ __forceinline__ void place_ranked(const u64* sur, int n,
                                             u64* top) {
  const int i = threadIdx.x / T, part = threadIdx.x % T;
  const int r = rank_of<T>(sur, n, i, part);
  if (part == 0 && i < n && r < kSeg) top[r] = sur[i];
}

// One CTA a batch row: the row's top 128 of the tiles' candidate lists, in
// rounds of 128 lists (after the first, list 0 is the running top 128,
// sorted).  A round:
//   - a bound: the lists' leading keys (m of each, 128 to 256 in all, the
//     lists' largest where the tiles ordered them for this m) form
//     a pool, each ranked by 4 threads, and a key of rank 127 is the bound
//     l (0 if equal zero keys leave none).  The pool is a part of the
//     round's keys, so its 128th key is at most theirs: every key of the
//     round's top 128 lies at or above l;
//   - the keys at or above l are gathered (a shared counter hands out their
//     slots; which keys survive does not depend on it): with random logits
//     about 150 of 16128;
//   - if there are at most 1024, each is ranked by 1, 2 or 4 threads and
//     the 128 of rank below 128 land in rank order; else (l = 0, or ties
//     across many tiles, e.g. a row of banned logits) the block finds the
//     128th key by its bits, one block-wide count a bit, gathers the 128 at
//     or above it and one warp sorts them.
// Every round holds at least 128 distinct nonzero keys (tile 0 has min(V,
// 1024) >= 128 real columns, and the running top 128 after it), so a
// nonzero bound leaves distinct survivors, and either path gives the
// round's exact top 128, independent of the slots handed out.  Ranks in
// place of a warp's search or sort: a warp alone stalls on every dependent
// step.
__global__ void __launch_bounds__(kMergeThreads)
head_merge(const u64* __restrict__ cand, float* __restrict__ vals,
           int32_t* __restrict__ idx, int n_tiles) {
  __shared__ __align__(16) u64 top[kSeg];
  __shared__ __align__(16) u64 pool[kPoolKeys];
  __shared__ __align__(16) u64 sur[kSurvMax];
  __shared__ __align__(16) int red[2][kMergeThreads / 32];
  __shared__ u64 bound;
  __shared__ int n_sur;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int e = 2 * (tid % kPairLanes);   // the pair of its lists it holds
  const u64* src = cand + (size_t)b * n_tiles * kSeg;
  int par = 0;
  for (int next = 0, round = 0; round == 0 || next < n_tiles; ++round) {
    const int first = round == 0 ? 0 : 1;
    const int take = min(kMergeLists - first, n_tiles - next);
    const int lists = first + take;
    const int m = min(kSeg, kPoolKeys / lists);
    u64 key[kMergeKeys];   // elements e, e + 1 of lists tid / 64 + 16 j
#pragma unroll
    for (int j = 0; j < kMergeKeys / 2; ++j) {   // every load in flight
      const int list = tid / kPairLanes + (kMergeThreads / kPairLanes) * j;
      ulonglong2 k2 = make_ulonglong2(0ull, 0ull);
      if (list < first)
        k2 = *reinterpret_cast<const ulonglong2*>(top + e);
      else if (list < lists)
        k2 = *reinterpret_cast<const ulonglong2*>(
            src + (size_t)(next + list - first) * kSeg + e);
      key[2 * j] = k2.x;
      key[2 * j + 1] = k2.y;
    }
    if (e < m) {
#pragma unroll
      for (int j = 0; j < kMergeKeys / 2; ++j) {
        const int list = tid / kPairLanes + (kMergeThreads / kPairLanes) * j;
        if (list < lists) {
          pool[list * m + e] = key[2 * j];
          if (e + 1 < m) pool[list * m + e + 1] = key[2 * j + 1];
        }
      }
    }
    next += take;
    if (tid == 0) {
      n_sur = 0;
      bound = 0;   // unless a pool key ranks 127 (none may: equal zeros)
    }
    __syncthreads();   // the pool is written; the running top 128 was read
    {
      constexpr int T = kMergeThreads / kPoolKeys;
      const int i = tid / T, part = tid % T, pn = lists * m;
      const int r = rank_of<T>(pool, pn, i, part);
      if (part == 0 && i < pn && r == kSeg - 1) bound = pool[i];
    }
    __syncthreads();   // the bound is set
    const u64 l = bound;
    int n = 0;
#pragma unroll
    for (int j = 0; j < kMergeKeys; ++j) n += key[j] >= l;
    int at = n > 0 ? atomicAdd(&n_sur, n) : 0;
#pragma unroll
    for (int j = 0; j < kMergeKeys; ++j) {
      if (key[j] >= l) {
        if (at < kSurvMax) sur[at] = key[j];
        ++at;
      }
    }
    __syncthreads();   // the survivors are gathered
    const int survivors = n_sur;
    if (l > 0 && survivors <= kSurvMax) {
      if (survivors <= kSurvMax / 4)
        place_ranked<4>(sur, survivors, top);
      else if (survivors <= kSurvMax / 2)
        place_ranked<2>(sur, survivors, top);
      else
        place_ranked<1>(sur, survivors, top);
    } else {
      u64 t = 0;
      for (int bit = 63; bit >= 0; --bit) {
        const u64 c = t | (1ull << bit);
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < kMergeKeys; ++j) cnt += key[j] >= c;
        cnt = __reduce_add_sync(0xffffffffu, cnt);
        if (lane == 0) red[par][warp] = cnt;
        __syncthreads();
        int total = 0;
#pragma unroll
        for (int i = 0; i < kMergeThreads / 128; ++i) {
          const int4 r4 = reinterpret_cast<const int4*>(red[par])[i];
          total += r4.x + r4.y + r4.z + r4.w;
        }
        par ^= 1;   // the next bit counts into the other half
        if (total >= kSeg) {
          t = c;
          if (total == kSeg) break;
        }
      }
      if (tid == 0) n_sur = 0;   // every thread read it before the loop
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kMergeKeys; ++j) {
        if (key[j] >= t) {
          const int s = atomicAdd(&n_sur, 1);
          if (s < kSeg) top[s] = key[j];
        }
      }
      __syncthreads();
      if (warp == 0) {
        u64 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = top[4 * lane + i];
        warp_sort(x, lane);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) top[4 * lane + i] = x[i];
      }
    }
    __syncthreads();   // the round's top 128 is in place
  }
  for (int j = tid; j < kSeg; j += kMergeThreads) {
    const u64 k = top[j];
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

// The tile kernel of a form, then head_merge.
template <auto Kernel, typename... Args>
int launch(int n_tiles, int threads, int smem, cudaStream_t stream,
           const u64* cand, float* vals, int32_t* idx, int B, Args... args) {
  cudaError_t err = configure<Kernel>(smem);
  if (err != cudaSuccess) return (int)err;
  Kernel<<<n_tiles, threads, smem, stream>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<B, kMergeThreads, 0, stream>>>(cand, vals, idx, n_tiles);
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

// A row-major bf16 (rows, cols) tensor as TMA boxes of box_rows x kB16KS
// columns with the 128-byte swizzle, zeros outside it; false if
// cuTensorMapEncodeTiled refuses it (a base not 16-byte aligned, a row not
// a multiple of 16 bytes).
bool tensor_map_bf16(CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)kB16KS, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// The layout of one form (0: the int8 form, with fp32 or bf16 h; 1: the
// tied fp32 form; 2: the tied bf16 form): field 0 the vocab columns a CTA
// (the tile), 1 the tile's columns a warp owns, 2 the K (= D) positions a
// stage of the cp.async ring, 3 the ring's stages, 4 the tile kernel's
// dynamic shared memory, 5 its threads (the tied bf16 form: 16 consumer
// warps and a producer warp), 6 the vocab columns a stage holds (the whole
// tile, or the tied bf16 form's chunk); -1 for another field or form.
int lmhead_topk_plan(int form, int field) {
  if (form < 0 || form > 2) return -1;
  const int f = form;
  switch (field) {
    case 0: return kTile;
    case 1: return f == 0 ? kWarpCols : f == 1 ? kF32WarpCols
                                               : kB16Chunks * kB16WarpRows;
    case 2: return f == 0 ? kKS : f == 1 ? kF32KS : kB16KS;
    case 3: return f == 0 ? kStages : f == 1 ? kF32Stages : kB16Stages;
    case 4: return f == 0 ? kI8Smem : f == 1 ? kF32Smem : kB16Smem;
    case 5: return f == 2 ? kB16Threads : kSelThreads;
    case 6: return f == 2 ? kB16Rows : kTile;
    default: return -1;
  }
}

// Returns a cudaError_t (0 on success; cudaErrorInvalidValue if the tied
// bf16 form's tensor maps are refused).  h (B, D) fp32 (bf16_in = 0) or
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
  if (bf16_in) {
    CUtensorMap tw, th;
    if (!tensor_map_bf16(&tw, w, V, D, kB16Rows) ||
        !tensor_map_bf16(&th, h, B, D, kRows))
      return (int)cudaErrorInvalidValue;
    return launch<head_tile_topk_tied_bf16>(
        n, kB16Threads, kB16Smem, stream, c, vals, idx, B, tw, th, mask,
        penalty, c, B, D, V, n);
  }
  return launch<head_tile_topk_tied>(
      n, kF32Threads, kF32Smem, stream, c, vals, idx, B,
      static_cast<const float*>(h), static_cast<const float*>(w), mask,
      penalty, c, B, D, V, n);
}

}  // extern "C"
