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
// int8 head (head_tile_topk_i8; the form generation runs).  What bounds it
// on an H100: the weight stream, 263 MB at D 2048, V 128256, over 3.35 TB/s
// = 0.079 ms, plus the 8.2 MB mask.  In fp32 FMAs on the CUDA cores its 4.2 G
// multiply-adds would need 0.125 ms, and each FMA group would also pay a
// conversion and a shared load, so the products run on the tensor cores,
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
// fp32 tied head (head_tile_topk_f32, unchanged since it was first
// written): each thread owns 4 columns and 16 rows of fp32 FMAs, h staged
// in shared memory, the (V, D) rows staged transposed through shared
// memory, synchronous loads.  Its bound is the 1.05 GB weight stream.
//
// On an H100 80GB HBM3 at 700 W (L2 flushed, B 16, V 128256, D 2048): the
// int8 form 0.288 ms in chip_smoke.py's kernel phase (the FMA form it
// replaces took 0.547; bytes bound 0.081).  head_variants.py, in the same
// call, puts 0.157 in the product (its copies alone 0.109, its arithmetic
// alone 0.114), 0.105 in the tile's selection and 0.028 in head_merge; the
// unfused int8 product (csrc/int8_matmul.cu) takes 0.152.  With 256
// threads the product took 0.150 and the whole 0.354.  The tied fp32 form
// 0.954-0.967 ms (chip_smoke.py; bound 0.316).
//
// ptxas (nvcc -Xptxas -v, sm_90a), with the dynamic shared memory a launch
// asks for:
//   head_tile_topk_i8   122 registers, no spills, 128.0 KB (512 threads)
//   head_tile_topk_f32  128 registers, no spills, 193.3 KB (256 threads)
//   head_merge           32 registers, no spills, 128.0 KB (1024 threads)
//
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/lmhead_topk.py:
// lmhead_topk_plan(field) reports the layout, lmhead_topk(...) launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kTile = 1024;            // vocab columns per CTA
constexpr int kRows = 16;              // batch rows per pass over the tile
constexpr int kSeg = 128;              // output width = segment length
constexpr int kMergeThreads = 1024;
constexpr int kMergeSegs = 128;        // segments held by head_merge
constexpr int kKeyBytes = kRows * kTile * (int)sizeof(u64);   // 128 KB
constexpr float kBanned = -1e9f;

// fp32 tied form: 4 columns a thread, 16 K rows a stage
constexpr int kF32DChunk = 16;
constexpr int kWsStride = kTile + 4;   // padded row of the staged fp32 tile
constexpr int kF32Smem = kKeyBytes + kRows * kF32DChunk * 4 +
                         kF32DChunk * kWsStride * 4;

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
// four biased rows, then the three terms' products, smallest first.
template <int J>
__device__ __forceinline__ void col_tile(float* c, const uint32_t (&a)[3][4],
                                         const uint32_t (&r)[4]) {
  const uint32_t b0 = __byte_perm(byte_f32<J>(r[0]), byte_f32<J>(r[1]),
                                  0x7632);
  const uint32_t b1 = __byte_perm(byte_f32<J>(r[2]), byte_f32<J>(r[3]),
                                  0x7632);
  mma(c, a[2], b0, b1);
  mma(c, a[1], b0, b1);
  mma(c, a[0], b0, b1);
}

__global__ void __launch_bounds__(kI8Threads, 1)
head_tile_topk_i8(const float* __restrict__ h, const int8_t* __restrict__ w8,
                  const float* __restrict__ scale,
                  const int32_t* __restrict__ mask, float penalty,
                  u64* __restrict__ cand, int B, int D, int V, int n_tiles) {
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
      float* xs = reinterpret_cast<float*>(ws + kWBytes);
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
      for (int i = tid; i < kRows * kKS / 4; i += kI8Threads) {
        const int r = i / (kKS / 4), c = (i % (kKS / 4)) * 4;
        const int k = k0 + c;
        const int bytes = b0 + r < B ? 4 * max(0, min(4, D - k)) : 0;
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
      const float* xs = reinterpret_cast<const float*>(ws + kWBytes);
#pragma unroll 1   // unrolled, the two steps' fragments spill
      for (int kk = 0; kk < kKS; kk += 16) {
        uint32_t a[3][4];   // the k16 step's h fragment, three terms
        const float* x0 = xs + g * kXS + kk + 2 * q;
        const float* x1 = x0 + 8 * kXS;
        const float2 f0 = *reinterpret_cast<const float2*>(x0);
        const float2 f1 = *reinterpret_cast<const float2*>(x1);
        const float2 f2 = *reinterpret_cast<const float2*>(x0 + 8);
        const float2 f3 = *reinterpret_cast<const float2*>(x1 + 8);
        split3(f0.x, f0.y, a[0][0], a[1][0], a[2][0]);
        split3(f1.x, f1.y, a[0][1], a[1][1], a[2][1]);
        split3(f2.x, f2.y, a[0][2], a[1][2], a[2][2]);
        split3(f3.x, f3.y, a[0][3], a[1][3], a[2][3]);
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
          col_tile<0>(acc[i][0], a, r);
          col_tile<1>(acc[i][1], a, r);
          col_tile<2>(acc[i][2], a, r);
          col_tile<3>(acc[i][3], a, r);
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

__global__ void __launch_bounds__(kThreads)
head_tile_topk_f32(const float* __restrict__ h, const float* __restrict__ w,
                   const int32_t* __restrict__ mask, float penalty,
                   u64* __restrict__ cand, int B, int D, int V, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // keys [kRows][kTile], hs [kRows][kF32DChunk], ws [kF32DChunk][kWsStride]
  u64* keys = reinterpret_cast<u64*>(smem_raw);
  float* hs = reinterpret_cast<float*>(keys + kRows * kTile);
  float* ws = hs + kRows * kF32DChunk;
  const int tile = blockIdx.x;
  const int v0 = tile * kTile;
  const int c0 = threadIdx.x * 4;
  const bool cols_in = v0 + c0 < V;    // V % 4 == 0: all 4 columns or none

  for (int b0 = 0; b0 < B; b0 += kRows) {
    float acc[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    }
    for (int d0 = 0; d0 < D; d0 += kF32DChunk) {
      const int dn = min(kF32DChunk, D - d0);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kF32DChunk; i += kThreads) {
        const int r = i / kF32DChunk, dd = i % kF32DChunk;
        hs[i] = (b0 + r < B && dd < dn) ? h[(size_t)(b0 + r) * D + d0 + dd]
                                        : 0.f;
      }
      // stage w[v0:v0+kTile, d0:d0+dn] transposed: ws[dd][c]
      for (int i = threadIdx.x; i < kTile * (kF32DChunk / 4); i += kThreads) {
        const int c = i / (kF32DChunk / 4), qd = i % (kF32DChunk / 4);
        float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v0 + c < V && 4 * qd < dn)
          f = *reinterpret_cast<const float4*>(w + (size_t)(v0 + c) * D +
                                               d0 + 4 * qd);
        ws[(4 * qd + 0) * kWsStride + c] = f.x;
        ws[(4 * qd + 1) * kWsStride + c] = f.y;
        ws[(4 * qd + 2) * kWsStride + c] = f.z;
        ws[(4 * qd + 3) * kWsStride + c] = f.w;
      }
      __syncthreads();
      if (cols_in) {
        // a shallow unroll keeps the 64 accumulators in registers
#pragma unroll 2
        for (int dd = 0; dd < dn; ++dd) {
          const float4 f =
              *reinterpret_cast<const float4*>(ws + dd * kWsStride + c0);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hv = hs[r * kF32DChunk + dd];
            acc[r][0] += hv * f.x;
            acc[r][1] += hv * f.y;
            acc[r][2] += hv * f.z;
            acc[r][3] += hv * f.w;
          }
        }
      }
    }

    // processed logits -> keys; columns past V and rows past B sort last
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int b = b0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = v0 + c0 + j;
        u64 key = 0;
        if (b < B && v < V)
          key = make_key(processed(acc[r][j],
                                   mask != nullptr ? mask[(size_t)b * V + v]
                                                   : 0,
                                   penalty),
                         v);
        keys[r * kTile + c0 + j] = key;
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

// The shared-memory limits of a form's two kernels, set at its first call
// only.
cudaError_t configure(bool int8) {
  static bool done[2] = {false, false};
  if (done[int8]) return cudaSuccess;
  cudaError_t err =
      int8 ? cudaFuncSetAttribute(head_tile_topk_i8,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kI8Smem)
           : cudaFuncSetAttribute(head_tile_topk_f32,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kF32Smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(head_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMergeSegs * kSeg * (int)sizeof(u64));
  done[int8] = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

// The layout: field 0 the vocab columns a CTA (the tile), 1 the columns a
// warp owns in the int8 form, 2 the K rows a stage of its ring, 3 the
// ring's stages, 4 the int8 form's dynamic shared memory; -1 for another
// field.
int lmhead_topk_plan(int field) {
  switch (field) {
    case 0: return kTile;
    case 1: return kWarpCols;
    case 2: return kKS;
    case 3: return kStages;
    case 4: return kI8Smem;
    default: return -1;
  }
}

// Returns a cudaError_t (0 on success).  h (B, D) fp32; exactly one of
// w (V, D) fp32 or (w8 (D, V) int8, scale (V,) fp32); mask (B, V) int32 or
// null; cand a (B, ceil(V / 1024), 128) 64-bit scratch; vals (B, 128) fp32
// and idx (B, 128) int32 out.  Needs V >= 128, V % 4 == 0, D % 4 == 0 and
// 16-byte aligned bases.
int lmhead_topk(const float* h, const float* w, const int8_t* w8,
                const float* scale, const int32_t* mask, float penalty,
                void* cand, float* vals, int32_t* idx, int B, int D, int V,
                cudaStream_t stream) {
  const int n_tiles = (V + kTile - 1) / kTile;
  u64* c = static_cast<u64*>(cand);
  const bool int8 = w8 != nullptr;
  cudaError_t err = configure(int8);
  if (err != cudaSuccess) return (int)err;
  if (int8)
    head_tile_topk_i8<<<n_tiles, kI8Threads, kI8Smem, stream>>>(
        h, w8, scale, mask, penalty, c, B, D, V, n_tiles);
  else
    head_tile_topk_f32<<<n_tiles, kThreads, kF32Smem, stream>>>(
        h, w, mask, penalty, c, B, D, V, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<B, kMergeThreads, kMergeSegs * kSeg * sizeof(u64), stream>>>(
      c, vals, idx, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
