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
// second comparison.  Two kernels:
//   1. head_tile_topk: one CTA per 1024-column vocab tile.  For 16 batch rows
//      at a time it computes the tile's logits in registers (each thread owns
//      4 columns; x rows staged in shared memory; int8 weights read as 4-byte
//      rows per lane, fp32 weights staged transposed through shared memory),
//      applies the mask, penalty and ban, writes the keys to shared memory,
//      sorts each 128-key segment with a bitonic network and merges the 8
//      segments of a row down to the row's top 128 of the tile;
//   2. head_merge: one CTA per batch row merges the per-tile lists, 127 at a
//      time into a running top 128, with the same segment merge.
// Merging two sorted lists keeps max(A[j], B[127 - j]) and re-sorts that
// bitonic sequence with 7 half-cleaner steps, so every step is a fixed
// network: the result does not depend on thread scheduling.
//
// What bounds it on an H100: the weight stream, 263 MB for the int8 head
// (128256 x 2048) or 1.05 GB for the fp32 tied head, read once per step;
// the selection adds about 8 bytes of shared-memory traffic per logit per
// network step and no device-memory traffic beyond 1 KB per tile and row.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/lmhead_topk.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 256;
constexpr int kTile = 1024;            // vocab columns per CTA, 4 per thread
constexpr int kRows = 16;              // batch rows per pass over the tile
constexpr int kSeg = 128;              // output width = segment length
constexpr int kMergeThreads = 1024;
constexpr int kMergeSegs = 128;        // segments held by head_merge
constexpr int kWsStride = kTile + 4;   // padded row of the staged fp32 tile
constexpr float kBanned = -1e9f;

template <bool kInt8>
struct TileShape {
  static constexpr int kDChunk = kInt8 ? 64 : 16;   // K rows per stage
  static constexpr size_t kSmem =
      (size_t)kRows * kTile * sizeof(u64) +
      (size_t)kRows * kDChunk * sizeof(float) +
      (kInt8 ? 0 : (size_t)kDChunk * kWsStride * sizeof(float));
};

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

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
head_tile_topk(const float* __restrict__ h, const float* __restrict__ w,
               const int8_t* __restrict__ w8,
               const float* __restrict__ scale,
               const int32_t* __restrict__ mask, float penalty,
               u64* __restrict__ cand, int B, int D, int V, int n_tiles) {
  constexpr int kDChunk = TileShape<kInt8>::kDChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* keys = reinterpret_cast<u64*>(smem_raw);              // [kRows][kTile]
  float* hs = reinterpret_cast<float*>(keys + kRows * kTile); // [kRows][kDChunk]
  float* ws = hs + kRows * kDChunk;                           // [kDChunk][kWsStride]
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
    for (int d0 = 0; d0 < D; d0 += kDChunk) {
      const int dn = min(kDChunk, D - d0);
      __syncthreads();
      for (int i = threadIdx.x; i < kRows * kDChunk; i += kThreads) {
        const int r = i / kDChunk, dd = i % kDChunk;
        hs[i] = (b0 + r < B && dd < dn) ? h[(size_t)(b0 + r) * D + d0 + dd]
                                        : 0.f;
      }
      if (!kInt8) {
        // stage w[v0:v0+kTile, d0:d0+dn] transposed: ws[dd][c]
        for (int i = threadIdx.x; i < kTile * (kDChunk / 4); i += kThreads) {
          const int c = i / (kDChunk / 4), qd = i % (kDChunk / 4);
          float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
          if (v0 + c < V && 4 * qd < dn)
            f = *reinterpret_cast<const float4*>(w + (size_t)(v0 + c) * D +
                                                 d0 + 4 * qd);
          ws[(4 * qd + 0) * kWsStride + c] = f.x;
          ws[(4 * qd + 1) * kWsStride + c] = f.y;
          ws[(4 * qd + 2) * kWsStride + c] = f.z;
          ws[(4 * qd + 3) * kWsStride + c] = f.w;
        }
      }
      __syncthreads();
      if (cols_in) {
        // int8: 16 row loads in flight; fp32 reads shared memory, where a
        // shallower unroll keeps the 64 accumulators in registers
#pragma unroll(kInt8 ? 16 : 2)
        for (int dd = 0; dd < dn; ++dd) {
          float w0, w1, w2, w3;
          if (kInt8) {
            const char4 c = *reinterpret_cast<const char4*>(
                w8 + (size_t)(d0 + dd) * V + v0 + c0);
            w0 = c.x; w1 = c.y; w2 = c.z; w3 = c.w;
          } else {
            const float4 f =
                *reinterpret_cast<const float4*>(ws + dd * kWsStride + c0);
            w0 = f.x; w1 = f.y; w2 = f.z; w3 = f.w;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float hv = hs[r * kDChunk + dd];
            acc[r][0] += hv * w0;
            acc[r][1] += hv * w1;
            acc[r][2] += hv * w2;
            acc[r][3] += hv * w3;
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
        if (b < B && v < V) {
          float val = acc[r][j];
          if (kInt8) val = val * scale[v];
          if (mask != nullptr) {
            const int m = mask[(size_t)b * V + v];
            if (penalty != 1.f && (m & 1))
              val = val > 0.f ? val / penalty : val * penalty;
            if (m & 2) val = kBanned;
          }
          key = make_key(val, v);
        }
        keys[r * kTile + c0 + j] = key;
      }
    }
    __syncthreads();
    sort_segments(keys, kRows * kTile);
    merge_segments(keys, kRows * kTile / kSeg, kTile / kSeg);
    for (int i = threadIdx.x; i < kRows * kSeg; i += kThreads) {
      const int r = i / kSeg, j = i % kSeg, b = b0 + r;
      if (b < B) cand[((size_t)b * n_tiles + tile) * kSeg + j] = keys[r * kTile + j];
    }
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

template <bool kInt8>
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      head_tile_topk<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)TileShape<kInt8>::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(head_merge,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMergeSegs * kSeg * (int)sizeof(u64));
  done = err == cudaSuccess;
  return err;
}

}  // namespace

extern "C" {

int lmhead_topk_tile() { return kTile; }

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
  cudaError_t err;
  if (w8 != nullptr) {
    err = configure<true>();
    if (err != cudaSuccess) return (int)err;
    head_tile_topk<true><<<n_tiles, kThreads, TileShape<true>::kSmem, stream>>>(
        h, nullptr, w8, scale, mask, penalty, c, B, D, V, n_tiles);
  } else {
    err = configure<false>();
    if (err != cudaSuccess) return (int)err;
    head_tile_topk<false><<<n_tiles, kThreads, TileShape<false>::kSmem, stream>>>(
        h, w, nullptr, nullptr, mask, penalty, c, B, D, V, n_tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_merge<<<B, kMergeThreads, kMergeSegs * kSeg * sizeof(u64), stream>>>(
      c, vals, idx, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
