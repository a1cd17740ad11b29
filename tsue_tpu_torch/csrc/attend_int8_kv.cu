// Decode attention over a per-token, per-head int8 KV cache.
//
// Replaces the Pallas kernel tsue_tpu/ops/kv_quant.py:147 (_attend_kernel,
// launched by _attend_int8_impl at :186).  For each batch row b, query step t
// and query head j (KV head h = j / G):
//   k = k8[b, s, h] * ks[b, s, h],  v = v8[b, s, h] * vs[b, s, h]   (fp32)
//   logit[s] = (q . k) * scale, or -1e30 where the mask hides s from (b, t)
//   p = exp(logit - max) / max(sum exp(logit - max), 1e-30)
//   out[b, t, j] = sum_s p[s] * v
// so a row with no valid key is the uniform average of v, as in the Pallas
// kernel.  q and out are (B, Tq, Hq, D) fp32; k8/v8 (B, S, Hkv, D) int8;
// ks/vs (B, S, Hkv) fp32; mask int32 (or null: every key valid), read at
// mask[b * (mq ? Tq * mq : S) + t * mq + s] with mq, its query stride, 0
// for a (B, S) key mask (decode steps) and S for a (B, Tq, S) per-query
// mask (the Pallas kernel's (1, Tq, S) mask block; a speculative window's
// in-window causality).  A key mask gives the bits it gave before the
// stride existed: the same loads, the same arithmetic.
//
// What bounds it on an H100: one decode step reads the int8 cache once,
// 2 * S * Hkv * D bytes a row plus the scales, with a few flops a byte: at
// B = 16, S = 592, 8 KV heads of 64 that is 10.6 MB, 3.2 us at 3.35 TB/s.
// Only 128 (row, KV head) pairs exist, under one per SM, so the time is set
// by how many bytes are in flight and by the latency of each block's chain
// of steps.  The design (split-S, flash-decoding):
//   - a thread block cluster of C CTAs (C = ceil(S / 32), at most 4) owns
//     one (row, query step, KV head); CTA r owns keys [r * per, (r+1) * per)
//     with per = ceil(S / C) and serves all G query heads, so each cache row
//     is read from memory once.  At the decode shape that is 512 CTAs of 4
//     warps (148 keys each at S = 592), all resident at once; 8 splits of
//     74 keys were slower on the card (the merge and the cluster barriers
//     cost more than the shorter chains save);
//   - each CTA issues every copy of its slice at once (16-byte cp.async for
//     the int8 K and V rows, 4-byte copies for q, the scales and the mask),
//     then waits once.  Every slot is read, masked or not;
//   - logits: a thread per key, 16 dims at a time against the G query heads
//     (q read as a shared-memory broadcast); K rows are padded to D + 16
//     bytes so a warp's 16-byte reads of 32 keys spread over the banks.
//     int8 values become fp32 by a byte permute and one subtraction, not by
//     the conversion unit (16 results a clock an SM);
//   - the slice's softmax runs a warp per head (local max m, sum l, and p *
//     vs in place); then a thread owns 4 dims of every head over every
//     (128 / (D / 4))-th key, so each V word is converted once, and the key
//     lanes are added by shuffles and then in warp order: acc;
//   - the merge: after a cluster barrier each CTA finishes a slice of the G
//     * D outputs, reading every rank's (m, l, acc) through distributed
//     shared memory in rank order: out = sum_r w_r acc_r / max(sum_r w_r
//     l_r, 1e-30), w_r = exp(m_r - max_r m_r).  One launch, no scratch in
//     device memory, no atomics: a repeated call is bit-identical;
//   - the -1e30 rule across splits: a split with no valid key reports m =
//     -1e30, l = its key count and acc = the sum of its V rows, so a row
//     with a valid key elsewhere weighs it by exp(-1e30 - m) = 0, and a row
//     with no valid key anywhere gets the uniform mean over all S slots.
//
// On an H100 80GB HBM3 at 700 W (chip_smoke.py's kernel phase, L2 flushed,
// B = 16, 32/8 heads of 64): 0.016 / 0.018 / 0.021 ms at S = 336 / 464 /
// 592 (the CTA-per-(row, KV head) kernel it replaces took 0.049 / 0.063 /
// 0.078; bytes bound 0.002-0.003), of which ~5.5 us is the timer's floor
// (chip_smoke.py prints it).  A speculative window with a (B, W, S) mask
// runs a cluster per query step, each re-reading its slice: 0.068 ms at W =
// 8, S = 600 and 0.042 at W = 4, S = 596 (operations bound 0.009 / 0.005).
//
// ptxas (nvcc -Xptxas -v, sm_90a), no spills: attend_int8_kernel<D> uses
// 55 / 56 / 56 / 64 registers at D = 16 / 32 / 64 / 128.  Its dynamic
// shared memory follows the slice (attend_int8_kv_plan): 30.9 KB at S =
// 592, D = 64, G = 4.
//
// The bf16 form (a bf16 model's decode: the Pallas kernel widens a bf16 q to
// fp32 and writes out in q's dtype, tsue_tpu/ops/kv_quant.py:147-175): q is
// bf16, loaded and widened to fp32 into the same shared-memory slot, every
// step after the load is the fp32 kernel's, and the output is rounded once
// to bf16 as it is stored.  The masks, the plan and the launch are the fp32
// form's; ptxas gives the bf16 instantiations the fp32 ones' registers (55-56
// at D <= 64, 64 at D = 128), no spills.  On an H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 14, L2 flushed): 0.020 ms at B = 16, S = 224, 32/8
// heads of 64, within one bf16 ulp of the plain version.
//
// C interface (loaded with ctypes by tsue_tpu_torch/ops/kv_quant.py):
// attend_int8_kv_plan(...) reports the launch plan (-1 for a shape the kernel
// does not take), attend_int8_kv(...) returns cudaGetLastError() after the
// one launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kMaxSplits = 4;        // more, shorter splits measured slower
constexpr int kKeysPerSplit = 32;    // fewest keys a split is given
constexpr int kMaxSmem = 227 * 1024;
constexpr float kMasked = -1e30f;

__host__ __device__ constexpr int up16(int n) { return (n + 15) & ~15; }

// Byte offsets of a CTA's shared memory for G heads, head dim D and a slice
// of `per` keys.
struct Layout {
  int q, part, ksc, vsc, valid, p, k, v, red, total;
  __host__ __device__ Layout(int G, int D, int per) {
    q = 0;
    part = q + up16(G * D * 4);                  // m[G], l[G], acc[G][D]
    ksc = part + up16((2 * G + G * D) * 4);
    vsc = ksc + up16(per * 4);
    valid = vsc + up16(per * 4);
    p = valid + up16(per * 4);                   // [G][per]
    k = p + up16(G * per * 4);                   // [per][D + 16] int8
    v = k + up16(per * (D + 16));
    red = v + up16(per * D);                     // [kWarps][G][D]
    total = red + up16(kWarps * G * D * 4);
  }
};

struct Plan {
  int splits, per, smem;
};

Plan make_plan(int S, int G, int D) {
  Plan p;
  int c = (S + kKeysPerSplit - 1) / kKeysPerSplit;
  p.splits = c < 1 ? 1 : (c > kMaxSplits ? kMaxSplits : c);
  p.per = (S + p.splits - 1) / p.splits;
  p.smem = Layout(G, D, p.per).total;
  return p;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Four int8 values packed in a word -> fp32, exactly, without the conversion
// unit (16 results a clock an SM): each byte, biased to b + 128, becomes the
// low mantissa byte of 2^23 (one byte permute), and one fp32 subtraction of
// 2^23 + 128 leaves b.
__device__ __forceinline__ void unpack4(int v, float* f) {
  const unsigned u = static_cast<unsigned>(v) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

typedef __nv_bfloat16 bf16;

// QT: q's and out's type, fp32 or bf16.
template <int D, typename QT>
__global__ void __launch_bounds__(kThreads)
attend_int8_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k8,
                   const float* __restrict__ ks,
                   const int8_t* __restrict__ v8,
                   const float* __restrict__ vs,
                   const int32_t* __restrict__ mask, QT* __restrict__ out,
                   int Tq, int S, int Hq, int Hkv, int per, int mq,
                   float scale) {
  static_assert(std::is_same_v<QT, float> || std::is_same_v<QT, bf16>,
                "q is fp32 or bf16");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hkv;
  const int h = blockIdx.y, bt = blockIdx.z, b = bt / Tq;
  // this (row, query step)'s mask row: row b's key mask, or its own
  const size_t m_off = mq ? (size_t)bt * mq : (size_t)b * S;
  const int s0 = min(S, rank * per);
  const int n = min(S, s0 + per) - s0;
  const Layout L(G, D, per);
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  int* valid = reinterpret_cast<int*>(smem + L.valid);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  int8_t* k_s = reinterpret_cast<int8_t*>(smem + L.k);
  int8_t* v_s = reinterpret_cast<int8_t*>(smem + L.v);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t q_off = ((size_t)bt * Hq + (size_t)h * G) * D;
  constexpr int CH = D / 16;              // 16-byte chunks of a cache row

  // every copy of the slice in flight at once
  if constexpr (std::is_same_v<QT, float>) {
    for (int i = tid; i < G * D; i += kThreads) cp4(q_s + i, q + q_off + i);
  }
  for (int i = tid; i < n * CH; i += kThreads) {
    const int key = i / CH, c = (i % CH) * 16;
    const size_t row = ((size_t)b * S + s0 + key) * Hkv + h;
    cp16(k_s + key * (D + 16) + c, k8 + row * D + c);
    cp16(v_s + key * D + c, v8 + row * D + c);
  }
  for (int i = tid; i < n; i += kThreads) {
    const size_t row = ((size_t)b * S + s0 + i) * Hkv + h;
    cp4(ksc + i, ks + row);
    cp4(vsc + i, vs + row);
    if (mask != nullptr)
      cp4(valid + i, mask + m_off + s0 + i);
    else
      valid[i] = 1;
  }
  asm volatile("cp.async.commit_group;\n" ::);
  if constexpr (std::is_same_v<QT, bf16>) {   // loaded and widened, exactly
    for (int i = tid; i < G * D; i += kThreads)
      q_s[i] = __bfloat162float(q[q_off + i]);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // logits: a thread per key, 16 dims at a time against the G query heads
  // (q read as a broadcast); K rows are padded to D + 16 bytes so a warp's
  // 16-byte reads of 32 keys spread over the banks
  for (int key = tid; key < n; key += kThreads) {
    float dot[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) dot[g] = 0.f;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int4 raw =
          *reinterpret_cast<const int4*>(k_s + key * (D + 16) + c * 16);
      float kf[16];
      unpack4(raw.x, kf);
      unpack4(raw.y, kf + 4);
      unpack4(raw.z, kf + 8);
      unpack4(raw.w, kf + 12);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g >= G) break;
        const float4* qv =
            reinterpret_cast<const float4*>(q_s + g * D + c * 16);
        float a = dot[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 q4 = qv[e];
          a = fmaf(q4.x, kf[4 * e], a);
          a = fmaf(q4.y, kf[4 * e + 1], a);
          a = fmaf(q4.z, kf[4 * e + 2], a);
          a = fmaf(q4.w, kf[4 * e + 3], a);
        }
        dot[g] = a;
      }
    }
    const bool ok = valid[key] > 0;
    const float s = ksc[key] * scale;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < G) p_s[g * per + key] = ok ? dot[g] * s : kMasked;
  }
  __syncthreads();

  // the slice's softmax, a warp per head: m, l, and p * vs in place
  float* m_s = part;
  float* l_s = part + G;
  float* acc_s = part + 2 * G;
  for (int g = warp; g < G; g += kWarps) {
    float* pg = p_s + g * per;
    float m = kMasked;
    for (int s = lane; s < n; s += 32) m = fmaxf(m, pg[s]);
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = lane; s < n; s += 32) {
      const float e = expf(pg[s] - m);
      pg[s] = e * vsc[s];
      l += e;
    }
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  __syncthreads();

  // acc[g][d] = sum over the slice of (p * vs)[g][s] * v8[s][d]: a thread
  // owns 4 dims of every head over the keys s = j (mod NJ), each V word
  // converted once; the key lanes of a warp are added by shuffles, then the
  // warps in warp order
  constexpr int DL = D / 4;               // lanes across the dims
  constexpr int NJ = kThreads / DL;       // key lanes
  float a[kMaxGroups][4];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[g][e] = 0.f;
  }
  const int d4 = (tid % DL) * 4;
  for (int s = tid / DL; s < n; s += NJ) {
    float vf[4];
    unpack4(*reinterpret_cast<const int*>(v_s + s * D + d4), vf);
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g >= G) break;
      const float pv = p_s[g * per + s];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[g][e] = fmaf(pv, vf[e], a[g][e]);
    }
  }
  float* red = reinterpret_cast<float*>(smem + L.red);
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int o = DL; o < 32; o <<= 1)
        a[g][e] += __shfl_xor_sync(0xffffffffu, a[g][e], o);
    }
    if (lane < DL)
      *reinterpret_cast<float4*>(red + (warp * G + g) * D + d4) =
          make_float4(a[g][0], a[g][1], a[g][2], a[g][3]);
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float t = red[i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += red[w * G * D + i];
    acc_s[i] = t;
  }

  // merge the cluster's splits in rank order; rank r writes a slice
  cluster.sync();
  const int chunk = (G * D + C - 1) / C;
  const int e_end = min(G * D, (rank + 1) * chunk);
  for (int e = rank * chunk + tid; e < e_end; e += kThreads) {
    const int g = e / D;
    float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r >= C) break;
      const float* pr = cluster.map_shared_rank(part, r);
      mr[r] = pr[g];
      lr[r] = pr[G + g];
      ar[r] = pr[2 * G + e];
    }
    float M = kMasked;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r)
      if (r < C) M = fmaxf(M, mr[r]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r >= C) break;
      const float w = expf(mr[r] - M);
      l = fmaf(lr[r], w, l);
      o = fmaf(ar[r], w, o);
    }
    const float r = o / fmaxf(l, 1e-30f);
    if constexpr (std::is_same_v<QT, float>)
      out[q_off + e] = r;
    else
      out[q_off + e] = __float2bfloat16_rn(r);
  }
  cluster.sync();   // no rank leaves while another reads its partials
}

template <int D, typename QT>
int launch(const void* q, const int8_t* k8, const float* ks,
           const int8_t* v8, const float* vs, const int32_t* mask,
           void* out, int B, int Tq, int S, int Hq, int Hkv, int mq,
           float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attend_int8_kernel<D, QT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const Plan p = make_plan(S, Hq / Hkv, D);
  if (p.smem > kMaxSmem) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.splits, (unsigned)Hkv, (unsigned)(B * Tq));
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, attend_int8_kernel<D, QT>, static_cast<const QT*>(q), k8, ks,
      v8, vs, mask, static_cast<QT*>(out), Tq, S, Hq, Hkv, p.per, mq, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int launch_d(const void* q, const int8_t* k8, const float* ks,
             const int8_t* v8, const float* vs, const int32_t* mask,
             void* out, int B, int Tq, int S, int Hq, int Hkv, int D, int mq,
             float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, QT>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, mq, scale, stream);
    case 32: return launch<32, QT>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, mq, scale, stream);
    case 64: return launch<64, QT>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, mq, scale, stream);
    case 128: return launch<128, QT>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, mq, scale, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

int attend_int8_kv_max_groups() { return kMaxGroups; }

// The launch plan for a cache of S slots, G query heads a KV head and head
// dim D: field 0 the splits (the cluster size), 1 the keys a split, 2 the
// shared memory a CTA asks for in bytes.  -1 when the slice does not fit
// the shared memory (or for another field).
int attend_int8_kv_plan(int S, int G, int D, int field) {
  const Plan p = make_plan(S, G, D);
  if (p.smem > kMaxSmem) return -1;
  switch (field) {
    case 0: return p.splits;
    case 1: return p.per;
    case 2: return p.smem;
    default: return -1;
  }
}

// Returns a cudaError_t (0 on success), or -1 for a shape it does not take.
// q and out are fp32 (q_bf16 = 0) or bf16 (q_bf16 = 1).  Needs D in {16,
// 32, 64, 128}, Hkv dividing Hq with Hq / Hkv <= 8, B * Tq <= 65535,
// 16-byte aligned k8 and v8, and mq (the mask's query stride) 0 or S.
int attend_int8_kv(const void* q, const int8_t* k8, const float* ks,
                   const int8_t* v8, const float* vs, const int32_t* mask,
                   void* out, int B, int Tq, int S, int Hq, int Hkv, int D,
                   int mq, float scale, int q_bf16, cudaStream_t stream) {
  if (mq != 0 && mq != S) return -1;
  return q_bf16 ? launch_d<bf16>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq,
                                 Hkv, D, mq, scale, stream)
                : launch_d<float>(q, k8, ks, v8, vs, mask, out, B, Tq, S,
                                  Hq, Hkv, D, mq, scale, stream);
}

}  // extern "C"
