// Decode attention over a per-token, per-head int8 KV cache.
//
// Replaces the Pallas kernel tsue_tpu/ops/kv_quant.py:147 (_attend_kernel,
// launched by _attend_int8_impl at :186).  For each batch row b, query step t
// and query head j (KV head h = j / G):
//   k = k8[b, s, h] * ks[b, s, h],  v = v8[b, s, h] * vs[b, s, h]   (fp32)
//   logit[s] = (q . k) * scale, or -1e30 where mask[b, s] == 0
//   p = exp(logit - max) / max(sum exp(logit - max), 1e-30)
//   out[b, t, j] = sum_s p[s] * v
// so a row with no valid key is the uniform average of v, as in the Pallas
// kernel.  q and out are (B, Tq, Hq, D) fp32; k8/v8 (B, S, Hkv, D) int8;
// ks/vs (B, S, Hkv) fp32; mask (B, S) int32 (or null: every key valid).
//
// What bounds it on an H100: one decode step reads the int8 cache once,
// about 2 * S * Hkv * D bytes per row plus the scales, with a handful of
// flops per byte, so it is a stream of the cache bytes.  The design:
//   - one CTA (4 warps) per (KV head, row, query step) serves all G query
//     heads of that KV head, so each cache row is read from memory once;
//   - pass 1: a thread per key loads the key's D int8 values with 16-byte
//     loads, dequantises in registers and writes the G logits to shared
//     memory;
//   - the softmax of each query head runs inside one warp (max, exp, sum,
//     divide), two-pass over the logits in shared memory;
//   - pass 2: the CTA stages 64 value rows at a time in shared memory
//     (16-byte int8 loads, dequantised on the way in), and a thread per
//     (query head, dimension) accumulates them against the probabilities,
//     which it reads as a shared-memory broadcast.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/kv_quant.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 8;
constexpr int kKeys = 64;        // value rows staged per pass-2 chunk
constexpr float kMasked = -1e30f;

template <int D>
__global__ void __launch_bounds__(kThreads)
attend_int8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                   const float* __restrict__ ks,
                   const int8_t* __restrict__ v8,
                   const float* __restrict__ vs,
                   const int32_t* __restrict__ mask, float* __restrict__ out,
                   int Tq, int S, int Hq, int Hkv, float scale) {
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  const int h = blockIdx.x, b = blockIdx.y, t = blockIdx.z;
  float* qs = smem;           // [G][D]
  float* p = smem + G * D;    // [G][S], then the value chunk
  const size_t q_off = ((size_t)(b * Tq + t) * Hq + (size_t)h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) qs[i] = q[q_off + i];
  __syncthreads();

  // pass 1: logits of every key for the G query heads
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const size_t row = ((size_t)b * S + s) * Hkv + h;
    float dot[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) dot[g] = 0.f;
    const float ksc = ks[row];
    const int4* kp = reinterpret_cast<const int4*>(k8 + row * D);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int4 raw = kp[c];
      const int8_t* kb = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float kf = (float)kb[e] * ksc;
        const int d = c * 16 + e;
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
          if (g < G) dot[g] += qs[g * D + d] * kf;
      }
    }
    const bool valid = mask == nullptr || mask[(size_t)b * S + s] > 0;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g)
      if (g < G) p[g * S + s] = valid ? dot[g] * scale : kMasked;
  }
  __syncthreads();

  // softmax of each query head inside one warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kWarps) {
    float* pg = p + (size_t)g * S;
    float m = kMasked;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, pg[s]);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int s = lane; s < S; s += 32) {
      const float e = expf(pg[s] - m);
      pg[s] = e;
      sum += e;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float denom = fmaxf(sum, 1e-30f);
    for (int s = lane; s < S; s += 32) pg[s] = pg[s] / denom;
  }
  __syncthreads();

  // pass 2: probabilities against the values, kKeys keys at a time: the
  // CTA loads a chunk of int8 value rows with 16-byte loads, dequantises it
  // into shared memory, and each thread accumulates its (head, dimension)
  // outputs from there
  float* vsm = p + (size_t)G * S;   // [kKeys][D]
  constexpr int kTasks = kMaxGroups * D / kThreads + 1;   // per thread
  float acc[kTasks];
#pragma unroll
  for (int i = 0; i < kTasks; ++i) acc[i] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kKeys) {
    const int n = min(kKeys, S - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < n * (D / 16); i += kThreads) {
      const int key = i / (D / 16), c = i % (D / 16);
      const size_t row = ((size_t)b * S + s0 + key) * Hkv + h;
      const int4 raw = reinterpret_cast<const int4*>(v8 + row * D)[c];
      const int8_t* vb = reinterpret_cast<const int8_t*>(&raw);
      const float vsc = vs[row];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        vsm[key * D + c * 16 + e] = (float)vb[e] * vsc;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      const int task = threadIdx.x + i * kThreads;
      if (task >= G * D) break;
      const int g = task / D, d = task % D;
      const float* pg = p + (size_t)g * S + s0;
      float a = acc[i];
      for (int key = 0; key < n; ++key) a += pg[key] * vsm[key * D + d];
      acc[i] = a;
    }
  }
#pragma unroll
  for (int i = 0; i < kTasks; ++i) {
    const int task = threadIdx.x + i * kThreads;
    if (task < G * D) out[q_off + task] = acc[i];
  }
}

template <int D>
int launch(const float* q, const int8_t* k8, const float* ks,
           const int8_t* v8, const float* vs, const int32_t* mask,
           float* out, int B, int Tq, int S, int Hq, int Hkv, float scale,
           cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        attend_int8_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int G = Hq / Hkv;
  const size_t smem = ((size_t)G * (D + S) + (size_t)kKeys * D) * sizeof(float);
  const dim3 grid(Hkv, B, Tq);
  attend_int8_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k8, ks, v8, vs, mask, out, Tq, S, Hq, Hkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest shared-memory footprint the kernel may take, in bytes; the caller
// checks (G * (D + S) + 64 * D) * 4 against it.
int attend_int8_kv_max_smem() { return 227 * 1024; }

int attend_int8_kv_max_groups() { return kMaxGroups; }

// Returns a cudaError_t (0 on success), or -1 for a head dim it has no
// instance for.  Needs D in {16, 32, 64, 128}, Hkv dividing Hq with
// Hq / Hkv <= 8, 16-byte aligned k8 rows.
int attend_int8_kv(const float* q, const int8_t* k8, const float* ks,
                   const int8_t* v8, const float* vs, const int32_t* mask,
                   float* out, int B, int Tq, int S, int Hq, int Hkv, int D,
                   float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, scale, stream);
    case 32: return launch<32>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, scale, stream);
    case 64: return launch<64>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, scale, stream);
    case 128: return launch<128>(q, k8, ks, v8, vs, mask, out, B, Tq, S, Hq, Hkv, scale, stream);
    default: return -1;
  }
}

}  // extern "C"
