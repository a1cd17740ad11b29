// Per-sample ADE and FDE in pixels, from normalised trajectories:
//   d_x[t] = (pred[b, 0, t] - gt[b, 0, t]) * (xmax - xmin)
//   d_y[t] = (pred[b, 1, t] - gt[b, 1, t]) * (ymax - ymin)
//   dist[t] = sqrt(d_x^2 + d_y^2 + 1e-12)
//   out[b] = (mean_t dist[t], dist[T-1])
//
// Replaces the Pallas kernel tsue_tpu/ops/metric_kernels.py:19
// (_ade_fde_kernel, launched by fused_ade_fde at :37).  pred, gt (B, 2, T)
// and norm_stat (B, 4) fp32, norm_stat laid out [xmin, xmax, ymin, ymax];
// out (B, 2) fp32.  The difference is taken before the denormalisation, as
// the Pallas kernel takes it (the offsets xmin, ymin cancel), and the 1e-12
// goes inside the square root.
//
// What bounds it on an H100: at B = 16..160, T <= 30 the call moves under
// 50 KB: a launch costs more than the work.  One warp per sample: each
// lane takes every 32nd step, the warp sums by shuffles in a fixed order,
// lane 0 writes the pair.  Plain C interface, loaded with ctypes by
// tsue_tpu_torch/ops/metric_kernels.py.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // samples per CTA

__global__ void __launch_bounds__(kWarps * 32)
ade_fde_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
               const float* __restrict__ stat, float* __restrict__ out, int B,
               int T) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* st = stat + (size_t)b * 4;
  const float rx = st[1] - st[0], ry = st[3] - st[2];
  const float* p = pred + (size_t)b * 2 * T;
  const float* g = gt + (size_t)b * 2 * T;
  float sum = 0.f, last = 0.f;
  for (int t = lane; t < T; t += 32) {
    const float dx = __fmul_rn(p[t] - g[t], rx);
    const float dy = __fmul_rn(p[T + t] - g[T + t], ry);
    const float dist =
        sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        1e-12f));
    sum += dist;
    if (t == T - 1) last = dist;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
    last += __shfl_xor_sync(0xffffffffu, last, off);
  }
  if (lane == 0) {
    out[(size_t)b * 2] = sum / (float)T;
    out[(size_t)b * 2 + 1] = last;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  pred, gt (B, 2, T), stat (B, 4),
// out (B, 2), all fp32 and contiguous; B, T > 0.
int ade_fde(const float* pred, const float* gt, const float* stat, float* out,
            int B, int T, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  ade_fde_kernel<<<grid, kWarps * 32, 0, stream>>>(pred, gt, stat, out, B, T);
  return (int)cudaGetLastError();
}

}  // extern "C"
