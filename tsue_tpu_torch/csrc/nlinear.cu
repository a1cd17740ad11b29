// NLinear in one pass: for each row b and channel c,
//   out[b, c, o] = sum_t (x[b, c, t] - x[b, c, Ti-1]) * w[c, t, o]
//                  + bias[c, o] + x[b, c, Ti-1]
//
// Replaces the Pallas kernel tsue_tpu/ops/nlinear.py:31 (_nlinear_kernel,
// launched by nlinear_fused at :46).  x (B, C, Ti), w (C, Ti, To), bias
// (C, To) and out (B, C, To), all fp32; the sum over t runs in fp32 in
// order, then the bias and the last step are added, as the Pallas kernel
// does (dot, + b, + last).
//
// What bounds it on an H100: nothing the card can feel.  At the LTSF's
// shapes (C = 64, Ti = 18, To <= 30, B = 16 or 160) the call moves 0.1 to
// 1.5 MB and does at most 11 MFLOP, a microsecond of either; a launch costs
// more.  So the design is the plainest that reads each input once:
//   - one CTA per row b; it stages the row's (C, Ti) block in shared memory
//     (one read of x) and subtracts each channel's last step there;
//   - each thread computes outputs (c, o), striding over the C * To of
//     them: consecutive threads take consecutive o, so the reads of w[c, t,
//     o] and the writes of out are coalesced; w and bias (a few hundred KB)
//     come from L2 after the first rows.
// Plain C interface, loaded with ctypes by tsue_tpu_torch/ops/nlinear.py.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRow = 12288;       // C * Ti floats: 48 KB of shared memory

__global__ void __launch_bounds__(kThreads)
nlinear_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ bias, float* __restrict__ out,
               int C, int Ti, int To) {
  extern __shared__ float xs[];      // (C, Ti): x - last, then last at Ti-1
  const int b = blockIdx.x;
  const float* xr = x + (size_t)b * C * Ti;
  for (int i = threadIdx.x; i < C * Ti; i += kThreads) xs[i] = xr[i];
  __syncthreads();
  // x - last in place; the last step keeps its value, since its own
  // difference is 0 and adds nothing to the sum
  for (int i = threadIdx.x; i < C * Ti; i += kThreads) {
    const int c = i / Ti, t = i - c * Ti;
    if (t != Ti - 1) xs[i] -= xs[c * Ti + Ti - 1];
  }
  __syncthreads();
  float* orow = out + (size_t)b * C * To;
  for (int i = threadIdx.x; i < C * To; i += kThreads) {
    const int c = i / To, o = i - c * To;
    const float* xc = xs + c * Ti;
    const float* wc = w + (size_t)c * Ti * To + o;
    float acc = 0.f;
    for (int t = 0; t < Ti - 1; ++t) acc = fmaf(xc[t], wc[(size_t)t * To], acc);
    orow[i] = (acc + bias[i]) + xc[Ti - 1];
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  x (B, C, Ti), w (C, Ti, To), bias
// (C, To), out (B, C, To), all fp32 and contiguous; C * Ti <= kMaxRow.
int nlinear(const float* x, const float* w, const float* bias, float* out,
            int B, int C, int Ti, int To, cudaStream_t stream) {
  const size_t smem = (size_t)C * Ti * sizeof(float);
  nlinear_kernel<<<B, kThreads, smem, stream>>>(x, w, bias, out, C, Ti, To);
  return (int)cudaGetLastError();
}

int nlinear_max_row() { return kMaxRow; }

}  // extern "C"
