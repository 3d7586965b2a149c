// K1: weighted row gather  out[t] = sum_k w[t,k] * values[idx[t,k]]  (fp32).
//
// Replaces the TPU kernel src/repro/kernels/gather_interp.py
// (gather_interp_pallas, _kernel; pallas_call at :73), which DMAs one
// value row per grid step through scalar-prefetched indices and
// accumulates in VMEM.
//
// Bound on an H100: bytes.  Per query row it reads k indices and weights
// (8 B each pair) and k value rows of 4m bytes, and writes one 4m-byte
// row: n*k*(4m + 8) + 4*n*m bytes at 3.35 TB/s.  The 2*n*k*m flops are
// far below the fp32 rate.
//
// Design: one warp per query row (grid-stride over rows).  Lane l loads
// idx[t, l] and w[t, l] once (32 at a time) and the warp broadcasts them
// with __shfl_sync, so every value row is read by the whole warp as one
// coalesced 256-byte transaction at m = 64 (a float2 per lane).  The sum
// stays in fp32 registers; the output row is written once.  Rows wider
// than 64 columns loop over 64-column chunks.  idx must lie in [0, N).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
gather_interp_kernel(const float* __restrict__ values,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec2 = (m % 2) == 0;  // float2 loads stay 8-byte aligned
  for (int t = blockIdx.x * kWarps + warp; t < n;
       t += gridDim.x * kWarps) {
    const int32_t* it = idx + (size_t)t * top_k;
    const float* wt = w + (size_t)t * top_k;
    for (int c0 = 0; c0 < m; c0 += 64) {
      const int c = c0 + 2 * lane;
      float ax = 0.f, ay = 0.f;
      for (int kb = 0; kb < top_k; kb += 32) {
        const int kk = kb + lane;
        const int my_i = kk < top_k ? it[kk] : 0;
        const float my_w = kk < top_k ? wt[kk] : 0.f;
        const int cnt = min(32, top_k - kb);
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const int row = __shfl_sync(kFull, my_i, j);
          const float wj = __shfl_sync(kFull, my_w, j);
          const float* vr = values + (size_t)row * m;
          if (vec2 && c + 1 < m) {
            const float2 v = *reinterpret_cast<const float2*>(vr + c);
            ax = fmaf(wj, v.x, ax);
            ay = fmaf(wj, v.y, ay);
          } else {
            if (c < m) ax = fmaf(wj, vr[c], ax);
            if (c + 1 < m) ay = fmaf(wj, vr[c + 1], ay);
          }
        }
      }
      float* ot = out + (size_t)t * m;
      if (c < m) ot[c] = ax;
      if (c + 1 < m) ot[c + 1] = ay;
    }
  }
}

}  // namespace

extern "C" int gather_interp_f32(const void* values, const void* idx,
                                 const void* w, void* out, int n, int top_k,
                                 int m, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const int blocks = min((n + kWarps - 1) / kWarps, 65535);
    gather_interp_kernel<<<blocks, kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(idx),
        static_cast<const float*>(w), static_cast<float*>(out), n, top_k, m);
  }
  return static_cast<int>(cudaGetLastError());
}
