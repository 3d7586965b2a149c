// K1: weighted row gather  out[t] = sum_k w[t,k] * values[idx[t,k]]  (fp32).
//
// Replaces the TPU kernel src/repro/kernels/gather_interp.py
// (gather_interp_pallas, _kernel; pallas_call at :73), which DMAs one
// value row per grid step through scalar-prefetched indices and
// accumulates in VMEM.
//
// Bound on an H100: bytes.  Each distinct row the indices name is read
// once (4m bytes), plus n*k*8 bytes of indices and weights and 4*n*m of
// output, at 3.35 TB/s.  The 2*n*k*m flops are far below the fp32 rate.
//
// Design: the warp-per-row gather of gather_rows.cuh on an fp32 table with
// the identity row map (float2 per lane: one 256-byte read per row at
// m = 64).  idx must lie in [0, N).

#include "gather_rows.cuh"

__global__ void __launch_bounds__(gather_rows::kWarps * 32)
gather_interp_kernel(const float* __restrict__ values,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m) {
  gather_rows::gather_rows<float, false>(values, nullptr, idx, w, out, n,
                                         top_k, m, gather_rows::DirectRows{});
}

extern "C" int gather_interp_f32(const void* values, const void* idx,
                                 const void* w, void* out, int n, int top_k,
                                 int m, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    gather_interp_kernel<<<gather_rows::blocks_for(n),
                           gather_rows::kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(values), static_cast<const int32_t*>(idx),
        static_cast<const float*>(w), static_cast<float*>(out), n, top_k, m);
  }
  return static_cast<int>(cudaGetLastError());
}
