// B4: weighted gather over a quantized table with fused dequantization,
//   out[t] = sum_k (w[t,k] * scale[i]) * q[i],  i = idx[t,k]   (fp32 sum)
// over int8 or float8_e4m3fn payload rows with one fp32 scale per row.
//
// Replaces the TPU kernel src/repro/kernels/gather_interp.py
// (gather_interp_quant_pallas, _kernel_quant; pallas_call at :138), which
// DMAs each 1-byte row and its (1, 1) scale block per grid step and
// multiplies the scale into the weight in VMEM.
//
// Bound on an H100: bytes.  Each distinct row the indices name is read
// once (m + 4 bytes: payload and scale), plus n*k*8 bytes of indices and
// weights and 4*n*m of output, at 3.35 TB/s.
//
// Design: the warp-per-row gather of gather_rows.cuh with the identity row
// map.  Lane l gathers the scale of its own index and folds it into its
// weight (one fp32 product, the Pallas body's order) before the warp
// broadcast; each row is then one 64-byte read at m = 64 (two bytes per
// lane), converted to fp32 in registers: int8 by a plain conversion, e4m3
// pairs by __nv_fp8x2_e4m3 -> float2 (exact).  One template per payload.

#include "gather_rows.cuh"

template <typename T>
__global__ void __launch_bounds__(gather_rows::kWarps * 32)
gather_interp_quant_kernel(const T* __restrict__ q,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int top_k, int m) {
  gather_rows::gather_rows<T, true>(q, scale, idx, w, out, n, top_k, m,
                                    gather_rows::DirectRows{});
}

template <typename T>
static int launch(const void* q, const void* scale, const void* idx,
                  const void* w, void* out, int n, int top_k, int m,
                  int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    gather_interp_quant_kernel<T><<<gather_rows::blocks_for(n),
                                    gather_rows::kWarps * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const float*>(scale),
        static_cast<const int32_t*>(idx), static_cast<const float*>(w),
        static_cast<float*>(out), n, top_k, m);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_interp_quant_i8(const void* q, const void* scale,
                                      const void* idx, const void* w,
                                      void* out, int n, int top_k, int m,
                                      int device, void* stream) {
  return launch<int8_t>(q, scale, idx, w, out, n, top_k, m, device, stream);
}

extern "C" int gather_interp_quant_e4m3(const void* q, const void* scale,
                                        const void* idx, const void* w,
                                        void* out, int n, int top_k, int m,
                                        int device, void* stream) {
  return launch<__nv_fp8_e4m3>(q, scale, idx, w, out, n, top_k, m, device,
                               stream);
}
