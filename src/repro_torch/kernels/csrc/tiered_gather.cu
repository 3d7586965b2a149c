// B5 / B6: the weighted gather from the tiered store's device cache,
// through the shard -> slot indirection
//   r = slot_table[gid >> log2 R] * R + (gid & (R - 1))
//   B5:  out[t] = sum_k w[t,k] * cache[r]                  (fp32 rows)
//   B6:  out[t] = sum_k (w[t,k] * scale[r]) * cache[r]     (int8 / e4m3
//        rows, per-row fp32 scales gathered through the same r)
//
// Replaces the TPU kernels src/repro/kernels/tiered_gather.py
// (tiered_gather_pallas, pallas_call at :91; tiered_gather_quant_pallas,
// pallas_call at :162), which chase the indirection in the BlockSpec
// index_map from scalar-prefetched SMEM and DMA one cached row per grid
// step.
//
// Bound on an H100: bytes.  Each distinct row the indices name is read
// once (4m bytes for B5, m + 4 for B6), plus n*k*8 bytes of indices and
// weights and 4*n*m of output, at 3.35 TB/s; the slot table (4 bytes per
// shard) is negligible.
//
// Design: the warp-per-row gather of gather_rows.cuh with the SlotRows
// map.  Each lane translates its own global index (a shift, a mask and one
// read of the slot table, which stays in L1) once, before the warp
// broadcast, so the indirection costs one extra small load per (t, k) and
// nothing per column.  Every touched shard must be resident: the wrapper
// refuses a call the store has not found fully resident, and a row whose
// slot is -1 comes out NaN rather than reading out of bounds.

#include "gather_rows.cuh"

__global__ void __launch_bounds__(gather_rows::kWarps * 32)
tiered_gather_kernel(const float* __restrict__ cache,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m, gather_rows::SlotRows rows) {
  gather_rows::gather_rows<float, false>(cache, nullptr, idx, w, out, n,
                                         top_k, m, rows);
}

template <typename T>
__global__ void __launch_bounds__(gather_rows::kWarps * 32)
tiered_gather_quant_kernel(const T* __restrict__ cache,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int top_k, int m,
                           gather_rows::SlotRows rows) {
  gather_rows::gather_rows<T, true>(cache, scale, idx, w, out, n, top_k, m,
                                    rows);
}

extern "C" int tiered_gather_f32(const void* cache, const void* idx,
                                 const void* slot_table, const void* w,
                                 void* out, int n, int top_k, int m,
                                 int log2r, int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const gather_rows::SlotRows rows{
        static_cast<const int32_t*>(slot_table), log2r};
    tiered_gather_kernel<<<gather_rows::blocks_for(n),
                           gather_rows::kWarps * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cache), static_cast<const int32_t*>(idx),
        static_cast<const float*>(w), static_cast<float*>(out), n, top_k, m,
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_quant(const void* cache, const void* scale, const void* idx,
                        const void* slot_table, const void* w, void* out,
                        int n, int top_k, int m, int log2r, int device,
                        void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const gather_rows::SlotRows rows{
        static_cast<const int32_t*>(slot_table), log2r};
    tiered_gather_quant_kernel<T><<<gather_rows::blocks_for(n),
                                    gather_rows::kWarps * 32, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(cache), static_cast<const float*>(scale),
        static_cast<const int32_t*>(idx), static_cast<const float*>(w),
        static_cast<float*>(out), n, top_k, m, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tiered_gather_quant_i8(const void* cache, const void* scale,
                                      const void* idx, const void* slot_table,
                                      const void* w, void* out, int n,
                                      int top_k, int m, int log2r, int device,
                                      void* stream) {
  return launch_quant<int8_t>(cache, scale, idx, slot_table, w, out, n,
                              top_k, m, log2r, device, stream);
}

extern "C" int tiered_gather_quant_e4m3(const void* cache, const void* scale,
                                        const void* idx,
                                        const void* slot_table, const void* w,
                                        void* out, int n, int top_k, int m,
                                        int log2r, int device, void* stream) {
  return launch_quant<__nv_fp8_e4m3>(cache, scale, idx, slot_table, w, out,
                                     n, top_k, m, log2r, device, stream);
}
