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
// Design: gather_batched.cuh's body (K1's) with the identity row map.
// The old body (warp per query, once in gather_rows.cuh) made about five
// dependent round trips a query, with a conversion beside each load and
// 16 blocks at n = 128.  Here lane l gathers the scale of its own index
// and folds it into its weight (one fp32 product, the Pallas body's
// order) before the warp broadcast, and the raw 1-byte payload is
// converted to fp32 (int8 by a plain conversion, e4m3 by __nv_fp8x2_e4m3
// -> float2, exact) only after a batch's loads are out.  Two layouts:
//   * wide (gather_batched.cuh's kWide; m % 8 == 0 and an 8-byte aligned
//     table): 8 bytes a lane, so one warp load serves 4 rows at m = 64 and
//     8 loads put a query's 32 rows in flight at once; the split leaves
//     each warp 32 candidates (one batch: at top-32 one warp a query).
//     It ran 1.3-2.0x the byte pairs' speed from n = 2,048 on, and at
//     n = 128 one warp a query with it beat byte pairs at any split
//     (tools/kernel_ab.py --phases b4, PERF.md).  It adds in another order
//     (rtol 2e-5 / atol 1e-6 against the plain version);
//   * byte pairs (m even, a 2-byte aligned table) or single bytes: 8 row
//     loads in flight a warp, and at decode sizes a query split over up to
//     8 warps of a block (the split from n and the card's SM count).  With
//     one warp a query on byte pairs the output is bit-equal to the old
//     body's.
// One instance per layout, (split == 1) and payload.
// gather_interp_quant_{i8,e4m3}_split take the split and the layout
// explicitly, for tests and A/B runs.  idx must lie in [0, N).

#include <stdint.h>

#include "gather_batched.cuh"

template <typename T, bool kOneWarp, bool kPairs, bool kWide>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  gather_batched::kMinBlocks)
gather_interp_quant_kernel(const T* __restrict__ q,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int top_k, int m,
                           int split) {
  gather_batched::gather<T, true, kOneWarp, kPairs, kWide>(
      q, scale, idx, w, out, n, top_k, m, split, gather_rows::DirectRows{});
}

template <typename T, bool kOneWarp, bool kPairs, bool kWide>
static void launch_instance(const void* q, const void* scale,
                            const void* idx, const void* w, void* out, int n,
                            int top_k, int m, int split,
                            cudaStream_t stream) {
  gather_interp_quant_kernel<T, kOneWarp, kPairs, kWide>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const T*>(q), static_cast<const float*>(scale),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, split);
}

// wide: 1 for the wide loads where they fit, 0 for the pair loads.
template <typename T>
static int launch(const void* q, const void* scale, const void* idx,
                  const void* w, void* out, int n, int top_k, int m,
                  int split, int wide, cudaStream_t stream) {
  // pair loads stay aligned
  const bool pairs = m % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 2 == 0;
  if (wide && gather_batched::fits_wide(q, m)) {
    if (split == 1)
      launch_instance<T, true, true, true>(q, scale, idx, w, out, n, top_k,
                                           m, 1, stream);
    else
      launch_instance<T, false, true, true>(q, scale, idx, w, out, n, top_k,
                                            m, split, stream);
  } else if (split == 1 && pairs) {
    launch_instance<T, true, true, false>(q, scale, idx, w, out, n, top_k, m,
                                          1, stream);
  } else if (split == 1) {
    launch_instance<T, true, false, false>(q, scale, idx, w, out, n, top_k,
                                           m, 1, stream);
  } else if (pairs) {
    launch_instance<T, false, true, false>(q, scale, idx, w, out, n, top_k,
                                           m, split, stream);
  } else {
    launch_instance<T, false, false, false>(q, scale, idx, w, out, n, top_k,
                                            m, split, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_auto(const void* q, const void* scale, const void* idx,
                       const void* w, void* out, int n, int top_k, int m,
                       int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int per_warp =
      gather_batched::fits_wide(q, m)
          ? gather_batched::kBatch * gather_batched::kWideRows
          : 4;
  return launch<T>(q, scale, idx, w, out, n, top_k, m,
                   gather_batched::split_for(
                       n, top_k, gather_batched::sm_count(device), per_warp),
                   1, static_cast<cudaStream_t>(stream));
}

template <typename T>
static int launch_split(const void* q, const void* scale, const void* idx,
                        const void* w, void* out, int n, int top_k, int m,
                        int split, int wide, int device, void* stream) {
  cudaSetDevice(device);
  if (split != 1 && split != 2 && split != 4 && split != 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch<T>(q, scale, idx, w, out, n, top_k, m, split, wide,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int gather_interp_quant_i8(const void* q, const void* scale,
                                      const void* idx, const void* w,
                                      void* out, int n, int top_k, int m,
                                      int device, void* stream) {
  return launch_auto<int8_t>(q, scale, idx, w, out, n, top_k, m, device,
                             stream);
}

extern "C" int gather_interp_quant_e4m3(const void* q, const void* scale,
                                        const void* idx, const void* w,
                                        void* out, int n, int top_k, int m,
                                        int device, void* stream) {
  return launch_auto<__nv_fp8_e4m3>(q, scale, idx, w, out, n, top_k, m,
                                    device, stream);
}

// The same gather with an explicit split (1, 2, 4 or 8 warps a query) and
// variant (wide 1: the wide loads where they fit; 0: the pair loads).
extern "C" int gather_interp_quant_i8_split(const void* q, const void* scale,
                                            const void* idx, const void* w,
                                            void* out, int n, int top_k,
                                            int m, int split, int wide,
                                            int device, void* stream) {
  return launch_split<int8_t>(q, scale, idx, w, out, n, top_k, m, split, wide,
                              device, stream);
}

extern "C" int gather_interp_quant_e4m3_split(const void* q,
                                              const void* scale,
                                              const void* idx, const void* w,
                                              void* out, int n, int top_k,
                                              int m, int split, int wide,
                                              int device, void* stream) {
  return launch_split<__nv_fp8_e4m3>(q, scale, idx, w, out, n, top_k, m,
                                     split, wide, device, stream);
}
