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
// shard, 512 B at full width) is negligible.  At n = 128, top-32, m = 64
// that is 0.00033 ms for B5 and 0.00010 for B6 (0.030 and 0.015 at
// n = 65,536 on a 32-slot cache).  Device time (tools/kernel_ab.py
// --phases b5,b6, NVIDIA H100 80GB HBM3, 700.00 W), 32-slot cache, n =
// 128 / 2,048 / 65,536: B5 0.0026 / 0.0053 / 0.115 ms, B6 int8 0.0027 /
// 0.0040 / 0.046, e4m3 0.0024 / 0.0035 / 0.048; the warp-per-query body
// these kernels ran before took 0.0076 / 0.0084 / 0.134 (B5) and 0.0082 /
// 0.0090 / 0.083 (B6 int8).
//
// Design: gather_batched.cuh's body, K1's for B5 and B4's for B6, with the
// SlotRows map.  Each lane maps its own candidate once, before the batch
// of row loads: the slot table read (it stays in L1) is the one dependent
// load K1 and B4 do not have, and nothing is spent per column.  B6 takes
// B4's wide loads (8 bytes a lane, 4 rows a load) where m % 8 == 0 and the
// cache is 8-byte aligned, but adds in candidate order (kInOrder: the
// rows pass through a tile in shared memory), so that its output does not
// depend on the layout (with weights that do not sum to 1, B4's 4-group
// order can stray past atol 1e-6 from the plain version's); B5 has no
// wide variant (a lane's fp32 pair already makes one load a 256-byte
// row).  So B5 at any split adds in exactly K1's order at that split, and
// B6 on either layout in B4's byte pairs' order; with one warp a query
// both are bit-equal to the old body.  The split (warps a query) comes
// from n and the card's SM count as for K1 and B4;
// tiered_gather_f32_split and tiered_gather_quant_{i8,e4m3}_split take it
// (and B6's layout) explicitly, for tests and A/B runs.  Every touched
// shard must be resident: the wrapper refuses a call the store has not
// found fully resident, and a row whose slot is -1 comes out NaN (its
// weight NaN, its scale not read, row 0 read in its place) rather than
// reading out of bounds.  A cache row must fit int32 (the wrapper refuses
// 2^31 rows or more).

#include <stdint.h>

#include "gather_batched.cuh"

// Blocks an SM for the instances with one warp a query on the path's
// layout (n >= 528): 5, so at most 48 registers, the occupancy K1's same
// instance has.  At 52 registers (4 blocks) B5 ran clustered queries at
// n = 65,536, which are L2-latency-bound, 5-7% slower than the old body
// and 11% slower than K1 on the same rows.
constexpr int kOneWarpMinBlocks = 5;

template <bool kOneWarp, bool kPairs>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  kOneWarp && kPairs
                                      ? kOneWarpMinBlocks
                                      : gather_batched::kMinBlocks)
tiered_gather_kernel(const float* __restrict__ cache,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n, int top_k, int m, int split,
                     gather_rows::SlotRows rows) {
  gather_batched::gather<float, false, kOneWarp, kPairs>(
      cache, nullptr, idx, w, out, n, top_k, m, split, rows);
}

template <typename T, bool kOneWarp, bool kPairs, bool kWide>
__global__ void __launch_bounds__(gather_batched::kThreads,
                                  kOneWarp && kWide
                                      ? kOneWarpMinBlocks
                                      : gather_batched::kMinBlocks)
tiered_gather_quant_kernel(const T* __restrict__ cache,
                           const float* __restrict__ scale,
                           const int32_t* __restrict__ idx,
                           const float* __restrict__ w,
                           float* __restrict__ out, int n, int top_k, int m,
                           int split, gather_rows::SlotRows rows) {
  // the wide loads in candidate order (kInOrder = kWide)
  gather_batched::gather<T, true, kOneWarp, kPairs, kWide, kWide>(
      cache, scale, idx, w, out, n, top_k, m, split, rows);
}

static gather_rows::SlotRows slot_rows(const void* slot_table, int log2r) {
  return {static_cast<const int32_t*>(slot_table), log2r};
}

template <bool kOneWarp, bool kPairs>
static void launch_f32_instance(const void* cache, const void* idx,
                                const void* slot_table, const void* w,
                                void* out, int n, int top_k, int m,
                                int log2r, int split, cudaStream_t stream) {
  tiered_gather_kernel<kOneWarp, kPairs>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const float*>(cache),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, split, slot_rows(slot_table, log2r));
}

static int launch_f32(const void* cache, const void* idx,
                      const void* slot_table, const void* w, void* out, int n,
                      int top_k, int m, int log2r, int split,
                      cudaStream_t stream) {
  const bool pairs = m % 2 == 0;  // pair loads stay aligned
  if (split == 1 && pairs)
    launch_f32_instance<true, true>(cache, idx, slot_table, w, out, n, top_k,
                                    m, log2r, 1, stream);
  else if (split == 1)
    launch_f32_instance<true, false>(cache, idx, slot_table, w, out, n, top_k,
                                     m, log2r, 1, stream);
  else if (pairs)
    launch_f32_instance<false, true>(cache, idx, slot_table, w, out, n, top_k,
                                     m, log2r, split, stream);
  else
    launch_f32_instance<false, false>(cache, idx, slot_table, w, out, n,
                                      top_k, m, log2r, split, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kOneWarp, bool kPairs, bool kWide>
static void launch_quant_instance(const void* cache, const void* scale,
                                  const void* idx, const void* slot_table,
                                  const void* w, void* out, int n, int top_k,
                                  int m, int log2r, int split,
                                  cudaStream_t stream) {
  tiered_gather_quant_kernel<T, kOneWarp, kPairs, kWide>
      <<<gather_batched::blocks_for(n, split), gather_batched::kThreads, 0,
         stream>>>(static_cast<const T*>(cache),
                   static_cast<const float*>(scale),
                   static_cast<const int32_t*>(idx),
                   static_cast<const float*>(w), static_cast<float*>(out), n,
                   top_k, m, split, slot_rows(slot_table, log2r));
}

// wide: 1 for the wide loads where they fit, 0 for the pair loads.
template <typename T>
static int launch_quant(const void* cache, const void* scale, const void* idx,
                        const void* slot_table, const void* w, void* out,
                        int n, int top_k, int m, int log2r, int split,
                        int wide, cudaStream_t stream) {
  // pair loads stay aligned
  const bool pairs =
      m % 2 == 0 && reinterpret_cast<uintptr_t>(cache) % 2 == 0;
  if (wide && gather_batched::fits_wide(cache, m)) {
    if (split == 1)
      launch_quant_instance<T, true, true, true>(
          cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, 1,
          stream);
    else
      launch_quant_instance<T, false, true, true>(
          cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, split,
          stream);
  } else if (split == 1 && pairs) {
    launch_quant_instance<T, true, true, false>(
        cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, 1, stream);
  } else if (split == 1) {
    launch_quant_instance<T, true, false, false>(
        cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, 1, stream);
  } else if (pairs) {
    launch_quant_instance<T, false, true, false>(
        cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, split,
        stream);
  } else {
    launch_quant_instance<T, false, false, false>(
        cache, scale, idx, slot_table, w, out, n, top_k, m, log2r, split,
        stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_quant_auto(const void* cache, const void* scale,
                             const void* idx, const void* slot_table,
                             const void* w, void* out, int n, int top_k,
                             int m, int log2r, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const int per_warp = gather_batched::fits_wide(cache, m)
                           ? gather_batched::kBatch *
                                 gather_batched::kWideRows
                           : 4;
  return launch_quant<T>(
      cache, scale, idx, slot_table, w, out, n, top_k, m, log2r,
      gather_batched::split_for(n, top_k, gather_batched::sm_count(device),
                                per_warp),
      1, static_cast<cudaStream_t>(stream));
}

static bool valid_split(int split) {
  return split == 1 || split == 2 || split == 4 || split == 8;
}

template <typename T>
static int launch_quant_split(const void* cache, const void* scale,
                              const void* idx, const void* slot_table,
                              const void* w, void* out, int n, int top_k,
                              int m, int log2r, int split, int wide,
                              int device, void* stream) {
  cudaSetDevice(device);
  if (!valid_split(split)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_quant<T>(cache, scale, idx, slot_table, w, out, n, top_k, m,
                         log2r, split, wide,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int tiered_gather_f32(const void* cache, const void* idx,
                                 const void* slot_table, const void* w,
                                 void* out, int n, int top_k, int m,
                                 int log2r, int device, void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_f32(cache, idx, slot_table, w, out, n, top_k, m, log2r,
                    gather_batched::split_for(
                        n, top_k, gather_batched::sm_count(device)),
                    static_cast<cudaStream_t>(stream));
}

extern "C" int tiered_gather_quant_i8(const void* cache, const void* scale,
                                      const void* idx, const void* slot_table,
                                      const void* w, void* out, int n,
                                      int top_k, int m, int log2r, int device,
                                      void* stream) {
  return launch_quant_auto<int8_t>(cache, scale, idx, slot_table, w, out, n,
                                   top_k, m, log2r, device, stream);
}

extern "C" int tiered_gather_quant_e4m3(const void* cache, const void* scale,
                                        const void* idx,
                                        const void* slot_table, const void* w,
                                        void* out, int n, int top_k, int m,
                                        int log2r, int device, void* stream) {
  return launch_quant_auto<__nv_fp8_e4m3>(cache, scale, idx, slot_table, w,
                                          out, n, top_k, m, log2r, device,
                                          stream);
}

// The same gathers with an explicit split (1, 2, 4 or 8 warps a query)
// and, for B6, variant (wide 1: the wide loads where they fit; 0: the pair
// loads): for tests and A/B runs.
extern "C" int tiered_gather_f32_split(const void* cache, const void* idx,
                                       const void* slot_table, const void* w,
                                       void* out, int n, int top_k, int m,
                                       int log2r, int split, int device,
                                       void* stream) {
  cudaSetDevice(device);
  if (!valid_split(split)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_f32(cache, idx, slot_table, w, out, n, top_k, m, log2r, split,
                    static_cast<cudaStream_t>(stream));
}

extern "C" int tiered_gather_quant_i8_split(
    const void* cache, const void* scale, const void* idx,
    const void* slot_table, const void* w, void* out, int n, int top_k, int m,
    int log2r, int split, int wide, int device, void* stream) {
  return launch_quant_split<int8_t>(cache, scale, idx, slot_table, w, out, n,
                                    top_k, m, log2r, split, wide, device,
                                    stream);
}

extern "C" int tiered_gather_quant_e4m3_split(
    const void* cache, const void* scale, const void* idx,
    const void* slot_table, const void* w, void* out, int n, int top_k, int m,
    int log2r, int split, int wide, int device, void* stream) {
  return launch_quant_split<__nv_fp8_e4m3>(cache, scale, idx, slot_table, w,
                                           out, n, top_k, m, log2r, split,
                                           wide, device, stream);
}
