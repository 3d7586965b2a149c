// Row payloads and row maps of the weighted row gathers
// (gather_batched.cuh's body: K1, B4, B5, B6 and the range gather):
//
//   out[t] = sum_k  w[t,k] * (scale[r] if scaled) * values[r],
//            r = row_map(idx[t,k])
//
// `values` rows are fp32, bf16 or fp16 (read exactly as fp32), or 1-byte
// int8 / e4m3 payloads with one fp32 scale per row; Payload reads one column
// of a row as fp32 (the odd-m path; gather_batched.cuh's Raw and Raw8 load
// pairs and 8-byte words).
// `row_map` is the identity (DirectRows: a dense table), the tiered
// store's shard -> slot indirection (SlotRows: B5, B6), or a row-range
// shard of the table (RangeRows: the sharded gathers).  A row map
// returns int64; a row below 0 (a tiered shard that is not resident) gives
// NaN for its output row instead of a read out of bounds, and a masking
// map's kNotMine (an index outside the shard) adds nothing.
//
// The warp-per-query body this file held (one warp walked its query's
// rows, each row's address shuffled out in unroll-8 groups: about five
// dependent round trips a query, and 16 blocks at n = 128) was replaced by
// gather_batched.cuh's, kernel by kernel; at n = 128, top-32, m = 64 it
// took 0.0078 ms for B5 and 0.0083 for B6 (int8) against bounds of
// 0.00033 and 0.00010, where gather_batched.cuh takes 0.0026 and 0.0027
// (device time, tools/kernel_ab.py on an NVIDIA H100 80GB HBM3 at
// 700.00 W).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gather_rows {

constexpr unsigned kFull = 0xffffffffu;
// a masking row map's answer for an index outside its shard
constexpr int64_t kNotMine = -(static_cast<int64_t>(1) << 62);

// One column of a row, as fp32.
template <typename T>
struct Payload;

template <>
struct Payload<float> {
  static __device__ __forceinline__ float one(const float* r, int c) {
    return r[c];
  }
};

template <>
struct Payload<__nv_bfloat16> {
  static __device__ __forceinline__ float one(const __nv_bfloat16* r,
                                              int c) {
    return __bfloat162float(r[c]);  // exact
  }
};

template <>
struct Payload<__half> {
  static __device__ __forceinline__ float one(const __half* r, int c) {
    return __half2float(r[c]);  // exact
  }
};

template <>
struct Payload<int8_t> {
  static __device__ __forceinline__ float one(const int8_t* r, int c) {
    return static_cast<float>(r[c]);
  }
};

template <>
struct Payload<__nv_fp8_e4m3> {
  static __device__ __forceinline__ float one(const __nv_fp8_e4m3* r,
                                              int c) {
    return static_cast<float>(r[c]);
  }
};

// Dense table: the index is the row.
struct DirectRows {
  static constexpr bool kMasked = false;
  __device__ __forceinline__ int64_t operator()(int32_t gid) const {
    return gid;
  }
};

// Tiered device cache: slot_table[gid >> log2r] * R + (gid & (R - 1)),
// below 0 when the shard is not resident.  In int32: a cache row fits
// (the wrappers refuse 2^31 rows or more), and fewer registers let B5 hold
// K1's occupancy.
struct SlotRows {
  static constexpr bool kMasked = false;
  const int32_t* slot_table;
  int log2r;
  __device__ __forceinline__ int64_t operator()(int32_t gid) const {
    const int32_t slot = __ldg(slot_table + (gid >> log2r));
    return slot < 0 ? -1 : (slot << log2r) | (gid & ((1 << log2r) - 1));
  }
};

// A row-range shard of the table: rows [base, base + rows) of the whole
// table are this shard's rows 0 .. rows - 1; any other index is kNotMine
// (a 0 term, no read), never the NaN of a missing tiered shard.
struct RangeRows {
  static constexpr bool kMasked = true;
  int32_t base;
  int32_t rows;
  __device__ __forceinline__ int64_t operator()(int32_t gid) const {
    const uint32_t rel = static_cast<uint32_t>(gid - base);
    return rel < static_cast<uint32_t>(rows) ? static_cast<int64_t>(rel)
                                             : kNotMine;
  }
};

}  // namespace gather_rows
