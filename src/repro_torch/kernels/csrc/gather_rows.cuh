// The warp-per-query weighted row gather of B5 and B6, the last kernels
// that run the body below.  K1, B4 and the range gather moved to
// gather_batched.cuh, which reuses this file's Payload and row maps;
// lookup_bwd.cu's instances without scatter have a batched body of their
// own (gather_batched.cuh's payloads):
//
//   out[t] = sum_k  w[t,k] * (scale[r] if scaled) * values[r],
//            r = row_map(idx[t,k])
//
// fp32 accumulate.  `values` rows are fp32 (B5) or 1-byte int8 / e4m3
// payloads with one fp32 scale per row (B6).  The scale is folded into
// the weight (w * scale, one fp32 product) before the multiply-add, as the
// TPU kernels' bodies do.  `row_map` is the identity (dense table), the
// tiered store's shard->slot indirection, or a row-range shard of the
// table (the sharded gathers).
//
// Design (bound: bytes; see each .cu for its TPU kernel):
//   * one warp per query row, grid-stride over rows;
//   * lane l loads idx[t, l], translates it to a table row, loads w[t, l]
//     (and the row's scale) once, 32 at a time, and the warp broadcasts
//     them with __shfl_sync;
//   * every value row is then read by the whole warp as one coalesced
//     transaction, two adjacent columns per lane (m = 64: 256 B for fp32,
//     64 B for a 1-byte payload), converted to fp32 in registers;
//   * the sum stays in fp32 registers and the output row is written once.
// Rows wider than 64 columns loop over 64-column chunks.  A row that maps
// below 0 (a tiered shard that is not resident, an index below 0) gives
// NaN for its output row instead of reading out of bounds.  A row map that
// masks (RangeRows) tells "not this shard's row" apart: such an index adds
// nothing (a 0 term) and its row is not read, a skip that is warp-uniform
// because every lane holds the same broadcast row.

#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gather_rows {

constexpr int kWarps = 8;  // warps per block
constexpr unsigned kFull = 0xffffffffu;
// a masking row map's answer for an index outside its shard
constexpr int64_t kNotMine = -(static_cast<int64_t>(1) << 62);

// Two adjacent columns (c, c + 1) or one column of a row, as fp32.
template <typename T>
struct Payload;

template <>
struct Payload<float> {
  static __device__ __forceinline__ float2 pair(const float* r, int c) {
    return *reinterpret_cast<const float2*>(r + c);
  }
  static __device__ __forceinline__ float one(const float* r, int c) {
    return r[c];
  }
};

template <>
struct Payload<int8_t> {
  static __device__ __forceinline__ float2 pair(const int8_t* r, int c) {
    const char2 v = *reinterpret_cast<const char2*>(r + c);
    return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
  }
  static __device__ __forceinline__ float one(const int8_t* r, int c) {
    return static_cast<float>(r[c]);
  }
};

template <>
struct Payload<__nv_fp8_e4m3> {
  static __device__ __forceinline__ float2 pair(const __nv_fp8_e4m3* r,
                                                int c) {
    const __nv_fp8x2_e4m3 v = *reinterpret_cast<const __nv_fp8x2_e4m3*>(r + c);
    return static_cast<float2>(v);  // exact: every e4m3 value is a float
  }
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
// below 0 when the shard is not resident.
struct SlotRows {
  static constexpr bool kMasked = false;
  const int32_t* slot_table;
  int log2r;
  __device__ __forceinline__ int64_t operator()(int32_t gid) const {
    const int64_t slot = __ldg(slot_table + (gid >> log2r));
    if (slot < 0) return -1;
    return (slot << log2r) | static_cast<int64_t>(gid & ((1 << log2r) - 1));
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

template <typename T, bool kScaled, typename RowMap>
__device__ __forceinline__ void gather_rows(
    const T* __restrict__ values, const float* __restrict__ scale,
    const int32_t* __restrict__ idx, const float* __restrict__ w,
    float* __restrict__ out, int n, int top_k, int m, RowMap row_map) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec2 = (m % 2) == 0;  // pair loads stay aligned
  for (int t = blockIdx.x * kWarps + warp; t < n;
       t += gridDim.x * kWarps) {
    const int32_t* it = idx + static_cast<int64_t>(t) * top_k;
    const float* wt = w + static_cast<int64_t>(t) * top_k;
    for (int c0 = 0; c0 < m; c0 += 64) {
      const int c = c0 + 2 * lane;
      float ax = 0.f, ay = 0.f;
      for (int kb = 0; kb < top_k; kb += 32) {
        const int kk = kb + lane;
        int64_t my_row = 0;
        float my_w = 0.f;
        if (kk < top_k) {
          my_row = row_map(it[kk]);
          my_w = wt[kk];
          if (RowMap::kMasked && my_row == kNotMine) {
            my_w = 0.f;  // not this shard's row: skipped below
          } else if (my_row < 0) {
            my_row = 0;
            my_w = __int_as_float(0x7fc00000);  // NaN marks the row
          } else if (kScaled) {
            my_w *= scale[my_row];
          }
        }
        const int cnt = min(32, top_k - kb);
#pragma unroll 8
        for (int j = 0; j < cnt; ++j) {
          const int64_t row = __shfl_sync(kFull, my_row, j);
          const float wj = __shfl_sync(kFull, my_w, j);
          if (RowMap::kMasked && row == kNotMine) continue;  // warp-uniform
          const T* vr = values + row * m;
          if (vec2 && c + 1 < m) {
            const float2 v = Payload<T>::pair(vr, c);
            ax = fmaf(wj, v.x, ax);
            ay = fmaf(wj, v.y, ay);
          } else {
            if (c < m) ax = fmaf(wj, Payload<T>::one(vr, c), ax);
            if (c + 1 < m) ay = fmaf(wj, Payload<T>::one(vr, c + 1), ay);
          }
        }
      }
      float* ot = out + static_cast<int64_t>(t) * m;
      if (c < m) ot[c] = ax;
      if (c + 1 < m) ot[c + 1] = ay;
    }
  }
}

inline int blocks_for(int n) { return min((n + kWarps - 1) / kWarps, 65535); }

}  // namespace gather_rows
